"""Profiling and timing helpers.

Counterpart of pytorchvideo_tpu/utils/profiling.py: :func:`trace` records a
``torch.profiler`` trace (the CUDA activity too when a card is present) as
a Chrome trace file; :func:`annotate` names a range in it; :func:`time_jitted`
and :func:`time_stateful` time a call by differencing two trip counts, as
the JAX package's ``_diff_trip_counts`` does: the fastest of ``trials`` runs
at 1 and at ``iters + 1`` calls, their difference over ``iters``, which
cancels the fixed cost of a run. On the card a run is timed by CUDA events
on the current stream, on the CPU by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir): step()`` writes ``dir/trace.json`` (Chrome trace
    format) on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> torch.profiler.record_function:
    """A named range of the trace around the code it wraps."""
    return torch.profiler.record_function(name)


def _on_card(values) -> bool:
    """Whether any tensor among ``values`` (nested in lists, tuples and
    dicts) lies on a CUDA device."""
    if isinstance(values, torch.Tensor):
        return values.is_cuda
    if isinstance(values, dict):
        values = list(values.values())
    return isinstance(values, (list, tuple)) and any(_on_card(v) for v in values)


def _run_seconds(run: Callable[[int], None], n: int, on_card: bool) -> float:
    if not on_card:
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _diff_trip_counts(run: Callable[[int], None], iters: int, trials: int, on_card: bool) -> float:
    """Seconds per call: the fastest run of 1 and of ``iters + 1`` calls over
    ``trials``, differenced, over ``iters`` (one run of each first, as a
    warm-up). RuntimeError when the difference is not positive."""
    run(1)
    run(iters + 1)
    best_small = best_big = float("inf")
    for _ in range(trials):
        best_small = min(best_small, _run_seconds(run, 1, on_card))
        best_big = min(best_big, _run_seconds(run, iters + 1, on_card))
    diff = best_big - best_small
    if diff <= 0:
        raise RuntimeError(f"call time below the measurement's noise (diff={diff * 1e3:.3f} ms "
                           f"over {iters} iters); raise `iters`")
    return diff / iters


def time_jitted(fn: Callable, *args, iters: int = 20, trials: int = 3) -> float:
    """Seconds per call of ``fn(*args)``: CUDA events where an argument lies on
    the card, the host clock otherwise."""

    def run(n: int) -> None:
        with torch.no_grad():
            for _ in range(n):
                fn(*args)

    return _diff_trip_counts(run, iters, trials, _on_card(args))


def time_stateful(step_fn: Callable, state, *args, iters: int = 20, trials: int = 3) -> float:
    """Seconds per call of ``new_state, out = step_fn(state, *args)``, the
    state carried from call to call within a run (each run starts from
    ``state``): a training step, whose update must run."""

    def run(n: int) -> None:
        s = state
        for _ in range(n):
            s, _ = step_fn(s, *args)

    return _diff_trip_counts(run, iters, trials, _on_card((state, args)))
