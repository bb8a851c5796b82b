"""Profiling and timing helpers, and the program's one recorder of spans,
counters and device marks.

Counterpart of pytorchvideo_tpu/utils/profiling.py: :func:`trace` records a
``torch.profiler`` trace (the CUDA activity too when a card is present) as
a Chrome trace file; :func:`time_jitted` and :func:`time_stateful` time a
call by differencing two trip counts, as the JAX package's
``_diff_trip_counts`` does: the fastest of ``trials`` runs at 1 and at
``iters + 1`` calls, their difference over ``iters``, which cancels the
fixed cost of a run. On the card a run is timed by CUDA events on the
current stream, on the CPU by the host clock.

The recorder. The program names its parts ``pvt.<layer>.<part>`` and
marks them in three ways:

- spans, :func:`annotate`: off (no profiler recording and no
  :func:`recording` open) a span is the shared no-op :data:`NOOP`, one
  check; under an active ``torch.profiler`` it is a ``record_function``
  range, in the trace beside the kernels it launches; inside
  :func:`recording` its name, host ``perf_counter_ns`` start and end, parent
  and step are kept in memory and returned when the block ends, with its
  self time (its duration less its children's). Nothing is written while
  it runs;
- counters, :data:`counters` and :func:`count`: a process-wide dict of
  ints, always on (one integer add);
- device marks, :class:`DeviceMarks`: named CUDA timing events recorded at
  fixed points of the device's work. Recorded while a CUDA graph is
  captured they become event-record nodes of the graph, so every replay
  records them again: the one way to time the parts of a replayed graph.
  They are read (a wait for the last of them) only inside
  :func:`recording`, by :func:`read_marks`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

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


@dataclass
class Span:
    """One span kept by :func:`recording`. ``parent`` is the index, in the
    recording, of the span it ran inside on its thread (None at a root);
    ``step`` the step or request it belongs to; times are host
    ``perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    step: Any
    self_ns: Optional[int] = None

    @property
    def ns(self) -> Optional[int]:
        return None if self.end_ns is None else self.end_ns - self.start_ns


class Recording(list):
    """The :class:`Span` s of one :func:`recording` block, in the order they
    opened, and ``parts``: ``(step, {part: device ms})`` per update whose
    device marks were read (:func:`read_marks`)."""

    def __init__(self):
        super().__init__()
        self.parts: List[Tuple[Any, Dict[str, float]]] = []
        self._lock = threading.Lock()
        self._stacks = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._stacks, "open", None)
        if stack is None:
            stack = self._stacks.open = []
        return stack

    def _open(self, name: str, step: Any) -> int:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if step is None:
            step = self[parent].step if parent is not None else -next(_requests)
        span = Span(name, time.perf_counter_ns(), None, parent, step)
        with self._lock:
            self.append(span)
            index = len(self) - 1
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self[index].end_ns = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] == index:
            stack.pop()

    def _finish(self) -> None:
        children = collections.defaultdict(int)
        for span in self:
            if span.parent is not None and span.ns is not None:
                children[span.parent] += span.ns
        for i, span in enumerate(self):
            if span.ns is not None:
                span.self_ns = span.ns - children[i]


_recording: Optional[Recording] = None
# A root span given no step opens a request of its own: -1, -2, ... (the
# train steps are the update counts, 0 and up).
_requests = itertools.count(1)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """``with recording() as spans:`` keeps every span the program opens in
    the block (any thread), and the device parts :func:`read_marks` reads;
    the spans' self times are set when the block ends. Blocks nest: the
    innermost keeps what opens in it."""
    global _recording
    outer, _recording = _recording, Recording()
    rec = _recording
    try:
        yield rec
    finally:
        _recording = outer
        rec._finish()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Off()


class _Span:
    __slots__ = ("name", "step", "_range", "_recording", "_index")

    def __init__(self, name: str, step: Any):
        self.name, self.step = name, step
        self._range = self._recording = self._index = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        rec = self._recording = _recording
        if rec is not None:
            self._index = rec._open(self.name, self.step)
        return None

    def __exit__(self, *exc) -> bool:
        if self._recording is not None:
            self._recording._close(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def annotate(name: str, step: Any = None):
    """The program's span around the code it wraps: :data:`NOOP` when off,
    a ``record_function`` range under an active ``torch.profiler``, kept by
    an open :func:`recording` (see the module docstring). ``step``: the
    step or request the span belongs to (default: its parent's, or a new
    request's at a root)."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return NOOP
    return _Span(name, step)


counters: Dict[str, int] = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``counters[name]``."""
    counters[name] += n


class DeviceMarks:
    """CUDA timing events, one per name of ``names``, recorded by
    :meth:`record` on the current stream at fixed points of the device's
    work, in that order. ``external=True``: recorded while a CUDA graph is
    captured, a mark becomes an event-record node of the graph, and each
    replay records it again; recorded eagerly, it is a plain event record.
    :meth:`parts` gives the device ms from each mark to the next, keyed by
    the later one's name."""

    def __init__(self, names: Sequence[str]):
        self.names = tuple(names)
        self._events: Dict[str, torch.cuda.Event] = {}

    def record(self, name: str) -> None:
        event = self._events.get(name)
        if event is None:
            event = self._events[name] = torch.cuda.Event(enable_timing=True, external=True)
        event.record()

    def recorded(self) -> bool:
        return len(self._events) == len(self.names)

    def parts(self) -> Dict[str, float]:
        """{later mark: ms from the mark before it}, once the last mark has
        been reached on the device (this waits for it)."""
        events = [self._events[name] for name in self.names]
        events[-1].synchronize()
        return {name: start.elapsed_time(end)
                for name, start, end in zip(self.names[1:], events, events[1:])}


def read_marks(marks: Optional[DeviceMarks], step: Any) -> None:
    """Inside :func:`recording`: waits for the last of ``marks`` and keeps
    their parts as ``(step, parts)`` in the recording's ``parts``. Outside,
    or where the marks were never recorded (the CPU), nothing."""
    rec = _recording
    if rec is not None and marks is not None and marks.recorded():
        rec.parts.append((step, marks.parts()))


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
