"""The program's own spans, counters and device marks, for the per-layer
metrics of a ``--trace 1`` run (``metrics/train_*_ms.py``,
``serve_call_host_ms.py``, ``capture_s.py``).

The program keeps them in ``pytorchvideo_tpu_torch.utils.profiling``: spans
named ``pvt.<layer>.<part>`` (``record_function`` ranges under the
profiler; kept with host times by ``recording()``), process-wide
``counters``, and the captured training step's device marks, whose four
parts ``recording()`` keeps per update. A program without that recorder
gives nothing to read: :func:`recorder` is None and the readers return
None.

After the profiled sub-window the readers drive the program once more,
inside ``recording()`` with no profiler attached, as the window drives it:
``traced_requests`` closed-loop requests through the kind's ``serve``, or
``traced_steps`` steps of the app's ``train()``. One such drive serves every
reader of the run (:func:`recorded`).

:func:`idle_by_span` puts each idle stretch of the device in the profiled
sub-window down to the innermost ``pvt.`` span open on the host then.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from perfbench.harness import trace as tr
from perfbench.harness.session import WINDOW

PREFIX = "pvt."
OUTSIDE = "outside the program"


def recorder():
    """The program's recorder module, or None where it has no ``recording``."""
    from pytorchvideo_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def recorded(run):
    """The ``Recording`` of one drive of the program after the traced
    sub-window (made at the first call, kept in ``run.program``), or None
    without a recorder."""
    if "recording" in run.program:
        return run.program["recording"]
    profiling = recorder()
    rec = None
    if profiling is not None:
        if "app" in run.program:
            app = run.program["app"]
            app.steps_per_epoch = run.traffic["traced_steps"]
            with profiling.recording() as rec:
                app.train()
        else:
            pool = run.program["pool"]
            with profiling.recording() as rec:
                for i in range(run.traffic["traced_requests"]):
                    run.kind.serve(run, pool[i % len(pool)])
        run.device.sync()
    run.program["recording"] = rec
    return rec


def span_ms(rec, name: str) -> List[float]:
    """The host ms of every closed span called ``name`` in ``rec``."""
    return [span.ns / 1e6 for span in rec if span.name == name and span.ns is not None]


def median_span_ms(run, name: str) -> Optional[float]:
    rec = recorded(run)
    found = span_ms(rec, name) if rec is not None else []
    if found:
        run.note(f"{name}: host ms median {statistics.median(found)!r} over {len(found)}, "
                 f"min {min(found)!r}, max {max(found)!r}")
    return statistics.median(found) if found else None


def median_part_ms(run, part: str) -> Optional[float]:
    """The median device ms of ``part`` of the recorded updates (the train
    step's device marks); None where no mark was read (the CPU)."""
    rec = recorded(run)
    if rec is None or not rec.parts:
        return None
    if "parts_noted" not in run.program:
        run.program["parts_noted"] = True
        sums = [sum(parts.values()) for _, parts in rec.parts]
        medians = {k: statistics.median(p[k] for _, p in rec.parts) for k in rec.parts[0][1]}
        run.note(f"train parts: {len(rec.parts)} updates, median ms {medians!r}; their sum "
                 f"median {statistics.median(sums)!r}, min {min(sums)!r}, max {max(sums)!r}")
        if run.busy:
            busy_ms = run.busy[0] / 1e3 / run.traffic["traced_steps"]
            run.note(f"train parts: the traced window's device busy time a step {busy_ms!r} ms; "
                     f"the parts' median sum over it {statistics.median(sums) / busy_ms!r}")
    return statistics.median(parts[part] for _, parts in rec.parts)


def idle_by_span(events: Sequence[dict], window: str = WINDOW) -> Dict[str, float]:
    """{innermost ``pvt.`` span, or :data:`OUTSIDE`: seconds the device was
    idle while it was open} over the range ``window``. Each idle stretch is
    cut at the spans' ends, and each piece goes to the latest-starting span
    that covers it, on any thread."""
    lo, hi = tr.window_of(events, window)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in tr.ranges(events, PREFIX)]
    starts = [s[0] for s in spans]
    reach, furthest = [], float("-inf")  # the latest end among spans[:i + 1]
    for _, end, _ in spans:
        furthest = max(furthest, end)
        reach.append(furthest)
    cuts = sorted({t for s in spans for t in s[:2]})

    def innermost(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] > t:
            if spans[i][1] > t:
                return spans[i][2]
            i -= 1
        return OUTSIDE

    out: Dict[str, float] = defaultdict(float)
    for a, b in tr.idle_gaps(tr.device_intervals(events), lo, hi):
        inside = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for x, y in zip([a, *inside], [*inside, b]):
            out[innermost((x + y) / 2)] += (y - x) / 1e6
    return dict(out)


def notes(run) -> None:
    """Once a run, on standard error: the device's idle seconds in the
    traced window by innermost program span, the ``pvt.`` spans the window
    holds, the program's counters and the captured graphs' launches a
    replay."""
    if run.program.get("noted"):
        return
    run.program["noted"] = True
    if run.events:
        idle = idle_by_span(run.events)
        ordered = sorted(idle.items(), key=lambda kv: -kv[1])
        run.note(f"idle s by program span: {ordered!r} (sum {sum(idle.values())!r})")
        lo, hi = tr.window_of(run.events, WINDOW)
        held: Dict[str, int] = defaultdict(int)
        for e in tr.ranges(run.events, PREFIX):
            inside = lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi
            held[e["name"] if inside else e["name"] + " (outside the window)"] += 1
        run.note(f"pvt spans in the traced window: {dict(sorted(held.items()))!r}")
    profiling = recorder()
    if profiling is not None:
        run.note(f"counters: {dict(sorted(profiling.counters.items()))!r}")
    for name, graph in graphs(run):
        run.note(f"{name}: launches_per_replay "
                 f"{getattr(graph, 'launches_per_replay', None)!r}, "
                 f"capture_s {getattr(graph, 'capture_s', None)!r}")


def graphs(run) -> list:
    """[(what, graph)]: the served ``CompiledForward``, or the app's captured
    train steps."""
    if "app" in run.program:
        return [(f"train step {i}", step)
                for i, step in enumerate(run.program["app"]._captured_steps.values())]
    server = run.program.get("server")
    return [] if server is None else [("served forward", server)]
