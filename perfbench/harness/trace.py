"""Readings of a ``torch.profiler`` trace, as exported in Chrome's format.

Every reading works on the list of complete (``"ph": "X"``) events, so the
tests can hand it a synthetic list:

- device intervals: kernels, copies and sets on the device (the profiler's
  ``gpu_user_annotation`` mirrors of host ranges and its "Command Buffer
  Full" rows are no device work), and their union;
- the idle share of a window: one minus the union over the window's length;
- the breakdown: the device operations that took most time, and the
  device's idle gaps summed by what the host was doing in them;
- attribution: the device time of each host range, summed over the
  kernels whose launch (the runtime call with the kernel's ``correlation``
  id) lies inside the range on the same thread, whatever their names.

Times in the trace are microseconds; what these functions return is too,
unless a name says seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# A name in the breakdown is cut to this many characters (template
# kernels' names run to hundreds).
NAME_CHARS = 120

Interval = Tuple[float, float]


def complete_events(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def profile_events(fn, activities, record_shapes: bool = False) -> List[dict]:
    """Runs ``fn()`` under ``torch.profiler`` with ``activities`` and returns
    the trace's complete events. The trace goes to a file under ``TMPDIR``,
    which is deleted once read."""
    import torch

    with torch.profiler.profile(activities=activities, record_shapes=record_shapes) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return complete_events(json.load(f))
    finally:
        os.remove(path)


def is_device_op(e: dict) -> bool:
    return e.get("cat") in DEVICE_CATS and "Command Buffer Full" not in e.get("name", "")


def device_intervals(events: Iterable[dict]) -> List[Interval]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if is_device_op(e))


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def idle_gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def ranges(events: Iterable[dict], prefix: str) -> List[dict]:
    """The host ranges (``record_function``) whose names start with ``prefix``."""
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(prefix)), key=lambda e: e["ts"])


def window_of(events: Sequence[dict], name: str) -> Interval:
    """(start, end) of the one host range called ``name``."""
    found = [e for e in ranges(events, name) if e["name"] == name]
    if len(found) != 1:
        raise ValueError(f"expected one range {name!r} in the trace, found {len(found)}")
    return float(found[0]["ts"]), float(found[0]["ts"]) + float(found[0]["dur"])


def idle_share(events: Sequence[dict], window: str) -> Optional[Tuple[float, float]]:
    """(busy us, window us) of the range ``window``; None where the trace
    holds no device operation in it."""
    lo, hi = window_of(events, window)
    spans = device_intervals(events)
    on = busy(spans, lo, hi)
    return None if on <= 0.0 else (on, hi - lo)


def attribute(events: Sequence[dict], prefix: str) -> Dict[str, List[float]]:
    """range name -> the device us of each of its occurrences: the summed
    duration of every device operation whose launch lies inside that
    occurrence of a host range named ``prefix``..., on the range's thread.
    A launch inside nested ranges counts for the innermost."""
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    spans = ranges(events, prefix)
    by_thread: Dict[object, List[dict]] = defaultdict(list)
    for r in spans:
        by_thread[r.get("tid")].append(r)
    starts = {tid: [float(r["ts"]) for r in rs] for tid, rs in by_thread.items()}
    totals = [0.0] * len(spans)
    index = {id(r): i for i, r in enumerate(spans)}
    for e in events:
        if not is_device_op(e):
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        ts, tid = launch
        rs = by_thread.get(tid, [])
        at = bisect.bisect_right(starts.get(tid, []), ts)
        owner = None
        for r in reversed(rs[:at]):
            if float(r["ts"]) + float(r["dur"]) >= ts:
                owner = r  # the latest-starting range that covers: the innermost
                break
        if owner is not None:
            totals[index[id(owner)]] += float(e["dur"])
    out: Dict[str, List[float]] = defaultdict(list)
    for r, total in zip(spans, totals):
        out[r["name"]].append(total)
    return dict(out)


def _host_activity(host: List[dict], starts: List[float], t: float) -> str:
    at = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, at - 400):at]):
        if float(e["ts"]) + float(e["dur"]) >= t:
            return e["name"][:NAME_CHARS]
    return "no host event"


def breakdown(events: Sequence[dict], window: str, top: int = 10) -> dict:
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[host activity, s],
    ...]}`` over the range ``window``: device time summed by operation name,
    and the device's idle time summed by the innermost host event at each
    gap's middle; the ``top`` largest of each."""
    lo, hi = window_of(events, window)
    ops: Dict[str, float] = defaultdict(float)
    for e in events:
        if is_device_op(e):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b > lo and a < hi:
                ops[e["name"][:NAME_CHARS]] += (min(b, hi) - max(a, lo)) / 1e6
    host = sorted((e for e in events if e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    starts = [float(e["ts"]) for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(device_intervals(events), lo, hi):
        gaps[_host_activity(host, starts, (a + b) / 2)] += (b - a) / 1e6
    ordered = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ordered(ops), "idle_gaps": ordered(gaps)}
