"""One run of one cell: set-up, the measured window, the traced readings
of a ``--trace 1`` run, and the comparison with the plain reference.

The cell's traffic kind (``kinds/<kind>.py``) drives the program; it
defines ``setup(run)``, ``measure(run)``, ``trace(run)``, ``release(run)``
and ``check(run)``. Each metric's reader (``metrics/<name>.py``) defines
``read(run)``, which returns the metric's value, or None where it finds
nothing to read, and then the metric is left out of the result.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, List, Optional

from perfbench.harness import spec

WINDOW = "perfbench.window"


class Run:
    """What the kind, the readers and the check share about one run."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device, t0: float):
        self.bench = bench
        self.cell = spec.cell(bench, workload)
        entry = spec.config_entry(bench, self.cell["config"])
        self.config = json.loads(spec.config_path(entry).read_text())
        self.model = self.config["model"]
        self.traffic = json.loads(spec.traffic_path(self.cell["traffic"]).read_text())
        self.reference = spec.load_module(spec.reference_path(self.config["reference"]))
        self.kind = spec.load_module(spec.kind_path(self.traffic["kind"]))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t0 = device, t0
        self.setup_s: Optional[float] = None
        self.window: Dict[str, Any] = {}  # the kind's record of the measured window
        self.events: Optional[List[dict]] = None  # the traced sub-window's trace events
        self.program: Dict[str, Any] = {}  # what the kind keeps for the readers
        self.checks: Dict[str, tuple] = {}  # name -> (value, limit): value <= limit passes
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.busy: Optional[tuple] = None  # (busy s, window s) of the traced sub-window

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """Runs the cell once and returns the result's object (not yet printed)."""
    from perfbench.harness import trace as tr

    run = Run(bench, workload, seed, seconds, trace, device, t0)
    run.kind.setup(run)
    run.note(f"setup_s {run.setup_s!r}")
    run.kind.measure(run)
    run.memory_peak = device.peak_bytes()
    breakdown = None
    if trace:
        run.kind.trace(run)
        if run.events:
            run.busy = tr.idle_share(run.events, WINDOW)
            breakdown = tr.breakdown(run.events, WINDOW)
    metrics = {}
    for entry in spec.metrics_of(bench, workload, trace):
        value = spec.load_module(spec.metric_path(entry["name"])).read(run)
        if value is None:
            run.note(f"{entry['name']}: nothing to read")
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    run.kind.release(run)
    t_check = time.perf_counter()
    run.kind.check(run)
    run.note(f"check took {time.perf_counter() - t_check:.3f} s")
    correct = run.failed == 0 and bool(run.checks) and all(
        math.isfinite(v) and v <= limit for v, limit in run.checks.values())
    result = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {"platform": device.platform, "kind": device.kind, "count": device.chips,
                   "memory_peak_bytes": int(run.memory_peak)},
    }
    if trace:
        busy_us, window_us = run.busy if run.busy else (0.0, 0.0)
        result["device"]["busy_s"] = busy_us / 1e6
        result["device"]["window_s"] = window_us / 1e6
        if breakdown is not None:
            result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in run.checks.items()}
    return result
