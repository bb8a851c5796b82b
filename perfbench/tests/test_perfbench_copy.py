"""Growth by files alone, and whole runs on the CPU at small sizes.

A copy of the benchmark in a temporary directory gains two configurations,
two traffic mixes and three cells by new files and new BENCHMARK.json
entries alone, and a per-layer metric by a new reader; each cell then runs
whole (set-up, window, traced readings, the check) on the CPU through the
harness's test-only host device, and comes out correct; with each fault
the cell can have planted underneath, it comes out not correct."""

import json

import pytest

from perfbench.tests import faults
from perfbench.tests.bench_copy import make_copy, run_cell


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    root = make_copy(tmp_path_factory.mktemp("bench"))
    # A new per-layer metric: its reader, and its entry.
    (root / "perfbench/metrics/requests_in_window.py").write_text(
        "def read(run):\n    return run.window.get('requests')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "request path",
                               "moves": "serve_clips_per_s", "workloads": ["x3d_tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("cell, trace", [("x3d_tiny.serve", False), ("x3d_tiny.serve", True),
                                         ("x3d_tiny.latency", False), ("x3d_tiny.latency", True),
                                         ("mvit_tiny.serve", True), ("mvit_tiny.train", False),
                                         ("mvit_tiny.train", True)])
def test_a_cell_added_by_files_runs_whole_and_correct(copy_root, cell, trace):
    result = run_cell(copy_root, cell, seconds=0.5, trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks" and result["checks"]
    expected = {"x3d_tiny.serve": ({"serve_clips_per_s", "setup_s"},
                                   {"serve_mfu", "requests_in_window"}),
                "x3d_tiny.latency": ({"serve_p95_ms", "setup_s"},
                                     {"request_p50_ms", "replay_host_ms"}),
                "mvit_tiny.serve": (set(), {"serve_mfu"}),
                "mvit_tiny.train": ({"train_clips_per_s", "setup_s"}, {"train_mfu"})}[cell]
    assert expected[trace] <= set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])


@pytest.mark.parametrize("cell, fault", [
    ("x3d_tiny.serve", "answer_altered"), ("mvit_tiny.serve", "answer_altered"),
    ("mvit_tiny.train", "state_unchanged"), ("mvit_tiny.train", "half_batch")])
def test_a_fault_underneath_makes_the_run_incorrect(copy_root, cell, fault):
    planted = {**faults.SERVE_FAULTS, **faults.TRAIN_FAULTS}[fault][1]
    result = run_cell(copy_root, cell, seconds=0.5, patch=planted)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
