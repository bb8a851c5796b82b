"""The readers of the program's own spans, counters and device marks: the
device's idle time by innermost program span on a synthetic trace, each
new reader on a CPU run of the small cells (a number, or nothing where it
needs the card), and BENCHMARK.json with their entries."""

import json

import pytest

from perfbench.harness import spans, spec
from perfbench.tests.bench_copy import REPO, make_copy, run_cell

NEW = {"train_forward_ms", "train_backward_ms", "train_clip_ms", "train_optimizer_ms",
       "train_host_ms", "serve_call_host_ms", "capture_s"}


def ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}


def test_idle_goes_to_the_innermost_program_span_or_outside():
    events = [
        ev("perfbench.window", 0, 100),
        ev("perfbench.request", 0, 100),
        ev("pvt.serve.call", 10, 60),
        ev("pvt.serve.copy_in", 12, 8),
        ev("pvt.serve.replay", 30, 20),
        ev("k1", 0, 5, cat="kernel"),
        ev("k2", 20, 15, cat="kernel"),
        ev("k3", 60, 30, cat="kernel"),
        ev("pvt.serve.call", 10, 60, cat="gpu_user_annotation"),  # no device work
    ]
    idle = spans.idle_by_span(events, "perfbench.window")
    # Idle: 5-20 (5-10 outside, 10-12 call, 12-20 copy_in), 35-60 (35-50
    # replay, 50-60 call), 90-100 outside.
    expected = {spans.OUTSIDE: (5 + 10) / 1e6, "pvt.serve.call": (2 + 10) / 1e6,
                "pvt.serve.copy_in": 8 / 1e6, "pvt.serve.replay": 15 / 1e6}
    assert idle.keys() == expected.keys()
    for name, seconds in expected.items():
        assert idle[name] == pytest.approx(seconds), name


def test_without_program_spans_every_idle_stretch_is_outside():
    events = [ev("perfbench.window", 0, 50), ev("k", 10, 10, cat="kernel"),
              ev("pvt.early", -20, 10)]
    assert spans.idle_by_span(events, "perfbench.window") == {
        spans.OUTSIDE: pytest.approx(40 / 1e6)}


def test_the_benchmark_with_the_new_entries_breaks_no_rule():
    data = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec.problems(data) == [] and spec.missing_files(data) == []
    entries = {m["name"]: m for m in data["per_layer"] if m["name"] in NEW}
    assert entries.keys() == NEW and list(entries) == [m["name"] for m in data["per_layer"][-7:]]
    assert all(m["source"] == "program_span" for m in entries.values())
    assert entries["capture_s"]["workloads"] == [c["name"] for c in data["workloads"]]


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell, number, nothing", [
    # The CPU's train step is the eager one: its span, no graph, no marks.
    ("mvit_tiny.train", {"train_host_ms"},
     {"train_forward_ms", "train_backward_ms", "train_clip_ms", "train_optimizer_ms",
      "capture_s"}),
    # The CPU serves the eager module: no compiled call, no capture.
    ("x3d_tiny.latency", set(), {"serve_call_host_ms", "capture_s"}),
])
def test_each_new_reader_reads_a_cpu_run_or_finds_nothing(copy_root, cell, number, nothing):
    result = run_cell(copy_root, cell, seconds=0.5, trace=True)
    assert result["correct"] is True
    got = set(result["metrics"]) & NEW
    assert got == number
    assert all(result["metrics"][m]["value"] > 0 for m in number)
    assert not nothing & set(result["metrics"])
    # The readers ran before the check, which still passes.
    assert list(result)[-1] == "checks"
