"""The benchmark's data: BENCHMARK.json's rules, the files each name leads
to, growth by new files alone, and what the benchmark may import."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import guard, spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_the_benchmark_loads_and_every_name_leads_to_its_file():
    data = spec.load(REPO / "BENCHMARK.json")
    for cell in data["workloads"]:
        cfg = json.loads(spec.config_path(spec.config_entry(data, cell["config"])).read_text())
        assert spec.reference_path(cfg["reference"]).is_file()
        traffic = json.loads(spec.traffic_path(cell["traffic"]).read_text())
        assert spec.kind_path(traffic["kind"]).is_file()
        for trace in (False, True):
            for metric in spec.metrics_of(data, cell["name"], trace):
                assert spec.metric_path(metric["name"]).is_file()
                assert callable(spec.load_module(spec.metric_path(metric["name"])).read)


@pytest.mark.parametrize("edit, complaint", [
    (lambda d: d["workloads"][0].update(name="bad name"), "bad name"),
    (lambda d: d["workloads"][0].update(name="x" * 65), "bad name"),
    (lambda d: d["end_to_end"][0].update(unit="clips per s"), "bad unit"),
    (lambda d: d["end_to_end"][0].update(unit="µs"), "bad unit"),
    (lambda d: d["end_to_end"][0].update(better="more"), "better"),
    (lambda d: d["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda d: d["end_to_end"][0].update(source="program_span"), "end-to-end source"),
    (lambda d: d["per_layer"][0].update(moves="nothing"), "unknown metric"),
    (lambda d: d["per_layer"][0].update(why="no such key"), "keys"),
    (lambda d: d["workloads"][0].update(chips=2), "chips"),
    (lambda d: d["workloads"][0].update(config="nope"), "unknown config"),
    (lambda d: d["workloads"].append(dict(d["workloads"][0], name="again")), "twice"),
    (lambda d: d.update(run_seconds=52), "run_seconds"),
    (lambda d: d["end_to_end"].pop([m["name"] for m in d["end_to_end"]].index("setup_s")),
     "setup_s"),
    (lambda d: d["configs"][0]["reduced"].append("a b"), "reduced"),
    (lambda d: d.update(paths=["/abs"]), "paths"),
    (lambda d: d.update(extra=1), "top-level"),
])
def test_malformed_entries_are_refused(edit, complaint):
    data = copy.deepcopy(BENCH)
    edit(data)
    found = spec.problems(data)
    assert any(complaint in p for p in found), found


def test_the_cells_as_committed_break_no_rule():
    assert spec.problems(BENCH) == []
    assert spec.missing_files(BENCH) == []


def test_a_missing_file_is_named():
    data = copy.deepcopy(BENCH)
    data["per_layer"][0]["name"] = "no_reader_for_this"
    assert any("no_reader_for_this.py" in p for p in spec.missing_files(data))


def _sources():
    return sorted(p for p in (REPO / "perfbench").rglob("*.py") if "tests" not in p.parts)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not guard.imported_top_levels(path) & set(guard.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        names = guard.imported_top_levels(path)
        assert guard.PROGRAM not in names and not names & set(guard.FORBIDDEN), path


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pytorchvideo_tpu_torch_lookalike", sys)
    assert guard.top_level("pytorchvideo_tpu_torch.ops") == "pytorchvideo_tpu_torch"
    assert "pytorchvideo_tpu_torch_lookalike" not in guard.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pytorchvideo_tpu.models", sys)
    assert guard.loaded_forbidden() == ["pytorchvideo_tpu.models"]


def test_importing_the_harness_the_references_and_the_program_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import spec, session, guard, trace, units, device\n"
        "from perfbench.reference import x3d, mvit, recipe\n"
        "for p in spec.BENCH_DIR.glob('kinds/*.py'): spec.load_module(p)\n"
        "for p in spec.BENCH_DIR.glob('metrics/*.py'): spec.load_module(p)\n"
        "import pytorchvideo_tpu_torch.train, pytorchvideo_tpu_torch.accelerate\n"
        "from pytorchvideo_tpu_torch.models import hub\n"
        "print(guard.loaded_forbidden())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
                           BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 3),
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "5", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
