"""BENCHMARK.json: its rules, and the files that each name in it leads to.

The harness is driven by data. A cell (an entry of ``workloads``) names a
configuration and a traffic mix; each is found by its name:

- ``configs/<config>.json`` (the path that ``configs[].file`` gives): the
  model's sizes as run, which reference models it (``reference``), and the
  program's factory that builds it (``program``);
- ``reference/<reference>.py``: the plain float32 model of that family;
- ``traffic/<traffic>.json``: the mix's parameters, and its ``kind``;
- ``kinds/<kind>.py``: the general driver of that kind of traffic;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or per layer.

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}


def _line(text: Any) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\r\n]", text)


def _name(text: Any) -> bool:
    return isinstance(text, str) and NAME.match(text) is not None


def problems(data: Dict[str, Any]) -> List[str]:
    """What in ``data`` (BENCHMARK.json as loaded) breaks the benchmark's
    rules: names, units, keys, sources, bounds and references between
    entries. Files are not looked at (see :func:`missing_files`)."""
    out = []
    if not isinstance(data, dict) or set(data) != TOP_KEYS:
        return [f"the top-level keys must be exactly {sorted(TOP_KEYS)}"]
    command, paths = data["command"], data["paths"]
    if not (isinstance(command, list) and 1 <= len(command) <= 32 and all(map(_line, command))):
        out.append("command: 1 to 32 words of 1 to 200 characters")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16 and all(
            isinstance(p, str) and PATH.match(p) and not p.startswith("/")
            and ".." not in p.split("/") for p in paths)):
        out.append("paths: 1 to 16 relative directories")
    seconds = data["run_seconds"]
    if not (isinstance(seconds, int) and not isinstance(seconds, bool) and 1 <= seconds <= 51):
        out.append("run_seconds: a whole number from 1 to 51")
    names = set()

    def entries(key, keys, low, high, extra=()):
        items = data[key]
        if not (isinstance(items, list) and low <= len(items) <= high):
            out.append(f"{key}: {low} to {high} entries")
            return []
        good = []
        for item in items:
            if not isinstance(item, dict) or not (keys <= set(item) <= keys | set(extra)):
                out.append(f"{key}: an entry must have the keys {sorted(keys)}, got {item!r}")
                continue
            if not _name(item["name"]):
                out.append(f"{key}: bad name {item['name']!r}")
            elif (key, item["name"]) in names:
                out.append(f"{key}: {item['name']} twice")
            names.add((key, item["name"]))
            good.append(item)
        return good

    configs = entries("configs", CONFIG_KEYS, 1, 24)
    cells = entries("workloads", CELL_KEYS, 1, 24)
    e2e = entries("end_to_end", E2E_KEYS, 1, 16, ("workloads",))
    layer = entries("per_layer", LAYER_KEYS, 1, 128, ("workloads",))
    config_names = {c["name"] for c in configs}
    cell_names = {c["name"] for c in cells}
    for c in configs:
        if not (_line(c["source"]) and _line(c["why"]) and isinstance(c["file"], str)
                and PATH.match(c["file"])):
            out.append(f"config {c['name']}: source, why and file must be single lines")
        reduced = c["reduced"]
        if not (isinstance(reduced, list) and len(reduced) <= 16 and all(map(_name, reduced))):
            out.append(f"config {c['name']}: reduced must list at most 16 names")
    pairs = set()
    for c in cells:
        if c["config"] not in config_names:
            out.append(f"cell {c['name']}: unknown config {c['config']!r}")
        if not _name(c["traffic"]):
            out.append(f"cell {c['name']}: bad traffic name {c['traffic']!r}")
        if c["chips"] not in (1, 4) or isinstance(c["chips"], bool):
            out.append(f"cell {c['name']}: chips must be 1 or 4")
        if not _line(c["why"]):
            out.append(f"cell {c['name']}: why must be one line of 1 to 200 characters")
        if (c["config"], c["traffic"]) in pairs:
            out.append(f"cell {c['name']}: its config and traffic appear twice")
        pairs.add((c["config"], c["traffic"]))
    for used in config_names - {c["config"] for c in cells}:
        out.append(f"config {used}: no cell uses it")
    metric_names = [m["name"] for m in e2e + layer]
    if len(set(metric_names)) != len(metric_names):
        out.append("a metric name appears twice")
    for m in e2e + layer:
        if not (isinstance(m["unit"], str) and UNIT.match(m["unit"])):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower or higher")
        if "workloads" in m and not (isinstance(m["workloads"], list) and m["workloads"]
                                     and set(m["workloads"]) <= cell_names):
            out.append(f"metric {m['name']}: workloads must list known cells")
    for m in e2e:
        if m["source"] not in E2E_SOURCES:
            out.append(f"metric {m['name']}: an end-to-end source is host_clock or device_trace")
        bound = m["bound"]
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            out.append(f"metric {m['name']}: bound must lie in [0.01, 0.25]")
    e2e_names = {m["name"] for m in e2e}
    if "setup_s" not in e2e_names:
        out.append("end_to_end must hold setup_s")
    for m in layer:
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: unknown source {m['source']!r}")
        if not _line(m["layer"]):
            out.append(f"metric {m['name']}: layer must be one line")
        if m["moves"] not in e2e_names:
            out.append(f"metric {m['name']}: moves an unknown metric {m['moves']!r}")
    if not out:
        for c in cells:
            names_e2e = [m["name"] for m in metrics_of(data, c["name"], trace=False)]
            if "setup_s" not in names_e2e or len(names_e2e) < 2:
                out.append(f"cell {c['name']}: needs setup_s and another end-to-end metric")
            layer_here = metrics_of(data, c["name"], trace=True)
            if not layer_here:
                out.append(f"cell {c['name']}: needs a per-layer metric")
            for m in layer_here:
                if m["moves"] not in names_e2e:
                    out.append(f"metric {m['name']}: cell {c['name']} does not report {m['moves']}")
    return out


def metrics_of(data: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; a metric with ``workloads`` only in the
    cells it lists."""
    return [m for m in data["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def config_path(entry: Dict[str, Any]) -> Path:
    return ROOT / entry["file"]


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def kind_path(name: str) -> Path:
    return BENCH_DIR / "kinds" / f"{name}.py"


def reference_path(name: str) -> Path:
    return BENCH_DIR / "reference" / f"{name}.py"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def missing_files(data: Dict[str, Any]) -> List[str]:
    """The files that the entries of ``data`` lead to and that are absent."""
    out = []
    for c in data["configs"]:
        path = config_path(c)
        if not path.is_file():
            out.append(str(path))
            continue
        reference = json.loads(path.read_text()).get("reference", "")
        if not _name(reference) or not reference_path(reference).is_file():
            out.append(f"{path}: reference {reference!r}")
    for c in data["workloads"]:
        path = traffic_path(c["traffic"])
        if not path.is_file():
            out.append(str(path))
            continue
        kind = json.loads(path.read_text()).get("kind", "")
        if not _name(kind) or not kind_path(kind).is_file():
            out.append(f"{path}: kind {kind!r}")
    for m in data["end_to_end"] + data["per_layer"]:
        if not metric_path(m["name"]).is_file():
            out.append(str(metric_path(m["name"])))
    return out


def load(path: Path = ROOT / "BENCHMARK.json") -> Dict[str, Any]:
    """BENCHMARK.json, checked; a ValueError lists every problem."""
    data = json.loads(Path(path).read_text())
    found = problems(data)
    if not found:
        found = missing_files(data)
    if found:
        raise ValueError("BENCHMARK.json: " + "; ".join(found))
    return data


def cell(data: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in data["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[c['name'] for c in data['workloads']]}")


def config_entry(data: Dict[str, Any], name: str) -> Dict[str, Any]:
    return next(c for c in data["configs"] if c["name"] == name)


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own (metric names hold
    dots, so the files are loaded by path, not imported by name)."""
    name = "perfbench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
