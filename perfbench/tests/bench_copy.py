"""A copy of the benchmark in a temporary directory, grown by new files and
entries alone, and runs of its cells on the CPU (the harness's test-only
``Host`` device in place of the card) at small sizes, each in a process of
its own so that the copy's ``perfbench`` is the one imported."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_X3D = {
    "name": "x3d_tiny", "source": "https://arxiv.org/abs/2004.04730", "reference": "x3d",
    "program": "x3d_s", "dtype": "bfloat16",
    "model": {"input_clip_length": 4, "input_crop_size": 64, "model_num_class": 10,
              "width_factor": 1.0, "depth_factor": 1.0, "head_dim_out": 64},
    "normalize": {"mean": [0.45] * 3, "std": [0.225] * 3},
    "limits": {"serve_closed": {"logit_gap": 0.05}}, "reduced": [],
}
TINY_MVIT = {
    "name": "mvit_tiny", "source": "https://arxiv.org/abs/2104.11227", "reference": "mvit",
    "program": "mvit_base_16x4", "dtype": "bfloat16",
    "model": {"spatial_size": 32, "temporal_size": 4, "depth": 3, "patch_embed_dim": 16,
              "num_heads": 1, "embed_dim_mul": [[1, 2.0]], "atten_head_mul": [[1, 2.0]],
              "pool_q_stride_size": [[1, 1, 2, 2]], "pool_kv_stride_adaptive": [1, 2, 2],
              "pool_kvq_kernel": [3, 3, 3], "head_num_classes": 10, "head_dropout_rate": 0.5},
    "normalize": {"mean": [0.45] * 3, "std": [0.225] * 3},
    "limits": {"serve_closed": {"logit_gap": 0.05},
               "train_steps": {"loss_gap": 0.05, "grad_gap": 0.1, "update_gap": 0.1,
                               "grad_gap_leaf": 0.2, "update_gap_leaf": 0.2}},
    "reduced": [],
}
SERVE_TINY = {"kind": "serve_closed", "batch": 2, "pool": 3, "warmup_requests": 1,
              "traced_requests": 2, "host_samples": 2, "unit_forwards": 1,
              "check_requests": 2, "check_block": 2}
CELLS = [("x3d_tiny.serve", "x3d_tiny", "serve_tiny", "x3d_s.serve_b128"),
         ("x3d_tiny.latency", "x3d_tiny", "serve_tiny_b1", "x3d_s.serve_b1"),
         ("mvit_tiny.serve", "mvit_tiny", "serve_tiny", "mvit_base_16x4.serve_b32"),
         ("mvit_tiny.train", "mvit_tiny", "train_tiny", "mvit_base_16x4.train_b8")]
TRAIN_TINY = {"kind": "train_steps", "batch": 4, "pool": 5, "recipe": "classification_mvit_16x4",
              "recipe_numbers": json.loads((REPO / "perfbench/traffic/train_b8.json").read_text())
              ["recipe_numbers"],
              "steps_per_epoch": 5, "checked_steps": 5, "gradient_steps": [1, 4], "warmup_steps": 1,
              "traced_steps": 1}


def make_copy(root: Path) -> Path:
    """BENCHMARK.json and perfbench/ copied under ``root``, with the tiny
    configurations, mixes and cells added as new files and entries."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (TINY_X3D, TINY_MVIT):
        path = f"perfbench/configs/{cfg['name']}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                                 "reduced": [], "why": "a small size for the CPU tests"})
    for name, traffic in (("serve_tiny", SERVE_TINY), ("serve_tiny_b1", dict(SERVE_TINY, batch=1)),
                          ("train_tiny", TRAIN_TINY)):
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    # Each small cell reports the metrics of the committed cell it mirrors.
    for name, config, traffic, mirrors in CELLS:
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a small size for the CPU tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if mirrors in metric.get("workloads", []):
                metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_cell(root: Path, workload: str, seconds: float = 1.0, trace: bool = False,
             seed: int = 2 ** 31 + 7, patch: str = "", timeout: int = 600) -> dict:
    """One run of ``workload`` from the copy at ``root`` on the CPU; ``patch``
    is Python run first in that process (to break the timed path)."""
    code = textwrap.dedent(f"""
        import json, sys, time
        T0 = time.perf_counter()
        sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
        import torch
        torch.set_num_threads(2)
        from perfbench.harness import spec, session
        from perfbench.harness.device import Host
    """) + textwrap.dedent(patch) + textwrap.dedent(f"""
        bench = spec.load(spec.ROOT / "BENCHMARK.json")
        result = session.execute(bench, {workload!r}, {seed}, {seconds}, {bool(trace)}, Host(), T0)
        print(json.dumps(result))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"run of {workload} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
