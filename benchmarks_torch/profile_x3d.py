"""Clips/s and device-time breakdown of the port's x3d_s on one CUDA card.

    python3 benchmarks_torch/profile_x3d.py [--out build/profile_x3d.json]

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
The model is ``hub.x3d_s(model_num_class=400)`` at full width and depth,
13x160x160, with the seeded random weights of ``chip_smoke.py``
(``randomize_``), in four bf16 forms, all eager:

- ``deploy``: ``convert_to_deployable_form`` (BN folded, the 22 stride-1
  ``conv_b`` on the fused kernel's tiled route, the 4 strided ones on
  ``F.conv3d``);
- ``deploy_scalar``: the same model with the fused kernel forced onto its
  scalar route (the first version);
- ``folded``: BN folded the same way, every ``conv_b`` left on cuDNN;
- ``eval``: the eval model cast to bf16, BN unfolded.

1. Clips/s at B1, B8 and B128: per batch the forms run in the order eval,
   folded, deploy, deploy_scalar, then the reverse; each run is one warm-up
   forward then ``ITERS`` forwards timed with CUDA events. Both runs of each
   form are printed; the summary keeps the faster.
2. Peak device memory of one deploy forward at B128.
3. ``torch.profiler`` over 3 forwards of deploy at B128 and B1 and of
   deploy_scalar at B128: device time per forward by kernel group and the
   top kernels. The card's busy share is that device time over the
   event-timed forward of step 1.

Prints one line per measurement, and writes them all, with the full kernel
tables, as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 8, 128)
ITERS = 10
PROFILED = (("deploy", 128), ("deploy_scalar", 128), ("deploy", 1))
PROFILED_FORWARDS = 3
# Kernel groups by name, first match wins. cuDNN runs a grouped (depthwise)
# conv in bf16 channels-last as per-group ``implicit_convolveNd_sgemm``
# launches, hence that group ahead of the GEMMs.
KERNEL_GROUPS = [
    ("fused depthwise kernel", r"depthwise3x3x3_(kernel|tiled)"),
    ("cuDNN grouped conv", r"convolveNd|conv_depthwise|depthwise"),
    ("GEMM / pointwise conv", r"gemm|xmma|cutlass"),
    ("layout conversion", r"nchwToNhwc|nhwcToNchw"),
    ("elementwise / reduction", r"elementwise|vectorized|reduce|Reduce"),
]
# Rows on the device timeline that are not device work: CUPTI bookkeeping,
# and the span of the optimizer's ``record_function`` (its kernels have rows
# of their own).
NOT_DEVICE_WORK = re.compile(r"Command Buffer Full|^Optimizer\.")


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


def kernel_table(prof, forwards: int) -> list:
    """(name, ms per forward, launches per forward) of every device kernel."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or NOT_DEVICE_WORK.search(evt.key):
            continue
        rows.append({"name": evt.key, "ms": _self_device_us(evt) / 1000.0 / forwards,
                     "launches": evt.count / forwards})
    return sorted(rows, key=lambda r: -r["ms"])


def group_table(rows: list, kernel_groups=KERNEL_GROUPS) -> dict:
    """Device time and launches per forward by kernel group (first match)."""
    groups = {name: {"ms": 0.0, "launches": 0.0} for name, _ in kernel_groups}
    groups["other"] = {"ms": 0.0, "launches": 0.0}
    for row in rows:
        group = next((n for n, pat in kernel_groups if re.search(pat, row["name"])), "other")
        groups[group]["ms"] += row["ms"]
        groups[group]["launches"] += row["launches"]
    return groups


def on_scalar_route(model):
    """``model`` run with its fused ``conv_b`` calls forced onto the kernel's
    scalar route (the first version)."""
    from pytorchvideo_tpu_torch.accelerate import deploy
    from pytorchvideo_tpu_torch.ops import depthwise_conv as dw

    scalar = functools.partial(dw.depthwise3x3x3_bn_swish_cuda, route="scalar")

    def forward(x):
        saved, deploy.depthwise3x3x3_bn_swish = deploy.depthwise3x3x3_bn_swish, scalar
        try:
            return model(x)
        finally:
            deploy.depthwise3x3x3_bn_swish = saved

    return forward


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_x3d.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_x3d: torch.cuda.is_available() is false; this run needs a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_time_ms, nvidia_smi_line, randomize_
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, fold_conv_bn
    from pytorchvideo_tpu_torch.models import hub

    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; {card}")
    gen = torch.Generator().manual_seed(0)
    model = hub.x3d_s(model_num_class=400)
    randomize_(model, gen, torch.randn(4, 3, 13, 160, 160, generator=gen).cuda())
    forms = {
        "eval": copy.deepcopy(model).to(torch.bfloat16).eval(),
        "folded": fold_conv_bn(copy.deepcopy(model).eval()).to(torch.bfloat16),
        "deploy": convert_to_deployable_form(model, dtype=torch.bfloat16),
    }
    forms["deploy_scalar"] = on_scalar_route(forms["deploy"])
    order = ("eval", "folded", "deploy", "deploy_scalar")
    report = {"card": card, "torch": torch.__version__, "iters": ITERS, "batches": {}}

    with torch.no_grad():
        for B in BATCHES:
            x = torch.randn(B, 3, 13, 160, 160, generator=gen).to("cuda", torch.bfloat16)
            runs = {name: [] for name in forms}
            for name in order + order[::-1]:
                runs[name].append(cuda_time_ms(lambda: forms[name](x), ITERS, warmup=1))
            entry = {}
            for name, times in runs.items():
                entry[name] = {"ms_runs": times, "clips_per_s": B * 1000.0 / min(times)}
                print(f"x3d_s {name} bf16 13x160x160 B{B}: "
                      f"{' / '.join(repr(t) for t in times)} ms/forward, "
                      f"{entry[name]['clips_per_s']!r} clips/s (faster run) on {card}")
            report["batches"][B] = entry

        x = torch.randn(max(BATCHES), 3, 13, 160, 160, generator=gen).to("cuda", torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forms["deploy"](x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        report["deploy_peak_bytes_b128"] = peak
        print(f"x3d_s deploy B{max(BATCHES)}: peak device memory {peak!r} bytes")

        report["profiles"] = {}
        for name, B in PROFILED:
            x = torch.randn(B, 3, 13, 160, 160, generator=gen).to("cuda", torch.bfloat16)
            forms[name](x)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(PROFILED_FORWARDS):
                    forms[name](x)
                torch.cuda.synchronize()
            rows = kernel_table(prof, PROFILED_FORWARDS)
            groups = group_table(rows)
            device_ms = sum(r["ms"] for r in rows)
            wall_ms = min(report["batches"][B][name]["ms_runs"])
            report["profiles"][f"{name} B{B}"] = {"device_ms": device_ms, "event_ms": wall_ms,
                                                  "groups": groups, "kernels": rows}
            print(f"profile {name} B{B} ({PROFILED_FORWARDS} forwards): device "
                  f"{device_ms!r} ms/forward of {wall_ms!r} ms event-timed "
                  f"(busy share {device_ms / wall_ms!r})")
            for name, g in groups.items():
                print(f"  group {name}: {g['ms']!r} ms/forward, {g['launches']!r} launches/forward, "
                      f"{g['ms'] / device_ms!r} of device time")
            for r in rows[:12]:
                print(f"  kernel {r['ms']!r} ms x{r['launches']!r}: {r['name'][:120]}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
