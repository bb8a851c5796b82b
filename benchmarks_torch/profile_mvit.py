"""Clips/s and device-time breakdown of the port's MViT-B 16x4 on one CUDA card.

    python3 benchmarks_torch/profile_mvit.py [--out build/profile_mvit.json]

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
The model is ``hub.mvit_base_16x4()`` at full width and depth, 16x224x224,
with the seeded random weights of ``chip_smoke.py`` (``randomize_mvit_``),
in its bf16 deploy form, eager, in three forms: "kernels" (the default
path), "fused" (the same weights in ``mvit_base_16x4(fused_kvpool=True)``,
whose kv pools, their norms and the attention go through the fused op) and
"plain" (the default path with every kernel swapped for its plain version,
``chip_smoke.plain_kernels``):

1. Clips/s at B1, B8 and B32 of each form, run in the order plain, kernels,
   fused, fused, kernels, plain; each run is one warm-up forward then
   ``ITERS`` forwards timed with CUDA events. Both runs are printed; the
   summary keeps the faster.
2. Peak device memory of one deploy forward at B32, kernels and fused.
3. ``torch.profiler`` over 3 deploy forwards at B32 and at B1 of the kernels
   and the fused form: device time per forward by kernel group and the top
   kernels. The card's busy share is that device time over the event-timed
   forward of step 1.

Prints one line per measurement, and writes them all, with the full kernel
tables, as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from profile_x3d import group_table, kernel_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 8, 32)
ITERS = 10
PROFILED_BATCHES = (32, 1)
PROFILED_FORWARDS = 3
# Kernel groups by name, first match wins.
KERNEL_GROUPS = [
    ("fused pool-LN kernel", r"kvpool_ln_(kernel|tiled)"),
    ("attention forward, tensor cores", r"pooled_attention_tc_kernel"),
    ("attention forward, split keys (partials, combine)", r"pooled_attention_(split|combine)_kernel"),
    ("attention forward, CUDA cores", r"pooled_attention_kernel"),
    ("token-pool kernel", r"token_pool_kernel"),
    ("patch-embed conv (cuDNN)", r"fprop|nhwcAddPadding|convolve|cudnn"),
    ("GEMM (q/k/v, proj, MLP, head)", r"nvjet|gemm|xmma|cutlass"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("copy / cat / layout", r"copy|Cat|cat_|transpose|permute"),
    ("elementwise (GELU, add, bias)", r"elementwise|vectorized|gelu|Gelu"),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_mvit.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_mvit: torch.cuda.is_available() is false; this run needs a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import MVIT_CLIP, cuda_time_ms, nvidia_smi_line, plain_kernels, randomize_mvit_
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import hub

    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; {card}")
    gen = torch.Generator().manual_seed(0)
    model = hub.mvit_base_16x4()
    randomize_mvit_(model, gen)
    fused = hub.mvit_base_16x4(fused_kvpool=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    deploy_fused = convert_to_deployable_form(fused, dtype=torch.bfloat16)
    del model, fused
    report = {"card": card, "torch": torch.__version__, "iters": ITERS, "batches": {}}

    def forward_plain(x):
        with plain_kernels():
            return deploy(x)

    forms = {"kernels": deploy, "fused": deploy_fused, "plain": forward_plain}
    with torch.no_grad():
        for B in BATCHES:
            x = torch.randn(B, 3, *MVIT_CLIP, generator=gen).to("cuda", torch.bfloat16)
            runs = {name: [] for name in forms}
            for name in ("plain", "kernels", "fused", "fused", "kernels", "plain"):
                runs[name].append(cuda_time_ms(lambda: forms[name](x), ITERS, warmup=1))
            entry = {}
            for name, times in runs.items():
                entry[name] = {"ms_runs": times, "clips_per_s": B * 1000.0 / min(times)}
                print(f"mvit_base_16x4 deploy ({name}) bf16 16x224x224 B{B}: "
                      f"{' / '.join(repr(t) for t in times)} ms/forward, "
                      f"{entry[name]['clips_per_s']!r} clips/s (faster run) on {card}")
            report["batches"][B] = entry

        x = torch.randn(max(BATCHES), 3, *MVIT_CLIP, generator=gen).to("cuda", torch.bfloat16)
        for name in ("kernels", "fused"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            forms[name](x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            report[f"deploy_peak_bytes_b32_{name}"] = peak
            print(f"mvit_base_16x4 deploy ({name}) B{max(BATCHES)}: peak device memory "
                  f"{peak!r} bytes")

        report["profiles"] = {}
        for B, name in ((B, name) for B in PROFILED_BATCHES for name in ("kernels", "fused")):
            x = torch.randn(B, 3, *MVIT_CLIP, generator=gen).to("cuda", torch.bfloat16)
            forms[name](x)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(PROFILED_FORWARDS):
                    forms[name](x)
                torch.cuda.synchronize()
            rows = kernel_table(prof, PROFILED_FORWARDS)
            groups = group_table(rows, KERNEL_GROUPS)
            device_ms = sum(r["ms"] for r in rows)
            wall_ms = min(report["batches"][B][name]["ms_runs"])
            report["profiles"][f"{name} B{B}"] = {"device_ms": device_ms, "event_ms": wall_ms,
                                                  "groups": groups, "kernels": rows}
            print(f"profile deploy ({name}) B{B} ({PROFILED_FORWARDS} forwards): device "
                  f"{device_ms!r} ms/forward of {wall_ms!r} ms event-timed "
                  f"(busy share {device_ms / wall_ms!r})")
            for name, g in groups.items():
                print(f"  group {name}: {g['ms']!r} ms/forward, {g['launches']!r} launches/forward, "
                      f"{g['ms'] / device_ms!r} of device time")
            for r in rows[:15]:
                print(f"  kernel {r['ms']!r} ms x{r['launches']!r}: {r['name'][:120]}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
