"""Step time and device-time breakdown of the port's MViT-B 16x4 training on one CUDA card.

    python3 benchmarks_torch/profile_mvit_train.py [--out build/profile_mvit_train.json]

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
It trains ``hub.mvit_base_16x4()`` at full width and depth, 16x224x224, with
the seeded random weights of ``chip_smoke.py``, through
``VideoClassificationTrainApp.train()`` (the captured step, train/compiled_step.py)
on the ``classification_mvit_16x4`` recipe (AdamW, clip 1.0, MixUp/CutMix)
with ``compute_dtype="bfloat16"``, on ``chip_smoke.SyntheticClips`` (seeded
clips made on the card). The forms below are Python-side switches, which a
graph freezes at its capture, so each run drops the app's graphs and
captures its form anew:

1. ms per step and clips/s at B8 and at the preset's B2, in three forms:
   "kernels" (the default path), "fused" (every block's ``fused_kvpool`` on:
   the fused kv-pool op, whose backward recomputes the unfused composition)
   and "plain" (every kernel swapped for its plain version,
   ``chip_smoke.plain_kernels``), one model and optimizer throughout, run in
   the order plain, kernels, fused, fused, kernels, plain; each run is
   ``WARMUP_STEPS`` + 1 steps (the captured step's eager warm-up updates and
   its capture), then ``STEPS`` replays timed by the host's clock with the
   card synchronised at both ends. ``STEPS`` is the preset's log interval, so
   a timed run reads the loss back to the host once, as a user's run does.
   Both runs are printed; the summary keeps the faster. The peak device
   memory of each form's timed steps.
2. ``torch.profiler`` over ``PROFILED_STEPS`` steps with the kernels and
   with the fused form at each batch: device time per step by kernel group
   and the top kernels. The card's busy share is that device time over the
   timed step of 1.

Prints one line per measurement, and writes them all, with the full kernel
tables, as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from profile_x3d import group_table, kernel_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (8, 2)
STEPS = 10
PROFILED_STEPS = 3
# Kernel groups by name, first match wins.
KERNEL_GROUPS = [
    ("fused pool-LN kernel", r"kvpool_ln_(kernel|tiled)"),
    ("attention forward, tensor cores", r"pooled_attention_tc_kernel"),
    ("attention forward, split keys (partials, combine)", r"pooled_attention_(split|combine)_kernel"),
    ("attention forward, CUDA cores", r"pooled_attention_kernel"),
    ("attention backward, tensor cores (dq, dk/dv, reduce)",
     r"attention_bwd_(dq_tc|dkdv_tc|reduce)"),
    ("attention backward, split keys (dk/dv and dq partials, combine)", r"attention_bwd_split"),
    ("attention backward, CUDA cores", r"attention_bwd_"),
    ("token-pool forward kernel", r"token_pool_kernel"),
    ("token-pool backward kernels (dx, dw)", r"token_pool_d[xw]_"),
    ("max-pool backward (PyTorch)", r"max_pool|MaxPool"),
    ("patch-embed conv (cuDNN)", r"fprop|dgrad|wgrad|nhwcAddPadding|convolve|cudnn"),
    ("GEMM (q/k/v, proj, MLP, head; cuBLAS)", r"nvjet|gemm|xmma|cutlass"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("optimizer and clip (foreach)", r"multi_tensor|foreach|Adam"),
    ("reductions and softmax", r"reduce_kernel|softmax|Softmax"),
    ("copy / cast / cat / layout", r"copy|Cat|cat_|transpose|permute"),
    ("elementwise (GELU, adds, MixUp)", r"elementwise|vectorized|gelu|Gelu"),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_mvit_train.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_mvit_train: torch.cuda.is_available() is false; this run needs a CUDA "
                 "card")
    sys.path.insert(0, REPO)
    from chip_smoke import SyntheticClips, nvidia_smi_line, plain_kernels, run_steps, train_app
    from pytorchvideo_tpu_torch import train
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; {card}")
    app = train_app(train, BATCHES[0], seed=0)
    report = {"card": card, "torch": torch.__version__, "steps": STEPS, "batches": {}}

    @contextlib.contextmanager
    def form_of(name):
        """The app in form ``name``, its graphs dropped and its step captured
        anew in that form (not timed)."""
        for block in app.model.blocks:
            block.attn.fused_kvpool = name == "fused"
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            app._drop_graphs()
            torch.cuda.empty_cache()
            run_steps(app, WARMUP_STEPS + 1)
            yield
        for block in app.model.blocks:
            block.attn.fused_kvpool = False

    for B in BATCHES:
        app.datamodule = SyntheticClips(B, seed=B)
        runs, peaks = {"plain": [], "kernels": [], "fused": []}, {}
        for form in ("plain", "kernels", "fused", "fused", "kernels", "plain"):
            with form_of(form):
                torch.cuda.reset_peak_memory_stats()
                _, ms = run_steps(app, STEPS)
            runs[form].append(ms)
            peaks[form] = max(peaks.get(form, 0), torch.cuda.max_memory_allocated())
        entry = report["batches"][B] = {}
        for form, times in runs.items():
            entry[form] = {"ms_runs": times, "clips_per_s": B * 1000.0 / min(times),
                           "peak_bytes": peaks[form]}
            print(f"mvit_base_16x4 train ({form}) bf16 16x224x224 B{B}: "
                  f"{' / '.join(repr(t) for t in times)} ms/step, "
                  f"{entry[form]['clips_per_s']!r} clips/s (faster run); peak device memory "
                  f"{peaks[form]!r} bytes; on {card}")

        for form in ("kernels", "fused"):
            with form_of(form):
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    run_steps(app, PROFILED_STEPS)
            rows = kernel_table(prof, PROFILED_STEPS)
            groups = group_table(rows, KERNEL_GROUPS)
            device_ms = sum(r["ms"] for r in rows)
            step_ms = min(runs[form])
            entry[f"profile_{form}"] = {"device_ms": device_ms, "step_ms": step_ms,
                                        "groups": groups, "kernels": rows}
            print(f"profile train ({form}) B{B} ({PROFILED_STEPS} steps): device {device_ms!r} "
                  f"ms/step of {step_ms!r} ms timed (busy share {device_ms / step_ms!r})")
            for name, g in groups.items():
                print(f"  group {name}: {g['ms']!r} ms/step, {g['launches']!r} launches/step, "
                      f"{g['ms'] / device_ms!r} of device time")
            pool_bwd = groups["token-pool backward kernels (dx, dw)"]
            print(f"  token-pool backward: {pool_bwd['launches']!r} kernel launches per step "
                  f"(35 dx + 35 dw calls)")
            for r in rows[:20]:
                print(f"  kernel {r['ms']!r} ms x{r['launches']!r}: {r['name'][:120]}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
