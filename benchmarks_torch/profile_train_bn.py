"""Step time and device-time breakdown of the port's BatchNorm-family training.

    python3 benchmarks_torch/profile_train_bn.py [--out build/profile_train_bn.json]

Run from the root of a checkout, on a machine with a CUDA card. Two train
steps, each through ``VideoClassificationTrainApp.train()`` (the captured
step, train/compiled_step.py) set up as ``chip_smoke.py``'s phase 18 sets it
up, bf16 compute, f32 masters, weights from ``init_net_weights`` on a seeded
generator:

- ``x3d_s`` at B128 (13x160x160) on bench.py:317's recipe: SGD momentum 0.9
  at LR 0.1, MixUp alpha 1.0 with label smoothing 0.1, soft-target CE;
- ``slowfast_r50`` at B32 ([8, 32] x 224 x 224 pathway lists) on the
  ``classification_slowfast_8x8_r50`` preset (nesterov SGD).

For each: ``WARMUP_STEPS`` + 1 steps (the captured step's eager warm-up
updates and its capture), then ``STEPS`` replays timed on the host clock
with the card synchronised at both ends (ms per step, clips/s; the peak
memory of these runs, the capture's included), then ``torch.profiler`` over ``PROFILED`` more replays on one batch:
device ms per step by kernel group and the top kernels (sums of kernel
times, which pass the step's time where cuDNN runs a grouped conv's
per-group kernels side by side), and the union of the device's intervals
per step; the busy share is that union over the timed step. Prints one
line per measurement and writes them all, with the full kernel tables, as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks_torch"))
sys.path.insert(0, REPO)

from profile_x3d import group_table, kernel_table  # noqa: E402

STEPS = 5
PROFILED = 3
# Kernel groups by name, first match wins: cuDNN's depthwise and grouped
# convs (forward, dgrad and wgrad) ahead of the other convs and GEMMs; the
# native BatchNorm kernels, whose statistics on a channels-last input are a
# Welford reduction; the optimizer's foreach kernels.
KERNEL_GROUPS = [
    ("cuDNN depthwise / grouped conv", r"convolveNd|conv_depthwise|depthwise|grouped"),
    ("BN train forward and backward", r"batch_norm|BatchNorm|Welford"),
    ("layout conversion", r"nchwToNhwc|nhwcToNchw"),
    ("GEMM / conv", r"gemm|xmma|cutlass|nvjet|conv|Conv|dgrad|wgrad|fprop"),
    ("SGD", r"multi_tensor|foreach|[Ss]gd"),
    ("elementwise / reduction", r"elementwise|vectorized|reduce|Reduce"),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_train_bn.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_train_bn: torch.cuda.is_available() is false; this run needs a CUDA card")
    from chip_smoke import (
        BN_SLOWFAST_BATCH,
        SLOWFAST_CLIPS,
        X3D_S_CLIP,
        SyntheticClips,
        bn_app,
        device_union_ms,
        nvidia_smi_line,
        run_steps,
        x3d_s_bench_overrides,
    )
    from pytorchvideo_tpu_torch import train
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; {card}")
    report = {"card": card, "torch": torch.__version__, "steps": STEPS, "models": {}}
    runs = (
        ("x3d_s", 128, lambda: bn_app(train, "classification_x3d_xs",
                                      SyntheticClips(128, seed=60, clip=X3D_S_CLIP), seed=60,
                                      **x3d_s_bench_overrides())),
        ("slowfast_r50", BN_SLOWFAST_BATCH, lambda: bn_app(
            train, "classification_slowfast_8x8_r50",
            SyntheticClips(BN_SLOWFAST_BATCH, seed=61, clip=SLOWFAST_CLIPS[1], alpha=4),
            seed=61, **{"trainer.compute_dtype": "bfloat16"})),
    )
    for name, B, make in runs:
        app = make()
        torch.cuda.reset_peak_memory_stats()
        run_steps(app, WARMUP_STEPS + 1)
        history, ms = run_steps(app, STEPS)
        peak = torch.cuda.max_memory_allocated()
        batch = app._device_batch(next(app.datamodule.train_dataloader(1)))
        app._step(batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                app._step(batch)
            torch.cuda.synchronize()
        rows = kernel_table(prof, PROFILED)
        groups = group_table(rows, KERNEL_GROUPS)
        device_ms = sum(r["ms"] for r in rows)
        busy_ms = device_union_ms(prof)[0] / PROFILED
        report["models"][name] = {
            "batch": B, "ms_per_step": ms, "clips_per_s": B * 1000.0 / ms, "peak_bytes": peak,
            "losses": history, "kernel_ms_sum": device_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / ms, "groups": groups, "kernels": rows}
        print(f"{name} train bf16 B{B}: {ms!r} ms/step, {B * 1000.0 / ms!r} clips/s over {STEPS} "
              f"steps; peak device memory {peak!r} bytes; on {card}")
        print(f"profile {name} B{B} ({PROFILED} steps): kernel times sum to {device_ms!r} ms/step; "
              f"the device is busy {busy_ms!r} ms of the {ms!r} ms step (busy share "
              f"{busy_ms / ms!r})")
        for group, g in groups.items():
            print(f"  group {group}: {g['ms']!r} ms/step, {g['launches']!r} launches/step, "
                  f"{g['ms'] / device_ms!r} of device time")
        for r in rows[:15]:
            print(f"  kernel {r['ms']!r} ms x{r['launches']!r}: {r['name'][:120]}")
        del app, batch, prof
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
