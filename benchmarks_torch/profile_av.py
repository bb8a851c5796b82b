"""Device-time breakdown of audio-visual SlowFast-R50 and the acoustic ResNet-50.

    python3 benchmarks_torch/profile_av.py [--out build/profile_av.json]

Run from the root of a checkout, on a machine with a CUDA card (no kernel
of the port lies on this path, so nothing is built). The models are
``create_audio_visual_slowfast()`` (slow 8x224x224, fast 32x224x224, a 128 x
80 spectrogram) and ``create_acoustic_resnet()`` (128 x 80) at full width
and depth, with the seeded random weights of ``chip_smoke.py``
(``randomize_``), in their bf16 deploy forms (BN folded, the acoustic stem's
BN kept), eager, at B32:

1. ms a forward by CUDA events (one warm-up forward, then ``ITERS``);
2. ``torch.profiler`` over ``PROFILED_FORWARDS`` forwards: device time a
   forward by kernel group (``profile_resnet.KERNEL_GROUPS``) and the top
   kernels; the busy share is that device time over the event-timed
   forward; and the convolutions by input shape (``aten::cudnn_convolution``
   rows grouped by their input shapes, the device time under each), which
   says which pathway's convs each kernel serves.

Prints one line per measurement and writes them, with the full kernel
tables, as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks_torch"))
sys.path.insert(0, REPO)

from profile_resnet import KERNEL_GROUPS  # noqa: E402
from profile_x3d import PROFILED_FORWARDS, group_table, kernel_table  # noqa: E402

ITERS = 5
BATCH = 32


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_av.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_av: torch.cuda.is_available() is false; this run needs a CUDA card")
    from chip_smoke import ACOUSTIC_CLIP, AV_CLIPS, clips, cuda_time_ms, nvidia_smi_line, randomize_
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import create_acoustic_resnet, create_audio_visual_slowfast

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; {card}")
    report = {"card": card, "torch": torch.__version__, "batch": BATCH, "models": {}}
    gen = torch.Generator().manual_seed(0)
    for name, build, clip in (("av_slowfast_r50", create_audio_visual_slowfast, AV_CLIPS),
                              ("acoustic_resnet50", create_acoustic_resnet, ACOUSTIC_CLIP)):
        model = build()
        randomize_(model, gen, clips(2, clip, gen))
        deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
        del model
        torch.cuda.empty_cache()
        x = clips(BATCH, clip, gen, torch.bfloat16)
        with torch.no_grad():
            event_ms = cuda_time_ms(lambda: deploy(x), ITERS, warmup=1)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA],
                                        record_shapes=True) as prof:
                for _ in range(PROFILED_FORWARDS):
                    deploy(x)
                torch.cuda.synchronize()
        rows = kernel_table(prof, PROFILED_FORWARDS)
        groups = group_table(rows, KERNEL_GROUPS)
        device_ms = sum(r["ms"] for r in rows)
        convs = sorted(({"shapes": str(evt.input_shapes),
                         "ms": evt.device_time_total / 1000.0 / PROFILED_FORWARDS,
                         "calls": evt.count / PROFILED_FORWARDS}
                        for evt in prof.key_averages(group_by_input_shape=True)
                        if evt.key == "aten::cudnn_convolution"), key=lambda r: -r["ms"])
        report["models"][name] = {"event_ms": event_ms, "device_ms": device_ms,
                                  "clips_per_s": BATCH * 1000.0 / event_ms, "groups": groups,
                                  "kernels": rows, "convs_by_shape": convs}
        print(f"profile {name} deploy bf16 B{BATCH} ({PROFILED_FORWARDS} forwards): device "
              f"{device_ms!r} ms/forward of {event_ms!r} ms event-timed (busy share "
              f"{device_ms / event_ms!r}), {BATCH * 1000.0 / event_ms!r} clips/s, on {card}")
        for group, g in groups.items():
            print(f"  group {group}: {g['ms']!r} ms/forward, {g['launches']!r} launches/forward, "
                  f"{g['ms'] / device_ms!r} of device time")
        for r in rows[:12]:
            print(f"  kernel {r['ms']!r} ms x{r['launches']!r}: {r['name'][:120]}")
        for r in convs[:12]:
            print(f"  conv {r['ms']!r} ms x{r['calls']!r}: input shapes {r['shapes'][:160]}")
        del deploy, x
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
