"""How far a bf16 train step's gradients lie from f32's and f64's, for the
port's BatchNorm models.

    python3 benchmarks_torch/bf16_grad_error.py [--out build/bf16_grad_error.json]

Run from the root of a checkout, on a machine with a CUDA card. One step's
gradients (``train.forward_backward``, dropout 0, TF32 off) of each model in
f64 (a float64 copy), f32 and bf16 compute, on seeded clips made on the
card:

- ``x3d_s`` (13x160x160) at B8 and B16, with ``chip_smoke.randomize_``
  weights (as ``chip_smoke.py``'s bf16 step check) and with
  ``init_net_weights`` (which zeroes each bottleneck's ``norm_c``);
- ``slowfast_r50`` ([8, 32] x 224 x 224) and ``slow_r50`` (8x224x224) at B4
  with ``randomize_`` weights.

For each pair (f32 against f64, bf16 against f64, bf16 against f32): the
relative L2 error and the cosine of all gradients together, each stage's
relative L2 error, and the worst tensor's share of phase 9's per-tensor bf16
bound (``chip_smoke.grad_error``). Prints one line per pair and writes
them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def step_grads(train, model, video, labels) -> dict:
    """{"f64" | "f32" | "bf16": ({name: f64 gradient}, loss)} of one step."""
    import torch

    from chip_smoke import cast, no_dropout

    out = {}
    with no_dropout(model):
        for name in ("f64", "f32", "bf16"):
            m = copy.deepcopy(model).double() if name == "f64" else model
            m.zero_grad(set_to_none=True)
            x = cast(video, torch.float64) if name == "f64" else video
            loss, _ = train.forward_backward(
                m.train(), x, labels, compute_dtype=torch.bfloat16 if name == "bf16" else None)
            out[name] = ({n: p.grad.double() for n, p in m.named_parameters()}, loss.item())
            del m
    model.zero_grad(set_to_none=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "bf16_grad_error.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("bf16_grad_error: torch.cuda.is_available() is false; this run needs a CUDA card")
    from chip_smoke import (
        SLOWFAST_CLIPS,
        X3D_S_CLIP,
        clips,
        grad_error,
        nvidia_smi_line,
        randomize_,
    )
    from pytorchvideo_tpu_torch import train
    from pytorchvideo_tpu_torch.models import hub, init_net_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; {card}")
    gen = torch.Generator().manual_seed(40)
    runs = [("x3d_s", init, B, X3D_S_CLIP) for init in ("randomize_", "init_net_weights")
            for B in (8, 16)]
    runs += [("slowfast_r50", "randomize_", 4, SLOWFAST_CLIPS), ("slow_r50", "randomize_", 4,
                                                                  (8, 224, 224))]
    report = {"card": card, "runs": []}
    for name, init, B, clip in runs:
        model = getattr(hub, name)()
        if init == "randomize_":
            randomize_(model, gen, clips(2, clip, gen))
        else:
            init_net_weights(model, generator=torch.Generator(device="cuda").manual_seed(1))
        video = clips(B, clip, gen)
        labels = torch.randint(0, 400, (B,), generator=gen).cuda()
        grads = step_grads(train, model, video, labels)
        entry = {"model": name, "init": init, "batch": B,
                 "losses": {k: v[1] for k, v in grads.items()}}
        for got, ref in (("f32", "f64"), ("bf16", "f64"), ("bf16", "f32")):
            entry[f"{got}_vs_{ref}"] = c = grad_error(grads[got][0], grads[ref][0])
            print(f"{name} {init} B{B} {got} vs {ref}: relative L2 {c['relative_l2']!r}, cosine "
                  f"{c['cosine']!r}, worst stage {max(c['stage_relative_l2'].values())!r}, "
                  f"phase 9 share {c['phase9_worst_share']!r} ({c['phase9_worst_tensor']}); "
                  f"on {card}")
        report["runs"].append(entry)
        del model, grads
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
