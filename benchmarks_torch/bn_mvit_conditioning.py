"""How well-conditioned the randomly initialised BatchNorm MViT-B 16x4 is,
with and without its residual branches' last layers scaled down.

    python3 benchmarks_torch/bn_mvit_conditioning.py [--clip 4 64 64] [--scales 1.0 0.3 0.1]

Run from the root of a checkout, on the CPU (the plain versions of the
kernels; no card needed). Builds ``hub.mvit_base_16x4(norm="batchnorm")`` at
full width and depth on a small clip, with ``chip_smoke.randomize_mvit_``'s
weights, BN affine as phase 23 (g) draws it and running stats from one
train-mode forward of two seeded clips, with each ``attn.proj`` and
``mlp.fc2`` weight times each of ``--scales`` (1: as drawn). For each it
prints the largest |logit| of four seeded clips and how far the logits move
when the input moves by 1e-6 (normal), when the model runs in float64, under
``fuse_bn_mvit``, and in the bf16 deploy form of the folded model: a model
whose logits move by O(max |logit|) there cannot be held to a rounding
bound.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 234


def build(clip, scale: float):
    import torch
    from torch.nn.modules.batchnorm import _BatchNorm

    import chip_smoke
    from pytorchvideo_tpu_torch.models import hub

    gen = torch.Generator().manual_seed(SEED)
    model = hub.mvit_base_16x4(norm="batchnorm", device="cpu", temporal_size=clip[0],
                               spatial_size=clip[1])
    chip_smoke.randomize_mvit_(model, gen)
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    with torch.no_grad():
        for name, module in model.named_modules():
            if name.endswith(("attn.proj", "mlp.fc2")):
                module.weight.mul_(scale)
        for bn in norms:
            c = bn.num_features
            bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
            bn.bias.copy_(torch.randn(c, generator=gen) * 0.1)
            bn.reset_running_stats()
            bn.momentum = None
        model.train()
        model(torch.randn(2, 3, *clip, generator=gen))
        model.eval()
    return model, gen


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, fuse_bn_mvit

    parser = argparse.ArgumentParser()
    parser.add_argument("--clip", type=int, nargs=3, default=(4, 64, 64))
    parser.add_argument("--scales", type=float, nargs="+", default=(1.0, 0.3, 0.1))
    args = parser.parse_args()
    rows = {}
    for scale in args.scales:
        model, gen = build(tuple(args.clip), scale)
        x = torch.randn(4, 3, *args.clip, generator=gen)
        with torch.no_grad():
            ref = model(x)
            moved = model(x + 1e-6 * torch.randn(x.shape, generator=gen))
            f64 = model.double()(x.double()).float()
            model.float()
            fused = fuse_bn_mvit(model)(x)
            bf16 = convert_to_deployable_form(fuse_bn_mvit(model))(x.bfloat16()).float()
        rows[scale] = {"max_abs_logit": ref.abs().max().item(),
                       "input_1e-6": (moved - ref).abs().max().item(),
                       "float64": (f64 - ref).abs().max().item(),
                       "fuse_bn_mvit": (fused - ref).abs().max().item(),
                       "bf16_deploy": (bf16 - ref).abs().max().item()}
        print(f"branch scale {scale}: " + json.dumps(rows[scale]), flush=True)


if __name__ == "__main__":
    main()
