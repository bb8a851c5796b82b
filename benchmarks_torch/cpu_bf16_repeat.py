"""Whether a bf16 train step's gradients repeat on the CPU, with PyTorch's
oneDNN convolutions on and off.

    python3 benchmarks_torch/cpu_bf16_repeat.py [--steps 30] [--processes 6]

Run from the root of a checkout; needs no card. Each of ``--processes``
processes (started together, so they share the host's cores as a
parallel test run does) builds the small X3D of
``tests/test_torch_train_bn.py`` (4x32x32, 5 classes, seeded weights) on one
intra-op thread, takes one bf16 ``train.forward_backward`` of a seeded B2
batch, then ``--steps`` more from the same weights and batch, and counts the
steps whose gradients are not bit-equal to the first one's. That is done
once with ``torch.backends.mkldnn`` on and once with it off. Prints, per
setting, the steps that differ out of all, the tensor that differs most
and by how much, and the largest relative L2 distance from the f32
gradients.
"""

from __future__ import annotations

import argparse
import copy
import multiprocessing
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _relative_l2(got: dict, ref: dict) -> float:
    err = sum(float(((got[n].double() - r.double()) ** 2).sum()) for n, r in ref.items())
    return (err / sum(float((r.double() ** 2).sum()) for r in ref.values())) ** 0.5


def repeat(args) -> dict:
    """One process's run: (steps that differ, worst tensor, its max |diff|,
    the largest relative L2 from f32)."""
    steps, mkldnn = args
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from pytorchvideo_tpu_torch.models.x3d import create_x3d
    from pytorchvideo_tpu_torch.train.train_loop import forward_backward

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = mkldnn
    torch.manual_seed(0)
    base = create_x3d(input_clip_length=4, input_crop_size=32, model_num_class=5,
                      width_factor=1.0, depth_factor=0.5, head_dim_out=32, dropout_rate=0.0,
                      device="cpu").train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 4, 32, 32))
                         .astype(np.float32))
    y = torch.tensor([1, 3])

    def grads(dtype):
        model = copy.deepcopy(base)
        forward_backward(model, x, y, compute_dtype=dtype)
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    f32 = grads(None)
    first = grads(torch.bfloat16)
    differ, worst, worst_diff, rel = 0, None, 0.0, _relative_l2(first, f32)
    for _ in range(steps):
        g = grads(torch.bfloat16)
        rel = max(rel, _relative_l2(g, f32))
        diffs = {n: float((g[n] - first[n]).abs().max()) for n in g}
        name = max(diffs, key=diffs.get)
        if not all(torch.equal(g[n], first[n]) for n in g):
            differ += 1
            if worst is None or diffs[name] > worst_diff:
                worst, worst_diff = name, diffs[name]
    return {"differ": differ, "worst": worst, "worst_diff": worst_diff, "rel_l2": rel}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--processes", type=int, default=6)
    args = parser.parse_args()
    ctx = multiprocessing.get_context("spawn")
    for mkldnn in (True, False):
        with ctx.Pool(args.processes) as pool:
            runs = pool.map(repeat, [(args.steps, mkldnn)] * args.processes)
        differ = sum(r["differ"] for r in runs)
        worst = max(runs, key=lambda r: r["worst_diff"])
        print(f"mkldnn {'on' if mkldnn else 'off'}: {differ} of "
              f"{args.steps * args.processes} bf16 steps differ from their first; worst "
              f"{worst['worst']} by {worst['worst_diff']!r}; relative L2 from f32 up to "
              f"{max(r['rel_l2'] for r in runs)!r}")


if __name__ == "__main__":
    main()
