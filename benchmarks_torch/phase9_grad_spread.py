"""How far phase 9's gradient check reads from its bound over fresh apps.

    python3 benchmarks_torch/phase9_grad_spread.py [--apps 3]

Run from the root of a checkout, on a machine with a CUDA card (TF32 off).
For each of ``--apps`` fresh ``VideoClassificationTrainApp``s it runs what
``chip_smoke.py`` phase 9 runs before its check (the first step, the timed
captured steps at B8, seed 21), then one f32 step of ``preset_batch(23)``
three ways on the same weights: through the kernels, through the plain
versions, and through the plain versions in float64. Per tensor it prints
the kernels-against-plain distance as a share of phase 9's bound (1e-3 x
the tensor's max |g| + 1e-5 x its module's), and each f32 form's distance
from float64 as a share of the same bound: the five worst tensors and the
worst of each; and, per skip max pool, the windows whose largest element
the two f32 forms' grids place at different positions. The training before
the check is not deterministic, so each app's weights differ.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_grads(train, model, context, batch, dtype):
    """(gradients, the grid each skip max pool took) of one step."""
    import torch

    pools = {name: m for name, m in model.named_modules() if name.endswith("pool_skip")}
    grids = {}
    hooks = [m.register_forward_hook(
        lambda m, args, out, name=name: grids.__setitem__(name, (args[0][1].detach(), args[1])))
        for name, m in pools.items()]
    model.zero_grad(set_to_none=True)
    torch.cuda.manual_seed(11)  # phase 9's dropout masks
    with context():
        train.forward_backward(model.train(), batch["video"], batch["label"], compute_dtype=dtype)
    for hook in hooks:
        hook.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, {name: (grids[name], pools[name]) for name in pools}


def argmax_flips(a: dict, b: dict) -> dict:
    """Per skip pool, the windows whose largest element differs between two
    forms' grids (each pooled by ``F.max_pool3d`` with its indices)."""
    import torch.nn.functional as F

    flips = {}
    for name, ((grid_a, thw), pool) in a.items():
        grid_b = b[name][0][0]
        indices = []
        for grid in (grid_a, grid_b):
            B, _, C = grid.shape
            x = grid.float().reshape(B, *thw, C).permute(0, 4, 1, 2, 3)
            indices.append(F.max_pool3d(x, pool.kernel, pool.stride,
                                        tuple(k // 2 for k in pool.kernel),
                                        return_indices=True)[1])
        flips[name] = int((indices[0] != indices[1]).sum())
    return flips


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from pytorchvideo_tpu_torch import train
    from pytorchvideo_tpu_torch.ops import _build

    parser = argparse.ArgumentParser()
    parser.add_argument("--apps", type=int, default=3)
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_library()
    _build.load_library()
    print(cs.nvidia_smi_line())
    rel, floor = cs.STEP_GRAD_TOL["float32"]
    for app_index in range(args.apps):
        app = cs.train_app(train, cs.TRAIN_BATCH, seed=21)
        counts, peak = cs.first_step_grads(app, "mvit_base_16x4", cs.MVIT_PER_STEP)
        cs.timed_steps(app, cs.MVIT_PER_STEP, "mvit_base_16x4", counts, peak)
        app._drop_graphs()
        batch = cs.preset_batch(23)
        kernels, kernel_grids = step_grads(train, app.model, contextlib.nullcontext, batch, None)
        plain, plain_grids = step_grads(train, app.model, cs.plain_kernels, batch, None)
        f64, _ = step_grads(train, app.model, cs.plain_kernels, batch, torch.float64)
        module_max = {}
        for name, g in plain.items():
            module = cs._module_of(name)
            module_max[module] = max(module_max.get(module, 0.0), g.abs().max().item())
        rows = []
        for name, ref in plain.items():
            bound = rel * ref.abs().max().item() + floor * module_max[cs._module_of(name)]
            rows.append(((kernels[name] - ref).abs().max().item() / bound, name,
                         (kernels[name] - f64[name]).abs().max().item() / bound,
                         (ref - f64[name]).abs().max().item() / bound))
        rows.sort(reverse=True)
        for share, name, k64, p64 in rows[:5]:
            print(f"app {app_index}: {name}: kernels vs plain {share!r} of the bound; from "
                  f"float64: kernels {k64!r}, plain {p64!r}", flush=True)
        print(f"app {app_index}: worst kernels vs plain {rows[0][0]!r} ({rows[0][1]}); worst "
              f"from float64: kernels {max(r[2] for r in rows)!r}, plain "
              f"{max(r[3] for r in rows)!r}; skip max pool windows whose argmax differs "
              f"between the two f32 forms: {argmax_flips(kernel_grids, plain_grids)}",
              flush=True)
        del app, kernels, plain, f64
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
