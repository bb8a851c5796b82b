"""Accelerator deployment walkthrough on the PyTorch/CUDA port.

Parity: upstream tutorials/accelerator/*.ipynb (build with efficient blocks,
use the accelerator model zoo, transmute a model). Shows the deploy paths
on an X3D-XS:

1. EfficientX3d: build from efficient blocks, convert() = BN fold + bf16,
   the stride-1 depthwise ``conv_b`` on the fused kernel, and on the card
   one CUDA graph at the example's shape.
2. convert_to_deployable_form on any hub model: the eager bf16 deploy form,
   and on the card its CUDA graph (``example_input``; a CPU model or input
   raises there).
3. transmute_model: the registry's "cuda" passes, which are the same
   conversion.
4. export_program: the deploy form as ``torch.export`` bytes, loaded back
   and run.

Weights are the builders' random init, seeded with 0.

Run: python examples_torch/accelerator_deployment.py [--device cpu]
"""

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")
    on_card = device.type == "cuda"

    from pytorchvideo_tpu_torch.accelerate import (
        CompiledForward,
        EfficientX3d,
        convert_to_deployable_form,
        export_program,
        transmute_model,
    )
    from pytorchvideo_tpu_torch.accelerate.deploy import WARMUP_FORWARDS
    from pytorchvideo_tpu_torch.models import hub

    def synchronize():
        if on_card:
            torch.cuda.synchronize(device)

    x = torch.from_numpy(
        np.random.default_rng(0).uniform(-1, 1, (1, 3, 4, 160, 160)).astype(np.float32)
    ).to(device)
    xb = x.to(torch.bfloat16)
    out = {"input": x}
    # Forwards that ran a deploy form eagerly: each launches the depthwise
    # kernel once per stride-1 conv_b on the card (a replay launches none).
    out["deploy_forwards"] = 0

    torch.manual_seed(0)
    with torch.no_grad():
        # 1. efficient-block model with a train -> deploy conversion
        eff = EfficientX3d(expansion="XS", num_classes=400, device=device).eval()
        out["efficient_reference"] = eff(x).float()
        eff.convert(x)  # BN fold + bf16, and on the card the CUDA graph
        if isinstance(eff.deploy_form, CompiledForward):
            out["deploy_forwards"] += WARMUP_FORWARDS + 1  # the warm-up and the capture
        synchronize()
        t0 = time.perf_counter()
        out["efficient"] = eff(x).float()
        synchronize()
        if not isinstance(eff.deploy_form, CompiledForward):
            out["deploy_forwards"] += 1
        print(f"EfficientX3d deploy: {tuple(out['efficient'].shape)} in "
              f"{time.perf_counter() - t0:.3f}s")

        # 2. any hub model -> deployable (folded, cast, the kernel swapped in)
        model = hub.x3d_xs(model_num_class=400, device=device).eval()
        out["reference"] = model(x).float()
        deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
        out["deployable"] = deploy(xb).float()
        out["deploy_forwards"] += 1
        print("deployable:", tuple(out["deployable"].shape))
        if on_card:
            compiled = convert_to_deployable_form(model, dtype=torch.bfloat16, example_input=x)
            out["deploy_forwards"] += WARMUP_FORWARDS + 1
            out["compiled"] = compiled(xb).float()
            print("compiled (CUDA graph):", tuple(out["compiled"].shape))

        # 3. transmuter registry
        model2 = transmute_model(model, target_device="cuda")
        out["transmuted"] = model2(xb).float()
        out["deploy_forwards"] += 1
        print("transmuted:", tuple(out["transmuted"].shape))

    # 4. export for serving (torch.export bytes), loaded back and run
    blob = export_program(deploy, xb)
    print(f"program exported: {len(blob)} bytes")
    program = torch.export.load(io.BytesIO(blob))
    with torch.no_grad():
        out["exported"] = program.module()(xb).float()
    out["deploy_forwards"] += 1
    out["deploy"] = deploy
    out["exported_bytes"] = len(blob)
    return out


if __name__ == "__main__":
    main()
