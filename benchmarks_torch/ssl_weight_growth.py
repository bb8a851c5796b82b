"""How the online weights of a BYOL run grow under the preset's optimizer
(LARS, constant LR 4.8, as the JAX app builds it: no schedule), eager and
captured.

    python3 benchmarks_torch/ssl_weight_growth.py [--steps 12] [--out build/ssl_weight_growth.json]

Run from the root of a checkout, on a machine with a CUDA card (f32, TF32
off). Builds ``SSLTrainApp`` for BYOL on full-width ``slow_r50`` (8x224x224,
head dropout 0, feature 256, predictor 4096, mmt 0.996 annealed) from seed
82 over B8 batches of seeded random clips, twice: once stepping the eager
step, once the captured step (``SSLTrainApp._step``). After each update it
prints the loss, the largest |weight| of the online network and of the
predictor, and the number of tensors that are not finite.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, CLIP, SEED, BATCHES = 8, (8, 224, 224), 82, 5


class _Views:
    def __init__(self, n: int):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        self.batches = [torch.randn(BATCH, 2, 3, *CLIP, device="cuda", generator=gen)
                        for _ in range(n)]

    def train_dataloader(self, n):
        for video in self.batches[:n]:
            yield {"video": video}


def run(form: str, steps: int) -> list:
    import torch

    from pytorchvideo_tpu_torch import train

    cfg = train.SSLConfig(task="byol", optim=train.get_preset("byol_train_app_conf")["optimizer"],
                          feature_dim=256, predictor_inner=4096, mmt=0.996)
    cfg.model = train.ModelConfig(name="slow_r50", clip_length=CLIP[0], crop_size=CLIP[1],
                                  kwargs={"dropout_rate": 0.0})
    torch.manual_seed(SEED)
    views = _Views(BATCHES)
    app = train.SSLTrainApp(cfg, steps_per_epoch=steps, seed=SEED, datamodule=views)
    app.setup()
    rows = []
    for i in range(steps):
        batch = {"video": views.batches[i % BATCHES]}
        mmt = app._momentum(i, 0)
        if form == "eager":
            app.state, metrics = app._train_step(app.state, batch, mmt=mmt)
        else:
            app.state, metrics = app._step(batch, mmt)
        with torch.no_grad():
            rows.append({
                "update": i + 1, "loss": metrics["loss"].item(),
                "online_max_abs": max(p.abs().max().item() for p in app.task.online.parameters()),
                "predictor_max_abs": max(p.abs().max().item()
                                         for p in app.task.predictor.parameters()),
                "nonfinite_tensors": sum(not torch.isfinite(p).all().item()
                                         for p in app.task.parameters())})
        print(form, rows[-1], flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import subprocess

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    report = {"device": card}
    for form in ("eager", "captured"):
        report[form] = run(form, args.steps)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
