"""Self-supervised video pretraining example on the PyTorch/CUDA port (BYOL /
SimCLR / MoCo v2).

Upstream ships these as Hydra train apps (pytorchvideo_trainer
conf/byol_train_app_conf.yaml etc.); here the same workflow is a small
script over SSLTrainApp: pretrain a backbone on unlabeled clips (decoded
with OpenCV on the host), then reuse it for classification fine-tuning.

Usage:
  python examples_torch/ssl_pretraining.py --data train.csv --task moco_v2 \
      --model slow_r50 --steps-per-epoch 100 --epochs 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pytorchvideo_tpu_torch import train as T

# BatchNorm's running statistics, which a state_dict holds beside the
# parameters.
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--task", default="byol", choices=["byol", "simclr", "moco_v2"])
    p.add_argument("--model", default="slow_r50")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")

    cfg = T.SSLConfig(task=args.task)
    cfg.model = T.ModelConfig(
        name=args.model,
        clip_length=args.frames,
        crop_size=args.crop,
    )
    cfg.data = T.DataConfig(
        data_path=args.data,
        batch_size=args.batch_size,
        num_samples=args.frames,
        crop_size=args.crop,
        clip_duration=args.frames * 2 / 30.0,
    )
    cfg.optim = T.OptimizerConfig(method="sgd", lr=args.lr, momentum=0.9)
    cfg.feature_dim = args.feature_dim
    cfg.max_epochs = args.epochs

    app = T.SSLTrainApp(cfg, steps_per_epoch=args.steps_per_epoch, device=device)
    app.setup()
    history = app.train()
    print(f"[{args.task}] {len(history)} steps, "
          f"loss {history[0]:.4f} -> {history[-1]:.4f}")

    backbone = app.backbone_variables()
    n = sum(t.numel() for key, t in backbone.items() if not key.endswith(_BUFFERS))
    print(f"pretrained backbone: {n/1e6:.2f}M params — fine-tune with "
          f"VideoClassificationTrainApp.load_ssl_backbone(backbone)")
    return {"losses": history, "backbone_params": n, "backbone": backbone}


if __name__ == "__main__":
    main()
