"""End-to-end video-classification example on the PyTorch/CUDA port (the
upstream tutorials/video_classification_example analogue).

Builds a Kinetics-format dataset (csv of `<path> <label>` lines or a class
directory tree, decoded with OpenCV on the host), a Slow-R50 model, and runs
a short train + multi-clip test on ``--device``: the card by default, where
the app captures its train step in a CUDA graph, or the CPU.

Usage:
  python examples_torch/video_classification.py --data train.csv --val val.csv \
      --classes 400 --epochs 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pytorchvideo_tpu_torch import train as T


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--val", default="")
    p.add_argument("--classes", type=int, default=400)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--model", default="slow_r50")
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")

    cfg = T.VideoClassificationTrainConfig()
    cfg.model = T.ModelConfig(
        name=args.model,
        num_classes=args.classes,
        clip_length=args.frames,
        crop_size=args.crop,
    )
    cfg.data = T.DataConfig(
        data_path=args.data,
        val_data_path=args.val,
        batch_size=args.batch_size,
        num_samples=args.frames,
        crop_size=args.crop,
        min_size=int(args.crop * 256 / 224),
        max_size=int(args.crop * 320 / 224),
    )
    cfg.optim.lr = args.lr
    cfg.lr_scheduler.lr = args.lr
    cfg.lr_scheduler.max_iters = args.epochs
    cfg.trainer.max_epochs = args.epochs
    if args.ckpt_dir:
        cfg.trainer.checkpoint_dir = args.ckpt_dir
        os.makedirs(args.ckpt_dir, exist_ok=True)

    app = T.VideoClassificationTrainApp(cfg, steps_per_epoch=args.steps_per_epoch, device=device)
    losses = app.train()
    print(f"final train losses: {losses[-3:]}")
    metrics = app.test()
    print("test metrics:", metrics)
    return {"losses": losses, "test": metrics}


if __name__ == "__main__":
    main()
