"""Trainer-level batch transforms (counterpart of
pytorchvideo_tpu/train/transforms.py; upstream
pytorchvideo_trainer/datamodule/transforms.py). So far only
``MixVideoBatchWrapper`` (upstream :165); the host-side clip transforms wait
for the data feed."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from pytorchvideo_tpu_torch.transforms.mix import MixVideo


class MixVideoBatchWrapper:
    """MixVideo over a batch dict, on the batch's device; the random scalars
    come from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, mixup_alpha: float, cutmix_prob: float, cutmix_alpha: float,
                 label_smoothing: float, num_classes: int = 400) -> None:
        self.mix_video_transform = MixVideo(
            mixup_alpha=mixup_alpha,
            cutmix_prob=cutmix_prob,
            cutmix_alpha=cutmix_alpha,
            label_smoothing=label_smoothing,
            num_classes=num_classes,
        )

    def __call__(self, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        batch["video"], batch["label"] = self.mix_video_transform(
            batch["video"], batch["label"], generator)
        return batch
