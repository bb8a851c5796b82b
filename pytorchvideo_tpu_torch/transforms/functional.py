"""Functional transforms (counterpart of pytorchvideo_tpu/transforms/functional.py):
so far only the one-hot labels of the losses and MixUp / CutMix."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convert_to_one_hot(
    targets: torch.Tensor, num_class: int, label_smooth: float = 0.0
) -> torch.Tensor:
    """Index labels (N,) -> (smoothed) one-hot (N, num_class) float32
    (upstream functional.py:163-192)."""
    if not 0.0 <= label_smooth < 1.0:
        raise ValueError(f"label_smooth must be in [0, 1), got {label_smooth}")
    non_target_value = label_smooth / num_class
    target_value = 1.0 - label_smooth + non_target_value
    one_hot = F.one_hot(targets.long(), num_class).float()
    return one_hot * (target_value - non_target_value) + non_target_value
