"""Soft-target cross entropy (counterpart of
pytorchvideo_tpu/losses/soft_target_cross_entropy.py; upstream
losses/soft_target_cross_entropy.py:10-81)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.transforms.functional import convert_to_one_hot

_EPS = float(torch.finfo(torch.float32).eps)


def soft_target_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int = -100,
    reduction: str = "mean",
    normalize_targets: bool = True,
) -> torch.Tensor:
    """-sum(target * log_softmax(logits)) with ignore-index masking.

    ``logits``: (N, C) raw scores. ``target``: (N, C) soft labels or (N,)
    class indices. Samples whose soft target puts positive mass on
    ``ignore_index`` are dropped; the mean is over the samples left."""
    if target.dim() == 1:
        target = convert_to_one_hot(target, logits.shape[1])
    if logits.shape != target.shape:
        raise ValueError(f"logits {tuple(logits.shape)} and target {tuple(target.shape)} differ")
    n, c = target.shape
    if 0 <= ignore_index <= c - 1:
        valid = (target[:, ignore_index] <= 0).float()[:, None]
    else:
        valid = torch.ones((n, 1), device=logits.device)
    valid_targets = target.float() * valid
    if normalize_targets:
        valid_targets = valid_targets / (_EPS + valid_targets.sum(dim=1, keepdim=True))
    per_sample = -(valid_targets * F.log_softmax(logits, dim=-1)).sum(-1)
    if reduction == "mean":
        return per_sample.sum() / torch.clamp((valid.sum(-1) > 0).sum(), min=1)
    if reduction == "none":
        return per_sample
    raise NotImplementedError(f'reduction type "{reduction}" not implemented')


class SoftTargetCrossEntropyLoss(nn.Module):
    """Module form of :func:`soft_target_cross_entropy`."""

    def __init__(self, ignore_index: int = -100, reduction: str = "mean",
                 normalize_targets: bool = True):
        super().__init__()
        if reduction not in ("mean", "none"):
            raise NotImplementedError(f'reduction type "{reduction}" not implemented')
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.normalize_targets = normalize_targets

    def forward(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return soft_target_cross_entropy(logits, target, self.ignore_index, self.reduction,
                                         self.normalize_targets)
