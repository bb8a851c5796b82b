"""Trainer-level losses (counterpart of pytorchvideo_tpu/train/losses.py;
upstream pytorchvideo_trainer/module/losses.py:12-134): NT-Xent,
similarity (BYOL) and contrastive (MoCo) losses, and the soft-target cross
entropy re-exported.

The JAX package's ``axis_name`` (NT-Xent's negatives all-gathered across
the devices of a ``shard_map``) is a ``torch.distributed`` process group
here: ``ntxent_loss(..., group=...)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pytorchvideo_tpu_torch.losses import soft_target_cross_entropy  # noqa: F401
from pytorchvideo_tpu_torch.parallel.collectives import contrast_targets


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


def ntxent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.07,
                group: Optional[torch.distributed.ProcessGroup] = None) -> torch.Tensor:
    """NT-Xent: each row of ``z1`` against every row of ``z2``, its positive
    on the diagonal. With ``group`` (the JAX package's ``axis_name``) the
    negatives are every rank's ``z2``, gathered with grad
    (:func:`contrast_targets`); the loss is this rank's rows' mean."""
    z1, z2 = _l2_normalize(z1), _l2_normalize(z2)
    keys, targets = contrast_targets(z1, z2, group)
    return F.cross_entropy((z1 @ keys.T) / temperature, targets)


def similarity_loss(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Negative mean cosine similarity of the normalised embeddings (BYOL)."""
    return -(_l2_normalize(q) * _l2_normalize(k)).sum(-1).mean()


def contrastive_loss(q: torch.Tensor, pos_and_neg: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE with the positive in column 0 of ``pos_and_neg`` (B, K+1, C)
    (MoCo); ``q`` (B, C) is normalised, the keys are taken as given."""
    logits = torch.einsum("nc,nkc->nk", _l2_normalize(q), pos_and_neg) / temperature
    return -F.log_softmax(logits, dim=-1)[:, 0].mean()
