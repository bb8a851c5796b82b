"""SimCLR NT-Xent (https://arxiv.org/abs/2002.05709); counterpart of
pytorchvideo_tpu/models/simclr.py (upstream pytorchvideo/models/simclr.py:13-66).

The JAX package's ``axis_name`` (negatives all-gathered across the devices
of a ``shard_map``) is a ``torch.distributed`` process group here:
``SimCLR.loss(..., group=...)``, as train/losses.py's ``ntxent_loss``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.models.byol import l2_normalize
from pytorchvideo_tpu_torch.parallel.collectives import contrast_targets


class SimCLR(nn.Module):
    """An optional backbone and a projection ``mlp`` (``state_dict`` keys
    ``backbone.*`` and ``mlp.*``, the JAX state's two trees)."""

    def __init__(self, mlp: nn.Module, backbone: Optional[nn.Module] = None,
                 temperature: float = 0.07):
        super().__init__()
        self.mlp = mlp
        self.backbone = backbone
        self.temperature = temperature

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        if self.backbone is not None:
            x = self.backbone(x)
        return l2_normalize(self.mlp(x))

    def nt_xent(self, z1: torch.Tensor, z2: torch.Tensor, group=None) -> torch.Tensor:
        """The loss of normalised embeddings: row i of ``z1`` against every
        row of ``z2``, its positive on the diagonal; with ``group`` against
        every rank's ``z2``, gathered with grad
        (``parallel.collectives.contrast_targets``)."""
        keys, targets = contrast_targets(z1, z2, group)
        return F.cross_entropy((z1 @ keys.T) / self.temperature, targets)

    def loss(self, x1: torch.Tensor, x2: torch.Tensor,
             group: Optional[torch.distributed.ProcessGroup] = None) -> torch.Tensor:
        """NT-Xent of the two views, in the module's mode; ``group`` (the
        JAX package's ``axis_name``) all-gathers the negatives."""
        return self.nt_xent(self.embed(x1), self.embed(x2), group)
