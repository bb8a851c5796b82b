"""BYOL (https://arxiv.org/pdf/2006.07733.pdf); counterpart of
pytorchvideo_tpu/models/byol.py (upstream pytorchvideo/models/byol.py:11-143).

The JAX wrapper holds three variables trees, ``online``, ``momentum`` and
``predictor``; here they are three submodules of one module, whose
``state_dict`` keys start with those names. ``momentum`` is a copy of the
online backbone that takes no gradient: it runs in eval mode (its running
stats) and moves only by :meth:`BYOL.momentum_update`, an EMA over every
float parameter and buffer, the BatchNorm running stats included, as the
JAX update maps over the whole variables tree; ``num_batches_tracked``
stays as it is (the JAX package keeps no such count).
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.layers.norms import BatchNorm1d


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2, -1) + eps), the JAX package's ``_l2_normalize``."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


class _Predictor(nn.Module):
    """Linear (no bias) -> BatchNorm -> ReLU -> Linear (JAX byol.py:20)."""

    def __init__(self, in_dim: int, inner_dim: int, out_dim: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, inner_dim, bias=False, device=device)
        self.norm = BatchNorm1d(inner_dim).to(device)
        self.fc2 = nn.Linear(inner_dim, out_dim, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.norm(self.fc1(x))))


def ema_(targets, sources, mmt) -> None:
    """targets = targets * mmt + sources * (1 - mmt), in place; ``mmt`` a
    float or a 0-d tensor (read on the device)."""
    torch._foreach_mul_(targets, mmt)
    torch._foreach_add_(targets, torch._foreach_mul(sources, 1.0 - mmt))


def ema_tensors(module: nn.Module):
    """The float parameters and buffers of ``module`` in ``state_dict``
    order: what a momentum update moves."""
    return [t for t in module.state_dict(keep_vars=True).values() if t.is_floating_point()]


def momentum_copy(backbone: nn.Module) -> nn.Module:
    """A copy of ``backbone`` that takes no gradient, in eval mode."""
    momentum = copy.deepcopy(backbone)
    for p in momentum.parameters():
        p.requires_grad_(False)
    return momentum.eval()


class BYOL(nn.Module):
    """BYOL around a backbone module that maps a clip to its (B, feature_dim)
    projection. ``predictor`` defaults to the JAX package's:
    Linear(feature_dim, predictor_inner) -> BatchNorm -> ReLU ->
    Linear(feature_dim).
    ``projector`` is refused as in the JAX package: compose it into the
    backbone."""

    def __init__(self, backbone: nn.Module, projector: Optional[nn.Module] = None,
                 predictor: Optional[nn.Module] = None, feature_dim: int = 2048,
                 predictor_inner: int = 4096, mmt: float = 0.99,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if projector is not None:
            raise NotImplementedError("pass a backbone already composed with its projector")
        self.online = backbone
        self.momentum = momentum_copy(backbone)
        self.predictor = predictor or _Predictor(feature_dim, predictor_inner, feature_dim,
                                                 device=device)
        self.mmt = mmt

    def train(self, mode: bool = True):
        super().train(mode)
        self.momentum.eval()
        return self

    @staticmethod
    def sim_loss(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """-mean(<q, k>) (upstream byol.py:62-72)."""
        return -(q * k).sum(-1).mean()

    @torch.no_grad()
    def momentum_update(self, mmt=None) -> None:
        """momentum = momentum * mmt + online * (1 - mmt) over every float
        parameter and buffer; ``mmt`` a float or a 0-d device tensor
        (default ``self.mmt``)."""
        ema_(ema_tensors(self.momentum), ema_tensors(self.online),
             self.mmt if mmt is None else mmt)

    def forward_backbone(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.predictor(self.online(x)))

    @torch.no_grad()
    def forward_backbone_mmt(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.momentum(x))

    def loss(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """The symmetric BYOL loss (upstream byol.py:124-143), in the
        module's mode for the online branch; call :meth:`momentum_update`
        after the optimizer's update."""
        pred_1, pred_2 = self.forward_backbone(x1), self.forward_backbone(x2)
        mmt_1, mmt_2 = self.forward_backbone_mmt(x1), self.forward_backbone_mmt(x2)
        return (self.sim_loss(pred_1, mmt_2) + self.sim_loss(pred_2, mmt_1)) / 2.0
