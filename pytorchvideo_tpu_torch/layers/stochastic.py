"""DropPath (stochastic depth), the heads' Dropout and Swish (counterpart of
pytorchvideo_tpu/layers/stochastic.py and of flax's ``nn.Dropout`` in the
JAX package's heads; upstream layers/drop_path.py and layers/swish.py).

The JAX package draws its masks from a ``jax.random`` key; here they come
from an explicit ``torch.Generator`` on the tensor's device, or from torch's
default generator for that device when none is given. The two give different
bits from one seed, so the tests compare distributions and fixed masks.

A mask is drawn out of place (``torch.rand`` below ``keep``): activation
checkpointing (train/train_loop.py) keeps the draw of the forward for the
recomputation, and it can keep only an op's fresh output, not a tensor that an
in-place draw has written.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def drop_path_scale(
    batch: int, rate: float, like: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """A per-sample (batch, 1, 1) factor: 1 / keep where the sample's branch
    is kept (probability keep = 1 - rate), else 0, in ``like``'s dtype and
    device."""
    keep = 1.0 - rate
    mask = torch.rand((batch, 1, 1), device=like.device, generator=generator) < keep
    return (mask / keep).to(like.dtype)


def drop_path(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Per-sample residual-branch drop, scaled by 1 / keep (JAX
    layers/stochastic.py:14-20)."""
    if rate == 0.0:
        return x
    scale = drop_path_scale(x.shape[0], rate, x, generator)
    return x * scale.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def drop_path_pair(
    pair: Tuple[Optional[torch.Tensor], torch.Tensor],
    rate: float,
    generator: Optional[torch.Generator] = None,
):
    """DropPath of a (cls (B, 1, C) or None, grid (B, L, C)) pair with ONE mask
    per sample for both halves (JAX layers/attention.py:752-767): two
    independent draws would drop a sample's cls token and its grid
    inconsistently within the same residual branch."""
    cls_x, grid_x = pair
    if rate == 0.0:
        return pair
    scale = drop_path_scale(grid_x.shape[0], rate, grid_x, generator)
    return (None if cls_x is None else cls_x * scale, grid_x * scale)


class DropPath(nn.Module):
    """Stochastic depth on a residual branch, active only in training mode.
    ``generator`` (optional) supplies the masks."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return drop_path(x, self.rate, self.generator)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Element-wise dropout as flax's ``nn.Dropout``: each value is kept with
    probability keep = 1 - rate and then divided by keep, else set to 0."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


class Dropout(nn.Module):
    """Dropout active only in training mode, its masks from ``generator``
    (optional) as :class:`DropPath`'s."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.generator)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(x)
