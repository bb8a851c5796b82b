"""Norm and activation factories for the builders' injected-callable idiom.

Counterpart of pytorchvideo_tpu/layers/norms.py. The JAX package wraps flax
BatchNorm so that every norm is called as ``norm(x, train=...)``; in PyTorch
the mode rides on the module (``model.eval()``). ``BatchNorm`` is an
``nn.BatchNorm3d`` (the same ``state_dict`` keys and eval path, torch's
defaults eps 1e-5 and momentum 0.1) whose train mode follows flax's
``nn.BatchNorm``, which the JAX package wraps.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn as nn

LayerNorm = nn.LayerNorm


class _Recompute(threading.local):
    active = False


_RECOMPUTE = _Recompute()


@contextlib.contextmanager
def recomputing():
    """While active (in this thread), a train-mode :class:`BatchNorm` leaves
    its running stats and ``num_batches_tracked`` as they are: an activation
    checkpoint's recomputation of a forward whose update already happened
    (train/train_loop.py), as ``jax.checkpoint`` returns the mutated
    collection once."""
    previous, _RECOMPUTE.active = _RECOMPUTE.active, True
    try:
        yield
    finally:
        _RECOMPUTE.active = previous


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's train-mode semantics.

    In train mode the batch mean and the biased batch variance are taken in
    float32 whatever the input's dtype; the input is normalised in float32
    and returned in its own dtype; the weight and bias may be of another
    dtype than the float32 running buffers (bf16 copies under a compute
    dtype); and the running stats move by ``momentum`` towards the batch
    mean and the *biased* variance (flax's decay is ``1 - momentum``), where
    ``nn.BatchNorm3d`` takes the unbiased one. ``momentum=None`` averages
    cumulatively, as in torch, with its factor 1 / ``num_batches_tracked``
    taken on the buffers' device (no host read, so a CUDA graph can hold
    it). Inside :func:`recomputing` the stats are not updated. Eval mode is
    ``nn.BatchNorm3d``'s.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        # Affine parameters in float32 at least: for a bf16 input the native
        # op then keeps the batch stats in float32 (with bf16 ones it rounds
        # them to bf16).
        acc = torch.promote_types(x.dtype, torch.float32)
        weight = None if self.weight is None else self.weight.to(acc)
        bias = None if self.bias is None else self.bias.to(acc)
        out, mean, invstd = torch.ops.aten._native_batch_norm_legit(
            x, weight, bias, True, 0.0, self.eps)
        if self.running_mean is not None and not _RECOMPUTE.active:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / self.num_batches_tracked.to(self.running_mean.dtype)
                          if self.momentum is None else self.momentum)
                self.running_mean.lerp_(mean, factor)
                self.running_var.lerp_(invstd.pow(-2) - self.eps, factor)
        return out


class BatchNorm1d(BatchNorm):
    """:class:`BatchNorm` over (B, C) features or (B, C, L) sequences: the
    JAX package's one BatchNorm reduces over every axis but the channels',
    whatever the rank (the SSL projector's and predictor's norm)."""

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() not in (2, 3):
            raise ValueError(f"expected 2D or 3D input (got {input.dim()}D input)")


class BatchNorm2d(BatchNorm):
    """:class:`BatchNorm` over (B, C, H, W) maps: the JAX package's one
    BatchNorm on the 2D squeeze-excitation block (layers/squeeze_excitation.py)."""

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() != 4:
            raise ValueError(f"expected 4D input (got {input.dim()}D input)")


class TokenBatchNorm(BatchNorm):
    """:class:`BatchNorm` over the trailing (channel) axis of an input of any
    rank, viewed as (N, C): the JAX package's BatchNorm on MViT's (B, L, C)
    tokens and (..., heads, c) per-head grids, the BatchNorm MViT's norms
    (layers/attention.py). The ``state_dict`` is ``nn.BatchNorm3d``'s."""

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.shape[-1] != self.num_features:
            raise ValueError(f"expected {self.num_features} channels last, got shape "
                             f"{tuple(input.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).view(x.shape)


def make_norm(
    norm: Optional[Callable], num_features: int, eps: float = 1e-5, momentum: float = 0.1
) -> Optional[nn.Module]:
    """Instantiate an injected norm factory (e.g. ``BatchNorm``), or None."""
    if norm is None:
        return None
    return norm(num_features=num_features, eps=eps, momentum=momentum)


def make_act(activation: Optional[Callable]) -> Optional[Callable]:
    """Injected activation -> callable: a module class is instantiated
    (upstream's ``activation=nn.ReLU`` idiom); a function or module instance
    is returned as is; None stays None."""
    if activation is None:
        return None
    if isinstance(activation, type):
        return activation()
    return activation
