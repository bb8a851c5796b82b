"""Norm and activation factories for the builders' injected-callable idiom.

Counterpart of pytorchvideo_tpu/layers/norms.py. The JAX package wraps flax
BatchNorm so that every norm is called as ``norm(x, train=...)``; in PyTorch
the mode rides on the module (``model.eval()``). ``BatchNorm`` is an
``nn.BatchNorm3d`` (the same ``state_dict`` keys and eval path, torch's
defaults eps 1e-5 and momentum 0.1) whose train mode follows flax's
``nn.BatchNorm``, which the JAX package wraps, its cross-device statistics
(``axis_name`` / ``axis_index_groups``) included: a ``process_group``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from pytorchvideo_tpu_torch.parallel.collectives import all_reduce_with_grad

LayerNorm = nn.LayerNorm
# The JAX package's Identity takes a ``train`` argument; here the mode rides
# on the module, and nn.Identity takes any argument.
Identity = nn.Identity


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


class _SharedGroup:
    """Holds a process group through ``copy.deepcopy`` of the module (a
    ``ProcessGroup`` cannot be copied): a copy syncs over the same group."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


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

    ``process_group`` (a ``torch.distributed`` group, the JAX package's
    ``axis_name``, or one of ``parallel.new_local_sync_groups``, its
    ``axis_index_groups``; settable later, see
    ``layers/batch_norm.py`` ``set_sync_group``): in train mode the batch
    statistics are the group's, flax's ``lax.pmean`` of the float32 mean
    and mean of squares, all-reduced with grad, and the biased variance,
    flax's ``mean of squares - mean**2``, taken as the mean of the ranks'
    variances plus the variance of their means: the same value, without
    the cancellation of a large mean's square against the mean of squares
    (one rank's synced statistics are its local ones). The group's ranks
    must hold batches of one size. Not ``nn.SyncBatchNorm``, which moves
    the running variance towards the unbiased one.
    """

    def __init__(self, *args, process_group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.process_group = process_group

    @property
    def process_group(self):
        return self._sync.group

    @process_group.setter
    def process_group(self, group) -> None:
        self._sync = _SharedGroup(group)

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
        if self.process_group is None:
            out, mean, invstd = torch.ops.aten._native_batch_norm_legit(
                x, weight, bias, True, 0.0, self.eps)
            var = None
        else:
            out, mean, var = self._synced(x, weight, bias, acc)
        if self.running_mean is not None and not _RECOMPUTE.active:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / self.num_batches_tracked.to(self.running_mean.dtype)
                          if self.momentum is None else self.momentum)
                self.running_mean.lerp_(mean, factor)
                self.running_var.lerp_(invstd.pow(-2) - self.eps if var is None else var,
                                       factor)
        return out

    def _synced(self, x: torch.Tensor, weight, bias, acc: torch.dtype):
        """(output, the group's mean, its biased variance) of a train-mode
        forward: this rank's mean, variance and squared mean (from one
        ``var_mean`` pass), all-reduced with grad; the group's variance is
        the ranks' mean variance plus the variance of their means; the
        input scaled and shifted per channel in one ``addcmul``."""
        dims = [0, *range(2, x.dim())]
        xf = x.to(acc)
        var, mean = torch.var_mean(xf, dims, correction=0)
        stats = torch.stack([mean, var, mean.square()])
        size = dist.get_world_size(self.process_group)
        mean, var, meansq = all_reduce_with_grad(stats, self.process_group) / size
        var = var + torch.clamp(meansq - mean.square(), min=0.0)
        scale = torch.rsqrt(var + self.eps)
        if weight is not None:
            scale = scale * weight
        shift = -mean * scale
        if bias is not None:
            shift = shift + bias
        shape = (1, -1) + (1,) * (x.dim() - 2)
        out = torch.addcmul(shift.view(shape), xf, scale.view(shape))
        return out.to(x.dtype), mean, var


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
