"""Differentiable collectives (counterpart of pytorchvideo_tpu/parallel/collectives.py;
upstream fvcore differentiable_all_gather in models/simclr.py:192,
AllGatherWithGradient in the trainer's module/distributed_utils.py:303-323,
cat_all_gather in layers/distributed.py:25-39).

``lax.all_gather`` is differentiable in JAX; here each collective is a
``torch.autograd.Function`` whose backward is the transpose of its
forward. ``group`` is a ``torch.distributed`` process group (None: the
default one), the JAX package's ``axis_name``.

The tensor-parallel region of an attention or MLP layer (parallel/tensor.py)
has two more: :func:`enter_region` (Megatron's ``f``: the identity forward,
an all-reduce of the gradients backward) and :func:`reduce_from_region`
(``g``: an all-reduce forward, the identity backward). The gradient of a
replicated activation after the region is the same on every rank of the
group, so the transpose of the exit's sum is the identity there, where
GSPMD's partitioner inserts the same pair. Each takes several tensors and
runs one all-reduce for all of them, in float32 (one rounding of a bf16
sum, and a type every backend carries).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        # Flat buffers: every backend takes the concatenated layout.
        out = x.new_empty(dist.get_world_size(group) * x.numel())
        dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
        return out.view(-1, *x.shape)

    @staticmethod
    def backward(ctx, g):
        # Each rank's slice of the sum over ranks of the gradient.
        grad = g.new_empty(g[0].numel())
        dist.reduce_scatter_tensor(grad, g.contiguous().view(-1), op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return grad.view(g.shape[1:]), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        grad = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_gather_with_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """Every rank's ``x`` stacked on a leading rank axis, (world, *x.shape),
    as ``lax.all_gather``; the gradient reaching each rank's ``x`` is its
    slice of the gradients' sum over ranks (a reduce-scatter)."""
    return _AllGather.apply(x, group)


def cat_all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order
    (``lax.all_gather(..., axis=0, tiled=True)``), with gradients as
    :func:`all_gather_with_grad`."""
    return all_gather_with_grad(x, group).flatten(0, 1)


def all_reduce_with_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """The sum over ranks of ``x`` (``lax.psum``); its gradient is the sum
    over ranks of the output's gradient."""
    return _AllReduceSum.apply(x, group)


def contrast_targets(z1: torch.Tensor, z2: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None):
    """(the keys, the target column of each row of ``z1``) of NT-Xent:
    ``z2`` and its diagonal; with a ``group``, every rank's ``z2`` gathered
    with grad (:func:`cat_all_gather`), the targets offset by this
    rank's index times the rows (the JAX package's ``axis_index * n``)."""
    n = z1.shape[0]
    targets = torch.arange(n, device=z1.device)
    if group is None:
        return z2, targets
    return cat_all_gather(z2, group), targets + dist.get_rank(group) * n


def _all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """The sums over ``group`` of ``tensors`` (of one dtype), from one
    all-reduce of them flattened together in float32."""
    flat = _flatten_dense_tensors([t.contiguous() for t in tensors]).float()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [t.to(tensors[0].dtype)
            for t in _unflatten_dense_tensors(flat, [t.float() for t in tensors])]


class _EnterRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_all_reduce_sum(grads, ctx.group))


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(_all_reduce_sum(xs, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def _none_safe(fn, group, xs):
    present = [x for x in xs if x is not None]
    outs = iter(fn(group, *present)) if present else iter(())
    return tuple(None if x is None else next(outs) for x in xs)


def enter_region(xs: Sequence[Optional[torch.Tensor]], group) -> tuple:
    """``xs`` as they are (None stays None); backward, the sum over
    ``group`` of their gradients, in one all-reduce: what reaches a
    replicated input from the ranks' parts of the region."""
    return _none_safe(_EnterRegion.apply, group, xs)


def reduce_from_region(xs: Sequence[Optional[torch.Tensor]], group) -> tuple:
    """The sums over ``group`` of ``xs`` (the ranks' partial outputs of a
    row-parallel layer), in one all-reduce; backward, the gradients as they
    are."""
    return _none_safe(_ReduceFromRegion.apply, group, xs)
