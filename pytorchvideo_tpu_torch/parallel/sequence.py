"""Sequence parallelism for pooled attention (counterpart of
pytorchvideo_tpu/parallel/sequence.py; beyond the reference, which is data
parallel only).

Attention rows are independent given the whole keys and values, so the
token axis of the head-packed (B, L, H*c) queries splits across the ranks
of a process group and each rank attends its rows: the context-parallel
decomposition the JAX package runs under ``shard_map``. Each rank's body
is :func:`pooled_attention_packed` on its rows: kernels #4 and #5 on the
card, the plain versions on the CPU.

Two kv layouts, as in the JAX package:

- ``kv_sharded=False``: every rank holds the whole k and v (the layout
  after a replicated kv pool); no collective.
- ``kv_sharded=True``: k and v are token-sharded like the queries (the
  all-L-sharded training layout); each rank all-gathers the (pooled,
  small) kv rows with grad before its attention.

It composes with data parallelism as the JAX function's ``batch_axis``
does: over a ``(data, model)`` mesh a rank holds its batch rows of the data
axis and its token rows of the model axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pytorchvideo_tpu_torch.ops.pooled_attention import pooled_attention_packed
from pytorchvideo_tpu_torch.parallel.collectives import all_gather_with_grad


def sequence_shard(x: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Rows ``index`` of ``parts`` equal slices of the token axis (dim 1) of
    ``x``, contiguous (a row slice of (B, L, H*c) is not, for B > 1, and
    the kernels take contiguous tensors). ValueError where L does not
    split."""
    length = x.shape[1]
    if length % parts:
        raise ValueError(f"sequence axis L={length} must divide into the {parts} ranks of the "
                         f"group; pad the token grid or split the cls row off first "
                         f"(layers/attention.py does)")
    n = length // parts
    return x[:, index * n:(index + 1) * n].contiguous()


def sequence_parallel_body(q_shard: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: float, residual_pool: bool = False
                           ) -> torch.Tensor:
    """One rank's part: the attention of its query rows ``q_shard`` (B,
    Lq / world, H*c) over the whole k and v (B, Lk, H*c)."""
    return pooled_attention_packed(q_shard, k.contiguous(), v.contiguous(), num_heads, scale,
                                   residual_pool)


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: float,
    residual_pool: bool = False,
    *,
    group: Optional[dist.ProcessGroup] = None,
    kv_sharded: bool = False,
    mesh=None,
    axis: str = "model",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Packed pooled attention with the token axis split over the ranks of
    ``group`` (None: the default group). Returns this rank's rows of the
    output, (B, Lq / world, H*c), rank r holding rows r * Lq / world on.

    ``mesh`` (a ``DeviceMesh``, the JAX function's arguments): the token
    axis split over the mesh axis ``axis`` (in place of ``group``) and,
    with ``batch_axis``, the batch over that one too: this rank then takes
    its contiguous share of the batch rows (the batch must divide by the
    axis's size, else ValueError) and returns (B / batch ranks, Lq /
    world, H*c).

    q, k, v: the (B, L, H*c) tensors the JAX function takes (global
    arrays there, the same tensors on every rank here). This rank attends
    its Lq / world query rows; ValueError (:func:`sequence_shard`) where
    Lq, or with ``kv_sharded`` Lk, does not divide by the group size.
    With ``kv_sharded`` this rank keeps its Lk / world rows of k and v and
    all-gathers every rank's (:func:`all_gather_with_grad`), as the JAX
    body gathers its token-sharded blocks, so each rank's gradient of k and
    v lands on its own rows, summed over the ranks' losses. The attention
    is :func:`sequence_parallel_body`."""
    if mesh is not None:
        group = mesh.get_group(axis)
        if batch_axis is not None:
            parts, index = mesh.size(mesh.mesh_dim_names.index(batch_axis)), \
                mesh.get_local_rank(batch_axis)
            if q.shape[0] % parts:
                raise ValueError(f"batch B={q.shape[0]} must divide into the {parts} ranks of "
                                 f"the '{batch_axis}' mesh axis")
            q, k, v = (t.chunk(parts)[index] for t in (q, k, v))
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    q_shard = sequence_shard(q, world, rank)
    if kv_sharded:
        k, v = (all_gather_with_grad(sequence_shard(t, world, rank), group)
                .transpose(0, 1).flatten(1, 2) for t in (k, v))
    return sequence_parallel_body(q_shard, k, v, num_heads, scale, residual_pool)
