"""Device mesh and batch sharding (counterpart of pytorchvideo_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` with named axes and lets
GSPMD place the data; here a mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group (one process per GPU), a
sharding is a tuple of ``DTensor`` placements, one per mesh axis, and
sharding a batch means taking this rank's rows of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(axis_shapes: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",)
              ) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default process group (which
    must be initialised): ``axis_shapes`` may hold one -1, inferred, and
    must tile the world size, else ValueError. Default: a 1-D data-parallel
    mesh over every rank. Its device type is the group's: "cuda" under
    NCCL, "cpu" under gloo."""
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised default process group "
                         "(parallel.init_distributed_training)")
    n = dist.get_world_size()
    shapes = list(axis_shapes)
    if -1 in shapes:
        known = int(np.prod([s for s in shapes if s != -1])) or 1
        shapes[shapes.index(-1)] = n // known
    if any(s <= 0 for s in shapes) or int(np.prod(shapes)) != n:
        raise ValueError(f"mesh axis shapes {dict(zip(axis_names, shapes))} do not tile the "
                         f"{n} rank(s) of the process group; start more processes or shrink "
                         f"the fixed axes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shapes), mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Tuple:
    """The placements of a batch sharded along dim 0 over ``axis`` and
    replicated over the mesh's other axes."""
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(),) * mesh.ndim


def batch_rows(batch_size: int, parts: int, index: int, microbatches: int = 1,
               mirrored: bool = False) -> torch.Tensor:
    """The global rows (ascending within each microbatch) that part ``index``
    of ``parts`` holds of a batch that the step splits into ``microbatches``
    equal microbatches: an equal share of each, in microbatch order, so
    that the part's own split into ``microbatches`` chunks gives its rows of
    each global microbatch. Contiguous shares by default.

    ``mirrored``: the shares are chosen so that the part's rows reversed
    pair each row i with row ``batch_size - 1 - i`` of the global batch,
    the partner MixUp and CutMix give it (transforms/mix.py flips the
    batch): a microbatch in the first half takes a contiguous share, its
    mirror microbatch the mirrored rows, and a middle microbatch (an odd
    count) half a share and its mirror. Raises ValueError, naming the
    constraint, where the batch does not split so: each microbatch
    (``batch_size / microbatches`` rows) must be a multiple of ``parts``,
    and under ``mirrored`` with an odd count of microbatches each part's
    share of the middle one must be even."""
    per_micro, odd = divmod(batch_size, microbatches)
    share, rem = divmod(per_micro, parts)
    if odd or rem or share == 0:
        raise ValueError(f"a batch of {batch_size} in {microbatches} microbatch(es) does not "
                         f"split over {parts} parts: batch / grad_accum_steps must be a "
                         f"multiple of {parts}")
    middle = mirrored and microbatches % 2 == 1
    if middle and share % 2:
        raise ValueError(f"under MixUp/CutMix each of {parts} parts needs an even share of a "
                         f"microbatch of {per_micro} (its rows and their mirror partners); "
                         f"this share is {share}: make batch / (grad_accum_steps * {parts}) "
                         f"even or grad_accum_steps even")
    rows = []
    for k in range(microbatches):
        start = k * per_micro
        partner = microbatches - 1 - k
        if not mirrored or k < partner:
            part = torch.arange(start + index * share, start + (index + 1) * share)
        elif k > partner:
            part = (batch_size - 1 - rows[partner]).flip(0)
        else:
            half = torch.arange(start + index * (share // 2), start + (index + 1) * (share // 2))
            part = torch.cat([half, (batch_size - 1 - half).flip(0)])
        rows.append(part)
    return torch.cat(rows)


def _take_rows(x, rows: torch.Tensor):
    if isinstance(x, dict):
        return {k: _take_rows(v, rows) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_take_rows(v, rows) for v in x)
    x = torch.as_tensor(x)
    return x.index_select(0, rows.to(x.device))


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data", microbatches: int = 1,
                mirrored: bool = False):
    """This rank's rows of a global batch (a tensor, or dicts, lists and
    tuples of them, every leaf with the batch on dim 0), sharded over the
    mesh axis ``axis``: :func:`batch_rows` of this rank's coordinate on
    that axis. The JAX package's ``device_put`` places every shard from
    one host; here each rank takes its own. Raises ValueError where the
    batch does not split (see :func:`batch_rows`)."""
    first = batch
    while isinstance(first, (dict, list, tuple)):
        first = next(iter(first.values())) if isinstance(first, dict) else first[0]
    rows = batch_rows(len(first), mesh.size(mesh.mesh_dim_names.index(axis)),
                      mesh.get_local_rank(axis), microbatches, mirrored)
    return _take_rows(batch, rows)

