"""Process groups of the port (counterpart of pytorchvideo_tpu/parallel/distributed.py;
upstream pytorchvideo/layers/distributed.py: get_world_size :13,
init_distributed_training :42, local groups :60-145).

The JAX package's runtime owns the transport and counts devices; here the
transport is a ``torch.distributed`` process group with one process per
GPU: NCCL on the card, gloo on the CPU. Every query falls back to the
single-process answer when no default group is initialised.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def get_world_size() -> int:
    """Processes in the default group (1 without one): one per GPU, so the
    JAX package's global device count."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_size() -> int:
    """Processes on this host (the JAX package's local device count):
    ``LOCAL_WORLD_SIZE`` where the launcher sets it (torchrun does), else
    the world size, one host."""
    if not dist.is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def get_rank() -> int:
    """This process's rank in the default group (0 without one). Unlike the
    JAX package's ``get_rank``, which is the host's process index (0 on one
    host whatever its device count), it counts one rank per GPU."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed_training(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Joins this process to the default group of ``num_processes`` ranks
    as rank ``process_id`` (upstream init_distributed_training :42-57):
    NCCL for ``device="cuda"``, and this process then works on card
    ``process_id % torch.cuda.device_count()``; gloo for ``device="cpu"``.
    ``coordinator_address`` is the rendezvous, ``host:port`` (TCP) or a URL
    (``tcp://...``, ``file://...``). A no-op for one process, as in the JAX
    package."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None or coordinator_address is None:
        raise ValueError("init_distributed_training needs coordinator_address and process_id "
                         "for more than one process")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def local_sync_groups(num_sync_devices: int) -> List[List[int]]:
    """The ranks in groups of ``num_sync_devices`` consecutive ones: the
    JAX package's ``axis_index_groups`` for local-group BatchNorm (upstream
    GroupGather, layers/distributed.py:91-145). :func:`new_local_sync_groups`
    makes their process groups."""
    n = get_world_size()
    if num_sync_devices < 1 or n % num_sync_devices:
        raise ValueError(f"{n} ranks do not split into groups of {num_sync_devices}")
    return [list(range(i, i + num_sync_devices)) for i in range(0, n, num_sync_devices)]


def new_local_sync_groups(num_sync_devices: int) -> Tuple[dist.ProcessGroup,
                                                          List[dist.ProcessGroup]]:
    """(this rank's group, every group) of :func:`local_sync_groups`, each
    made by ``dist.new_group``. Every rank must call it, at the same point
    of its program: each rank takes part in making every group, in the
    same order, or the job hangs."""
    return dist.new_subgroups_by_enumeration(local_sync_groups(num_sync_devices))
