"""The sharded train step of the JAX package's multichip dry run
(``__graft_entry__.py:123-179`` ``run_sharded_step``): one SGD step of a
model on a ``(data, model)`` mesh with the Megatron rules on its attention
and MLP, FSDP of every other large parameter over ``data``, the optimizer
state sharded like the parameters, the batch's rows over ``data``,
global-batch BatchNorm, an optional batch transform (MixUp) and the clip by
global norm.

The JAX function jits the step with ``in_shardings`` and lets GSPMD
partition it; here each rank puts the model on its placements
(parallel/tensor.py ``shard_model_``), builds the optimizer over its shards
and steps on its rows (train/train_loop.py ``sharding=``). Every rank must
hold the same model weights and the same global batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from pytorchvideo_tpu_torch.parallel.mesh import shard_batch
from pytorchvideo_tpu_torch.parallel.sharding import (
    MEGATRON_ATTENTION_RULES,
    infer_param_shardings,
    optimizer_state_shardings,
)
from pytorchvideo_tpu_torch.parallel.tensor import ShardPlan, shard_model_
from pytorchvideo_tpu_torch.train.optimizer import OptimizerConfig, construct_optimizer
from pytorchvideo_tpu_torch.train.train_loop import TrainState, create_train_state, make_train_step

# The dry run's optimizer (__graft_entry__.py:128-131).
SHARDED_STEP_OPTIMIZER = dict(method="sgd", lr=0.1, zero_weight_decay_1d_param=True)


@dataclass
class ShardedStep:
    """What :func:`run_sharded_step` leaves: the step's loss (the global
    batch's), the state (its model on its shards, one update made), the
    plan, and the optimizer state's placements {parameter: {key:
    placements}}."""

    loss: float
    state: TrainState
    plan: ShardPlan
    optimizer_placements: Dict[str, Dict[str, Tuple]]


def run_sharded_step(model: torch.nn.Module, video, labels: torch.Tensor,
                     batch_transform: Optional[Callable] = None, *, mesh) -> ShardedStep:
    """One step of ``model`` (train mode; the same weights on every rank) on
    the global batch (``video``, a clip tensor or a pathway list, and
    ``labels``) sharded over ``mesh`` (a ``DeviceMesh`` with a ``data`` and
    a ``model`` axis, parallel/mesh.py ``make_mesh``), as the dry run sets
    it: ``MEGATRON_ATTENTION_RULES`` and FSDP over ``data`` for parameters
    of at least 256 elements, SGD at lr 0.1 with no weight decay on 1-D
    parameters, this rank's rows of the batch (mirrored under a
    ``batch_transform``, so that its local flip pairs the global partners),
    the clip at global norm 1.0. The batch transform draws from a CPU
    generator seeded by 0 (the same draw on every rank); dropout and
    DropPath from torch's default generators seeded by the rank's data
    coordinate, so the ranks of a model group draw the same masks. Raises
    ValueError where the loss is not finite."""
    placements = infer_param_shardings(model, mesh, MEGATRON_ATTENTION_RULES, "data", 256)
    plan = shard_model_(model, placements, mesh)
    state = create_train_state(model, construct_optimizer(
        model, OptimizerConfig(**SHARDED_STEP_OPTIMIZER)))
    step = make_train_step(batch_transform=batch_transform, clip_grad_norm=1.0, sharding=plan)
    torch.manual_seed(plan.axes.coords["data"])
    batch = shard_batch({"video": video, "label": labels}, mesh, "data",
                        mirrored=batch_transform is not None)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    loss = metrics["loss"].item()
    if not math.isfinite(loss):
        raise ValueError(f"non-finite loss {loss}")
    return ShardedStep(loss, state, plan, optimizer_state_shardings(state, placements, mesh))
