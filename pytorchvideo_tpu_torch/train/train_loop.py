"""Training and eval steps (counterpart of pytorchvideo_tpu/train/train_loop.py;
upstream module/video_classification.py:104-223).

The JAX package's step is a pure jitted function of (state, batch, rng). Here
the state is a small mutable object (model, optimizer, LR schedule, update
count) and the step updates it in place: the parameters and the optimizer
state are updated where they lie, as ``torch.optim`` does.

Mixed precision follows the JAX package's policy (train_loop.py:108-121),
not ``torch.autocast``: the f32 master parameters and the clip are cast to
``compute_dtype`` at the top of the loss and the model runs through
``torch.func.functional_call`` on the cast copies, so every layer (LayerNorm
included) computes and returns ``compute_dtype`` and the kernels see one
dtype throughout; the logits are taken to f32 for the loss, and the
gradients land on the f32 masters through the casts. Only the parameters
are cast: the BatchNorm running buffers stay float32 on the module, and the
train-mode BatchNorm (layers/norms.py) updates them in place from float32
batch statistics, as flax does.

A clip is a tensor or, for SlowFast, a list of pathway tensors; the step
casts and splits each pathway, as the JAX step maps over its tree.

Activation rematerialisation (``remat_policy``, JAX train_loop.py:99-105)
checkpoints the whole forward, as the JAX step wraps the whole
``model.apply`` in ``jax.checkpoint``: ``torch.utils.checkpoint`` without
reentrance, each policy a selective-checkpoint function over the aten ops
(:data:`REMAT_POLICIES`). Convolutions and the kernels' forwards are
recomputed under every policy but ``everything_saveable``, as JAX recomputes
``conv_general_dilated`` and ``pallas_call`` outputs under the dots
policies; so under ``"full"`` each kernel's forward launches twice a step.
The random draws of DropPath and dropout are saved under every policy,
whatever generator made them, so the recomputation applies the forward's
masks, as ``jax.checkpoint`` replays the same key; and the train-mode
BatchNorm leaves its running stats alone while recomputing
(``layers/norms.py`` ``recomputing``), so they move once a forward, as the
mutated collection ``jax.checkpoint`` returns.

The step's device work (:meth:`TrainStep.update`) reads nothing back to the
host, so train/compiled_step.py can capture it in a CUDA graph; the host's
part (the batch transform, the LR written into the optimizer's LR tensor,
the update count) stays outside.

Data parallelism (``process_group``): each rank steps on its rows of the
global batch (parallel/mesh.py ``shard_batch``) and the step averages the
gradients, the loss and the accuracy over the group, so that, as the JAX
step jitted over a data mesh, the update is the global batch's. The
average is one all-reduce of every gradient and the metrics flattened
together, after the backward and the zero fill of the gradients the loss
does not reach (every rank then reduces the same tensors) and before the
clip, whose norm is then the global batch's. It runs on the step's own
stream, so a CUDA graph of the update holds it, as the jitted step holds
its ``psum``. BatchNorm statistics are the group's where the model's norms
carry the group (layers/batch_norm.py ``set_sync_group``).

A model on placements (``sharding``, the :class:`ShardPlan` of
parallel/tensor.py ``shard_model_``: tensor-parallel attention and MLP over
a model group, FSDP shards over the data axis) steps as the JAX step jitted
over its ``(data, model)`` mesh: the forward runs on the plan's compute
parameters (each FSDP shard gathered with grad, so its gradient arrives
reduce-scattered), the region's replicated parameters have their gradients
summed over the model group, every gradient and the metrics are averaged
over the data axis, and the clip takes the global norm, each split
parameter's squares summed over the ranks that hold its shards and each
replicated one counted once. The optimizer updates the local shards, so
its state is shard-sized.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pytorchvideo_tpu_torch.layers.norms import recomputing
from pytorchvideo_tpu_torch.losses import soft_target_cross_entropy
from pytorchvideo_tpu_torch.train.optimizer import set_lr
from pytorchvideo_tpu_torch.utils.profiling import DeviceMarks, annotate, count, read_marks

_aten = torch.ops.aten
# A flax Dense is a dot_general without batch dims: aten mm / addmm (a
# Linear on a (B, L, C) activation folds to one addmm). MViT's attention
# einsums carry batch dims: bmm / baddbmm.
_DOTS_NO_BATCH = frozenset({_aten.mm, _aten.addmm})
_DOTS = _DOTS_NO_BATCH | {_aten.bmm, _aten.baddbmm}
# Policy name (the JAX package's: "full" or a jax.checkpoint_policies
# member) -> the aten ops whose outputs the forward saves, or None where
# every output is saved, which is the step without rematerialisation.
REMAT_POLICIES = {
    "full": frozenset(),
    "nothing_saveable": frozenset(),
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


def checkpoint_policy(remat_policy: Optional[str]) -> Optional[Callable]:
    """The selective-checkpoint function of a policy name (None where the
    forward runs unchecked: no policy, or ``everything_saveable``). It saves
    the outputs of the policy's ops and of every random op
    (``nondeterministic_seeded``), and recomputes the rest. Raises
    ValueError on another name, the JAX factory policies
    (``save_only_these_names`` ...) included: a bare name cannot configure
    them."""
    if remat_policy is None:
        return None
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of {sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[remat_policy]
    if saved is None:
        return None

    def policy(ctx, op, *args, **kwargs):
        if (getattr(op, "overloadpacket", None) in saved
                or torch.Tag.nondeterministic_seeded in getattr(op, "tags", ())):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextlib.contextmanager
def _recompute_context(cached_mode):
    with cached_mode, recomputing():
        yield


def _remat_contexts(policy: Callable):
    """``context_fn`` of the checkpoint: the selective-checkpoint modes, the
    recomputation's also under BatchNorm's ``recomputing``."""
    forward, recompute = create_selective_checkpoint_contexts(policy)
    return forward, _recompute_context(recompute)


def average_over_group_(tensors: List[torch.Tensor], group) -> None:
    """Replaces each of ``tensors`` (of one dtype) in place by its mean over
    the ranks of ``group``: one all-reduce of them flattened together."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


@dataclass
class TrainState:
    """What a step updates: the model (f32 master parameters), its optimizer,
    the LR schedule (update count -> LR, or None for the optimizer's own LR)
    and the number of updates made so far."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Optional[Callable[[int], float]] = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       lr_schedule: Optional[Callable[[int], float]] = None) -> TrainState:
    """A :class:`TrainState` at update 0 (the JAX package's
    ``create_train_state(variables, tx)``: here the model holds its
    parameters and buffers and the optimizer its state, so they take the
    place of the variables and the optax transformation)."""
    return TrainState(model, optimizer, lr_schedule)


Video = Union[torch.Tensor, Sequence[torch.Tensor]]


def map_video(fn: Callable, video: Video):
    """``fn`` of a clip tensor, or the list of ``fn`` of each pathway."""
    if isinstance(video, (list, tuple)):
        return [fn(v) for v in video]
    return fn(video)


def _tensors(video: Video) -> List[torch.Tensor]:
    return list(video) if isinstance(video, (list, tuple)) else [video]


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def split_video(video: Video, chunks: int) -> list:
    """The clip (each pathway alike) split along the batch into ``chunks``
    microbatches."""
    if isinstance(video, (list, tuple)):
        return [list(parts) for parts in zip(*(v.chunk(chunks) for v in video))]
    return list(video.chunk(chunks))


def cast_parameters(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: the floating-point parameter cast to ``dtype``}: differentiable
    casts, so gradients reach the masters in their own dtype."""
    return {name: p.to(dtype) if p.is_floating_point() else p
            for name, p in model.named_parameters()}


def forward_backward(model: nn.Module, video: Video, labels: torch.Tensor,
                     loss_fn: Callable = soft_target_cross_entropy,
                     compute_dtype: Optional[torch.dtype] = None, grad_scale: float = 1.0,
                     remat_policy: Optional[str] = None, sharding=None,
                     marks: Optional[DeviceMarks] = None):
    """One forward and backward of ``loss_fn(f32 logits, labels)``; the
    gradients (times ``grad_scale``) accumulate into the parameters' ``.grad``.
    ``remat_policy`` checkpoints the forward (see the module docstring);
    ``sharding`` (a ``ShardPlan``) runs it on the plan's compute parameters;
    ``marks`` (:data:`TRAIN_MARKS`) get "forward" after the loss and
    "backward" after the backward. Returns the detached loss and logits."""
    policy = checkpoint_policy(remat_policy)
    params = None
    if sharding is not None:
        params = sharding.compute_parameters(model, compute_dtype)
    elif compute_dtype is not None:
        params = cast_parameters(model, compute_dtype)
    if compute_dtype is not None:
        video = map_video(lambda v: v.to(compute_dtype), video)

    def forward(params, video):
        if params is None:
            return model(video)
        return torch.func.functional_call(model, params, (video,))

    if policy is None:
        logits = forward(params, video)
    else:
        logits = checkpoint(forward, params, video, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=functools.partial(_remat_contexts, policy))
    loss = loss_fn(logits.float(), labels)
    if marks is not None:
        marks.record("forward")
    (loss * grad_scale).backward()
    if marks is not None:
        marks.record("backward")
    return loss.detach(), logits.detach()


def global_norm(tensors) -> torch.Tensor:
    """The f32 L2 norm of all ``tensors`` together (``optax.global_norm``)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, max_norm: float, norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scales ``grads`` in place by min(1, max_norm / (norm + 1e-6)) (JAX
    train_loop.py:172-175), ``norm`` their :func:`global_norm` unless given
    (a sharded model's, whose shards are not all here); returns it."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(list(grads), scale)
    return norm


# The device marks of an update on the card (TrainStep.marks), in order: its
# start, after the loss, after the backward, after the zero gradients and the
# clip (with a group, the gradients' average too), after the optimizer's step.
# With several microbatches "forward" and "backward" fall in the last one.
TRAIN_MARKS = ("start", "forward", "backward", "clip", "optimizer")


class TrainStep:
    """``step(state, batch, generator=None) -> (state, metrics)``, built by
    :func:`make_train_step`: :meth:`prepare` (the host's part: checks, the
    batch transform), :meth:`write_scalars` (the LR of update ``state.step``
    written into the optimizer,
    :func:`~pytorchvideo_tpu_torch.train.optimizer.set_lr`), :meth:`update`
    (the device's part), then the update count. train/compiled_step.py
    captures :meth:`update` by that interface, :meth:`signature` included.

    ``marks``: the update's device marks (:data:`TRAIN_MARKS`, utils/profiling.py
    ``DeviceMarks``), recorded on the card only: the four parts forward,
    backward, clip and optimizer. A captured update holds them as event
    nodes; inside ``profiling.recording()`` a call keeps their parts once
    the update is done. The eager :meth:`__call__` opens the spans
    ``pvt.train.step``, with ``pvt.train.prepare``, ``pvt.train.scalars``
    and ``pvt.train.update`` inside, and counts ``train.eager_updates``."""

    def __init__(self, loss_fn: Callable, batch_transform: Optional[Callable],
                 clip_grad_norm: Optional[float], input_key: str, label_key: str,
                 compute_dtype: Optional[torch.dtype], remat_policy: Optional[str],
                 grad_accum_steps: int, process_group=None, sharding=None):
        checkpoint_policy(remat_policy)  # refuses an unknown name here
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.loss_fn, self.batch_transform = loss_fn, batch_transform
        self.clip_grad_norm = clip_grad_norm
        self.input_key, self.label_key = input_key, label_key
        self.compute_dtype, self.remat_policy = compute_dtype, remat_policy
        self.grad_accum_steps = grad_accum_steps
        self.process_group = process_group
        self.sharding = sharding
        self.marks = DeviceMarks(TRAIN_MARKS)

    def signature(self, batch: Dict[str, Any]) -> tuple:
        """What one CUDA graph of this step is captured for: the clip's (or
        each pathway's) and the labels' shape, dtype and device, whether the
        clip is a list, ``grad_accum_steps`` and ``compute_dtype``."""
        video = batch[self.input_key]
        return (isinstance(video, (list, tuple)), tuple(_spec(t) for t in _tensors(video)),
                _spec(batch[self.label_key]), self.grad_accum_steps, self.compute_dtype)

    def write_scalars(self, state: TrainState) -> None:
        """The host's values that the device part reads from tensors: the LR
        of update ``state.step``."""
        if state.lr_schedule is not None:
            set_lr(state.optimizer, state.lr_schedule(state.step))

    def prepare(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """(video, labels) of ``batch`` after the batch transform, which
        draws its random scalars from ``generator``."""
        video, labels = batch[self.input_key], batch[self.label_key]
        if labels.shape[0] % self.grad_accum_steps:
            raise ValueError(f"batch size {labels.shape[0]} is not divisible by "
                             f"grad_accum_steps={self.grad_accum_steps}")
        if self.batch_transform is not None:
            video, labels = self.batch_transform(video, labels, generator)
        return video, labels

    def update(self, state: TrainState, video: Video, labels: torch.Tensor) -> Dict[str, Any]:
        """The forward and backward of every microbatch, the zero gradients
        of parameters the loss does not reach, with a ``process_group`` the
        average of the gradients and metrics over it, the clip and the
        optimizer's update at the LR it holds; returns the metrics as 0-d
        device tensors. No value is read back to the host."""
        model = state.model
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        marks = self.marks if params and params[0].is_cuda else None
        if marks is not None:
            marks.record("start")
        for p in params:
            p.grad = None
        hard_labels = labels.dim() == 1
        chunks = self.grad_accum_steps
        loss_sum = accuracy_sum = 0.0
        for v, y in zip(split_video(video, chunks), labels.chunk(chunks)):
            loss, logits = forward_backward(model, v, y, self.loss_fn, self.compute_dtype,
                                            1.0 / chunks, self.remat_policy, self.sharding,
                                            marks)
            loss_sum = loss_sum + loss
            if hard_labels:
                accuracy_sum = accuracy_sum + (logits.argmax(-1) == y).float().mean()
        for p in params:
            if p.grad is None:  # a parameter the loss does not reach: zero, as in JAX
                p.grad = torch.zeros_like(p)
        metrics = {"loss": loss_sum / chunks}
        if hard_labels:
            metrics["accuracy"] = accuracy_sum / chunks
        if self.sharding is not None:
            scalars = torch.stack(list(metrics.values())).to(params[0].grad.dtype)
            self.sharding.reduce_gradients_(model, scalars)
            metrics = dict(zip(metrics, scalars.unbind()))
        elif self.process_group is not None:
            grads = [p.grad for p in params]
            scalars = torch.stack(list(metrics.values())).to(grads[0].dtype)
            average_over_group_([*grads, scalars], self.process_group)
            metrics = dict(zip(metrics, scalars.unbind()))
        if self.clip_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in params], self.clip_grad_norm,
                                 None if self.sharding is None else
                                 self.sharding.global_norm(model))
        if marks is not None:
            marks.record("clip")
        state.optimizer.step()
        if marks is not None:
            marks.record("optimizer")
        return metrics

    def __call__(self, state: TrainState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        update = state.step
        with annotate("pvt.train.step", step=update):
            with annotate("pvt.train.prepare"):
                video, labels = self.prepare(batch, generator)
            with annotate("pvt.train.scalars"):
                self.write_scalars(state)
            with annotate("pvt.train.update"):
                metrics = self.update(state, video, labels)
            state.step += 1
        count("train.eager_updates")
        read_marks(self.marks, update)
        return state, metrics


def make_train_step(
    loss_fn: Callable = soft_target_cross_entropy,
    batch_transform: Optional[Callable] = None,
    clip_grad_norm: Optional[float] = None,
    input_key: str = "video",
    label_key: str = "label",
    compute_dtype: Optional[torch.dtype] = None,
    remat_policy: Optional[str] = None,
    grad_accum_steps: int = 1,
    process_group=None,
    sharding=None,
) -> TrainStep:
    """Build the eager step ``step(state, batch, generator=None) -> (state,
    metrics)`` (a :class:`TrainStep`).

    ``batch_transform``: optional (video, labels, generator) -> (video,
    labels), MixUp/CutMix on the device, run once on the whole batch.
    ``compute_dtype``: e.g. ``torch.bfloat16``; see the module docstring.
    ``remat_policy``: None, or one of :data:`REMAT_POLICIES` (ValueError
    otherwise); see the module docstring.
    ``grad_accum_steps``: the batch is split into that many equal
    microbatches whose gradients are averaged before ONE optimizer update;
    the BatchNorm running stats go through the microbatches in order, as
    the JAX step's ``lax.scan`` threads them.
    ``process_group``: a ``torch.distributed`` group over which the
    gradients and metrics are averaged (see the module docstring); each
    rank passes its rows of the global batch, every rank the same number.
    ``sharding``: the model's ``ShardPlan`` (parallel/tensor.py), in place
    of ``process_group``; each rank passes its rows over the data axis.
    Metrics: "loss" (the microbatches' mean) and, on hard labels, top-1
    "accuracy", both as 0-d tensors on the device (reading them waits for the
    step)."""
    return TrainStep(loss_fn, batch_transform, clip_grad_norm, input_key, label_key,
                     compute_dtype, remat_policy, grad_accum_steps, process_group, sharding)


def make_eval_step(input_key: str = "video"):
    """``step(state, batch) -> logits`` in eval mode (running BN stats),
    without gradients; the clip is a tensor or a list of pathways."""

    def step(state: TrainState, batch: Dict[str, Any]) -> torch.Tensor:
        state.model.eval()
        with torch.no_grad():
            return state.model(batch[input_key])

    return step


def ensemble_video_level(logits_list, video_indices, num_videos: int,
                         method: str = "sum") -> torch.Tensor:
    """Multi-clip test ensembling (JAX train_loop.py:204; upstream
    module/video_classification.py:290-311): the (num_videos, classes) f32
    sum or max of the clips' logits, each clip keyed by its video index."""
    logits = torch.cat(list(logits_list)).float()
    index = torch.cat([torch.as_tensor(i) for i in video_indices]).to(logits.device, torch.long)
    shape = (num_videos, logits.shape[-1])
    if method == "sum":
        return torch.zeros(shape, device=logits.device).index_add_(0, index, logits)
    if method == "max":
        return torch.full(shape, -math.inf, device=logits.device).scatter_reduce_(
            0, index[:, None].expand_as(logits), logits, "amax")
    raise NotImplementedError(method)
