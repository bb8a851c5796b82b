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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.losses import soft_target_cross_entropy


@dataclass
class TrainState:
    """What a step updates: the model (f32 master parameters), its optimizer,
    the LR schedule (update count -> LR, or None for the optimizer's own LR)
    and the number of updates made so far."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Optional[Callable[[int], float]] = None
    step: int = 0


Video = Union[torch.Tensor, Sequence[torch.Tensor]]


def map_video(fn: Callable, video: Video):
    """``fn`` of a clip tensor, or the list of ``fn`` of each pathway."""
    if isinstance(video, (list, tuple)):
        return [fn(v) for v in video]
    return fn(video)


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
                     compute_dtype: Optional[torch.dtype] = None, grad_scale: float = 1.0):
    """One forward and backward of ``loss_fn(f32 logits, labels)``; the
    gradients (times ``grad_scale``) accumulate into the parameters' ``.grad``.
    Returns the detached loss and logits."""
    if compute_dtype is None:
        logits = model(video)
    else:
        logits = torch.func.functional_call(
            model, cast_parameters(model, compute_dtype),
            (map_video(lambda v: v.to(compute_dtype), video),))
    loss = loss_fn(logits.float(), labels)
    (loss * grad_scale).backward()
    return loss.detach(), logits.detach()


def global_norm(tensors) -> torch.Tensor:
    """The f32 L2 norm of all ``tensors`` together (``optax.global_norm``)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scales ``grads`` in place by min(1, max_norm / (norm + 1e-6)) (JAX
    train_loop.py:172-175); returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(list(grads), scale)
    return norm


def make_train_step(
    loss_fn: Callable = soft_target_cross_entropy,
    batch_transform: Optional[Callable] = None,
    clip_grad_norm: Optional[float] = None,
    input_key: str = "video",
    label_key: str = "label",
    compute_dtype: Optional[torch.dtype] = None,
    remat_policy: Optional[str] = None,
    grad_accum_steps: int = 1,
):
    """Build ``step(state, batch, generator=None) -> (state, metrics)``.

    ``batch_transform``: optional (video, labels, generator) -> (video,
    labels), MixUp/CutMix on the device, run once on the whole batch.
    ``compute_dtype``: e.g. ``torch.bfloat16``; see the module docstring.
    ``grad_accum_steps``: the batch is split into that many equal
    microbatches whose gradients are averaged before ONE optimizer update;
    the BatchNorm running stats go through the microbatches in order, as
    the JAX step's ``lax.scan`` threads them.
    Metrics: "loss" (the microbatches' mean) and, on hard labels, top-1
    "accuracy", both as 0-d tensors on the device (reading them waits for the
    step)."""
    if remat_policy is not None:
        raise NotImplementedError("remat_policy (activation checkpointing) is not ported yet")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        video, labels = batch[input_key], batch[label_key]
        batch_size = labels.shape[0]
        if batch_size % grad_accum_steps:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"grad_accum_steps={grad_accum_steps}")
        hard_labels = labels.dim() == 1
        if batch_transform is not None:
            video, labels = batch_transform(video, labels, generator)
            hard_labels = False
        model = state.model
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss_sum = accuracy_sum = 0.0
        for v, y in zip(split_video(video, grad_accum_steps), labels.chunk(grad_accum_steps)):
            loss, logits = forward_backward(model, v, y, loss_fn, compute_dtype,
                                            1.0 / grad_accum_steps)
            loss_sum = loss_sum + loss
            if hard_labels:
                accuracy_sum = accuracy_sum + (logits.argmax(-1) == y).float().mean()
        for p in params:
            if p.grad is None:  # a parameter the loss does not reach: zero, as in JAX
                p.grad = torch.zeros_like(p)
        if clip_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in params], clip_grad_norm)
        if state.lr_schedule is not None:
            lr = state.lr_schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss_sum / grad_accum_steps}
        if hard_labels:
            metrics["accuracy"] = accuracy_sum / grad_accum_steps
        return state, metrics

    return step


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
