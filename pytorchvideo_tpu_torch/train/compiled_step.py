"""The training step captured in a CUDA graph: the port's counterpart of the
JAX app's ``jax.jit(make_train_step(...))`` (pytorchvideo_tpu/train/app.py),
as accelerate/deploy.py's ``CompiledForward`` is of its compiled forward.

:class:`CompiledTrainStep` captures ONE graph for one batch signature (the
clip's, or each pathway's, shape, dtype and device, the labels', the step's
``grad_accum_steps`` and ``compute_dtype``) after its warm-up updates, and
replays it at every call after. The graph holds the whole device part of
the eager step (``TrainStep.update``): the forward and backward of every
microbatch (checkpointed under ``remat_policy``), the zero gradients of
parameters the loss does not reach, the clip by global norm, the
optimizer's update and the metrics. The host's part stays around it: the
batch transform (MixUp/CutMix draws its scalars and box from the app's CPU
generator), the copy of the batch into the static buffers, the schedule's
LR written into the optimizer's LR tensor (train/optimizer.py), and the
update count.

Capture. The first ``WARMUP_STEPS`` batches of a signature are real
updates, made eagerly on a side stream (PyTorch's recipe for whole-network
capture): they build the kernels, set up cuDNN and cuBLAS, allocate the
tiled dw kernel's counters (ops/token_pool.py) and create the optimizer's
state. The next batch's update is captured in the memory pool ``pool`` and
replayed at once; each later batch replays it. Graphs of one model share
one pool. A capture that fails raises: there is no eager fallback.

Random draws. torch's default CUDA generator is graph-safe: each replay
advances it, so each replay draws new DropPath and dropout masks. A
module's own CUDA generator (a ``generator`` attribute, as DropPath,
Dropout and MultiScaleBlock hold) is registered with the graph
(``CUDAGraph.register_generator_state``) to the same effect; a torch
without that refuses such a model.

What a replay cannot see. The graph runs the kernels recorded at the
capture on the tensors it saw there. Python-side state is frozen into it:
a dropout ``rate``, ``train()``/``eval()``, ``requires_grad``, a module
swapped in or out, the optimizer's hyperparameters other than the LR.
Parameters, buffers and optimizer state are read and written where they
lie, so an in-place edit (``load_state_dict`` of the model, precise BN)
takes effect at the next replay; rebinding one to a new tensor
(``optimizer.load_state_dict``) does not, and needs a new capture. Replays
must run on one stream, one at a time: the dw kernel's counters are one
buffer per device. The kernels' launch counters move once an update at
each warm-up update and at the capture, never on a replay, which runs no
Python.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from pytorchvideo_tpu_torch.train.optimizer import set_lr
from pytorchvideo_tpu_torch.train.train_loop import TrainState, TrainStep

WARMUP_STEPS = 2


def _tensors(video) -> List[torch.Tensor]:
    return list(video) if isinstance(video, (list, tuple)) else [video]


def _spec(t: torch.Tensor):
    return tuple(t.shape), t.dtype, t.device


def batch_signature(step: TrainStep, batch: Dict[str, Any]) -> tuple:
    """What one graph of ``step`` is captured for: the clip's (or each
    pathway's) and the labels' shape, dtype and device, whether the clip is
    a list, the step's ``grad_accum_steps`` and ``compute_dtype``."""
    video = batch[step.input_key]
    return (isinstance(video, (list, tuple)), tuple(_spec(t) for t in _tensors(video)),
            _spec(batch[step.label_key]), step.grad_accum_steps, step.compute_dtype)


def _explicit_generators(model: torch.nn.Module) -> List[torch.Generator]:
    found = {}
    for module in model.modules():
        generator = getattr(module, "generator", None)
        if isinstance(generator, torch.Generator):
            found[id(generator)] = generator
    return list(found.values())


def model_device(model: torch.nn.Module) -> torch.device:
    """The one CUDA device of ``model``'s parameters and buffers; raises
    ValueError otherwise (a captured step needs the card)."""
    devices = {t.device for t in [*model.parameters(), *model.buffers()]}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the captured training step needs the model on one CUDA device, got "
                         f"{sorted(map(str, devices))}; on the CPU use the eager step "
                         f"(make_train_step)")
    return next(iter(devices))


class CompiledTrainStep:
    """``step(state, batch, generator=None) -> (state, metrics)``, as the
    eager ``step`` (a :class:`~pytorchvideo_tpu_torch.train.train_loop.TrainStep`)
    computes it, for one batch signature (:func:`batch_signature`, fixed by
    the first call): the first ``WARMUP_STEPS`` calls make eager updates on a
    side stream, the next captures the update in one ``torch.cuda.CUDAGraph``
    and replays it, and every later call replays it.

    ``state`` is the train state the graph is captured for: its model on one
    CUDA device (else ValueError) and, when it has an LR schedule, its
    optimizer's LR a CUDA tensor (``construct_optimizer`` makes one; a float
    LR would be baked into the graph). ``pool``: a
    ``torch.cuda.graph_pool_handle()`` shared with the model's other graphs
    (default: a new one, kept as ``.pool``).

    A call runs ``step.prepare`` (the batch transform) eagerly, copies the
    clip and labels into the static buffers, writes the LR of update
    ``state.step``, updates (eagerly, or by a replay), advances ``state.step``
    and ``calls``, and returns the metrics as 0-d device tensors. A batch of
    another signature, or another train state, raises ValueError. See the
    module docstring for what a replay cannot see.
    """

    def __init__(self, step: TrainStep, state: TrainState, pool=None):
        self.device = model_device(state.model)
        if state.lr_schedule is not None and not all(
                isinstance(g["lr"], torch.Tensor) and g["lr"].device == self.device
                for g in state.optimizer.param_groups):
            raise ValueError("the captured step needs the optimizer's LR as a tensor on the "
                             "model's device (construct_optimizer): a float LR would be baked "
                             "into the graph")
        self._generators = [g for g in _explicit_generators(state.model)
                            if g.device.type == "cuda"]
        if self._generators and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise ValueError("this torch cannot make a module's own CUDA generator graph-safe "
                             "(CUDAGraph.register_generator_state): every replay would draw "
                             "one mask; use torch's default generator")
        self.step, self.state = step, state
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.signature = None
        self.calls = 0  # updates made: WARMUP_STEPS eager ones, then replays
        self._side = None

    def __call__(self, state: TrainState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        if state is not self.state:
            raise ValueError("this step was captured for another train state")
        signature = batch_signature(self.step, batch)
        if self.signature is not None and signature != self.signature:
            raise ValueError(f"this step was captured for the batch signature {self.signature}, "
                             f"got {signature}")
        video, labels = self.step.prepare(batch, generator)
        if self.signature is None:
            # The static buffers lie outside the graph's pool.
            self._static_video = [t.detach().clone() for t in _tensors(video)]
            self._static_labels = labels.detach().clone()
            self._arg = (self._static_video if isinstance(video, (list, tuple))
                         else self._static_video[0])
            self._side = torch.cuda.Stream(self.device)
            self.signature = signature
        with torch.no_grad():
            for static, t in zip(self._static_video, _tensors(video)):
                static.copy_(t)
            self._static_labels.copy_(labels)
        if state.lr_schedule is not None:
            set_lr(state.optimizer, state.lr_schedule(state.step))
        if self.calls < WARMUP_STEPS:
            metrics = self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            metrics = {k: v.clone() for k, v in self._metrics.items()}
        self.calls += 1
        state.step += 1
        return state, metrics

    def _warm_up(self) -> Dict[str, torch.Tensor]:
        """One eager update on the side stream (PyTorch's recipe for what a
        capture follows: kernels built, cuDNN and cuBLAS set up, the dw
        kernel's counters and the optimizer's state allocated)."""
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            metrics = self.step.update(self.state, self._arg, self._static_labels)
        current.wait_stream(self._side)
        return metrics

    def _capture(self) -> None:
        model = self.state.model
        graph = torch.cuda.CUDAGraph()
        for g in self._generators:
            graph.register_generator_state(g)
        # Thread-local: the datamodule's prefetch thread (its event waits and
        # pinned allocations, on a stream of its own) runs beside the capture.
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            metrics = self.step.update(self.state, self._arg, self._static_labels)
        self._metrics = metrics
        # The gradients the graph writes (allocated in its pool): held here
        # so that the pool never hands their memory to another allocation.
        self._grads = [p.grad for p in model.parameters() if p.requires_grad]
        self.graph = graph
