"""The training step captured in a CUDA graph: the port's counterpart of the
JAX apps' ``jax.jit`` of their steps (pytorchvideo_tpu/train/app.py's
``make_train_step``, ssl_app.py's BYOL, SimCLR and MoCo v2 steps), as
accelerate/deploy.py's ``CompiledForward`` is of its compiled forward.

:class:`CompiledTrainStep` captures ONE graph for one batch signature
(``step.signature(batch)``: for the classification step the clip's, or each
pathway's, shape, dtype and device, the labels', ``grad_accum_steps`` and
``compute_dtype``; for an SSL step the two views' and the task) after its
warm-up updates, and replays it at every call after. It takes any step
with the interface of train_loop.py's ``TrainStep`` and ssl_app.py's
``SSLTrainStep``:

- ``signature(batch)``: the tuple a graph is captured for;
- ``prepare(batch, generator)``: the host's part (checks, the batch
  transform, whose random scalars come from ``generator``), returning the
  update's inputs, each a tensor or a list of tensors;
- ``write_scalars(state, **scalars)``: the host's values the update reads
  from device tensors, written before each update: the schedule's LR into
  the optimizer's LR tensor (train/optimizer.py), and an SSL step's EMA
  momentum ``mmt`` into the state's ``mmt`` tensor;
- ``update(state, *inputs)``: the device part, which reads nothing back to
  the host, returning its metrics as 0-d device tensors.

:class:`CapturedSteps` is what both train apps step through: their captured
steps by signature in one memory pool on the card, the eager step on the
CPU.

The graph holds the whole of ``update``: for the classification step the
forward and backward of every microbatch (checkpointed under
``remat_policy``), the zero gradients of parameters the loss does not
reach, the clip by global norm, the optimizer's update and the metrics; for
an SSL step the two views' forwards and the backward, the optimizer's
update, then the EMA of the momentum encoder and the queue's rotation. The
host's part stays around it: ``prepare``, the copy of the inputs into the
static buffers, ``write_scalars`` and the update count.

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
Dropout and MultiScaleBlock hold, and MoCo v2's shuffle) is registered
with the graph (``CUDAGraph.register_generator_state``) to the same
effect; a torch without that refuses such a model.

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

What the program counts and times (utils/profiling.py). Counters:
``train.eager_updates`` (the warm-up updates), ``train.captures`` (one a
batch signature: a second signature shows as a recapture) and
``train.replays``. ``.launches_per_replay`` holds the launches the capture
made by kernel, so replays times it gives the launches the replays made;
``.capture_s`` the host seconds of the warm-up updates and the capture
(the capture begins by waiting for the card, so the warm-ups' device time
is in it). Spans: ``pvt.train.step`` around a call, with
``pvt.train.prepare``, ``pvt.train.copy_in``, ``pvt.train.scalars``, then
``pvt.train.warmup``, or ``pvt.train.capture`` and ``pvt.train.replay``, or
``pvt.train.replay`` and ``pvt.train.metrics`` inside. A step with device
marks (train_loop.py ``TrainStep.marks``: forward, backward, clip,
optimizer) has them captured in its graph; inside a
``profiling.recording()`` block each call then waits for the update's last
mark, after its span, and keeps the four parts.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from pytorchvideo_tpu_torch.ops import launch_counts, launches_since
from pytorchvideo_tpu_torch.train.train_loop import TrainState, _tensors
from pytorchvideo_tpu_torch.utils.profiling import annotate, count, read_marks

WARMUP_STEPS = 2


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
    """``step(state, batch, generator=None, **scalars) -> (state, metrics)``,
    as the eager ``step`` (a
    :class:`~pytorchvideo_tpu_torch.train.train_loop.TrainStep` or an
    :class:`~pytorchvideo_tpu_torch.train.ssl_app.SSLTrainStep`) computes it,
    for one batch signature (``step.signature``, fixed by the first call):
    the first ``WARMUP_STEPS`` calls make eager updates on a side stream, the
    next captures the update in one ``torch.cuda.CUDAGraph`` and replays it,
    and every later call replays it.

    ``state`` is the train state the graph is captured for: its model on one
    CUDA device (else ValueError) and, when it has an LR schedule, its
    optimizer's LR a CUDA tensor (``construct_optimizer`` makes one; a float
    LR would be baked into the graph). ``pool``: a
    ``torch.cuda.graph_pool_handle()`` shared with the model's other graphs
    (default: a new one, kept as ``.pool``).

    A call runs ``step.prepare`` eagerly, copies its inputs into the static
    buffers, runs ``step.write_scalars(state, **scalars)`` (the LR of update
    ``state.step``; an SSL step's ``mmt``), updates (eagerly, or by a
    replay), advances ``state.step`` and ``calls``, and returns the metrics
    as 0-d device tensors. A batch of another signature, or another train
    state, raises ValueError. See the module docstring for what a replay
    cannot see.
    """

    def __init__(self, step, state: TrainState, pool=None):
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
        self.capture_s = 0.0
        self.launches_per_replay: Dict[str, int] = {}

    def __call__(self, state: TrainState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None, **scalars):
        if state is not self.state:
            raise ValueError("this step was captured for another train state")
        signature = self.step.signature(batch)
        if self.signature is not None and signature != self.signature:
            raise ValueError(f"this step was captured for the batch signature {self.signature}, "
                             f"got {signature}")
        update = state.step
        with annotate("pvt.train.step", step=update):
            with annotate("pvt.train.prepare"):
                inputs = self.step.prepare(batch, generator)
            if self.signature is None:
                # The static buffers lie outside the graph's pool.
                self._static = [[t.detach().clone() for t in _tensors(x)] for x in inputs]
                self._args = tuple(static if isinstance(x, (list, tuple)) else static[0]
                                   for static, x in zip(self._static, inputs))
                self._side = torch.cuda.Stream(self.device)
                self.signature = signature
            with annotate("pvt.train.copy_in"), torch.no_grad():
                for static, x in zip(self._static, inputs):
                    for buffer, t in zip(static, _tensors(x)):
                        buffer.copy_(t)
            with annotate("pvt.train.scalars"):
                self.step.write_scalars(state, **scalars)
            if self.calls < WARMUP_STEPS:
                metrics = self._warm_up()
            else:
                if self.graph is None:
                    self._capture()
                with annotate("pvt.train.replay"):
                    self.graph.replay()
                count("train.replays")
                with annotate("pvt.train.metrics"):
                    metrics = {k: v.clone() for k, v in self._metrics.items()}
            self.calls += 1
            state.step += 1
        read_marks(getattr(self.step, "marks", None), update)
        return state, metrics

    def _warm_up(self) -> Dict[str, torch.Tensor]:
        """One eager update on the side stream (PyTorch's recipe for what a
        capture follows: kernels built, cuDNN and cuBLAS set up, the dw
        kernel's counters and the optimizer's state allocated)."""
        start = time.perf_counter()
        with annotate("pvt.train.warmup"):
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                metrics = self.step.update(self.state, *self._args)
            current.wait_stream(self._side)
        self.capture_s += time.perf_counter() - start
        count("train.eager_updates")
        return metrics

    def _capture(self) -> None:
        start = time.perf_counter()
        model = self.state.model
        graph = torch.cuda.CUDAGraph()
        for g in self._generators:
            graph.register_generator_state(g)
        launches = launch_counts()
        # Thread-local: the datamodule's prefetch thread (its event waits and
        # pinned allocations, on a stream of its own) runs beside the capture.
        with annotate("pvt.train.capture"), torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            metrics = self.step.update(self.state, *self._args)
        self.launches_per_replay = launches_since(launches)
        self.capture_s += time.perf_counter() - start
        count("train.captures")
        self._metrics = metrics
        # The gradients the graph writes (allocated in its pool): held here
        # so that the pool never hands their memory to another allocation.
        self._grads = [p.grad for p in model.parameters() if p.requires_grad]
        self.graph = graph


class CapturedSteps(dict):
    """An app's captured train steps, one :class:`CompiledTrainStep` per batch
    signature (this dict maps ``step.signature(batch)`` to it), all in one
    graph memory pool, which the app's other graphs share through
    :meth:`graph_pool`. On a ``device`` other than the card, :meth:`run`
    calls the eager step."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.pool = None

    def graph_pool(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def run(self, step, state: TrainState, batch: Dict[str, Any],
            generator: Optional[torch.Generator] = None, **scalars):
        """One update of ``state`` on ``batch``: the captured step of the
        batch's signature on the card (made at its first batch), ``step``
        itself elsewhere."""
        if self.device.type != "cuda":
            return step(state, batch, generator, **scalars)
        key = step.signature(batch)
        compiled = self.get(key)
        if compiled is None:
            compiled = self[key] = CompiledTrainStep(step, state, pool=self.graph_pool())
        return compiled(state, batch, generator, **scalars)
