"""SSL pretraining: the BYOL, SimCLR and MoCo v2 train steps and the app
(counterpart of pytorchvideo_tpu/train/ssl_app.py; upstream
pytorchvideo_trainer/module/{ssl_helper.py, byol.py, simclr.py, moco_v2.py}
and the byol/simclr/moco_v2_train_app_conf.yaml apps).

The JAX package jits one pure step per task over (ssl_state, opt_state).
Here the state is an :class:`SSLTrainState`: the task module (models/byol.py
``BYOL``, models/simclr.py ``SimCLR``, train/ssl.py ``MoCoV2``), its
optimizer over the trainable parameters (the momentum encoders take no
gradient), the update count and ``mmt``, the EMA momentum as a 0-d tensor
on the device, which the step reads where the JAX step takes a scalar
argument. A step (:class:`SSLTrainStep`) updates the state in place, in
the JAX step's order:

- the two views go through the online network one after the other in train
  mode, so the BatchNorm running stats move by view 1 then by view 2, as
  the JAX step threads its ``batch_stats`` from the first branch into the
  second;
- BYOL's momentum branch and MoCo's key encoder run in eval mode (their
  running stats), MoCo's on the batch shuffled by a permutation from the
  task's own generator;
- the optimizer's update, then the EMA of the momentum encoder from the
  updated online weights and the running stats after view 2 (BYOL, MoCo),
  then the queue's rotation (MoCo).

The device part (:meth:`SSLTrainStep.update`) reads nothing back to the
host, so train/compiled_step.py captures it in a CUDA graph as the JAX app
jits its step: ``SSLTrainApp.train()`` runs the captured step on the card
and the eager one on the CPU. SSL runs in float32, as the JAX app does.

The two augmented views arrive as one (B, 2, 3, T, H, W) batch, made by
the app's datamodule (:meth:`SSLTrainApp._datamodule`) or by
:class:`TwoViewTransform`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.models.byol import BYOL
from pytorchvideo_tpu_torch.models.simclr import SimCLR
from pytorchvideo_tpu_torch.train.compiled_step import CapturedSteps
from pytorchvideo_tpu_torch.train.config import DataConfig, ModelConfig
from pytorchvideo_tpu_torch.train.datamodule import VideoClassificationDataModule
from pytorchvideo_tpu_torch.train.optimizer import OptimizerConfig, construct_optimizer, set_lr
from pytorchvideo_tpu_torch.train.ssl import MoCoV2, momentum_anneal_cosine
from pytorchvideo_tpu_torch.train.train_loop import TrainState

logger = logging.getLogger(__name__)


@dataclass
class SSLTrainState(TrainState):
    """A :class:`TrainState` whose model is an SSL task, with ``mmt``: the
    EMA momentum the step reads, a 0-d tensor on the task's device (None
    for SimCLR, which has no momentum encoder)."""

    mmt: Optional[torch.Tensor] = None


def ssl_train_state(task: nn.Module, optimizer: torch.optim.Optimizer,
                    mmt: Optional[float] = None, lr_schedule=None) -> SSLTrainState:
    """The state of ``task``, its ``mmt`` tensor made as the optimizer's LR
    tensor is (float32 on the card, float64 on the CPU, where it holds the
    Python float exactly)."""
    tensor = None
    if mmt is not None:
        device = next(task.parameters()).device
        dtype = torch.float32 if device.type == "cuda" else torch.float64
        tensor = torch.tensor(mmt, dtype=dtype, device=device)
    return SSLTrainState(task, optimizer, lr_schedule, mmt=tensor)


def _byol_loss(task: BYOL, x1, x2):
    return task.loss(x1, x2), None


def _byol_after(state: SSLTrainState, _) -> None:
    state.model.momentum_update(state.mmt)


def _simclr_loss(task: SimCLR, x1, x2):
    return task.loss(x1, x2), None


def _moco_loss(task: MoCoV2, x1, x2):
    return task.loss(x1, x2)


def _moco_after(state: SSLTrainState, keys: torch.Tensor) -> None:
    state.model.momentum_update(state.mmt)
    state.model.dequeue_and_enqueue(keys)


class SSLTrainStep:
    """``step(state, batch, generator=None, mmt=None) -> (state, metrics)``
    for one SSL task: :meth:`prepare` splits ``batch["video"]`` (B, 2, 3, T,
    H, W) into the two views, :meth:`write_scalars` writes the LR of update
    ``state.step`` (with a schedule) and ``mmt`` (when given) into their
    device tensors, :meth:`update` makes the update (see the module
    docstring); metrics: "loss", a 0-d device tensor. Built by
    :func:`make_byol_train_step`, :func:`make_simclr_train_step` and
    :func:`make_moco_train_step`; train/compiled_step.py captures it."""

    def __init__(self, task: str, loss: Callable, after: Optional[Callable] = None):
        self.task, self._loss, self._after = task, loss, after

    def signature(self, batch: Dict[str, Any]) -> tuple:
        video = batch["video"]
        return self.task, tuple(video.shape), video.dtype, video.device

    def prepare(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        video = batch["video"]
        if video.dim() < 2 or video.shape[1] != 2:
            raise ValueError(f"an SSL batch holds two views, (B, 2, ...); got {tuple(video.shape)}")
        return video[:, 0], video[:, 1]

    def write_scalars(self, state: SSLTrainState, mmt: Optional[float] = None) -> None:
        if state.lr_schedule is not None:
            set_lr(state.optimizer, state.lr_schedule(state.step))
        if mmt is not None:
            if state.mmt is None:
                raise ValueError(f"the {self.task} state has no mmt tensor")
            state.mmt.fill_(mmt)

    def update(self, state: SSLTrainState, x1: torch.Tensor, x2: torch.Tensor) -> Dict[str, Any]:
        task = state.model
        task.train()
        params = [p for p in task.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss, keys = self._loss(task, x1, x2)
        loss.backward()
        for p in params:
            if p.grad is None:  # a parameter the loss does not reach: zero, as in JAX
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        if self._after is not None:
            self._after(state, keys)
        return {"loss": loss.detach()}

    def __call__(self, state: SSLTrainState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None, mmt: Optional[float] = None):
        x1, x2 = self.prepare(batch, generator)
        self.write_scalars(state, mmt)
        metrics = self.update(state, x1, x2)
        state.step += 1
        return state, metrics


def make_byol_train_step() -> SSLTrainStep:
    """BYOL (JAX ssl_app.py:50): gradients reach the online backbone and the
    predictor; after the update the momentum branch moves by the EMA at the
    state's ``mmt``."""
    return SSLTrainStep("byol", _byol_loss, _byol_after)


def make_simclr_train_step() -> SSLTrainStep:
    """SimCLR (JAX ssl_app.py:113): NT-Xent over the batch on this device."""
    return SSLTrainStep("simclr", _simclr_loss)


def make_moco_train_step() -> SSLTrainStep:
    """MoCo v2 (JAX ssl_app.py:166): InfoNCE against the queue; after the
    update the EMA at the state's ``mmt``, then the step's keys enter the
    queue."""
    return SSLTrainStep("moco_v2", _moco_loss, _moco_after)


class TwoViewTransform:
    """Applies a (stochastic) view transform twice and stacks the views:
    (2, C, T, H, W) (upstream RepeatandConverttoList + the per-view chains
    of the SSL apps)."""

    def __init__(self, view_transform: Callable):
        self.view_transform = view_transform

    def __call__(self, video) -> torch.Tensor:
        return torch.stack([torch.as_tensor(self.view_transform(video)) for _ in range(2)])


@dataclass
class SSLConfig:
    task: str = "byol"  # byol | simclr | moco_v2
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    feature_dim: int = 128
    predictor_inner: int = 512
    temperature: float = 0.2
    queue_size: int = 4096
    mmt: float = 0.994
    anneal_momentum: bool = True
    max_epochs: int = 1


class _Mlp(nn.Module):
    """SimCLR's projection in the app: Linear -> ReLU -> Linear, ``dim``
    wide (JAX ssl_app.py:306-314)."""

    def __init__(self, dim: int, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, device=device)
        self.fc2 = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class SSLTrainApp:
    """Self-supervised pretraining over the classification datamodule.

    The backbone is a hub model whose head projects to ``feature_dim``, built
    as the JAX app builds it: ``model_num_class=feature_dim`` (and, for X3D,
    the clip length and crop size). So, as in the JAX app, an MViT backbone
    raises TypeError: the MViT factory takes ``head_num_classes``. After
    :meth:`train`, :meth:`backbone_variables` is the pretrained backbone's
    ``state_dict`` for ``VideoClassificationTrainApp.load_ssl_backbone``.

    ``device``: where the task lives and the batches go (the card unless the
    caller asks for the CPU). ``seed`` seeds the datamodule's draws, the
    queue's initial draw and MoCo's shuffle generator. ``datamodule``: any
    object whose ``train_dataloader(n)`` yields ``n`` dicts ``{"video": (B,
    2, 3, T, H, W)}``; by default the two-view datamodule of ``cfg.data``
    (:meth:`_datamodule`). The LR is ``cfg.optim.lr`` throughout (the JAX app
    builds its optimizer without a schedule)."""

    def __init__(self, cfg: SSLConfig, steps_per_epoch: int = 0,
                 device: Union[str, torch.device] = "cuda", seed: int = 0, datamodule=None):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.seed = seed
        self.datamodule = datamodule
        self.state: Optional[SSLTrainState] = None
        self._loss_history = []
        self._captured_steps = CapturedSteps(self.device)

    def _build_backbone(self) -> nn.Module:
        from pytorchvideo_tpu_torch.models import hub

        factory = getattr(hub, self.cfg.model.name, None)
        if factory is None:
            raise NotImplementedError(f"hub model {self.cfg.model.name!r} is not ported yet")
        kwargs = dict(self.cfg.model.kwargs or {})
        if self.cfg.model.name.startswith("x3d"):
            # X3D's head pool is sized for the input geometry.
            kwargs.setdefault("input_clip_length", self.cfg.model.clip_length)
            kwargs.setdefault("input_crop_size", self.cfg.model.crop_size)
        return factory(model_num_class=self.cfg.feature_dim, device=self.device, **kwargs)

    def setup(self) -> SSLTrainState:
        cfg = self.cfg
        backbone = self._build_backbone()
        if cfg.task == "byol":
            task = BYOL(backbone, feature_dim=cfg.feature_dim, predictor_inner=cfg.predictor_inner,
                        mmt=cfg.mmt, device=self.device)
            self._train_step, mmt = make_byol_train_step(), cfg.mmt
        elif cfg.task == "simclr":
            task = SimCLR(_Mlp(cfg.feature_dim, device=self.device), backbone=backbone,
                          temperature=cfg.temperature)
            self._train_step, mmt = make_simclr_train_step(), None
        elif cfg.task == "moco_v2":
            task = MoCoV2(backbone, queue_size=cfg.queue_size, dim=cfg.feature_dim,
                          temperature=cfg.temperature, mmt=cfg.mmt, seed=self.seed,
                          device=self.device)
            self._train_step, mmt = make_moco_train_step(), cfg.mmt
        else:
            raise ValueError(f"unknown ssl task {cfg.task}")
        self.task = task
        self.state = ssl_train_state(task, construct_optimizer(task, cfg.optim), mmt)
        self._captured_steps = CapturedSteps(self.device)
        return self.state

    def _datamodule(self) -> VideoClassificationDataModule:
        """The classification datamodule of ``cfg.data`` whose train chain
        makes two views: as in the JAX app, the base chain runs once whose
        video is dropped (its other keys kept), then once per view, each
        with fresh draws; the views are stacked to (2, 3, T, H, W)."""
        dm = VideoClassificationDataModule(self.cfg.data, self.cfg.model, device=self.device,
                                           seed=self.seed)
        orig = dm._transform

        def two_view(mode: str, seed: Optional[int]):
            base = orig(mode, seed)
            if mode != "train":
                return base

            def transform(sample):
                out = base(dict(sample))
                out["video"] = torch.stack([base(dict(sample))["video"] for _ in range(2)])
                return out

            return transform

        dm._transform = two_view
        return dm

    def _step(self, batch: Dict[str, Any], mmt: Optional[float]):
        """One update on a device batch: captured on the card (one graph per
        batch signature, all in one memory pool), eager on the CPU."""
        scalars = {} if mmt is None else {"mmt": mmt}
        return self._captured_steps.run(self._train_step, self.state, batch, **scalars)

    def _momentum(self, step_idx: int, epoch: int) -> Optional[float]:
        """The step's EMA momentum (None for SimCLR): annealed by cosine over
        the epochs when ``anneal_momentum``, at the JAX app's exact epoch,
        ``epoch + step_idx / steps_per_epoch`` with ``step_idx`` counted over
        the whole run."""
        if self.cfg.task == "simclr":
            return None
        if not self.cfg.anneal_momentum:
            return self.cfg.mmt
        exact_epoch = epoch + (step_idx / max(1, self.steps_per_epoch)
                               if self.steps_per_epoch else 0.0)
        return momentum_anneal_cosine(self.cfg.mmt, exact_epoch, self.cfg.max_epochs)

    def train(self):
        """``max_epochs`` epochs of ``steps_per_epoch`` steps (all the
        datamodule's batches with 0); returns every step's loss so far."""
        if self.state is None:
            self.setup()
        dm = self.datamodule if self.datamodule is not None else self._datamodule()
        step_idx = 0
        for epoch in range(self.cfg.max_epochs):
            for batch in dm.train_dataloader(self.steps_per_epoch or None):
                video = torch.as_tensor(batch["video"]).to(self.device)
                self.state, metrics = self._step({"video": video},
                                                 self._momentum(step_idx, epoch))
                self._loss_history.append(float(metrics["loss"]))
                step_idx += 1
        return self._loss_history

    def backbone_variables(self) -> Dict[str, torch.Tensor]:
        """The pretrained backbone's ``state_dict`` (SimCLR's backbone, BYOL's
        and MoCo's online encoder), for classification fine-tuning."""
        if self.cfg.task == "simclr":
            return self.state.model.backbone.state_dict()
        return self.state.model.online.state_dict()
