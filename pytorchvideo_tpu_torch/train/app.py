"""VideoClassificationTrainApp: the training entry point (counterpart of
pytorchvideo_tpu/train/app.py; upstream pytorchvideo_trainer/train_app.py
and module/video_classification.py: per-step LR :161-180, grad clip
:219-222, batch MixVideo :210).

It builds the model from the config (on ``device``, the card unless the
caller asks for the CPU), its optimizer groups and LR schedule, and the
train step of train/train_loop.py, then walks the datamodule's batches.
Checkpoints are ``torch.save`` files.

On the card every step runs captured, as the JAX app always runs its jitted
step: one :class:`~pytorchvideo_tpu_torch.train.compiled_step.CompiledTrainStep`
per batch signature, whose first ``WARMUP_STEPS`` batches are eager
updates and whose next batch captures the update, all graphs in one memory
pool; and the eval pass replays one ``CompiledForward`` (accelerate/deploy.py)
of the eval-mode model per clip shape, in the same pool. A capture that fails raises. On the CPU the steps run eagerly (the
eager step stays public through ``make_train_step``). ``load_checkpoint``
drops the graphs, since loading rebinds the optimizer's state, and the next
batches capture anew.

It trains the BatchNorm models (X3D, Slow, SlowFast and the other ResNet
builders) and MViT. With ``trainer.precise_bn_batches > 0`` each epoch ends
with precise BN over that many fresh training batches
(train/precise_batchnorm.py). ``test()`` ensembles the clips of each video
(``trainer.test_ensemble_method``) and ``predict()`` returns per-clip logits.
``load_ssl_backbone`` grafts a self-supervised backbone onto the model.

Without a ``datamodule`` the app builds the
:class:`~pytorchvideo_tpu_torch.train.datamodule.VideoClassificationDataModule`
of ``config.data`` and ``config.model``, as the JAX app does, whose batches
arrive on the app's device through its prefetch. Any other datamodule
works whose ``train_dataloader(n)`` yields ``n`` dicts ``{"video": (B, 3,
T, H, W), or the list [slow, fast] of them, "label": (B,)}`` (tensors or
numpy arrays, on the device or the host) and whose
``val_dataloader(None)`` yields such dicts with a ``"video_index"`` (and
optionally a ``"clip_index"``) per clip.

Data parallelism. Where a default ``torch.distributed`` process group is
initialised when the app is made (one process per GPU,
``parallel.init_distributed_training``), the app builds a data mesh over
it (``self.mesh``), as the JAX app builds one over every device, and runs
the JAX app's global-batch semantics on it: every rank reads the same
global batches (the datamodule's, seeded alike) and steps on its rows
(``parallel.shard_batch``); its BatchNorms take the world group, so their
statistics are the global batch's; the step averages the gradients and
metrics over the group before the clip (train/train_loop.py), inside the
captured graph on the card. MixUp and CutMix flip the global batch, so
under MixUp each rank's rows are the mirrored layout
(``parallel.batch_rows``) whose local flip pairs each row with its global
partner; every rank draws lambda and the box from its generator, seeded
alike. A batch that the ranks do not divide is replicated (each rank
steps on all of it, the JAX app's fallback); one they divide whose
microbatches or mirrored shares do not split raises ValueError, naming
the constraint. The eval pass runs each rank's rows and gathers the
logits. Every rank must run the same calls.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import torch
import torch.distributed as dist

from pytorchvideo_tpu_torch.accelerate.deploy import CompiledForward
from pytorchvideo_tpu_torch.layers.batch_norm import set_sync_group
from pytorchvideo_tpu_torch.parallel import cat_all_gather, make_mesh, shard_batch
from pytorchvideo_tpu_torch.train.compiled_step import CapturedSteps
from pytorchvideo_tpu_torch.train.config import VideoClassificationTrainConfig, save_config
from pytorchvideo_tpu_torch.train.datamodule import VideoClassificationDataModule
from pytorchvideo_tpu_torch.train.logger import MetricsLogger
from pytorchvideo_tpu_torch.train.optimizer import (
    construct_optimizer,
    load_optimizer_state,
    lr_schedule_from_config,
)
from pytorchvideo_tpu_torch.train.precise_batchnorm import update_bn_stats
from pytorchvideo_tpu_torch.train.train_loop import (
    TrainState,
    ensemble_video_level,
    make_eval_step,
    make_train_step,
    map_video,
)
from pytorchvideo_tpu_torch.train.transforms import MixVideoBatchWrapper
from pytorchvideo_tpu_torch.utils.profiling import annotate, count

logger = logging.getLogger(__name__)


class VideoClassificationTrainApp:
    """Assembles model, data, optimizer and step from the config and runs
    the loop.

    ``seed`` seeds the CPU generator of the batch transform's random scalars
    (MixUp's lambda, the CutMix box, the MixUp/CutMix coin) and, when the
    app builds its datamodule, the datamodule's draws."""

    def __init__(
        self,
        config: VideoClassificationTrainConfig,
        model: Optional[torch.nn.Module] = None,
        datamodule=None,
        steps_per_epoch: int = 100,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        self.cfg = config
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.model = model if model is not None else self._build_model()
        self.datamodule = datamodule if datamodule is not None else VideoClassificationDataModule(
            config.data, config.model, device=self.device, seed=seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.mesh = make_mesh((-1,), ("data",)) if dist.is_initialized() else None
        if self.mesh is not None:
            set_sync_group(self.model, self._group())
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = make_eval_step()
        self._drop_graphs()

    def _group(self):
        """The data axis's process group (None without a mesh)."""
        return None if self.mesh is None else self.mesh.get_group("data")

    def _drop_graphs(self) -> None:
        """Forget every captured graph (the card's train steps by batch
        signature, eval forwards by clip shape) and their memory pool."""
        self._captured_steps = CapturedSteps(self.device)
        self._captured_evals: Dict[tuple, CompiledForward] = {}

    def _step(self, batch: Dict[str, Any]):
        """One update on a device batch: captured on the card, eager on the CPU."""
        return self._captured_steps.run(self._train_step, self.state, batch, self.generator)

    def _evaluate(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Eval-mode logits of a device batch: a replayed ``CompiledForward``
        on the card, the eager eval step on the CPU."""
        if self.device.type != "cuda":
            return self._eval_step(self.state, batch)
        video = batch["video"]
        key = tuple((tuple(t.shape), t.dtype) for t in
                    (video if isinstance(video, (list, tuple)) else [video]))
        self.state.model.eval()
        forward = self._captured_evals.get(key)
        if forward is None:
            forward = CompiledForward(self.state.model, video,
                                      pool=self._captured_steps.graph_pool())
            self._captured_evals[key] = forward
        return forward(video)

    def _build_model(self):
        from pytorchvideo_tpu_torch.models import hub

        name = self.cfg.model.name
        factory = getattr(hub, name, None)
        if factory is None:
            raise NotImplementedError(f"hub model {name!r} is not ported yet")
        kwargs = dict(self.cfg.model.kwargs)
        if name.startswith("mvit"):
            kwargs.setdefault("head_num_classes", self.cfg.model.num_classes)
        else:
            kwargs.setdefault("model_num_class", self.cfg.model.num_classes)
            if name.startswith("x3d"):
                kwargs.setdefault("input_clip_length", self.cfg.model.clip_length)
                kwargs.setdefault("input_crop_size", self.cfg.model.crop_size)
        return factory(device=self.device, **kwargs)

    def setup(self) -> TrainState:
        trainer = self.cfg.trainer
        optimizer = construct_optimizer(self.model, self.cfg.optim)
        schedule = lr_schedule_from_config(self.cfg.lr_scheduler, self.steps_per_epoch)
        self.state = TrainState(self.model, optimizer, schedule)
        batch_transform = None
        if self.cfg.mix.enabled:
            batch_transform = MixVideoBatchWrapper(
                mixup_alpha=self.cfg.mix.mixup_alpha,
                cutmix_prob=self.cfg.mix.cutmix_prob,
                cutmix_alpha=self.cfg.mix.cutmix_alpha,
                label_smoothing=self.cfg.mix.label_smoothing,
                num_classes=self.cfg.model.num_classes,
            ).mix_video_transform
        compute_dtype = (None if trainer.compute_dtype in (None, "", "float32")
                         else getattr(torch, trainer.compute_dtype))
        self._train_step = make_train_step(
            batch_transform=batch_transform,
            clip_grad_norm=trainer.clip_grad_norm,
            compute_dtype=compute_dtype,
            remat_policy=trainer.remat_policy,
            grad_accum_steps=trainer.grad_accum_steps,
            process_group=self._group(),
        )
        return self.state

    def _on_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's clip (each pathway of a list), labels and, where
        present, video and clip indices, on the app's device: a tensor
        already there (the datamodule's prefetch put it there) as it is,
        anything else copied."""
        return {key: map_video(lambda a: torch.as_tensor(a).to(self.device), batch[key])
                for key in ("video", "label", "video_index", "clip_index") if key in batch}

    def _rows(self, batch: Dict[str, Any], train: bool) -> Dict[str, Any]:
        """This rank's rows of a device batch: for a training batch split
        as the step splits it into microbatches, mirrored under MixUp (see
        the module docstring); the whole batch where the ranks do not
        divide it, or without a mesh."""
        if self.mesh is None or len(batch["label"]) % self.mesh.size():
            return batch  # replicated: correct, just not data-parallel
        kwargs = dict(microbatches=self.cfg.trainer.grad_accum_steps,
                      mirrored=self.cfg.mix.enabled) if train else {}
        return shard_batch(batch, self.mesh, **kwargs)

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a training batch, on the app's device."""
        return self._rows(self._on_device(batch), train=True)

    def train(self):
        """Runs ``trainer.max_epochs`` epochs of ``steps_per_epoch`` steps;
        returns the losses logged (every ``log_every_n_steps`` steps).
        Repeated calls continue the same state and schedule.

        Spans (utils/profiling.py): ``pvt.train.batch`` (the batch to the
        device), the step's own, and at a logged step ``pvt.train.log`` (the
        loss read back to the host, counted in ``train.host_reads``)."""
        if self.state is None:
            self.setup()
        trainer = self.cfg.trainer
        mlog = MetricsLogger(trainer.log_dir)
        history = []
        global_step = 0
        for epoch in range(trainer.max_epochs):
            t0 = time.time()
            for step, batch in enumerate(self.datamodule.train_dataloader(self.steps_per_epoch)):
                with annotate("pvt.train.batch", step=self.state.step):
                    batch = self._device_batch(batch)
                self.state, metrics = self._step(batch)
                if step % trainer.log_every_n_steps == 0:
                    # The LR of the update just made (the schedule's index
                    # is the update count before it).
                    update = self.state.step - 1
                    with annotate("pvt.train.log", step=update):
                        count("train.host_reads")
                        history.append(float(metrics["loss"]))
                        lr = self.state.lr_schedule(update)
                        mlog.log({**metrics, "exact_epoch": epoch + step / self.steps_per_epoch,
                                  "lr": lr}, step=global_step, epoch=epoch)
                global_step += 1
            if trainer.precise_bn_batches > 0:
                update_bn_stats(self.state.model,
                                (self._device_batch(b) for b in
                                 self.datamodule.train_dataloader(trainer.precise_bn_batches)),
                                trainer.precise_bn_batches)
            logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
            if trainer.checkpoint_dir:
                self.save_checkpoint(epoch)
        mlog.close()
        return history

    def _val_batches(self, max_batches: Optional[int] = None):
        """(device batch, eval logits) over ``datamodule.val_dataloader(None)``;
        with a mesh each rank evaluates its rows and the logits are gathered."""
        if self.state is None:
            raise RuntimeError("call setup() or train() first")
        for n, batch in enumerate(self.datamodule.val_dataloader(None)):
            if max_batches is not None and n >= max_batches:
                return
            whole = self._on_device(batch)
            rows = self._rows(whole, train=False)
            logits = self._evaluate(rows)
            if rows is not whole:
                logits = cat_all_gather(logits, self._group())
            yield whole, logits

    def test(self, num_videos: Optional[int] = None) -> Dict[str, float]:
        """Multi-clip test (upstream module/video_classification.py:275-311):
        each video's clips ensembled by ``trainer.test_ensemble_method``,
        then the video-level top-1 over the videos seen ({} without any).
        ``num_videos`` defaults to the largest video index + 1."""
        logits_list, index_list, labels = [], [], {}
        for batch, logits in self._val_batches():
            logits_list.append(logits)
            index_list.append(batch["video_index"])
            labels.update(zip(batch["video_index"].tolist(), batch["label"].tolist()))
        if not logits_list:
            return {}
        ensembled = ensemble_video_level(logits_list, index_list, num_videos or max(labels) + 1,
                                         self.cfg.trainer.test_ensemble_method)
        seen = sorted(labels)
        predictions = ensembled[seen].argmax(-1).cpu()
        truth = torch.tensor([labels[v] for v in seen])
        return {"video_top1": (predictions == truth).float().mean().item()}

    def predict(self, max_batches: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
        """Per-clip predictions over the val set (upstream train_app.py:184-209):
        a dict of host tensors per batch, "logits", "video_index",
        "clip_index" (empty where the batch has none) and "label"."""
        return [{"logits": logits.cpu(),
                 "video_index": batch["video_index"].cpu(),
                 "clip_index": batch.get("clip_index", torch.zeros(0, dtype=torch.long)).cpu(),
                 "label": batch["label"].cpu()}
                for batch, logits in self._val_batches(max_batches)]

    def save_checkpoint(self, step: int) -> str:
        """Writes model, optimizer and update count to
        ``<checkpoint_dir>/ckpt_<step>.pt`` and the config beside it;
        returns the checkpoint's path."""
        directory = self.cfg.trainer.checkpoint_dir
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"ckpt_{step}.pt")
        torch.save({"model": self.state.model.state_dict(),
                    "optimizer": self.state.optimizer.state_dict(),
                    "step": self.state.step}, path)
        save_config(self.cfg, os.path.join(directory, "config.json"))
        return path

    def load_checkpoint(self, path: str) -> TrainState:
        """Restores model, optimizer and update count from ``path``; the
        captured graphs are dropped (the optimizer's state tensors are new)."""
        if self.state is None:
            self.setup()
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self._drop_graphs()
        self.state.model.load_state_dict(ckpt["model"])
        load_optimizer_state(self.state.optimizer, ckpt["optimizer"])
        self.state.step = int(ckpt["step"])
        return self.state

    def load_ssl_backbone(self, state_dict: Mapping[str, torch.Tensor]) -> int:
        """SSL -> classification surgery (JAX train/app.py ``load_ssl_backbone``;
        upstream module/ssl_helper.py:67): copies in place every tensor of a
        pretrained backbone's ``state_dict`` whose key and shape match this
        model's, parameters and BatchNorm running stats alike, and keeps the
        freshly initialised classifier. The head's final projection
        (``head.proj`` for MViT, the last block's ``proj`` for the ResNet
        family and X3D) is excluded by name, so an SSL feature width that
        equals ``num_classes`` cannot overwrite the classifier;
        ``num_batches_tracked`` stays this model's own count (the JAX
        package keeps none). Call after ``setup()``; returns the number of
        tensors grafted."""
        if self.state is None:
            raise RuntimeError("call setup() first")
        ours = self.state.model.state_dict()
        blocks = [int(m.group(1)) for m in map(re.compile(r"blocks\.(\d+)\.").match, ours) if m]
        head = "head" if any(k.startswith("head.") for k in ours) else (
            f"blocks.{max(blocks)}" if blocks else None)
        grafted = 0
        with torch.no_grad():
            for key, theirs in state_dict.items():
                target = ours.get(key)
                if (target is None or key.endswith("num_batches_tracked")
                        or (head is not None and key.startswith(f"{head}.proj."))
                        or tuple(target.shape) != tuple(theirs.shape)):
                    continue
                target.copy_(torch.as_tensor(theirs))
                grafted += 1
        return grafted
