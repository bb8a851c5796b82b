"""The data module: datasets -> batches on the device (counterpart of
pytorchvideo_tpu/train/datamodule.py; upstream
pytorchvideo_trainer/datamodule/datamodule.py:24-167).

Per phase it builds a LabeledVideoDataset over ``data_path`` (or
``val_data_path``) with the JAX package's transform chains, decodes and
transforms each clip on the host (CPU tensors, in-process or in
BatchLoader's threads), collates and hands each batch to
``device_prefetch`` (data/loader.py), which copies it to the card ahead of
the step. A batch is ``{"video": (B, 3, T, H, W) float32 or [slow, fast],
"label", "video_index", "clip_index", "aug_index"}``; the clip is made
THWC -> CTHW as a view and collated in its THWC memory order, so a batch
is ``channels_last_3d``.

The port works in float32 where the JAX module divides numpy uint8 clips
by ``255.0`` into float64. Its random draws are seeded: ``seed`` gives each
dataset (one per ``*_dataloader`` call) the seeds of its clip sampler, its
transform chain and its video order (:func:`dataset_seeds`); ``None``
draws fresh entropy, as the JAX module always does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from pytorchvideo_tpu_torch.data.clip_sampling import make_clip_sampler
from pytorchvideo_tpu_torch.data.labeled_video_dataset import labeled_video_dataset
from pytorchvideo_tpu_torch.data.loader import BatchLoader, device_prefetch
from pytorchvideo_tpu_torch.data.samplers import RandomSampler, SequentialSampler
from pytorchvideo_tpu_torch.train.config import DataConfig, ModelConfig
from pytorchvideo_tpu_torch.train.transforms import SlowFastPackPathway, default_collate
from pytorchvideo_tpu_torch.transforms import (
    ApplyTransformToKey,
    Compose,
    Normalize,
    ShortSideScale,
    UniformCropVideo,
    UniformTemporalSubsample,
    create_video_transform,
)
from pytorchvideo_tpu_torch.transforms.functional import div_255, thwc_to_cthw

_KEYS = ("video", "label", "video_index", "clip_index", "aug_index")
_MODES = ("train", "val")


def dataset_seeds(seed: Optional[int], mode: str, call: int) -> Tuple[Optional[int], ...]:
    """(clip sampler, transform chain, video sampler) seeds of the
    ``call``-th dataset of ``mode``; all None for ``seed=None``."""
    if seed is None:
        return (None, None, None)
    rng = np.random.default_rng([seed, _MODES.index(mode), call])
    return tuple(int(s) for s in rng.integers(0, 2**31, 3))


def _keep_keys(sample: Dict[str, Any]) -> Dict[str, Any]:
    return {k: sample[k] for k in _KEYS if k in sample}


class VideoClassificationDataModule:
    """Train and val datasets and their device batches from a DataConfig.

    ``num_workers`` 0 decodes in the iterating thread, in the sampler's
    order (the JAX module's); more decode in BatchLoader's threads.
    ``device``: where the batches go (the card unless the caller asks for
    the CPU)."""

    def __init__(self, data: DataConfig, model: Optional[ModelConfig] = None,
                 num_workers: int = 0, device: Union[str, torch.device] = "cuda",
                 seed: Optional[int] = None):
        self.cfg = data
        self.model_cfg = model or ModelConfig()
        self.num_workers = num_workers
        self.device = torch.device(device)
        self.seed = seed
        self._calls = {mode: 0 for mode in _MODES}

    def _transform(self, mode: str, seed: Optional[int]) -> Callable:
        cfg = self.cfg
        if mode != "train" and cfg.val_3crop:
            # The model zoo's "x3 views": the short side scaled to the crop,
            # then left, centre and right crops keyed by the sampler's
            # aug_index.
            t = Compose([UniformTemporalSubsample(cfg.num_samples),
                         Normalize(cfg.video_mean, cfg.video_std),
                         ShortSideScale(cfg.crop_size)])
            steps = [ApplyTransformToKey("video", Compose([div_255, t])),
                     UniformCropVideo(cfg.crop_size),
                     ApplyTransformToKey("video", thwc_to_cthw)]
        else:
            t = create_video_transform(
                mode, num_samples=cfg.num_samples, convert_to_float=False,
                video_mean=cfg.video_mean, video_std=cfg.video_std, min_size=cfg.min_size,
                max_size=cfg.max_size, crop_size=cfg.crop_size,
                aug_type=cfg.aug_type if mode == "train" else "default", seed=seed)
            steps = [ApplyTransformToKey("video", Compose([div_255, t, thwc_to_cthw]))]
        if self.model_cfg.slowfast_alpha:
            steps.append(ApplyTransformToKey("video",
                                             SlowFastPackPathway(self.model_cfg.slowfast_alpha)))
        steps.append(_keep_keys)
        return Compose(steps)

    def _dataset(self, mode: str):
        cfg = self.cfg
        clip_seed, transform_seed, sampler_seed = dataset_seeds(self.seed, mode,
                                                                self._calls[mode])
        self._calls[mode] += 1
        path = cfg.data_path if mode == "train" else (cfg.val_data_path or cfg.data_path)
        if mode == "train":
            clip_sampler = make_clip_sampler("random", cfg.clip_duration,
                                             np.random.default_rng(clip_seed))
        else:
            clip_sampler = make_clip_sampler("constant_clips_per_video", cfg.clip_duration,
                                             cfg.clips_per_video, 3 if cfg.val_3crop else 1)
        return labeled_video_dataset(
            path, clip_sampler,
            video_sampler=RandomSampler if mode == "train" else SequentialSampler,
            transform=self._transform(mode, transform_seed), decoder=cfg.decoder,
            seed=sampler_seed)

    def _batches(self, dataset, steps: Optional[int]) -> Iterator[Dict[str, Any]]:
        """Collated host batches: at most ``steps``, full ones only."""
        if self.num_workers > 0:
            loader = iter(BatchLoader(dataset, self.cfg.batch_size, self.num_workers))
            try:
                for produced, batch in enumerate(loader):
                    if steps is not None and produced >= steps:
                        return
                    yield batch
            finally:
                loader.close()
            return
        it = iter(dataset)
        produced = 0
        while steps is None or produced < steps:
            samples = []
            try:
                for _ in range(self.cfg.batch_size):
                    samples.append(next(it))
            except (StopIteration, RuntimeError):
                pass
            if len(samples) < self.cfg.batch_size:
                return
            yield default_collate(samples)
            produced += 1

    def train_dataloader(self, steps: Optional[int] = None):
        """An iterator of at most ``steps`` train batches on the device."""
        return device_prefetch(self._batches(self._dataset("train"), steps), self.device)

    def val_dataloader(self, steps: Optional[int] = None):
        """An iterator of at most ``steps`` val batches on the device."""
        return device_prefetch(self._batches(self._dataset("val"), steps), self.device)
