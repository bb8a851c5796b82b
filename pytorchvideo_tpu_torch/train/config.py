"""Trainer configuration as dataclasses (counterpart of
pytorchvideo_tpu/train/config.py; upstream train_app.py:229-253 and its
conf/ yaml tree), serialisable to json and built back from nested dicts
(parsed json or yaml) by :func:`config_from_dict`."""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig
from pytorchvideo_tpu_torch.train.optimizer import OptimizerConfig


@dataclass
class ModelConfig:
    name: str = "slow_r50"  # a pytorchvideo_tpu_torch.models.hub factory name
    num_classes: int = 400
    kwargs: Dict[str, Any] = field(default_factory=dict)
    clip_length: int = 8
    crop_size: int = 224
    slowfast_alpha: Optional[int] = None


@dataclass
class DataConfig:
    """The data layer's settings: what the app's default datamodule
    (train/datamodule.py) reads, and how it transforms the clips."""

    data_path: str = ""
    val_data_path: str = ""
    clip_duration: float = 2.0
    clips_per_video: int = 1
    batch_size: int = 8
    num_samples: Optional[int] = 8
    min_size: int = 256
    max_size: int = 320
    crop_size: int = 224
    aug_type: str = "default"
    val_3crop: bool = False
    video_mean: Tuple[float, float, float] = (0.45, 0.45, 0.45)
    video_std: Tuple[float, float, float] = (0.225, 0.225, 0.225)
    decoder: str = "opencv"


@dataclass
class MixConfig:
    enabled: bool = False
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    cutmix_prob: float = 0.5
    label_smoothing: float = 0.1


@dataclass
class TrainerConfig:
    max_epochs: int = 1
    clip_grad_norm: Optional[float] = None
    precise_bn_batches: int = 0
    checkpoint_dir: Optional[str] = None
    log_dir: Optional[str] = None  # metrics.jsonl output
    log_every_n_steps: int = 10
    test_ensemble_method: str = "sum"
    # "float32" | "bfloat16": the forward/backward dtype; f32 masters and
    # optimizer state either way.
    compute_dtype: str = "float32"
    remat_policy: Optional[str] = None
    grad_accum_steps: int = 1


@dataclass
class VideoClassificationTrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    mix: MixConfig = field(default_factory=MixConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def _from_dict(cls, data: Dict[str, Any]):
    """``cls`` from the nested dict ``data``: keys that are not fields of
    ``cls`` are ignored, missing ones keep their defaults, dataclass fields
    are built from their dicts, and a list where the field is a tuple (as
    json writes a tuple) becomes a tuple."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = _from_dict(ftype, value)
        elif isinstance(value, list) and tuple in (typing.get_origin(ftype), ftype):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def config_from_dict(data: Dict[str, Any]) -> VideoClassificationTrainConfig:
    """The full train config from a nested dict (JAX config.py:104)."""
    return _from_dict(VideoClassificationTrainConfig, data)


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str) -> None:
    """Writes the resolved config as json, for reproducibility."""
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, default=str)
