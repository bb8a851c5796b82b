"""Named training presets (counterpart of pytorchvideo_tpu/train/presets.py;
upstream pytorchvideo_trainer/conf/*.yaml), as data: each preset returns a
``VideoClassificationTrainConfig`` with the reference's published
hyperparameters, and keyword overrides on dotted paths (e.g.
``**{"trainer.compute_dtype": "bfloat16"}``) replace any field after
composition. The port trains the four classification recipes
(``classification_slow_8x8_r50``, ``classification_slowfast_8x8_r50``,
``classification_x3d_xs``, ``classification_mvit_16x4``; X3D-S through a
``model.name`` override). The three SSL recipes return dicts as the JAX
package's do; their keys (``backbone``, ``projector_dims``, ``momentum``,
``k``, ``batch_shuffle``) are not ``SSLConfig``'s fields
(train/ssl_app.py), so a caller maps them, and their ``optimizer`` builds
with ``construct_optimizer`` (LARS for BYOL and SimCLR).
"""

from __future__ import annotations

from typing import Any, Dict

from pytorchvideo_tpu_torch.train.config import (
    DataConfig,
    MixConfig,
    ModelConfig,
    TrainerConfig,
    VideoClassificationTrainConfig,
)
from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig
from pytorchvideo_tpu_torch.train.optimizer import OptimizerConfig


def _apply_overrides(cfg, overrides: Dict[str, Any]):
    """Dotted-path overrides, e.g. {"optim.lr": 0.1, "data.batch_size": 8}."""
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise AttributeError(f"unknown config field: {key}")
        setattr(obj, parts[-1], value)
    return cfg


def classification_slow_8x8_r50(**overrides) -> VideoClassificationTrainConfig:
    """Slow 8x8 R50 Kinetics recipe (conf/classification_slow_8x8_r50.yaml:
    lr 0.8, nesterov SGD, cosine 196 epochs, warmup 34 from 0.01)."""
    cfg = VideoClassificationTrainConfig(
        model=ModelConfig(name="slow_r50", clip_length=8, crop_size=224),
        data=DataConfig(clip_duration=8 * 8 / 30.0, batch_size=16,
                        num_samples=8),
        optim=OptimizerConfig(method="sgd", lr=0.8, nesterov=True,
                              weight_decay=1e-4),
        lr_scheduler=LRSchedulerConfig(
            lr_policy="cosine", lr=0.8, max_iters=196, warmup_iters=34,
            warmup_start_lr=0.01,
        ),
        trainer=TrainerConfig(max_epochs=196, precise_bn_batches=200,
                              test_ensemble_method="sum"),
    )
    return _apply_overrides(cfg, overrides)


def classification_slowfast_8x8_r50(**overrides) -> VideoClassificationTrainConfig:
    """SlowFast 8x8 R50 recipe (conf/classification_slowfast_8x8_r50.yaml:
    same schedule as Slow; fast pathway alpha=4)."""
    cfg = classification_slow_8x8_r50()
    cfg.model = ModelConfig(
        name="slowfast_r50", clip_length=32, crop_size=224, slowfast_alpha=4
    )
    cfg.data.num_samples = 32
    return _apply_overrides(cfg, overrides)


def classification_x3d_xs(**overrides) -> VideoClassificationTrainConfig:
    """X3D-XS recipe (conf/classification_x3d_xs.yaml: lr 0.8 nesterov,
    wd 5e-5, cosine 300 epochs, warmup 35 from 0.01, clip 1.6 s)."""
    cfg = VideoClassificationTrainConfig(
        model=ModelConfig(name="x3d_xs", clip_length=4, crop_size=160),
        data=DataConfig(clip_duration=1.6, batch_size=16, num_samples=4,
                        min_size=182, max_size=228, crop_size=160),
        optim=OptimizerConfig(method="sgd", lr=0.8, nesterov=True,
                              weight_decay=5e-5),
        lr_scheduler=LRSchedulerConfig(
            lr_policy="cosine", lr=0.8, max_iters=300, warmup_iters=35,
            warmup_start_lr=0.01,
        ),
        trainer=TrainerConfig(max_epochs=300, precise_bn_batches=200,
                              test_ensemble_method="sum"),
    )
    return _apply_overrides(cfg, overrides)


def classification_mvit_16x4(**overrides) -> VideoClassificationTrainConfig:
    """MViT-B 16x4 recipe (conf/classification_mvit_16x4.yaml: AdamW lr
    1.6e-3, wd 0.05, zero-wd 1d params, cosine-after-warmup 200 epochs,
    warmup 30 from 1.6e-5, grad clip 1.0, MixUp/CutMix batch transform)."""
    cfg = VideoClassificationTrainConfig(
        model=ModelConfig(name="mvit_base_16x4", clip_length=16,
                          crop_size=224),
        data=DataConfig(clip_duration=16 * 4 / 30.0, batch_size=2,
                        num_samples=16, aug_type="randaug"),
        optim=OptimizerConfig(method="adamw", lr=0.0016, weight_decay=0.05,
                              zero_weight_decay_1d_param=True),
        lr_scheduler=LRSchedulerConfig(
            lr_policy="cosine", lr=0.0016, max_iters=200, warmup_iters=30,
            warmup_start_lr=1.6e-5, cosine_after_warmup=True,
            cosine_end_lr=1.6e-5,
        ),
        mix=MixConfig(enabled=True, mixup_alpha=0.8, cutmix_alpha=1.0,
                      cutmix_prob=0.5, label_smoothing=0.1),
        trainer=TrainerConfig(max_epochs=200, clip_grad_norm=1.0,
                              test_ensemble_method="sum"),
    )
    return _apply_overrides(cfg, overrides)


def byol_train_app_conf(**overrides) -> Dict[str, Any]:
    """BYOL SSL recipe (conf/byol_train_app_conf.yaml), as a dict:
    momentum annealed cosine on, LARS."""
    cfg = dict(
        backbone="slow_r50",
        projector_dims=(2048, 4096, 256),
        momentum=0.996,
        momentum_anneal_cosine=True,
        optimizer=OptimizerConfig(method="sgd", lr=4.8, nesterov=False,
                                  weight_decay=1e-6, lars_on=True,
                                  zero_weight_decay_1d_param=True),
    )
    cfg.update(overrides)
    return cfg


def simclr_train_app_conf(**overrides) -> Dict[str, Any]:
    """SimCLR SSL recipe (conf/simclr_train_app_conf.yaml)."""
    cfg = dict(
        backbone="slow_r50",
        projector_dims=(2048, 2048, 128),
        temperature=0.1,
        optimizer=OptimizerConfig(method="sgd", lr=4.8, nesterov=False,
                                  weight_decay=1e-6, lars_on=True,
                                  zero_weight_decay_1d_param=True),
    )
    cfg.update(overrides)
    return cfg


def moco_v2_train_app_conf(**overrides) -> Dict[str, Any]:
    """MoCo-v2 SSL recipe (conf/moco_v2_train_app_conf.yaml: queue k=65536,
    batch shuffle on)."""
    cfg = dict(
        backbone="slow_r50",
        dim=128,
        k=65536,
        momentum=0.994,
        temperature=0.07,
        batch_shuffle=True,
        optimizer=OptimizerConfig(method="sgd", lr=0.4, nesterov=False,
                                  weight_decay=1e-4),
    )
    cfg.update(overrides)
    return cfg


PRESETS = {
    "classification_slow_8x8_r50": classification_slow_8x8_r50,
    "classification_slowfast_8x8_r50": classification_slowfast_8x8_r50,
    "classification_x3d_xs": classification_x3d_xs,
    "classification_mvit_16x4": classification_mvit_16x4,
    "byol_train_app_conf": byol_train_app_conf,
    "simclr_train_app_conf": simclr_train_app_conf,
    "moco_v2_train_app_conf": moco_v2_train_app_conf,
}


def get_preset(name: str, **overrides):
    """Look up a preset by its reference yaml name."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](**overrides)
