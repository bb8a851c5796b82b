"""The default train and val transform chains (counterpart of
pytorchvideo_tpu/transforms/transforms_factory.py; upstream
pytorchvideo/transforms/transforms_factory.py:46-274,
``create_video_transform``). Clips are (T, H, W, C) tensors on any device;
with ``video_key`` the chain is wrapped in ApplyTransformToKey (and
RemoveKey)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from pytorchvideo_tpu_torch.transforms.augmix import AugMix
from pytorchvideo_tpu_torch.transforms.rand_augment import RandAugment
from pytorchvideo_tpu_torch.transforms.transforms import (
    ApplyTransformToKey,
    CenterCropVideo,
    Compose,
    ConvertUint8ToFloat,
    Normalize,
    RandomCropVideo,
    RandomHorizontalFlipVideo,
    RandomResizedCrop,
    RandomShortSideScale,
    RemoveKey,
    ShortSideScale,
    UniformTemporalSubsample,
)

_RANDAUG_DEFAULT_PARAS = {
    "magnitude": 9,
    "num_layers": 2,
    "prob": 0.5,
    "transform_hparas": None,
    "sampling_type": "gaussian",
    "sampling_hparas": None,
}

_AUGMIX_DEFAULT_PARAS = {
    "magnitude": 3,
    "alpha": 1.0,
    "width": 3,
    "depth": -1,
    "transform_hparas": None,
    "sampling_hparas": None,
}

_RANDOM_RESIZED_CROP_DEFAULT_PARAS = {
    "scale": (0.08, 1.0),
    "aspect_ratio": (3.0 / 4.0, 4.0 / 3.0),
}


def transform_seeds(seed: Optional[int], count: int) -> List[Optional[int]]:
    """``count`` seeds for a chain's random transforms, in the order they
    are built: integers drawn from ``np.random.default_rng(seed)``, or all
    None (fresh entropy) for ``seed=None``."""
    if seed is None:
        return [None] * count
    return [int(s) for s in np.random.default_rng(seed).integers(0, 2**31, count)]


def _get_augmentation(aug_type: str, aug_paras: Optional[Dict[str, Any]] = None,
                      seed: Optional[int] = None) -> List[Callable]:
    """Upstream transforms_factory.py:46-106 (the ops take THWC, so no Permute)."""
    aug_paras = aug_paras or {}
    if aug_type == "default":
        return []
    if aug_type == "randaug":
        return [RandAugment(**{k: aug_paras.get(k, v) for k, v in _RANDAUG_DEFAULT_PARAS.items()},
                            seed=seed)]
    if aug_type == "augmix":
        return [AugMix(**{k: aug_paras.get(k, v) for k, v in _AUGMIX_DEFAULT_PARAS.items()},
                       seed=seed)]
    raise NotImplementedError(f"aug_type {aug_type}")


def create_video_transform(
    mode: str,
    video_key: Optional[str] = None,
    remove_key: Optional[List[str]] = None,
    num_samples: Optional[int] = 8,
    convert_to_float: bool = True,
    video_mean: Tuple[float, float, float] = (0.45, 0.45, 0.45),
    video_std: Tuple[float, float, float] = (0.225, 0.225, 0.225),
    min_size: int = 256,
    max_size: int = 320,
    crop_size: Union[int, Tuple[int, int]] = 224,
    horizontal_flip_prob: float = 0.5,
    aug_type: str = "default",
    aug_paras: Optional[Dict[str, Any]] = None,
    random_resized_crop_paras: Optional[Dict[str, Any]] = None,
    seed: Optional[int] = None,
) -> Callable:
    """train: subsample -> (randaug | augmix) -> float -> normalize ->
    (random resized crop | random scale, crop, flip); val: subsample ->
    float -> normalize -> scale and centre crop. ``seed`` is split among
    the chain's random transforms (:func:`transform_seeds`, in the order
    they are built: the augmentation, then the scale, crop and flip, or the
    resized crop); ``None`` leaves them unseeded, as the JAX factory does."""
    if isinstance(crop_size, int):
        if crop_size > min_size:
            raise ValueError("crop_size must be <= min_size")
    elif isinstance(crop_size, tuple):
        if max(crop_size) > min_size:
            raise ValueError("crop_size must be <= min_size")
    else:
        raise TypeError(type(crop_size))
    if video_key is None and remove_key is not None:
        raise ValueError("remove_key requires video_key")
    if aug_type == "default" and aug_paras is not None:
        raise ValueError("aug_paras must be None for the default aug_type")

    seeds = iter(transform_seeds(seed, 4))
    train = mode == "train"
    augmentation = ([] if not train or aug_type == "default"
                    else _get_augmentation(aug_type, aug_paras, seed=next(seeds)))
    if not train:
        crops = [ShortSideScale(size=min_size), CenterCropVideo(size=crop_size)]
    elif random_resized_crop_paras is not None:
        paras = dict(random_resized_crop_paras)
        paras["target_height"] = crop_size
        paras["target_width"] = crop_size
        paras.setdefault("scale", _RANDOM_RESIZED_CROP_DEFAULT_PARAS["scale"])
        paras.setdefault("aspect_ratio", _RANDOM_RESIZED_CROP_DEFAULT_PARAS["aspect_ratio"])
        crops = [RandomResizedCrop(**paras, seed=next(seeds))]
    else:
        crops = [RandomShortSideScale(min_size=min_size, max_size=max_size, seed=next(seeds)),
                 RandomCropVideo(size=crop_size, seed=next(seeds)),
                 RandomHorizontalFlipVideo(p=horizontal_flip_prob, seed=next(seeds))]
    transform = Compose(
        ([] if num_samples is None else [UniformTemporalSubsample(num_samples=num_samples)])
        + augmentation
        + ([ConvertUint8ToFloat()] if convert_to_float else [])
        + [Normalize(mean=video_mean, std=video_std)]
        + crops
    )
    if video_key is None:
        return transform
    return Compose([ApplyTransformToKey(key=video_key, transform=transform)]
                   + ([] if remove_key is None else [RemoveKey(k) for k in remove_key]))
