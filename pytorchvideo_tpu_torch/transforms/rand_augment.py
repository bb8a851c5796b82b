"""RandAugment for video (counterpart of
pytorchvideo_tpu/transforms/rand_augment.py; upstream
pytorchvideo/transforms/rand_augment.py:41-101): ``num_layers`` of the 14
AugmentTransforms drawn by an OpSampler, on (T, H, W, C) tensors on any
device. The seeds of the 14 transforms and of the sampler derive from
``seed`` as in the JAX package, so one seed draws the same ops and
magnitudes there and here."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from pytorchvideo_tpu_torch.transforms.augmentations import AugmentTransform
from pytorchvideo_tpu_torch.transforms.transforms import OpSampler

_TRANSFORM_RANDAUG_MAX_PARAMS = {
    "AdjustBrightness": (1, 0.9),
    "AdjustContrast": (1, 0.9),
    "AdjustSaturation": (1, 0.9),
    "AdjustSharpness": (1, 0.9),
    "AutoContrast": None,
    "Equalize": None,
    "Invert": None,
    "Rotate": (0, 30),
    "Posterize": (4, 4),
    "Solarize": (1, 1),
    "ShearX": (0, 0.3),
    "ShearY": (0, 0.3),
    "TranslateX": (0, 0.45),
    "TranslateY": (0, 0.45),
}

SAMPLING_RANDAUG_DEFAULT_HPARAS = {
    "sampling_data_type": "int",
    "sampling_min": 0,
    "sampling_std": 0.5,
}


class RandAugment:
    """RandAugment (https://arxiv.org/abs/1909.13719) for video clips."""

    def __init__(
        self,
        magnitude: int = 9,
        num_layers: int = 2,
        prob: float = 0.5,
        transform_hparas: Optional[Dict[str, Any]] = None,
        sampling_type: str = "gaussian",
        sampling_hparas: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
    ) -> None:
        if sampling_type not in ("gaussian", "uniform"):
            raise ValueError(f"sampling_type must be 'gaussian' or 'uniform', got {sampling_type!r}")
        sampling_hparas = sampling_hparas or SAMPLING_RANDAUG_DEFAULT_HPARAS
        seeds = np.random.default_rng(seed).integers(0, 2**31, 20)
        randaug_fn = [
            AugmentTransform(
                name,
                magnitude,
                prob=prob,
                transform_max_paras=_TRANSFORM_RANDAUG_MAX_PARAMS,
                transform_hparas=transform_hparas,
                sampling_type=sampling_type,
                sampling_hparas=sampling_hparas,
                seed=int(seeds[i]),
            )
            for i, name in enumerate(_TRANSFORM_RANDAUG_MAX_PARAMS)
        ]
        self.randaug_fn = OpSampler(randaug_fn, num_sample_op=num_layers, seed=int(seeds[-1]))

    def __call__(self, video):
        return self.randaug_fn(video)
