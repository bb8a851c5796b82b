"""AugMix for video (counterpart of pytorchvideo_tpu/transforms/augmix.py;
upstream pytorchvideo/transforms/augmix.py:56-147): ``width`` chains of
augmentations mixed by Dirichlet weights, then blended with the clip by a
Beta-distributed weight, on (T, H, W, C) tensors on any device. The
weights are numpy draws on the host, as in the JAX package."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from pytorchvideo_tpu_torch.transforms.augmentations import (
    _AUGMENTATION_MAX_LEVEL,
    AugmentTransform,
)
from pytorchvideo_tpu_torch.transforms.transforms import OpSampler

_AUGMIX_LEVEL_TO_ARG = {
    "AutoContrast": None,
    "Equalize": None,
    "Rotate": "inc_neg",
    "Posterize": "dec_int",
    "Solarize": "dec",
    "ShearX": "inc_neg",
    "ShearY": "inc_neg",
    "TranslateX": "inc_neg",
    "TranslateY": "inc_neg",
    "AdjustSaturation": "inc",
    "AdjustContrast": "inc",
    "AdjustBrightness": "inc",
    "AdjustSharpness": "inc",
}

_TRANSFORM_AUGMIX_MAX_PARAMS = {
    "AutoContrast": None,
    "Equalize": None,
    "Rotate": (0, 30),
    "Posterize": (4, 4),
    "Solarize": (1, 1),
    "ShearX": (0, 0.3),
    "ShearY": (0, 0.3),
    "TranslateX": (0, 1.0 / 3.0),
    "TranslateY": (0, 1.0 / 3.0),
    "AdjustSaturation": (0.1, 1.8),
    "AdjustContrast": (0.1, 1.8),
    "AdjustBrightness": (0.1, 1.8),
    "AdjustSharpness": (0.1, 1.8),
}

SAMPLING_AUGMIX_DEFAULT_HPARAS = {"sampling_data_type": "float", "sampling_min": 0.1}


class AugMix:
    """AugMix (https://arxiv.org/pdf/1912.02781.pdf) for video clips."""

    def __init__(
        self,
        magnitude: int = 3,
        alpha: float = 1.0,
        width: int = 3,
        depth: int = -1,
        transform_hparas: Optional[Dict[str, Any]] = None,
        sampling_hparas: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
    ) -> None:
        if not isinstance(magnitude, int) or not 1 <= magnitude <= _AUGMENTATION_MAX_LEVEL:
            raise ValueError(f"magnitude must be an int in [1, {_AUGMENTATION_MAX_LEVEL}]")
        if not (alpha > 0.0 and width > 0):
            raise ValueError(f"need alpha > 0 and width > 0, got {alpha}, {width}")
        self._alpha = alpha
        self._width = width
        self._rng = np.random.default_rng(seed)
        seeds = self._rng.integers(0, 2**31, 20)
        transforms_list = [
            AugmentTransform(
                transform_name=name,
                magnitude=magnitude,
                prob=1.0,
                level_to_arg=_AUGMIX_LEVEL_TO_ARG,
                transform_max_paras=_TRANSFORM_AUGMIX_MAX_PARAMS,
                transform_hparas=transform_hparas,
                sampling_type="uniform",
                sampling_hparas=sampling_hparas or SAMPLING_AUGMIX_DEFAULT_HPARAS,
                seed=int(seeds[i]),
            )
            for i, name in enumerate(_TRANSFORM_AUGMIX_MAX_PARAMS)
        ]
        if depth > 0:
            self.augmix_fn = OpSampler(transforms_list, num_sample_op=depth, replacement=True,
                                       seed=int(seeds[-1]))
        else:
            self.augmix_fn = OpSampler(transforms_list, num_sample_op=3,
                                       randomly_sample_depth=True, replacement=True,
                                       seed=int(seeds[-1]))

    def __call__(self, video: torch.Tensor) -> torch.Tensor:
        mixing_weights = self._rng.dirichlet([self._alpha] * self._width)
        m = self._rng.beta(self._alpha, self._alpha)
        mixed = torch.zeros(video.shape, dtype=torch.float32, device=video.device)
        for mw in mixing_weights:
            # numpy: a float64 weight times a float32 clip is float64, added
            # into the float32 sum.
            mixed = (mixed.double() + self.augmix_fn(video).float().double() * float(mw)).float()
        out = video.float() * float(m) + mixed * (1.0 - float(m))
        return out.to(video.dtype)
