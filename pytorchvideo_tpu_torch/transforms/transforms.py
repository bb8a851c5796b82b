"""Dict- and tensor-level transform classes (counterpart of
pytorchvideo_tpu/transforms/transforms.py; upstream
pytorchvideo/transforms/transforms.py:10-430).

Clips are (T, H, W, C) tensors on any device; pass ``data_format="CTHW"``
to a tensor transform to take and give upstream's (C, T, H, W). A random
transform holds a ``numpy.random.Generator`` seeded from ``seed`` and makes
the JAX package's draws, in its order, on the host: one seed gives the
same crop, scale, flip and op choice as the JAX transform. The arithmetic
runs where the clip is (transforms/functional.py). ``Div255`` and
``Normalize``, on the served path, open a span each call,
``pvt.transform.<class>`` (utils/profiling.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorchvideo_tpu_torch.transforms import functional as F
from pytorchvideo_tpu_torch.utils.profiling import annotate


class Compose:
    """Apply callables in turn (torchvision's Compose)."""

    def __init__(self, transforms: List[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class _Layout:
    """CTHW <-> THWC adaptation of the tensor transforms."""

    def __init__(self, data_format: str = "THWC"):
        if data_format not in ("THWC", "CTHW"):
            raise ValueError(f"data_format must be 'THWC' or 'CTHW', got {data_format!r}")
        self._cthw = data_format == "CTHW"

    def _to_native(self, x):
        return F.cthw_to_thwc(x) if self._cthw else x

    def _from_native(self, x):
        return F.thwc_to_cthw(x) if self._cthw else x


class ApplyTransformToKey:
    """Apply ``transform`` to ``sample[key]`` (upstream transforms.py:10-31)."""

    def __init__(self, key: str, transform: Callable):
        self._key = key
        self._transform = transform

    def __call__(self, x: Dict[str, Any]) -> Dict[str, Any]:
        x[self._key] = self._transform(x[self._key])
        return x


class RemoveKey:
    """Remove ``key`` from the sample dict (upstream transforms.py:34-51)."""

    def __init__(self, key: str):
        self._key = key

    def __call__(self, x: Dict[str, Any]) -> Dict[str, Any]:
        x.pop(self._key, None)
        return x


class UniformTemporalSubsample(_Layout):
    """Upstream transforms.py:54-76."""

    def __init__(self, num_samples: int, data_format: str = "THWC"):
        super().__init__(data_format)
        self._num_samples = num_samples

    def __call__(self, x):
        return F.uniform_temporal_subsample(x, self._num_samples, -3 if self._cthw else -4)


class UniformTemporalSubsampleRepeated(_Layout):
    """Upstream transforms.py:79-97."""

    def __init__(self, frame_ratios: Tuple[int, ...], data_format: str = "THWC"):
        super().__init__(data_format)
        self._frame_ratios = tuple(frame_ratios)

    def __call__(self, x):
        return F.uniform_temporal_subsample_repeated(x, self._frame_ratios,
                                                     -3 if self._cthw else -4)


class ShortSideScale(_Layout):
    """Upstream transforms.py:100-120."""

    def __init__(self, size: int, interpolation: str = "bilinear", data_format: str = "THWC"):
        super().__init__(data_format)
        self._size = size
        self._interpolation = interpolation

    def __call__(self, x):
        out = F.short_side_scale(self._to_native(x), self._size, self._interpolation)
        return self._from_native(out)


class RandomShortSideScale(_Layout):
    """Short-side scale to a size drawn from [min_size, max_size]
    (upstream transforms.py:123-150)."""

    def __init__(self, min_size: int, max_size: int, interpolation: str = "bilinear",
                 data_format: str = "THWC", seed: Optional[int] = None):
        super().__init__(data_format)
        self._min_size = min_size
        self._max_size = max_size
        self._interpolation = interpolation
        self._rng = np.random.default_rng(seed)

    def __call__(self, x):
        size = int(self._rng.integers(self._min_size, self._max_size + 1))
        return self._from_native(F.short_side_scale(self._to_native(x), size,
                                                    self._interpolation))


class RandomCropVideo(_Layout):
    def __init__(self, size: int, data_format: str = "THWC", seed: Optional[int] = None):
        super().__init__(data_format)
        self._size = size
        self._rng = np.random.default_rng(seed)

    def __call__(self, x):
        v = self._to_native(x)
        h, w = v.shape[-3], v.shape[-2]
        y = int(self._rng.integers(0, max(h - self._size, 0) + 1))
        xo = int(self._rng.integers(0, max(w - self._size, 0) + 1))
        return self._from_native(F.crop(v, y, xo, self._size))


class CenterCropVideo(_Layout):
    def __init__(self, size: int, data_format: str = "THWC"):
        super().__init__(data_format)
        self._size = size

    def __call__(self, x):
        return self._from_native(F.center_crop(self._to_native(x), self._size))


class RandomHorizontalFlipVideo(_Layout):
    def __init__(self, p: float = 0.5, data_format: str = "THWC", seed: Optional[int] = None):
        super().__init__(data_format)
        self._p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, x):
        if self._rng.random() < self._p:
            return self._from_native(F.horizontal_flip(self._to_native(x)))
        return x


class UniformCropVideo:
    """3-crop evaluation keyed by ``aug_index`` (upstream transforms.py:153-174)."""

    def __init__(self, size: int, video_key: str = "video", aug_index_key: str = "aug_index",
                 data_format: str = "THWC"):
        self._size = size
        self._video_key = video_key
        self._aug_index_key = aug_index_key
        self._layout = _Layout(data_format)

    def __call__(self, x: Dict[str, Any]) -> Dict[str, Any]:
        v = self._layout._to_native(x[self._video_key])
        out = F.uniform_crop(v, self._size, x[self._aug_index_key])
        x[self._video_key] = self._layout._from_native(out)
        return x


class Normalize(_Layout):
    """Per-channel normalize (upstream transforms.py:177-195). The mean and
    std tensors are made once per device and dtype."""

    def __init__(self, mean, std, data_format: str = "THWC"):
        super().__init__(data_format)
        self._mean = tuple(float(m) for m in mean)
        self._std = tuple(float(s) for s in std)
        self._constants: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, x):
        with annotate("pvt.transform.Normalize"):
            v = self._to_native(x)
            key = (v.device, v.dtype)
            if key not in self._constants:
                self._constants[key] = (F.device_constant(self._mean, v.dtype, v.device),
                                        F.device_constant(self._std, v.dtype, v.device))
            return self._from_native(F.normalize(v, *self._constants[key]))


class ConvertUint8ToFloat:
    """uint8 [0, 255] -> float32 [0, 1] (upstream transforms.py:218-233)."""

    def __call__(self, x):
        if x.dtype != torch.uint8:
            raise TypeError(f"image must be uint8, got {x.dtype}")
        return x.float() / 255.0


class ConvertFloatToUint8:
    """float [0, 1] -> uint8 [0, 255], rounded (upstream transforms.py:198-215)."""

    def __call__(self, x):
        if x.dtype not in (torch.float32, torch.float16):
            raise TypeError(f"image must be float, got {x.dtype}")
        return torch.round(x * 255.0).to(torch.uint8)


class MoveChannelRear:
    """CTHW -> THWC."""

    def __call__(self, x):
        return F.cthw_to_thwc(x)


class MoveChannelFront:
    """THWC -> CTHW."""

    def __call__(self, x):
        return F.thwc_to_cthw(x)


class RandomResizedCrop(_Layout):
    """Random resized crop (upstream transforms.py:272-313). Each call draws
    one integer from the numpy generator, as the JAX transform draws its
    key's seed, and samples the box from a CPU ``torch.Generator`` seeded
    with it (the JAX package samples it with ``jax.random``)."""

    def __init__(self, target_height: int, target_width: int, scale: Tuple[float, float],
                 aspect_ratio: Tuple[float, float], shift: bool = False,
                 log_uniform_ratio: bool = True, interpolation: str = "bilinear",
                 num_tries: int = 10, data_format: str = "THWC", seed: Optional[int] = None):
        super().__init__(data_format)
        self._kw = dict(target_height=target_height, target_width=target_width, scale=scale,
                        aspect_ratio=aspect_ratio, shift=shift,
                        log_uniform_ratio=log_uniform_ratio, interpolation=interpolation,
                        num_tries=num_tries)
        self._rng = np.random.default_rng(seed)

    def __call__(self, x):
        generator = torch.Generator().manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        out = F.random_resized_crop(self._to_native(x), generator=generator, **self._kw)
        return self._from_native(out)


class Permute:
    """Permute axes (upstream transforms.py:316-338)."""

    def __init__(self, dims: Tuple[int, ...]):
        if sorted(dims) != list(range(len(dims))):
            raise ValueError(f"dims must be a permutation, got {dims}")
        self._dims = tuple(dims)

    def __call__(self, x):
        return x.permute(self._dims)


class OpSampler:
    """Apply ``num_sample_op`` ops drawn from a list with the given weights
    (upstream transforms.py:341-411); the draws as the JAX package's."""

    def __init__(self, transforms_list: List[Callable],
                 transforms_prob: Optional[List[float]] = None, num_sample_op: int = 1,
                 randomly_sample_depth: bool = False, replacement: bool = False,
                 seed: Optional[int] = None):
        if not transforms_list:
            raise ValueError("transforms_list is empty")
        if transforms_prob is not None and (len(transforms_list) != len(transforms_prob)
                                            or min(transforms_prob) <= 0.0):
            raise ValueError("transforms_prob needs one positive weight per transform")
        if not 0 < num_sample_op <= len(transforms_list):
            raise ValueError(f"num_sample_op must be in [1, {len(transforms_list)}]")
        self._transforms = list(transforms_list)
        self._probs = None
        if transforms_prob is not None:
            p = np.asarray(transforms_prob, dtype=np.float64)
            self._probs = p / p.sum()
        self._num_sample_op = num_sample_op
        self._randomly_sample_depth = randomly_sample_depth
        self._replacement = replacement
        self._rng = np.random.default_rng(seed)

    def __call__(self, x):
        depth = (int(self._rng.integers(1, self._num_sample_op + 1))
                 if self._randomly_sample_depth else self._num_sample_op)
        indices = self._rng.choice(len(self._transforms), size=depth, replace=self._replacement,
                                   p=self._probs)
        for i in indices:
            x = self._transforms[int(i)](x)
        return x


class Div255:
    """Float32 x / 255 (upstream transforms.py:414-430)."""

    def __call__(self, x):
        with annotate("pvt.transform.Div255"):
            return F.div_255(x.float())
