"""The 14 video augmentation ops and their magnitude machinery, the base of
RandAugment and AugMix (counterpart of
pytorchvideo_tpu/transforms/augmentations.py; upstream
pytorchvideo/transforms/augmentations.py: ops :24-233, magnitude curves
:244-303, tables :306-362, AugmentTransform :370-483).

Clips are (T, H, W, C) tensors on any device, uint8 (exact integer
semantics: equalize and posterize on integers, blends truncated back to
uint8) or float in [0, 1]. Each op computes the JAX package's numpy
arithmetic in torch where the clip is, with no read back to the host:

- A scalar argument that numpy holds as a float64 scalar (``np.float64``,
  as ``np.deg2rad`` returns) makes numpy compute in float64; a Python
  number is cast to the array's float32. The ops follow the same rule
  (:func:`_scalar_dtype`), so uint8 results equal the JAX package's.
- The grayscale weights are summed as numpy's ``@`` does here: a
  float32 product, then two fused multiply-adds (emulated in float64).
- Equalize's per-(t, c) histograms are one ``scatter_add_`` over values
  offset by (t, c) (``bincount`` reads its range back to the host on the
  card); the ``step == 0`` case is a ``torch.where``.

The random draws (whether to apply, the magnitude, the sign) stay numpy
draws on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pytorchvideo_tpu_torch.transforms.functional import device_constant

_AUGMENTATION_MAX_LEVEL = 10

_GRAY_WEIGHTS = tuple(float(w) for w in np.array([0.2989, 0.587, 0.114], dtype=np.float32))
# The sharpness blur's taps, float32 as numpy's [[1,1,1],[1,5,1],[1,1,1]] / 13.
_SHARP_TAPS = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0


def _scalar_dtype(*scalars) -> torch.dtype:
    """float64 where numpy would compute in float64 with these scalars (any
    of them a 64-bit numpy float), else float32."""
    return (torch.float64 if any(isinstance(s, np.floating) and np.dtype(type(s)).itemsize == 8
                                 for s in scalars) else torch.float32)


def _bound(video: torch.Tensor) -> float:
    return 255.0 if video.dtype == torch.uint8 else 1.0


def _true_div(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """``numerator / t`` by true division (torch's ``scalar / tensor`` is a
    reciprocal times the scalar)."""
    return torch.full_like(t, numerator) / t


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio) -> torch.Tensor:
    """ratio * img1 + (1 - ratio) * img2, clamped to the dtype's bound and
    cast back (truncated for uint8; torchvision's ``_blend``)."""
    dtype = _scalar_dtype(ratio)
    out = img1.to(dtype) * float(ratio) + img2.to(dtype) * (1.0 - float(ratio))
    return out.clamp(0, _bound(img1)).to(img1.dtype)


def _gray_f32(video: torch.Tensor) -> torch.Tensor:
    """(T, H, W) luma in float32: ``v0 * w0`` then ``fma(v1, w1, .)`` and
    ``fma(v2, w2, .)``, numpy's ``video.astype(float32) @ weights`` here."""
    v = video.float()
    acc = v[..., 0] * _GRAY_WEIGHTS[0]
    for c in (1, 2):
        acc = (v[..., c].double() * _GRAY_WEIGHTS[c] + acc.double()).float()
    return acc


def _rgb_to_grayscale(video: torch.Tensor) -> torch.Tensor:
    gray = _gray_f32(video)[..., None]
    if video.dtype == torch.uint8:
        gray = gray.floor()
    return gray.expand(video.shape).to(video.dtype)


def _autocontrast(video: torch.Tensor, **kwargs) -> torch.Tensor:
    """Per-frame per-channel min/max remap."""
    bound = _bound(video)
    v = video.float()
    minimum = v.amin(dim=(1, 2), keepdim=True)
    maximum = v.amax(dim=(1, 2), keepdim=True)
    eq = maximum == minimum
    scale = _true_div(bound, torch.where(eq, torch.ones_like(maximum), maximum - minimum))
    out = torch.where(eq, v, ((v - minimum) * scale).clamp(0, bound))
    return out.to(video.dtype)


def _equalize_uint8(video: torch.Tensor) -> torch.Tensor:
    """torchvision's equalize: a histogram LUT per frame and channel."""
    T, H, W, C = video.shape
    planes = video.permute(0, 3, 1, 2).reshape(T * C, H * W).long()
    offsets = torch.arange(T * C, device=video.device)[:, None] * 256
    hist = torch.zeros(T * C * 256, dtype=torch.long, device=video.device)
    hist.scatter_add_(0, (planes + offsets).reshape(-1), torch.ones_like(planes).reshape(-1))
    hist = hist.view(T * C, 256)
    # The nonzero bins but the last sum to all pixels less the top value's count.
    top = planes.amax(dim=1, keepdim=True)
    step = (H * W - hist.gather(1, top)) // 255
    safe = torch.where(step == 0, torch.ones_like(step), step)
    lut = (hist.cumsum(1) + safe // 2) // safe
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=1).clamp(0, 255)
    out = torch.where(step == 0, planes, lut.gather(1, planes))
    return out.to(torch.uint8).view(T, C, H, W).permute(0, 2, 3, 1).contiguous()


def _to_uint8_levels(video: torch.Tensor) -> torch.Tensor:
    return (video * 255).to(torch.uint8)


def _from_uint8_levels(levels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # numpy's uint8 / 255 is float64.
    return (levels.double() / torch.full_like(levels, 255, dtype=torch.float64)).to(dtype)


def _equalize(video: torch.Tensor, **kwargs) -> torch.Tensor:
    if video.dtype != torch.uint8:
        return _from_uint8_levels(_equalize_uint8(_to_uint8_levels(video)), video.dtype)
    return _equalize_uint8(video)


def _invert(video: torch.Tensor, **kwargs) -> torch.Tensor:
    return (_bound(video) - video.float()).to(video.dtype)


def _solarize(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    threshold = int(factor * 255.0) if video.dtype == torch.uint8 else float(factor)
    return torch.where(video >= threshold, _invert(video), video)


def _adjust_contrast(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    """Blend with the clip's per-frame mean luma (floored for uint8)."""
    gray = _gray_f32(video)
    if video.dtype == torch.uint8:
        gray = gray.floor()
        # Integer luma: its sum is exact; numpy's float32 mean divides the
        # float32 sum by the count.
        total = gray.long().sum(dim=(1, 2), keepdim=True).float()
        mean = (total / torch.full_like(total, float(gray.shape[1] * gray.shape[2]))).floor()
    else:
        mean = gray.mean(dim=(1, 2), keepdim=True)
    return _blend(video, mean[..., None].expand(video.shape), factor)


def _adjust_saturation(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    return _blend(video, _rgb_to_grayscale(video), factor)


def _adjust_brightness(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    return _blend(video, torch.zeros_like(video), factor)


def _adjust_sharpness(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    """Blend with a 3x3 smoothing (kernel [[1,1,1],[1,5,1],[1,1,1]]/13),
    the border kept from the original (torchvision). The taps are summed in
    numpy's order, so the blur equals its bit for bit."""
    v = video.float()
    T, H, W, C = v.shape
    blurred = None
    for dy in range(3):
        for dx in range(3):
            term = v[:, dy:dy + H - 2, dx:dx + W - 2] * float(_SHARP_TAPS[dy, dx])
            blurred = term if blurred is None else blurred + term
    if video.dtype == torch.uint8:
        blurred = blurred.round().clamp(0, 255)
    full = v.clone()
    full[:, 1:-1, 1:-1] = blurred
    return _blend(video, full.to(video.dtype), factor)


def _posterize(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    if factor >= 8:
        return video
    if video.dtype != torch.uint8:
        return _from_uint8_levels(_posterize(_to_uint8_levels(video), factor), video.dtype)
    mask = 255 - (2 ** (8 - int(factor)) - 1)
    return video & mask


def _times(coef, grid: torch.Tensor) -> torch.Tensor:
    """numpy's ``coef * grid`` for a float32 grid."""
    return grid.to(_scalar_dtype(coef)) * float(coef)


def _plus(acc: torch.Tensor, scalar) -> torch.Tensor:
    """numpy's ``acc + scalar``."""
    if _scalar_dtype(scalar) == torch.float64:
        acc = acc.double()
    return acc + float(scalar)


def affine(video: torch.Tensor, matrix, fill=(0.5, 0.5, 0.5),
           interpolation: str = "bilinear") -> torch.Tensor:
    """Apply the 2x3 affine ``matrix`` that maps OUTPUT pixel coordinates to
    INPUT ones, ``x_in = a*x + b*y + c``, ``y_in = d*x + e*y + f``, about the
    frame's centre (upstream's private affine, augmentations.py:485-661).
    Pixels from outside the frame take ``fill`` (times 255 for uint8)."""
    a, b, c, d, e, f = matrix
    T, H, W, C = video.shape
    device = video.device
    xs_c = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W) - (W - 1) / 2.0
    ys_c = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W) - (H - 1) / 2.0
    x_in = _plus(_plus(_times(a, xs_c) + _times(b, ys_c), c), (W - 1) / 2.0)
    y_in = _plus(_plus(_times(d, xs_c) + _times(e, ys_c), f), (H - 1) / 2.0)

    scale = 255.0 if video.dtype == torch.uint8 else 1.0
    fill_t = device_constant([float(np.float32(v)) * scale for v in fill], torch.float32, device)
    v = video.float()

    def sample(yy, xx):
        valid = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[None, :, :, None]
        return torch.where(valid, v[:, yy.clamp(0, H - 1), xx.clamp(0, W - 1), :], fill_t)

    if interpolation == "nearest":
        out = sample(y_in.round().long(), x_in.round().long())
    else:
        x0, y0 = x_in.floor().long(), y_in.floor().long()
        # numpy: float minus int64 is float64.
        wx = (x_in.double() - x0.double())[None, :, :, None]
        wy = (y_in.double() - y0.double())[None, :, :, None]
        out = None
        for yy, xx, w in ((y0, x0, (1 - wy) * (1 - wx)), (y0, x0 + 1, (1 - wy) * wx),
                          (y0 + 1, x0, wy * (1 - wx)), (y0 + 1, x0 + 1, wy * wx)):
            term = w * sample(yy, xx).double()
            out = term.float() if out is None else (out.double() + term).float()
    if video.dtype == torch.uint8:
        out = out.round().clamp(0, 255)
    return out.to(video.dtype)


def _rotate(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    """Rotate counter-clockwise by ``factor`` degrees about the centre."""
    theta = np.deg2rad(factor)
    cos, sin = np.cos(theta), np.sin(theta)
    return affine(video, [cos, -sin, 0, sin, cos, 0], fill=kwargs.get("fill", (0.5,) * 3))


def _shear_x(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    offset = video.shape[1] * factor / 2
    return affine(video, [1, factor, offset, 0, 1, 0], fill=kwargs.get("fill", (0.5,) * 3))


def _shear_y(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    offset = video.shape[2] * factor / 2
    return affine(video, [1, 0, 0, factor, 1, offset], fill=kwargs.get("fill", (0.5,) * 3))


def _translate_x(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    offset = factor * video.shape[2]
    return affine(video, [1, 0, offset, 0, 1, 0], fill=kwargs.get("fill", (0.5,) * 3))


def _translate_y(video: torch.Tensor, factor, **kwargs) -> torch.Tensor:
    offset = factor * video.shape[1]
    return affine(video, [1, 0, 0, 0, 1, offset], fill=kwargs.get("fill", (0.5,) * 3))


# ---------------------------------------------------------------------------
# Magnitude machinery (upstream augmentations.py:244-362)
# ---------------------------------------------------------------------------


def _increasing_magnitude_to_arg(level, params):
    magnitude = (level / _AUGMENTATION_MAX_LEVEL) * params[1]
    return (params[0] + magnitude,)


def _increasing_randomly_negate_to_arg(level, params, rng):
    magnitude = (level / _AUGMENTATION_MAX_LEVEL) * params[1]
    if rng.random() > 0.5:
        return (params[0] + magnitude,)
    return (params[0] - magnitude,)


def _decreasing_int_to_arg(level, params):
    magnitude = (level / _AUGMENTATION_MAX_LEVEL) * params[1]
    return (params[0] - int(magnitude),)


def _decreasing_to_arg(level, params):
    magnitude = (level / _AUGMENTATION_MAX_LEVEL) * params[1]
    return (params[0] - magnitude,)


_NAME_TO_TRANSFORM_FUNC = {
    "AdjustBrightness": _adjust_brightness,
    "AdjustContrast": _adjust_contrast,
    "AdjustSaturation": _adjust_saturation,
    "AdjustSharpness": _adjust_sharpness,
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Invert": _invert,
    "Rotate": _rotate,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
}

_LEVEL_TO_ARG = {
    "AdjustBrightness": "inc_neg",
    "AdjustContrast": "inc_neg",
    "AdjustSaturation": "inc_neg",
    "AdjustSharpness": "inc_neg",
    "AutoContrast": None,
    "Equalize": None,
    "Invert": None,
    "Rotate": "inc_neg",
    "Posterize": "dec_int",
    "Solarize": "dec",
    "ShearX": "inc_neg",
    "ShearY": "inc_neg",
    "TranslateX": "inc_neg",
    "TranslateY": "inc_neg",
}

_TRANSFORM_MAX_PARAMS = {
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

SAMPLING_DEFAULT_HPARAS = {"sampling_std": 0.5}
TRANSFORM_DEFAULT_HPARAS = {"fill": (0.5, 0.5, 0.5)}


class AugmentTransform:
    """One named augmentation with its probability and magnitude draws
    (upstream augmentations.py:370-483), made on the host from a numpy
    generator seeded with ``seed``, in the JAX package's order."""

    def __init__(
        self,
        transform_name: str,
        magnitude: int = 10,
        prob: float = 0.5,
        name_to_transform_func: Optional[Dict[str, Callable]] = None,
        level_to_arg: Optional[Dict[str, Any]] = None,
        transform_max_paras: Optional[Dict[str, Tuple]] = None,
        transform_hparas: Optional[Dict[str, Any]] = None,
        sampling_type: str = "gaussian",
        sampling_hparas: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
    ) -> None:
        if sampling_type not in ("gaussian", "uniform"):
            raise ValueError(f"sampling_type must be 'gaussian' or 'uniform', got {sampling_type!r}")
        name_to_transform_func = name_to_transform_func or _NAME_TO_TRANSFORM_FUNC
        level_to_arg = level_to_arg or _LEVEL_TO_ARG
        transform_max_paras = transform_max_paras or _TRANSFORM_MAX_PARAMS
        self.transform_hparas = transform_hparas or TRANSFORM_DEFAULT_HPARAS
        self.sampling_type = sampling_type
        self.sampling_hparas = sampling_hparas or SAMPLING_DEFAULT_HPARAS
        needed = {"gaussian": ("sampling_std",),
                  "uniform": ("sampling_data_type", "sampling_min")}[sampling_type]
        if "fill" not in self.transform_hparas or any(k not in self.sampling_hparas
                                                      for k in needed):
            raise ValueError(f"transform_hparas needs 'fill', sampling_hparas {needed}")
        if transform_name not in name_to_transform_func:
            raise ValueError(f"unknown augmentation {transform_name!r}")
        self.max_level = _AUGMENTATION_MAX_LEVEL
        self.transform_name = transform_name
        self.magnitude = magnitude
        self.transform_fn = name_to_transform_func[transform_name]
        self.level_fn = level_to_arg[transform_name]
        self.level_paras = transform_max_paras[transform_name]
        self.prob = prob
        self._rng = np.random.default_rng(seed)

    def _get_magnitude(self) -> float:
        if self.sampling_type == "gaussian":
            return max(0, min(self.max_level, self._rng.normal(
                self.magnitude, self.sampling_hparas["sampling_std"])))
        if self.sampling_hparas["sampling_data_type"] == "int":
            return int(self._rng.integers(self.sampling_hparas["sampling_min"],
                                          self.magnitude + 1))
        if self.sampling_hparas["sampling_data_type"] == "float":
            return (self._rng.random() * (self.magnitude - self.sampling_hparas["sampling_min"])
                    + self.sampling_hparas["sampling_min"])
        raise ValueError("sampling_data_type must be 'int' or 'float'")

    def _level_args(self, magnitude):
        if self.level_fn is None:
            return ()
        if self.level_fn == "inc_neg":
            return _increasing_randomly_negate_to_arg(magnitude, self.level_paras, self._rng)
        if self.level_fn == "inc":
            return _increasing_magnitude_to_arg(magnitude, self.level_paras)
        if self.level_fn == "dec_int":
            return _decreasing_int_to_arg(magnitude, self.level_paras)
        if self.level_fn == "dec":
            return _decreasing_to_arg(magnitude, self.level_paras)
        return self.level_fn(magnitude, self.level_paras)

    def __call__(self, video: torch.Tensor) -> torch.Tensor:
        if self._rng.random() > self.prob:
            return video
        level_args = self._level_args(self._get_magnitude())
        return self.transform_fn(video, *level_args, **self.transform_hparas)
