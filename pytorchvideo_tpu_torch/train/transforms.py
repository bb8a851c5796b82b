"""Trainer-level transforms (counterpart of
pytorchvideo_tpu/train/transforms.py; upstream
pytorchvideo_trainer/datamodule/transforms.py and collators.py):
``SlowFastPackPathway`` (upstream :99-139) and ``default_collate``, which
make SlowFast's pathway-list batches from clips, and
``MixVideoBatchWrapper`` (upstream :165); the SSL transforms
``RepeatandConverttoList`` (:141), ``ColorJitterVideoSSl`` (:195),
``GaussianBlur`` (:263) and ``RandomErasing`` (rand_erase_transform.py:38-190),
and the collators ``multiple_samples_collate`` (collators.py:9) and
``build_collator_from_name``.

The SSL transforms take (C, T, H, W) float clips on any device, where the
JAX package's numpy functions take (T, H, W, C); they compute the JAX
formulas in float32 where the clip lies (``_rgb_to_gray``'s weights 0.299,
0.587, 0.114; the blur's edge padding and radius max(round(3 sigma), 1);
the hue rotation in YIQ). Their random draws are the JAX package's numpy
draws on the host, in its order, from a generator seeded by ``seed``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from pytorchvideo_tpu_torch.transforms.mix import MixVideo


class MixVideoBatchWrapper:
    """MixVideo over a batch dict, on the batch's device; the random scalars
    come from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, mixup_alpha: float, cutmix_prob: float, cutmix_alpha: float,
                 label_smoothing: float, num_classes: int = 400) -> None:
        self.mix_video_transform = MixVideo(
            mixup_alpha=mixup_alpha,
            cutmix_prob=cutmix_prob,
            cutmix_alpha=cutmix_alpha,
            label_smoothing=label_smoothing,
            num_classes=num_classes,
        )

    def __call__(self, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        batch["video"], batch["label"] = self.mix_video_transform(
            batch["video"], batch["label"], generator)
        return batch


class SlowFastPackPathway:
    """A (C, T, H, W) clip -> ``[slow, fast]``: the slow pathway keeps T //
    alpha frames evenly spaced over the clip (the first and the last among
    them), the fast one all T."""

    def __init__(self, alpha: int) -> None:
        self.alpha = alpha

    def __call__(self, frames) -> List[torch.Tensor]:
        frames = torch.as_tensor(frames)
        t = frames.shape[1]
        index = torch.from_numpy(np.linspace(0, t - 1, t // self.alpha).astype(np.int64))
        return [frames.index_select(1, index.to(frames.device)), frames]


def _stack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` in the samples' memory order: each sample permuted to
    its strides' order, stacked, and the batch permuted back, so that CTHW
    views of THWC clips make a ``channels_last_3d`` batch."""
    first = tensors[0]
    order = sorted(range(first.dim()), key=lambda i: -first.stride(i))
    if order == list(range(first.dim())):
        return torch.stack(tensors)
    batch = torch.stack([t.permute(order) for t in tensors])
    return batch.permute(0, *[order.index(i) + 1 for i in range(first.dim())])


def default_collate(samples: List[Any]):
    """Stacks the samples' leaves into a batch, through dicts, lists and
    tuples (a list of ``[slow, fast]`` clips becomes ``[slow batch, fast
    batch]``); numbers become a tensor, strings stay a list. Tensors keep
    their memory order (:func:`_stack`)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, str):
        return list(samples)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return torch.as_tensor(np.asarray(samples))
    return _stack([torch.as_tensor(s) for s in samples])


class RepeatandConverttoList:
    """Repeat every value of a sample dict into a list of ``repeat_num``
    (multi-view augmentation)."""

    def __init__(self, repeat_num: int) -> None:
        self.repeat_num = repeat_num

    def __call__(self, sample_dict: Dict[str, Any]) -> Dict[str, List[Any]]:
        for k, v in sample_dict.items():
            sample_dict[k] = self.repeat_num * [v]
        return sample_dict


_GRAY = (0.299, 0.587, 0.114)
_YIQ = np.array([[0.299, 0.587, 0.114], [0.5959, -0.2746, -0.3213],
                 [0.2115, -0.5227, 0.3112]], np.float32)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(C, T, H, W) -> the luma repeated over the 3 channels."""
    w = torch.tensor(_GRAY, dtype=torch.float32, device=frames.device)
    gray = torch.einsum("cthw,c->thw", frames, w)
    return gray.unsqueeze(0).expand(3, *gray.shape).contiguous()


def _color_matrix(frames: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """out[c] = sum_k m[c, k] * frames[k]: numpy's ``f @ m.T`` on THWC."""
    return torch.einsum("ck,kthw->cthw", torch.from_numpy(m).to(frames.device), frames)


def adjust_brightness(frames: torch.Tensor, factor: float) -> torch.Tensor:
    return (frames * factor).clamp(0, 1)


def adjust_contrast(frames: torch.Tensor, factor: float) -> torch.Tensor:
    mean = rgb_to_gray(frames).mean()
    return ((frames - mean) * factor + mean).clamp(0, 1)


def adjust_saturation(frames: torch.Tensor, factor: float) -> torch.Tensor:
    gray = rgb_to_gray(frames)
    return (gray + (frames - gray) * factor).clamp(0, 1)


def hue_matrix(shift: float) -> np.ndarray:
    """The float32 RGB -> YIQ -> rotated by 2 pi shift -> RGB matrix."""
    theta = 2 * np.pi * shift
    cos, sin = np.cos(theta), np.sin(theta)
    rot = np.array([[1, 0, 0], [0, cos, -sin], [0, sin, cos]], np.float32)
    return np.linalg.inv(_YIQ) @ rot @ _YIQ


def adjust_hue(frames: torch.Tensor, shift: float) -> torch.Tensor:
    return _color_matrix(frames, hue_matrix(shift)).clamp(0, 1)


def gaussian_blur(frames: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian over (H, W) of each frame, edges padded by
    replication, radius max(round(3 sigma), 1)."""
    radius = max(int(round(3 * sigma)), 1)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    h, w = frames.shape[-2:]
    out = frames.float()
    padded = torch.cat([out[..., :1, :].expand(*out.shape[:-2], radius, w), out,
                        out[..., -1:, :].expand(*out.shape[:-2], radius, w)], dim=-2)
    out = sum(float(k[i]) * padded[..., i:i + h, :] for i in range(len(k)))
    padded = torch.cat([out[..., :1].expand(*out.shape[:-1], radius), out,
                        out[..., -1:].expand(*out.shape[:-1], radius)], dim=-1)
    out = sum(float(k[i]) * padded[..., i:i + w] for i in range(len(k)))
    return out.to(frames.dtype)


class GaussianBlur:
    """Video-level gaussian blur with sigma drawn uniformly in ``sigma``
    (upstream :263-280)."""

    def __init__(self, sigma: Sequence[float] = (0.1, 2.0), seed=None) -> None:
        self.sigma = sigma
        self._rng = np.random.default_rng(seed)

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        sigma = self.sigma[0]
        if len(self.sigma) == 2:
            sigma = float(self._rng.uniform(self.sigma[0], self.sigma[1]))
        return gaussian_blur(torch.as_tensor(frames).float(), sigma)


class ColorJitterVideoSSl:
    """Random color jitter (brightness, contrast, saturation and hue in a
    shuffled order), grayscale and gaussian blur for SSL (upstream
    :195-260); a (C, T, H, W) float clip in [0, 1]."""

    def __init__(self, bri_con_sat: Sequence[float], hue: float, p_color_jitter: float,
                 p_convert_gray: float, p_gaussian_blur: float = 0.5,
                 gaussian_blur_sigma: Sequence[float] = (0.1, 2.0), seed=None) -> None:
        self.bri_con_sat = bri_con_sat
        self.hue = hue
        self.p_color_jitter = p_color_jitter
        self.p_convert_gray = p_convert_gray
        self.p_gaussian_blur = p_gaussian_blur
        self.gaussian_blur_sigma = gaussian_blur_sigma
        self._rng = np.random.default_rng(seed)

    def _jitter(self, frames: torch.Tensor) -> torch.Tensor:
        rng = self._rng
        b, c, s = self.bri_con_sat
        ops = [
            lambda f: adjust_brightness(f, rng.uniform(max(0, 1 - b), 1 + b)),
            lambda f: adjust_contrast(f, rng.uniform(max(0, 1 - c), 1 + c)),
            lambda f: adjust_saturation(f, rng.uniform(max(0, 1 - s), 1 + s)),
            lambda f: adjust_hue(f, rng.uniform(-self.hue, self.hue)),
        ]
        rng.shuffle(ops)
        for op in ops:
            frames = op(frames)
        return frames

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        frames = torch.as_tensor(frames).float()
        rng = self._rng
        if rng.random() < self.p_color_jitter:
            frames = self._jitter(frames)
        if rng.random() < self.p_convert_gray:
            frames = rgb_to_gray(frames)
        if rng.random() < self.p_gaussian_blur:
            sigma = float(rng.uniform(self.gaussian_blur_sigma[0], self.gaussian_blur_sigma[1]))
            frames = gaussian_blur(frames, sigma)
        return frames


class RandomErasing:
    """Random erasing of a normalised (C, T, H, W) clip; ``cube`` erases the
    same boxes in every frame, else each frame draws its own (upstream
    rand_erase_transform.py:38-190). ``mode``: "const" (zeros), "rand" (one
    normal draw per channel) or "pixel" (a normal draw per value); the
    draws have the JAX package's (h, w, c) shape and order."""

    def __init__(self, probability: float = 0.5, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None, mode: str = "const", min_count: int = 1,
                 max_count: Optional[int] = None, cube: bool = True, seed=None) -> None:
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        assert mode in ("const", "rand", "pixel")
        self.mode = mode
        self.cube = cube
        self._rng = np.random.default_rng(seed)

    def _fill(self, shape, device) -> torch.Tensor:
        """A (c, h, w) fill for a box of ``shape`` (h, w, c)."""
        if self.mode == "pixel":
            fill = self._rng.normal(size=shape).astype(np.float32)
        elif self.mode == "rand":
            fill = np.broadcast_to(self._rng.normal(size=(1, 1, shape[-1])).astype(np.float32),
                                   shape)
        else:
            fill = np.zeros(shape, np.float32)
        return torch.from_numpy(np.ascontiguousarray(fill)).to(device).permute(2, 0, 1)

    def boxes(self, height: int, width: int) -> List[tuple]:
        """The boxes (top, left, h, w) of one draw: none with probability
        1 - ``probability``."""
        if self._rng.random() > self.probability:
            return []
        count = (self.min_count if self.min_count == self.max_count
                 else int(self._rng.integers(self.min_count, self.max_count + 1)))
        boxes = []
        area = height * width
        for _ in range(count):
            for _ in range(10):
                target_area = self._rng.uniform(self.min_area, self.max_area) * area / count
                aspect = math.exp(self._rng.uniform(*self.log_aspect_ratio))
                h = int(round(math.sqrt(target_area * aspect)))
                w = int(round(math.sqrt(target_area / aspect)))
                if w < width and h < height:
                    top = int(self._rng.integers(0, height - h + 1))
                    left = int(self._rng.integers(0, width - w + 1))
                    boxes.append((top, left, h, w))
                    break
        return boxes

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        frames = torch.as_tensor(frames).float().clone()
        c, t, height, width = frames.shape
        if self.cube:
            for top, left, h, w in self.boxes(height, width):
                fill = self._fill((h, w, c), frames.device)
                frames[:, :, top:top + h, left:left + w] = fill[:, None]
        else:
            for i in range(t):
                for top, left, h, w in self.boxes(height, width):
                    frames[:, i, top:top + h, left:left + w] = self._fill((h, w, c),
                                                                          frames.device)
        return frames


def multiple_samples_collate(batch: List[Dict[str, List[Any]]]) -> Dict[str, Any]:
    """Flattens the repeated-augmentation lists of each sample, then
    collates (upstream collators.py:9-28)."""
    batch_dict = {}
    for k in batch[0].keys():
        v_iter = []
        for sample_dict in batch:
            v_iter += sample_dict[k]
        batch_dict[k] = default_collate(v_iter)
    return batch_dict


_COLLATORS = {"multiple_samples_collate": multiple_samples_collate}


def build_collator_from_name(name: str) -> Callable:
    assert name in _COLLATORS, f"available: {list(_COLLATORS)}"
    return _COLLATORS[name]
