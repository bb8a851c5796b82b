"""Batch-level MixUp / CutMix / MixVideo on the device (counterpart of
pytorchvideo_tpu/transforms/mix.py; upstream transforms/mix.py: MixUp :35,
CutMix :99, MixVideo :199, _mix_labels :9).

Clips are NCTHW (B, C, T, H, W), as the port's models take them; each sample
is mixed with its batch flip. The random scalars (the Beta-distributed
lambda, the CutMix box centre, MixVideo's coin) are drawn on the host from an
explicit ``torch.Generator`` (a CPU one; torch's default CPU generator when
None), so the device never waits on them; the mixing itself runs where the
clips are.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pytorchvideo_tpu_torch.transforms.functional import convert_to_one_hot


def _uniform(generator: Optional[torch.Generator]) -> float:
    return float(torch.rand((), generator=generator))


def _sample_gamma(alpha: float, generator: Optional[torch.Generator]) -> float:
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (alpha < 1 boosted
    through Gamma(alpha + 1) * U^(1 / alpha))."""
    if alpha < 1.0:
        return _sample_gamma(alpha + 1.0, generator) * _uniform(generator) ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = _uniform(generator)
        if math.log(max(u, 1e-300)) < 0.5 * z * z + d - d * v + d * math.log(v):
            return d * v


def _sample_beta(alpha: float, generator: Optional[torch.Generator]) -> float:
    """Beta(alpha, alpha) as the ratio of two Gamma(alpha) draws."""
    x = _sample_gamma(alpha, generator)
    y = _sample_gamma(alpha, generator)
    return x / (x + y)


def _sample_center(h: int, w: int, generator: Optional[torch.Generator]) -> Tuple[int, int]:
    """The CutMix box centre, uniform over the (h, w) grid."""
    return (int(torch.randint(0, h, (), generator=generator)),
            int(torch.randint(0, w, (), generator=generator)))


def _mix_labels(labels: torch.Tensor, num_classes: int, lam: float,
                label_smoothing: float = 0.0, one_hot: bool = False) -> torch.Tensor:
    """Labels mixed with their batch flip (upstream mix.py:9-32)."""
    if one_hot:
        labels1, labels2 = labels.float(), labels.flip(0).float()
    else:
        labels1 = convert_to_one_hot(labels, num_classes, label_smoothing)
        labels2 = convert_to_one_hot(labels.flip(0), num_classes, label_smoothing)
    return labels1 * lam + labels2 * (1.0 - lam)


def mixup(x_video: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
          label_smoothing: float = 0.0, num_classes: int = 400, one_hot: bool = False,
          generator: Optional[torch.Generator] = None):
    """MixUp (upstream mix.py:35-97): lam * x + (1 - lam) * flip(x, batch)."""
    lam = _sample_beta(alpha, generator)
    mixed = x_video * lam + x_video.flip(0) * (1.0 - lam)
    return mixed, _mix_labels(labels, num_classes, lam, label_smoothing, one_hot)


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int):
    """The box (y0, y1, x0, x1) around (cy, cx) of side sqrt(1 - lam) times
    the grid's, clipped to it, and lambda corrected by the box's real area
    (upstream mix.py:128-147)."""
    ratio = math.sqrt(1.0 - lam)
    cut_h, cut_w = int(math.floor(h * ratio)), int(math.floor(w * ratio))
    y0, y1 = min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h)
    x0, x1 = min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w)
    return (y0, y1, x0, x1), 1.0 - (y1 - y0) * (x1 - x0) / float(h * w)


def cutmix(x_video: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
           label_smoothing: float = 0.0, num_classes: int = 400, one_hot: bool = False,
           generator: Optional[torch.Generator] = None):
    """CutMix (upstream mix.py:99-196): a box of each clip's frames replaced
    by the flipped sample's, lambda corrected by the box's area."""
    lam = _sample_beta(alpha, generator)
    h, w = x_video.shape[-2:]
    (y0, y1, x0, x1), lam = cutmix_box(h, w, lam, *_sample_center(h, w, generator))
    mixed = x_video.clone()
    mixed[..., y0:y1, x0:x1] = x_video.flip(0)[..., y0:y1, x0:x1]
    return mixed, _mix_labels(labels, num_classes, lam, label_smoothing, one_hot)


class MixUp:
    """Class form of :func:`mixup` (upstream mix.py:35)."""

    def __init__(self, alpha: float = 1.0, label_smoothing: float = 0.0, num_classes: int = 400,
                 one_hot: bool = False):
        self.alpha = alpha
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.one_hot = one_hot

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None):
        return mixup(x_video, labels, self.alpha, self.label_smoothing, self.num_classes,
                     self.one_hot, generator)


class CutMix(MixUp):
    """Class form of :func:`cutmix` (upstream mix.py:99)."""

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None):
        return cutmix(x_video, labels, self.alpha, self.label_smoothing, self.num_classes,
                      self.one_hot, generator)


class MixVideo:
    """CutMix with probability ``cutmix_prob``, else MixUp (upstream
    mix.py:199-279)."""

    def __init__(self, cutmix_prob: float = 0.5, mixup_alpha: float = 1.0,
                 cutmix_alpha: float = 1.0, label_smoothing: float = 0.0,
                 num_classes: int = 400, one_hot: bool = False):
        if not 0.0 <= cutmix_prob <= 1.0:
            raise ValueError(f"cutmix_prob must be in [0, 1], got {cutmix_prob}")
        self.cutmix_prob = cutmix_prob
        self.mixup = MixUp(mixup_alpha, label_smoothing, num_classes, one_hot)
        self.cutmix = CutMix(cutmix_alpha, label_smoothing, num_classes, one_hot)

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None):
        if _uniform(generator) < self.cutmix_prob:
            return self.cutmix(x_video, labels, generator)
        return self.mixup(x_video, labels, generator)
