"""Batch-level MixUp / CutMix / MixVideo on the device (counterpart of
pytorchvideo_tpu/transforms/mix.py; upstream transforms/mix.py: MixUp :35,
CutMix :99, MixVideo :199, _mix_labels :9).

Clips are NCTHW (B, C, T, H, W), as the port's models take them; each sample
is mixed with its batch flip. An audio input (``x_audio``, audio-visual
SlowFast's (B, 1, T, 1, F) spectrogram or any (..., H, W) tensor) is mixed
with the same lambda and batch flip; CutMix cuts it with a box of its own,
drawn on its own (H, W) with the same sampled lambda, and only the video's
box corrects the labels' lambda (the JAX package's ``x_audio``). The random
scalars (the Beta-distributed lambda, the CutMix box centres, MixVideo's
coin) are read to the host from the caller's ``torch.Generator`` (torch's
default CPU generator when None): a CPU generator keeps the device from
waiting on them; a CUDA one draws on the card, and each scalar read waits
for it. The mixing itself runs where the clips are. Each class's call is
one span, ``pvt.transform.<class>`` (utils/profiling.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pytorchvideo_tpu_torch.transforms.functional import convert_to_one_hot
from pytorchvideo_tpu_torch.utils.profiling import annotate


def _device(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else "cpu"


def _uniform(generator: Optional[torch.Generator]) -> float:
    return float(torch.rand((), generator=generator, device=_device(generator)))


def _sample_gamma(alpha: float, generator: Optional[torch.Generator]) -> float:
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (alpha < 1 boosted
    through Gamma(alpha + 1) * U^(1 / alpha))."""
    if alpha < 1.0:
        return _sample_gamma(alpha + 1.0, generator) * _uniform(generator) ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator, device=_device(generator)))
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
    device = _device(generator)
    return (int(torch.randint(0, h, (), generator=generator, device=device)),
            int(torch.randint(0, w, (), generator=generator, device=device)))


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
          generator: Optional[torch.Generator] = None, x_audio: Optional[torch.Tensor] = None):
    """MixUp (upstream mix.py:35-97): lam * x + (1 - lam) * flip(x, batch);
    ``x_audio`` with the same lambda. Returns (video, labels), or (video,
    audio, labels) with ``x_audio``."""
    lam = _sample_beta(alpha, generator)
    mixed = x_video * lam + x_video.flip(0) * (1.0 - lam)
    new_labels = _mix_labels(labels, num_classes, lam, label_smoothing, one_hot)
    if x_audio is not None:
        return mixed, x_audio * lam + x_audio.flip(0) * (1.0 - lam), new_labels
    return mixed, new_labels


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int):
    """The box (y0, y1, x0, x1) around (cy, cx) of side sqrt(1 - lam) times
    the grid's, clipped to it, and lambda corrected by the box's real area
    (upstream mix.py:128-147)."""
    ratio = math.sqrt(1.0 - lam)
    cut_h, cut_w = int(math.floor(h * ratio)), int(math.floor(w * ratio))
    y0, y1 = min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h)
    x0, x1 = min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w)
    return (y0, y1, x0, x1), 1.0 - (y1 - y0) * (x1 - x0) / float(h * w)


def _cut(x: torch.Tensor, lam: float, generator: Optional[torch.Generator]):
    """``x`` with a box of its (H, W) replaced by its batch flip's, the box
    drawn for ``lam``; and lambda corrected by the box's area."""
    h, w = x.shape[-2:]
    (y0, y1, x0, x1), lam = cutmix_box(h, w, lam, *_sample_center(h, w, generator))
    mixed = x.clone()
    mixed[..., y0:y1, x0:x1] = x.flip(0)[..., y0:y1, x0:x1]
    return mixed, lam


def cutmix(x_video: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
           label_smoothing: float = 0.0, num_classes: int = 400, one_hot: bool = False,
           generator: Optional[torch.Generator] = None, x_audio: Optional[torch.Tensor] = None):
    """CutMix (upstream mix.py:99-196): a box of each clip's frames replaced
    by the flipped sample's, lambda corrected by the box's area; ``x_audio``
    cut with its own box at the same sampled lambda. Returns (video, labels),
    or (video, audio, labels) with ``x_audio``."""
    lam = _sample_beta(alpha, generator)
    mixed, lam_video = _cut(x_video, lam, generator)
    new_labels = _mix_labels(labels, num_classes, lam_video, label_smoothing, one_hot)
    if x_audio is not None:
        return mixed, _cut(x_audio, lam, generator)[0], new_labels
    return mixed, new_labels


class MixUp:
    """Class form of :func:`mixup` (upstream mix.py:35)."""

    def __init__(self, alpha: float = 1.0, label_smoothing: float = 0.0, num_classes: int = 400,
                 one_hot: bool = False):
        self.alpha = alpha
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.one_hot = one_hot

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None,
                 x_audio: Optional[torch.Tensor] = None):
        with annotate("pvt.transform.MixUp"):
            return mixup(x_video, labels, self.alpha, self.label_smoothing, self.num_classes,
                         self.one_hot, generator, x_audio)


class CutMix(MixUp):
    """Class form of :func:`cutmix` (upstream mix.py:99)."""

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None,
                 x_audio: Optional[torch.Tensor] = None):
        with annotate("pvt.transform.CutMix"):
            return cutmix(x_video, labels, self.alpha, self.label_smoothing, self.num_classes,
                          self.one_hot, generator, x_audio)


class MixVideo:
    """CutMix with probability ``cutmix_prob``, else MixUp (upstream
    mix.py:199-279); one coin for the video and its ``x_audio``."""

    def __init__(self, cutmix_prob: float = 0.5, mixup_alpha: float = 1.0,
                 cutmix_alpha: float = 1.0, label_smoothing: float = 0.0,
                 num_classes: int = 400, one_hot: bool = False):
        if not 0.0 <= cutmix_prob <= 1.0:
            raise ValueError(f"cutmix_prob must be in [0, 1], got {cutmix_prob}")
        self.cutmix_prob = cutmix_prob
        self.mixup = MixUp(mixup_alpha, label_smoothing, num_classes, one_hot)
        self.cutmix = CutMix(cutmix_alpha, label_smoothing, num_classes, one_hot)

    def __call__(self, x_video, labels, generator: Optional[torch.Generator] = None,
                 x_audio: Optional[torch.Tensor] = None):
        with annotate("pvt.transform.MixVideo"):
            if _uniform(generator) < self.cutmix_prob:
                return self.cutmix(x_video, labels, generator, x_audio)
            return self.mixup(x_video, labels, generator, x_audio)
