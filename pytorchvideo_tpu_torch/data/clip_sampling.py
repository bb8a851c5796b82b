"""Clip samplers: (last clip end, video duration, annotation) -> ClipInfo
(counterpart of pytorchvideo_tpu/data/clip_sampling.py; upstream
pytorchvideo/data/clip_sampling.py: UniformClipSampler :98,
RandomClipSampler :239, RandomMultiClipSampler :269,
ConstantClipsPerVideoSampler :343, make_clip_sampler :72).

All time arithmetic is ``fractions.Fraction``, as upstream's
(clip_sampling.py:54, 153-161): float drift would change which frames land
in a clip. The random samplers draw from an explicit
``numpy.random.Generator`` (upstream uses the global ``random`` module), so
one generator state gives the JAX package's clips.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from fractions import Fraction
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np

Seconds = Union[float, Fraction]


class ClipInfo(NamedTuple):
    clip_start_sec: Seconds
    clip_end_sec: Seconds
    clip_index: int
    aug_index: int
    is_last_clip: bool


class ClipInfoList(NamedTuple):
    clip_start_sec: List[Seconds]
    clip_end_sec: List[Seconds]
    clip_index: List[int]
    aug_index: List[int]
    is_last_clip: List[bool]


class ClipSampler(ABC):
    """Stateful per-video clip sampler (upstream clip_sampling.py:47-70)."""

    def __init__(self, clip_duration: Seconds) -> None:
        self._clip_duration = Fraction(clip_duration)
        self._current_clip_index = 0
        self._current_aug_index = 0

    @abstractmethod
    def __call__(
        self,
        last_clip_end_time: Optional[Seconds],
        video_duration: Seconds,
        annotation: Dict[str, Any],
    ) -> ClipInfo:
        ...

    def reset(self) -> None:
        """Reset per-video state before moving to the next video."""


def make_clip_sampler(sampling_type: str, *args, **kwargs) -> ClipSampler:
    """Factory (upstream clip_sampling.py:72-96)."""
    samplers = {
        "uniform": UniformClipSampler,
        "random": RandomClipSampler,
        "constant_clips_per_video": ConstantClipsPerVideoSampler,
        "random_multi": RandomMultiClipSampler,
    }
    if sampling_type not in samplers:
        raise NotImplementedError(f"{sampling_type} not supported")
    return samplers[sampling_type](*args, **kwargs)


class UniformClipSampler(ClipSampler):
    """Evenly split the video into clip_duration-sized clips.

    Stride/backpad semantics per upstream clip_sampling.py:98-204: the next
    clip starts at ``last_end + (stride - clip_duration)``; with
    ``backpad_last`` the final window is shifted back so it ends exactly at
    the video end.
    """

    def __init__(
        self,
        clip_duration: Seconds,
        stride: Optional[Seconds] = None,
        backpad_last: bool = False,
        eps: float = 1e-6,
    ):
        super().__init__(clip_duration)
        self._stride = Fraction(stride) if stride is not None else self._clip_duration
        if self._stride <= 0:
            raise ValueError("stride must be positive")
        self._backpad_last = backpad_last
        self._eps = eps

    def _span(self, last_end: Optional[Seconds], duration: Seconds):
        delta = self._stride - self._clip_duration
        start = Fraction((-delta if last_end is None else last_end) + delta)
        end = start + self._clip_duration
        if self._backpad_last:
            overhang = max(0, end - duration)
            start = Fraction(max(0, start - overhang))
            end = start + self._clip_duration
        return start, end

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfo:
        start, end = self._span(last_clip_end_time, video_duration)
        _, next_end = self._span(end, video_duration)
        if self._backpad_last:
            is_last = abs(next_end - end) < self._eps
        else:
            is_last = (next_end - video_duration) > self._eps

        index = self._current_clip_index
        self._current_clip_index += 1
        if is_last:
            self.reset()
        return ClipInfo(start, end, index, 0, is_last)

    def reset(self):
        self._current_clip_index = 0


class UniformClipSamplerTruncateFromStart(UniformClipSampler):
    """Uniform sampling restricted to [0, truncation_duration]
    (upstream clip_sampling.py:206-237)."""

    def __init__(
        self,
        clip_duration: Seconds,
        stride: Optional[Seconds] = None,
        backpad_last: bool = False,
        eps: float = 1e-6,
        truncation_duration: Optional[float] = None,
    ):
        super().__init__(clip_duration, stride, backpad_last, eps)
        self.truncation_duration = truncation_duration

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfo:
        if self.truncation_duration is not None:
            video_duration = min(self.truncation_duration, video_duration)
        return super().__call__(last_clip_end_time, video_duration, annotation)


class RandomClipSampler(ClipSampler):
    """One uniformly-random clip per video (upstream clip_sampling.py:239-267)."""

    def __init__(
        self, clip_duration: Seconds, rng: Optional[np.random.Generator] = None
    ):
        super().__init__(clip_duration)
        self._rng = rng or np.random.default_rng()

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfo:
        max_start = max(video_duration - self._clip_duration, 0)
        start = Fraction(float(self._rng.uniform(0, float(max_start))))
        return ClipInfo(start, start + self._clip_duration, 0, 0, True)


class RandomMultiClipSampler(RandomClipSampler):
    """N random clips per video -> ClipInfoList (upstream :269-310)."""

    def __init__(
        self,
        clip_duration: Seconds,
        num_clips: int,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(clip_duration, rng)
        self._num_clips = num_clips

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfoList:
        clips = [
            RandomClipSampler.__call__(
                self, last_clip_end_time, video_duration, annotation
            )
            for _ in range(self._num_clips)
        ]
        return ClipInfoList(*(list(col) for col in zip(*clips)))


class RandomMultiClipSamplerTruncateFromStart(RandomMultiClipSampler):
    """Reference clip_sampling.py:313-340."""

    def __init__(
        self,
        clip_duration: Seconds,
        num_clips: int,
        truncation_duration: Optional[float] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(clip_duration, num_clips, rng)
        self.truncation_duration = truncation_duration

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfoList:
        if self.truncation_duration is not None:
            video_duration = min(self.truncation_duration, video_duration)
        return super().__call__(last_clip_end_time, video_duration, annotation)


class ConstantClipsPerVideoSampler(ClipSampler):
    """clips_per_video evenly-spaced clips x augs_per_clip views each
    (upstream clip_sampling.py:343-410)."""

    def __init__(
        self, clip_duration: Seconds, clips_per_video: int, augs_per_clip: int = 1
    ):
        super().__init__(clip_duration)
        self._clips_per_video = clips_per_video
        self._augs_per_clip = augs_per_clip

    def __call__(self, last_clip_end_time, video_duration, annotation) -> ClipInfo:
        max_start = Fraction(max(video_duration - self._clip_duration, 0))
        spacing = Fraction(max_start, max(self._clips_per_video - 1, 1))
        start = spacing * self._current_clip_index
        clip_index = self._current_clip_index
        aug_index = self._current_aug_index

        self._current_aug_index += 1
        if self._current_aug_index >= self._augs_per_clip:
            self._current_clip_index += 1
            self._current_aug_index = 0

        is_last = (
            self._current_clip_index >= self._clips_per_video
            or spacing * self._current_clip_index > max_start
        )
        if is_last:
            self.reset()
        return ClipInfo(
            start, start + self._clip_duration, clip_index, aug_index, is_last
        )

    def reset(self):
        self._current_clip_index = 0
        self._current_aug_index = 0
