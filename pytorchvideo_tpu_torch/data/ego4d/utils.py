"""Ego4d helpers (counterpart of pytorchvideo_tpu/data/ego4d/utils.py;
upstream pytorchvideo/data/ego4d/utils.py): a window brought to its length
inside the video (``check_window_len``), the moments clip sampler, the
label-id map and the IMU reader's interface.
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

from pytorchvideo_tpu_torch.data.clip_sampling import ClipInfo, ClipSampler

log = logging.getLogger("Ego4dDatasetUtils")


def check_window_len(s_time: float, e_time: float, w_len: float, video_dur: float
                     ) -> Tuple[float, float]:
    """[s_time, e_time] widened or narrowed about its centre to ``w_len``,
    then slid to start at 0 or end at ``video_dur`` where it falls out."""
    interval = e_time - s_time
    if abs(interval - w_len) > 0.001:
        delta = w_len - (e_time - s_time)
        s_time -= delta / 2
        e_time += delta / 2
        if s_time < 0:
            e_time += -s_time
            s_time = 0
    if video_dur and e_time > video_dur:
        overlap = e_time - video_dur
        if s_time < overlap:
            raise ValueError(f"a window of {w_len} s does not fit a video of {video_dur} s")
        s_time -= overlap
        e_time -= overlap
    if abs((e_time - s_time) - w_len) > 0.01:
        log.error("check_window_len: invalid time interval: %s, %s", s_time, e_time)
    return s_time, e_time


class MomentsClipSampler(ClipSampler):
    """One clip a moment: the annotated span brought to ``window_sec`` (left
    as it is when 0), written into the annotation as ``clip_start`` and
    ``clip_end`` for the dataset's transform."""

    def __init__(self, window_sec: float = 0) -> None:
        self.window_sec = window_sec

    def __call__(self, last_clip_end_time: Optional[float], video_duration: float,
                 annotation: Dict[str, Any]) -> ClipInfo:
        if last_clip_end_time is not None and last_clip_end_time > video_duration:
            raise ValueError(f"last clip end {last_clip_end_time} after the video's end "
                             f"{video_duration}")
        start = annotation["label_video_start_sec"]
        end = annotation["label_video_end_sec"]
        if video_duration is not None and end > video_duration + 0.1:
            raise ValueError(f"Invalid video_duration/end_sec: {video_duration} / {end}")
        if end < start:
            raise ValueError(f"the moment ends at {end}, before its start {start}")
        if self.window_sec > 0:
            start, end = check_window_len(start, end, self.window_sec, video_duration)
        annotation["clip_start"] = start
        annotation["clip_end"] = end
        return ClipInfo(start, end, 0, 0, True)

    def reset(self) -> None:
        pass


def get_label_id_map(label_id_map_path: str) -> Dict[str, int]:
    """The {label name: id} JSON at ``label_id_map_path``."""
    try:
        with open(label_id_map_path, "r") as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise FileNotFoundError(f"{label_id_map_path} must be a valid label id map json: {e}")


class Ego4dImuDataBase(ABC):
    """The IMU reader's interface."""

    def __init__(self, basepath: str):
        self.basepath = basepath

    @abstractmethod
    def has_imu(self, video_uid: str) -> bool:
        ...

    @abstractmethod
    def get_imu_sample(self, video_uid: str, video_start: float, video_end: float
                       ) -> Dict[str, Any]:
        ...
