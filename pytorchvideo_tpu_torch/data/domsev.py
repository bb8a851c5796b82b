"""The DoMSEV egocentric datasets, frame-level and clip-level (counterpart
of pytorchvideo_tpu/data/domsev.py; upstream pytorchvideo/data/domsev.py:
label maps :32-74, LabelData :77, DomsevFrameDataset :136,
DomsevVideoDataset :300, the overlap of two time ranges :109-124). An
image is an (H, W, C) uint8 RGB tensor, a clip a (T, H, W, C) one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from pytorchvideo_tpu_torch.data.dataset_manifest_utils import (
    ImageDataset,
    ImageFrameInfo,
    VideoClipInfo,
    VideoDataset,
    VideoDatasetType,
)
from pytorchvideo_tpu_torch.data.frame_video import _load_images_with_retries
from pytorchvideo_tpu_torch.data.utils import DataclassFieldCaster, load_dataclass_dict_from_csv
from pytorchvideo_tpu_torch.data.video import Video

USER_ENVIRONMENT_MAP = {
    0: "none",
    1: "indoor",
    2: "nature",
    3: "crowded_environment",
    4: "urban",
}

USER_ACTIVITY_MAP = {
    0: "none",
    1: "walking",
    2: "running",
    3: "standing",
    4: "biking",
    5: "driving",
    6: "playing",
    7: "cooking",
    8: "eating",
    9: "observing",
    10: "in_conversation",
    11: "browsing",
    12: "shopping",
}

USER_ATTENTION_MAP = {
    0: "none",
    1: "paying_attention",
    2: "interacting",
}


class LabelType(Enum):
    Environment = 1
    Activity = 2
    UserAttention = 3


LABEL_TYPE_2_MAP = {
    LabelType.Environment: USER_ENVIRONMENT_MAP,
    LabelType.Activity: USER_ACTIVITY_MAP,
    LabelType.UserAttention: USER_ATTENTION_MAP,
}


@dataclass
class LabelData(DataclassFieldCaster):
    """One label over a contiguous segment of a video."""

    video_id: str
    start_time: float
    stop_time: float
    start_frame: int
    stop_frame: int
    label_id: int
    label_name: str


def _seconds_to_frame_index(time_in_seconds: float, fps: int, zero_indexed: bool = True) -> int:
    """The frame at ``time_in_seconds``, rounding down (upstream :90-107)."""
    frame_idx = math.floor(time_in_seconds * fps)
    if not zero_indexed:
        frame_idx += 1
    return frame_idx


def _get_overlap_for_time_range_pair(t1_start: float, t1_stop: float, t2_start: float,
                                     t2_stop: float) -> Optional[Tuple[float, float]]:
    """The overlap of two time ranges, or None (upstream :109-124)."""
    if (t1_start <= t2_stop) and (t2_start <= t1_stop):
        return (max(t1_start, t2_start), min(t1_stop, t2_stop))
    return None


class DomsevFrameDataset:
    """Frame-level classification: item ``i`` is {"frame_id", "image",
    "label"} of the frames in an order shuffled once by ``generator`` (a
    CPU ``torch.Generator``; None: torch's default one) (upstream
    :136-297)."""

    def __init__(
        self,
        video_data_manifest_file_path: str,
        video_info_file_path: str,
        labels_file_path: str,
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        multithreaded_io: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        if not (video_info_file_path and labels_file_path and video_data_manifest_file_path):
            raise ValueError("the manifest, video info and labels files are all needed")
        frames_dict: Dict[str, ImageFrameInfo] = ImageDataset._load_images(
            video_data_manifest_file_path, video_info_file_path, multithreaded_io)
        video_labels: Dict[str, List[LabelData]] = load_dataclass_dict_from_csv(
            labels_file_path, LabelData, "video_id", list_per_key=True)
        self._labels_per_frame = self._assign_labels_to_frames(frames_dict, video_labels)
        self._user_transform = transform
        frames = list(frames_dict.values())
        self._frames = [frames[i] for i in torch.randperm(len(frames), generator=generator)]

    @staticmethod
    def _assign_labels_to_frames(frames_dict: Dict[str, ImageFrameInfo],
                                 video_labels: Dict[str, List[LabelData]]) -> Dict[str, int]:
        """Each frame's label: the last label whose frame span holds it."""
        labels_per_frame: Dict[str, int] = {}
        for frame_id, image_info in frames_dict.items():
            for label in video_labels[image_info.video_id]:
                if label.start_frame <= image_info.frame_number <= label.stop_frame:
                    labels_per_frame[frame_id] = label.label_id
        return labels_per_frame

    def __getitem__(self, index) -> Dict[str, Any]:
        frame = self._frames[index]
        frame_data = {
            "frame_id": frame.frame_id,
            "image": _load_images_with_retries([frame.frame_file_path],
                                                multithreaded=False)[0],
            "label": self._labels_per_frame[frame.frame_id],
        }
        for key in frame_data:
            if frame_data[key] is None:
                frame_data[key] = torch.empty(0, dtype=torch.float64)
        if self._user_transform:
            frame_data = self._user_transform(frame_data)
        return frame_data

    def __len__(self) -> int:
        return len(self._frames)


class DomsevVideoDataset:
    """Clip-level: clip ``i`` holds one label a frame (at
    ``frames_per_second``) of each label's overlap with the clip, as an
    int64 tensor under "labels" (upstream :300-449)."""

    def __init__(
        self,
        video_data_manifest_file_path: str,
        video_info_file_path: str,
        labels_file_path: str,
        clip_sampler: Callable[[Dict[str, Video], Dict[str, List[LabelData]]],
                               List[VideoClipInfo]],
        dataset_type: VideoDatasetType = VideoDatasetType.Frame,
        frames_per_second: int = 1,
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        frame_filter: Optional[Callable[[List[int]], List[int]]] = None,
        multithreaded_io: bool = False,
    ) -> None:
        if not (video_info_file_path and labels_file_path and video_data_manifest_file_path):
            raise ValueError("the manifest, video info and labels files are all needed")
        self._videos: Dict[str, Video] = VideoDataset._load_videos(
            video_data_manifest_file_path, video_info_file_path, multithreaded_io, dataset_type)
        self._labels_per_video: Dict[str, List[LabelData]] = load_dataclass_dict_from_csv(
            labels_file_path, LabelData, "video_id", list_per_key=True)
        self._clips: List[VideoClipInfo] = clip_sampler(self._videos, self._labels_per_video)
        self._frames_per_second = frames_per_second
        self._user_transform = transform
        self._frame_filter = frame_filter

    def __getitem__(self, index) -> Dict[str, Any]:
        clip = self._clips[index]
        labels_in_clip = []
        for label_data in self._labels_per_video[clip.video_id]:
            overlap = _get_overlap_for_time_range_pair(clip.start_time, clip.stop_time,
                                                       label_data.start_time,
                                                       label_data.stop_time)
            if overlap is not None:
                start_f = _seconds_to_frame_index(overlap[0], self._frames_per_second)
                stop_f = _seconds_to_frame_index(overlap[1], self._frames_per_second)
                labels_in_clip.extend([label_data] * (stop_f - start_f))

        clip_data = {
            "video_id": clip.video_id,
            **self._videos[clip.video_id].get_clip(clip.start_time, clip.stop_time),
            "labels": torch.tensor([ld.label_id for ld in labels_in_clip], dtype=torch.int64),
            "start_time": clip.start_time,
            "stop_time": clip.stop_time,
        }
        for key in clip_data:
            if clip_data[key] is None:
                clip_data[key] = torch.empty(0, dtype=torch.float64)
        if self._user_transform:
            clip_data = self._user_transform(clip_data)
        return clip_data

    def __len__(self) -> int:
        return len(self._clips)
