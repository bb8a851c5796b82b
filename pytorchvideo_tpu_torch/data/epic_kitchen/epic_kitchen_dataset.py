"""The EPIC-Kitchens-55 dataset over manifests (counterpart of
pytorchvideo_tpu/data/epic_kitchen/epic_kitchen_dataset.py; upstream
pytorchvideo/data/epic_kitchen/epic_kitchen_dataset.py:20-200): videos
from the manifests, their actions from a CSV, and the clip list an injected
sampler makes of both; a map-style dataset over that list.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from pytorchvideo_tpu_torch.data.dataset_manifest_utils import (
    VideoClipInfo,
    VideoDataset,
    VideoDatasetType,
    get_seconds_from_hms_time,
)
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo
from pytorchvideo_tpu_torch.data.utils import (
    DataclassFieldCaster,
    complex_initialized_dataclass_field,
    load_dataclass_dict_from_csv,
)
from pytorchvideo_tpu_torch.data.video import Video


@dataclass
class ActionData(DataclassFieldCaster):
    """One action row of the annotations: ``HH:MM:SS.f`` timestamps, the
    noun lists as Python literals."""

    participant_id: str
    video_id: str
    narration: str
    start_timestamp: str
    stop_timestamp: str
    start_frame: int
    stop_frame: int
    verb: str
    verb_class: int
    noun: str
    noun_class: int
    all_nouns: list = complex_initialized_dataclass_field(ast.literal_eval)
    all_noun_classes: list = complex_initialized_dataclass_field(ast.literal_eval)

    @property
    def start_time(self) -> float:
        return get_seconds_from_hms_time(self.start_timestamp)

    @property
    def stop_time(self) -> float:
        return get_seconds_from_hms_time(self.stop_timestamp)


class EpicKitchenDataset:
    """Clip ``i`` is ``{"video_id", **the video's clip dict, "actions",
    "start_time", "stop_time"}`` through ``transform``; a frame video's
    frames go through ``frame_filter`` before any is read."""

    def __init__(
        self,
        video_info_file_path: str,
        actions_file_path: str,
        clip_sampler: Callable[[Dict[str, Video], Dict[str, List[ActionData]]],
                               List[VideoClipInfo]],
        video_data_manifest_file_path: str,
        dataset_type: VideoDatasetType = VideoDatasetType.Frame,
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        frame_filter: Optional[Callable[[List[int]], List[int]]] = None,
        multithreaded_io: bool = True,
    ) -> None:
        if not (video_info_file_path and actions_file_path and video_data_manifest_file_path
                and clip_sampler):
            raise ValueError("the video info, actions and manifest files and the clip sampler "
                             "are all needed")
        self._videos: Dict[str, Video] = VideoDataset._load_videos(
            video_data_manifest_file_path, video_info_file_path, multithreaded_io, dataset_type)
        self._actions: Dict[str, List[ActionData]] = load_dataclass_dict_from_csv(
            actions_file_path, ActionData, "video_id", list_per_key=True)
        self._clips: List[VideoClipInfo] = clip_sampler(self._videos, self._actions)
        self._transform = transform
        self._frame_filter = frame_filter

    def __getitem__(self, index) -> Dict[str, Any]:
        clip = self._clips[index]
        video = self._videos[clip.video_id]
        if isinstance(video, FrameVideo):
            clip_dict = video.get_clip(clip.start_time, clip.stop_time, self._frame_filter)
        else:
            clip_dict = video.get_clip(clip.start_time, clip.stop_time)
        clip_data = {
            "video_id": clip.video_id,
            **clip_dict,
            "actions": self._actions[clip.video_id],
            "start_time": clip.start_time,
            "stop_time": clip.stop_time,
        }
        if self._transform:
            clip_data = self._transform(clip_data)
        return clip_data

    def __len__(self) -> int:
        return len(self._clips)
