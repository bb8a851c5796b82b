"""EPIC-Kitchens action recognition (counterpart of
pytorchvideo_tpu/data/epic_kitchen_recognition.py; upstream
pytorchvideo/data/epic_kitchen_recognition.py:20-224): each video tiled by
clips of ``seconds_per_clip`` from a random offset, a clip's actions pruned
to those that overlap it.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import torch

from pytorchvideo_tpu_torch.data.dataset_manifest_utils import VideoClipInfo, VideoDatasetType
from pytorchvideo_tpu_torch.data.epic_kitchen import ActionData, EpicKitchenDataset
from pytorchvideo_tpu_torch.data.video import Video


class ClipSampling(Enum):
    RandomOffsetUniform = 1


class EpicKitchenRecognition(EpicKitchenDataset):
    """Each video's offset is drawn from ``generator`` (a CPU
    ``torch.Generator``; None: torch's default one), uniform in [0,
    seconds_per_clip)."""

    def __init__(
        self,
        video_info_file_path: str,
        actions_file_path: str,
        video_data_manifest_file_path: str,
        clip_sampling: ClipSampling = ClipSampling.RandomOffsetUniform,
        dataset_type: VideoDatasetType = VideoDatasetType.Frame,
        seconds_per_clip: float = 2.0,
        frames_per_clip: Optional[int] = None,
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        multithreaded_io: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        define_clip_structure_fn = self._define_clip_structure_generator(
            seconds_per_clip, clip_sampling, generator)
        transform = self._transform_generator(transform)
        frame_filter = (self._frame_filter_generator(frames_per_clip)
                        if frames_per_clip is not None else None)
        super().__init__(
            video_info_file_path=video_info_file_path,
            actions_file_path=actions_file_path,
            dataset_type=dataset_type,
            video_data_manifest_file_path=video_data_manifest_file_path,
            transform=transform,
            frame_filter=frame_filter,
            clip_sampler=define_clip_structure_fn,
            multithreaded_io=multithreaded_io,
        )

    @staticmethod
    def _transform_generator(transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]]
                             ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
        """Keeps the actions that overlap the clip, puts an empty tensor
        where the clip dict holds None, then runs ``transform``
        (upstream :119-149)."""

        def transform_clip(clip: Dict[str, Any]) -> Dict[str, Any]:
            clip["actions"] = [a for a in clip["actions"]
                               if a.start_time <= clip["stop_time"]
                               and a.stop_time >= clip["start_time"]]
            for key in clip:
                if clip[key] is None:
                    clip[key] = torch.empty(0, dtype=torch.float64)
            if transform:
                clip = transform(clip)
            return clip

        return transform_clip

    @staticmethod
    def _frame_filter_generator(frames_per_clip: int) -> Callable[[List[int]], List[int]]:
        """Every ``len // frames_per_clip``-th frame (upstream :152-168)."""

        def frame_filter(frame_indices: List[int]) -> List[int]:
            num_frames = len(frame_indices)
            frame_step = int(num_frames // frames_per_clip)
            selected = set(range(0, num_frames, frame_step))
            return [x for i, x in enumerate(frame_indices) if i in selected]

        return frame_filter

    @staticmethod
    def _define_clip_structure_generator(seconds_per_clip: float, clip_sampling: ClipSampling,
                                         generator: Optional[torch.Generator] = None):
        """Clips tiling each video from its offset (upstream :171-224)."""
        if clip_sampling != ClipSampling.RandomOffsetUniform:
            raise NotImplementedError(f"{clip_sampling} not implemented.")

        def define_clip_structure(videos: Dict[str, Video], actions: Dict[str, List[ActionData]]
                                  ) -> List[VideoClipInfo]:
            clips = []
            for video_id, video in videos.items():
                offset = float(torch.rand((), generator=generator, dtype=torch.float64))
                offset *= seconds_per_clip
                num_clips = int((video.duration - offset) // seconds_per_clip)
                for i in range(num_clips):
                    start = i * seconds_per_clip + offset
                    clips.append(VideoClipInfo(video_id, start, start + seconds_per_clip))
            return clips

        return define_clip_structure
