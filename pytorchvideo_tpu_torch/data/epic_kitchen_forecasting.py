"""EPIC-Kitchens action forecasting (counterpart of
pytorchvideo_tpu/data/epic_kitchen_forecasting.py; upstream
pytorchvideo/data/epic_kitchen_forecasting.py:19-300): an input window of
``num_input_clips`` subclips, ``clip_time_stride`` apart, that ends where an
action stops; the labels are the next ``num_forecast_actions`` actions. The
video comes out as (num_input_clips, frames_per_clip, H, W, C).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import torch

from pytorchvideo_tpu_torch.data.dataset_manifest_utils import VideoClipInfo, VideoDatasetType
from pytorchvideo_tpu_torch.data.epic_kitchen import ActionData, EpicKitchenDataset
from pytorchvideo_tpu_torch.data.video import Video


class ClipSampling(Enum):
    Random = 1


class EpicKitchenForecasting(EpicKitchenDataset):
    def __init__(
        self,
        video_info_file_path: str,
        actions_file_path: str,
        video_data_manifest_file_path: str,
        clip_sampling: ClipSampling = ClipSampling.Random,
        dataset_type: VideoDatasetType = VideoDatasetType.Frame,
        seconds_per_clip: float = 2.0,
        clip_time_stride: float = 10.0,
        num_input_clips: int = 1,
        frames_per_clip: Optional[int] = None,
        num_forecast_actions: int = 1,
        transform: Optional[Callable] = None,
        multithreaded_io: bool = True,
    ):
        define_clip_structure_fn = self._define_clip_structure_generator(
            clip_sampling, seconds_per_clip, clip_time_stride, num_input_clips,
            num_forecast_actions)
        frame_filter = (self._frame_filter_generator(frames_per_clip, seconds_per_clip,
                                                     clip_time_stride, num_input_clips)
                        if frames_per_clip is not None else None)
        transform = self._transform_generator(transform, num_forecast_actions, frames_per_clip,
                                              num_input_clips)
        super().__init__(
            video_info_file_path=video_info_file_path,
            actions_file_path=actions_file_path,
            video_data_manifest_file_path=video_data_manifest_file_path,
            dataset_type=dataset_type,
            transform=transform,
            frame_filter=frame_filter,
            clip_sampler=define_clip_structure_fn,
            multithreaded_io=multithreaded_io,
        )

    @staticmethod
    def _transform_generator(transform: Optional[Callable], num_forecast_actions: int,
                             frames_per_clip: int, num_input_clips: int
                             ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
        """The labels: the first ``num_forecast_actions`` actions that start
        after the window; the (T, H, W, C) video stacked into its subclips
        (upstream :138-186)."""

        def transform_clip(clip: Dict[str, Any]) -> Dict[str, Any]:
            actions = clip["actions"]
            if any(actions[i].start_time > actions[i + 1].start_time
                   for i in range(len(actions) - 1)):
                raise ValueError("Actions must be sorted")
            clip["actions"] = [a for a in actions
                               if a.start_time > clip["stop_time"]][:num_forecast_actions]
            video = clip["video"]
            if video.shape[0] != num_input_clips * frames_per_clip:
                raise ValueError(f"{video.shape[0]} frames, expected "
                                 f"{num_input_clips} x {frames_per_clip}")
            clip["video"] = torch.stack([video[i * frames_per_clip:(i + 1) * frames_per_clip]
                                         for i in range(num_input_clips)])
            for key in clip:
                if clip[key] is None:
                    clip[key] = torch.empty(0, dtype=torch.float64)
            if transform:
                clip = transform(clip)
            return clip

        return transform_clip

    @staticmethod
    def _frame_filter_generator(frames_per_clip: int, seconds_per_clip: float,
                                clip_time_stride: float, num_input_clips: int
                                ) -> Callable[[List[int]], List[int]]:
        """Each subclip's ``frames_per_clip`` frames within the window
        (upstream :189-238)."""
        time_window_length = seconds_per_clip + (num_input_clips - 1) * clip_time_stride
        desired_fps = frames_per_clip / seconds_per_clip

        def frame_filter(frame_indices: List[int]) -> List[int]:
            available_fps = len(frame_indices) / time_window_length
            intra_stride = int(available_fps // desired_fps)
            selected = set()
            for i in range(num_input_clips):
                clip_start = int(i * clip_time_stride * available_fps)
                for j in range(frames_per_clip):
                    selected.add(clip_start + j * intra_stride)
            return [x for i, x in enumerate(frame_indices) if i in selected]

        return frame_filter

    @staticmethod
    def _define_clip_structure_generator(clip_sampling: ClipSampling, seconds_per_clip: float,
                                         clip_time_stride: float, num_input_clips: int,
                                         num_forecast_actions: int):
        """A window ending at each action's stop that has
        ``num_forecast_actions`` later actions and starts inside the video
        (upstream :241-300)."""
        if clip_sampling != ClipSampling.Random:
            raise NotImplementedError(f"{clip_sampling} not implemented.")
        time_window_length = seconds_per_clip + (num_input_clips - 1) * clip_time_stride

        def define_clip_structure(videos: Dict[str, Video],
                                  video_actions: Dict[str, List[ActionData]]
                                  ) -> List[VideoClipInfo]:
            clips = []
            for video_id, actions in video_actions.items():
                for i, action in enumerate(actions[: -1 * num_forecast_actions]):
                    number_valid_actions = 0
                    for j in range(i + 1, len(actions)):
                        if actions[j].start_time > action.stop_time:
                            number_valid_actions += 1
                        if number_valid_actions == num_forecast_actions:
                            if action.start_time - time_window_length >= 0:
                                clips.append(VideoClipInfo(
                                    video_id, action.stop_time - time_window_length,
                                    action.stop_time))
                            break
            return clips

        return define_clip_structure
