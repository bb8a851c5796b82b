"""Manifest-driven videos and images, shared by EPIC-Kitchens and DoMSEV
(counterpart of pytorchvideo_tpu/data/dataset_manifest_utils.py; upstream
pytorchvideo/data/dataset_manifest_utils.py:20-314): the CSV manifest
dataclasses, frame paths rebuilt from a stem and zero padding, loading
frame directories or encoded files by ``VideoDatasetType``, and the two
manifest writers.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Union

from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo
from pytorchvideo_tpu_torch.data.utils import (
    DataclassFieldCaster,
    load_dataclass_dict_from_csv,
    save_dataclass_objs_to_headered_csv,
)
from pytorchvideo_tpu_torch.data.video import Video


@dataclass
class EncodedVideoInfo(DataclassFieldCaster):
    """Where an encoded video lies."""

    video_id: str
    file_path: str


@dataclass
class VideoFrameInfo(DataclassFieldCaster):
    """Where a video's frames lie: ``location/<stem><zero-padded number>.<ext>``
    for each number in [min_frame_number, max_frame_number]."""

    video_id: str
    location: str
    frame_file_stem: str
    frame_string_length: int
    min_frame_number: int
    max_frame_number: int
    file_extension: str


@dataclass
class VideoInfo(DataclassFieldCaster):
    """A video's metadata."""

    video_id: str
    resolution: str
    duration: float
    fps: float


@dataclass
class VideoClipInfo(DataclassFieldCaster):
    video_id: str
    start_time: float
    stop_time: float


@dataclass
class ImageFrameInfo(DataclassFieldCaster):
    """One frame of a video, as an image."""

    video_id: str
    frame_id: str
    frame_number: int
    frame_file_path: str


class VideoDatasetType(Enum):
    Frame = 1
    EncodedVideo = 2


class VideoDataset:
    @staticmethod
    def _load_videos(video_data_manifest_file_path: Optional[str], video_info_file_path: str,
                     multithreaded_io: bool, dataset_type: VideoDatasetType
                     ) -> Dict[str, Video]:
        """The videos of both manifests, as frame videos or encoded ones."""
        video_infos: Dict[str, VideoInfo] = load_dataclass_dict_from_csv(
            video_info_file_path, VideoInfo, "video_id")
        if dataset_type == VideoDatasetType.Frame:
            return VideoDataset._load_frame_videos(video_data_manifest_file_path, video_infos,
                                                   multithreaded_io)
        return VideoDataset._load_encoded_videos(video_data_manifest_file_path, video_infos)

    @staticmethod
    def _load_frame_videos(frame_manifest_file_path: str, video_infos: Dict[str, VideoInfo],
                           multithreaded_io: bool) -> Dict[str, FrameVideo]:
        video_frames: Dict[str, VideoFrameInfo] = load_dataclass_dict_from_csv(
            frame_manifest_file_path, VideoFrameInfo, "video_id")
        VideoDataset._remove_video_info_missing_or_incomplete_videos(video_frames, video_infos)
        return {
            video_id: FrameVideo(
                video_frame_paths=VideoDataset._frame_number_to_filepaths(
                    video_id, video_frames, video_infos),
                duration=video_infos[video_id].duration,
                fps=video_infos[video_id].fps,
                multithreaded_io=multithreaded_io,
            )
            for video_id in video_infos
        }

    @staticmethod
    def _load_encoded_videos(encoded_video_manifest_file_path: str,
                             video_infos: Dict[str, VideoInfo]) -> Dict[str, Video]:
        encoded_video_infos: Dict[str, EncodedVideoInfo] = load_dataclass_dict_from_csv(
            encoded_video_manifest_file_path, EncodedVideoInfo, "video_id")
        VideoDataset._remove_video_info_missing_or_incomplete_videos(encoded_video_infos,
                                                                     video_infos)
        return {video_id: EncodedVideo.from_path(info.file_path)
                for video_id, info in encoded_video_infos.items()}

    @staticmethod
    def _frame_number_to_filepaths(video_id: str, video_frames: Dict[str, VideoFrameInfo],
                                   video_infos: Dict[str, VideoInfo]) -> Optional[List[str]]:
        """The frame paths rebuilt from the manifest's stem, zero-padded to
        ``frame_string_length``; None where a number does not fit it."""
        info = video_frames[video_infos[video_id].video_id]
        paths = []
        for frame_number in range(info.min_frame_number, info.max_frame_number + 1):
            index_str = str(frame_number)
            pad = info.frame_string_length - len(index_str) - len(info.frame_file_stem)
            if pad < 0:
                return None
            paths.append(f"{info.location}/{info.frame_file_stem}{'0' * pad}{index_str}"
                         f".{info.file_extension}")
        return paths

    @staticmethod
    def _remove_video_info_missing_or_incomplete_videos(
            video_data_infos: Dict[str, Union[VideoFrameInfo, EncodedVideoInfo]],
            video_infos: Dict[str, VideoInfo]) -> None:
        """Drops, in place, the videos missing from either manifest, and the
        frame videos whose frame count is off duration x fps by more than
        one second of frames."""
        for video_id in list(video_infos):
            info = video_infos[video_id]
            if video_id not in video_data_infos:
                del video_infos[video_id]
                continue
            data_info = video_data_infos[video_id]
            if isinstance(data_info, VideoFrameInfo):
                expected = round(info.duration * info.fps)
                num_frames = data_info.max_frame_number - data_info.min_frame_number
                if abs(num_frames - expected) > info.fps:
                    del video_data_infos[video_id]
                    del video_infos[video_id]
        for video_id in list(video_data_infos):
            if video_id not in video_infos:
                del video_data_infos[video_id]


class ImageDataset:
    @staticmethod
    def _load_images(frame_manifest_file_path: Optional[str], video_info_file_path: str,
                     multithreaded_io: bool) -> Dict[str, ImageFrameInfo]:
        """Every frame of the manifests' videos as an image, keyed by its
        file name's stem."""
        video_infos: Dict[str, VideoInfo] = load_dataclass_dict_from_csv(
            video_info_file_path, VideoInfo, "video_id")
        video_frames: Dict[str, VideoFrameInfo] = load_dataclass_dict_from_csv(
            frame_manifest_file_path, VideoFrameInfo, "video_id")
        VideoDataset._remove_video_info_missing_or_incomplete_videos(video_frames, video_infos)
        image_infos = {}
        for video_id in video_infos:
            frame_filepaths = VideoDataset._frame_number_to_filepaths(
                video_id, video_frames, video_infos)
            frame_info = video_frames[video_id]
            for frame_filepath, frame_number in zip(
                    frame_filepaths,
                    range(frame_info.min_frame_number, frame_info.max_frame_number + 1)):
                frame_id = os.path.splitext(os.path.basename(frame_filepath))[0]
                image_infos[frame_id] = ImageFrameInfo(video_id, frame_id, frame_number,
                                                       frame_filepath)
        return image_infos


def get_seconds_from_hms_time(time_str: str) -> float:
    """'HH:MM:SS' or 'HH:MM:SS.f' in seconds (upstream :300-314)."""
    for fmt in ("%H:%M:%S.%f", "%H:%M:%S"):
        try:
            t = datetime.datetime.strptime(time_str, fmt)
        except ValueError:
            continue
        return float(datetime.timedelta(hours=t.hour, minutes=t.minute, seconds=t.second,
                                        microseconds=t.microsecond).total_seconds())
    raise ValueError(f"No valid data format found for provided string {time_str}.")


def save_encoded_video_manifest(encoded_video_infos: Dict[str, EncodedVideoInfo],
                                file_name: Optional[str] = None) -> str:
    """An encoded-video manifest as a headered CSV (default
    ``./encoded_video_manifest.csv``); returns its path (upstream :269-290)."""
    file_name = f"{os.getcwd()}/encoded_video_manifest.csv" if file_name is None else file_name
    save_dataclass_objs_to_headered_csv(list(encoded_video_infos.values()), file_name)
    return file_name


def save_video_frame_info(video_frames: Dict[str, VideoFrameInfo],
                          file_name: Optional[str] = None) -> str:
    """A frame-video manifest as a headered CSV (default
    ``./video_frame_metadata.csv``); returns its path (upstream :293-314)."""
    file_name = f"{os.getcwd()}/video_frame_metadata.csv" if file_name is None else file_name
    save_dataclass_objs_to_headered_csv(list(video_frames.values()), file_name)
    return file_name
