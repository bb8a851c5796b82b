"""Manifest builders for EPIC-Kitchens directory layouts (counterpart of
pytorchvideo_tpu/data/epic_kitchen/utils.py; upstream
pytorchvideo/data/epic_kitchen/utils.py:10-199): walk a tree of frames or
encoded videos on the local file system and give the ``VideoFrameInfo`` or
``EncodedVideoInfo`` manifest the dataset reads.
"""

from __future__ import annotations

import os
from typing import Dict

from pytorchvideo_tpu_torch.data.dataset_manifest_utils import EncodedVideoInfo, VideoFrameInfo
from pytorchvideo_tpu_torch.data.utils import optional_threaded_foreach


def _ls(path: str):
    return sorted(os.listdir(str(path)))


def _accumulate_frame(video_frames: Dict[str, VideoFrameInfo], video_id: str, location: str,
                      frame_file_name: str, frame_file_stem: str, frame_number: int) -> None:
    """Folds one frame file into its video's ``VideoFrameInfo``; a video's
    frames must be numbered without gaps, in one place, with one name
    length and one extension (upstream epic_kitchen/utils.py:52-76)."""
    file_extension = frame_file_name.split(".")[-1]
    frame_name = frame_file_name[: -(len(file_extension) + 1)]
    if video_id not in video_frames:
        video_frames[video_id] = VideoFrameInfo(
            video_id=video_id, location=location, frame_file_stem=frame_file_stem,
            frame_string_length=len(frame_name), min_frame_number=frame_number,
            max_frame_number=frame_number, file_extension=file_extension)
        return
    info = video_frames[video_id]
    if info.frame_string_length != len(frame_name):
        raise ValueError(f"Frames of two name lengths found for video {video_id}")
    if info.location != location:
        raise ValueError(f"Frames for {video_id} found in two paths: {info.location} and "
                         f"{location}")
    if info.max_frame_number + 1 != frame_number:
        raise ValueError(f"Frame {frame_number} of video {video_id} follows "
                         f"{info.max_frame_number}")
    if info.file_extension != file_extension:
        raise ValueError(f"Frames with two different file extensions found for video "
                         f"{video_id}")
    video_frames[video_id] = VideoFrameInfo(
        video_id=info.video_id, location=info.location, frame_file_stem=info.frame_file_stem,
        frame_string_length=info.frame_string_length, min_frame_number=info.min_frame_number,
        max_frame_number=frame_number, file_extension=info.file_extension)


def build_frame_manifest_from_flat_directory(data_directory_path: str, multithreaded: bool
                                             ) -> Dict[str, VideoFrameInfo]:
    """The ``{video_id}/{stem}_{number}.{ext}`` layout's manifest
    (upstream epic_kitchen/utils.py:10-84); one thread a video with
    ``multithreaded``."""
    video_frames: Dict[str, VideoFrameInfo] = {}

    def add_video_frames(video_id: str, video_path: str) -> None:
        for frame in _ls(video_path):
            file_extension = frame.split(".")[-1]
            frame_name = frame[: -(len(file_extension) + 1)]
            stem, path_frame_id = frame_name.split("_")
            _accumulate_frame(video_frames, video_id, video_path, frame, f"{stem}_",
                              int(path_frame_id))

    video_paths = [(video_id, f"{data_directory_path}/{video_id}")
                   for video_id in _ls(data_directory_path)]
    optional_threaded_foreach(add_video_frames, video_paths, multithreaded)
    return video_frames


def build_frame_manifest_from_nested_directory(data_directory_path: str, multithreaded: bool
                                               ) -> Dict[str, VideoFrameInfo]:
    """The ``{participant}/{participant}_{video}_{number}.{ext}`` layout's
    manifest, the video id ``{participant}_{video}`` (upstream
    epic_kitchen/utils.py:87-173); one thread a participant with
    ``multithreaded``."""
    video_frames: Dict[str, VideoFrameInfo] = {}

    def add_participant_video_frames(participant_id: str, participant_path: str) -> None:
        for frame_file_name in _ls(participant_path):
            file_extension = frame_file_name.split(".")[-1]
            frame_name = frame_file_name[: -(len(file_extension) + 1)]
            path_participant_id, path_video_id, path_frame_id = frame_name.split("_")
            if path_participant_id != participant_id:
                raise ValueError(f"{frame_file_name} lies under participant {participant_id}")
            video_id = f"{path_participant_id}_{path_video_id}"
            _accumulate_frame(video_frames, video_id, participant_path, frame_file_name,
                              f"{video_id}_", int(path_frame_id))

    participant_paths = [(participant_id, f"{data_directory_path}/{participant_id}")
                         for participant_id in _ls(data_directory_path)]
    optional_threaded_foreach(add_participant_video_frames, participant_paths, multithreaded)
    return video_frames


def build_encoded_manifest_from_nested_directory(data_directory_path: str
                                                 ) -> Dict[str, EncodedVideoInfo]:
    """The ``{participant}/{video file}`` layout's manifest, the video id the
    file name's first six characters (upstream epic_kitchen/utils.py:176-199)."""
    encoded_video_infos: Dict[str, EncodedVideoInfo] = {}
    for participant_id in _ls(data_directory_path):
        participant_folder_path = f"{data_directory_path}/{participant_id}"
        for video_file_name in _ls(participant_folder_path):
            video_id = video_file_name[:6]
            encoded_video_infos[video_id] = EncodedVideoInfo(
                video_id, f"{participant_folder_path}/{video_file_name}")
    return encoded_video_infos
