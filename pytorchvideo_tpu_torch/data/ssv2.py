"""The Something-Something v2 dataset (counterpart of
pytorchvideo_tpu/data/ssv2.py; upstream pytorchvideo/data/ssv2.py:21-249):
frame videos whose labels join the label-name JSON, the per-video label
JSON and the frame-path CSV; each clip spans its whole video and takes one
frame a segment.
"""

from __future__ import annotations

import csv
import functools
import json
import os
from collections import defaultdict
from typing import Any, Callable, List, Optional, Tuple, Type

import torch

from pytorchvideo_tpu_torch.data.clip_sampling import ClipSampler
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo
from pytorchvideo_tpu_torch.data.samplers import RandomSampler
from pytorchvideo_tpu_torch.data.utils import MultiProcessSampler


class SSv2:
    """Iterable over {"video", "label", "video_name", "video_index",
    "clip_index", "aug_index"}; "video" a (T, H, W, C) uint8 tensor. With
    ``rand_sample_frames`` each segment's frame is drawn from
    ``generator`` (a CPU ``torch.Generator``; None: torch's default one)."""

    def __init__(
        self,
        label_name_file: str,
        video_label_file: str,
        video_path_label_file: str,
        clip_sampler: ClipSampler,
        video_sampler: Type = RandomSampler,
        transform: Optional[Callable[[dict], Any]] = None,
        video_path_prefix: str = "",
        frames_per_clip: Optional[int] = None,
        rand_sample_frames: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        self._transform = transform
        self._clip_sampler = clip_sampler
        self._path_to_videos, self._labels = _read_video_paths_and_labels(
            label_name_file, video_label_file, video_path_label_file, prefix=video_path_prefix)
        self._video_sampler = video_sampler(self._path_to_videos)
        self._video_sampler_iter = None
        self._frame_filter = (
            functools.partial(SSv2._sample_clip_frames, frames_per_clip=frames_per_clip,
                              rand_sample=rand_sample_frames, generator=generator)
            if frames_per_clip is not None else None)
        self._loaded_video = None
        self._loaded_clip = None
        self._next_clip_start_time = 0.0

    @staticmethod
    def _sample_clip_frames(frame_indices: List[int], frames_per_clip: int, rand_sample: bool,
                            generator: Optional[torch.Generator] = None) -> List[int]:
        """One frame from each of ``frames_per_clip`` segments: the middle
        one, or with ``rand_sample`` one drawn uniformly from the segment's
        bounds, both included (upstream ssv2.py:119-146)."""
        seg_size = float(len(frame_indices) - 1) / frames_per_clip
        seq = []
        for i in range(frames_per_clip):
            start = round(seg_size * i)
            end = round(seg_size * (i + 1))
            if rand_sample:
                seq.append(int(torch.randint(start, end + 1, (), generator=generator)))
            else:
                seq.append((start + end) // 2)
        return [frame_indices[i] for i in seq]

    @property
    def video_sampler(self):
        return self._video_sampler

    def __next__(self) -> dict:
        if not self._video_sampler_iter:
            self._video_sampler_iter = iter(MultiProcessSampler(self._video_sampler))

        if self._loaded_video:
            video, video_index = self._loaded_video
        else:
            video_index = next(self._video_sampler_iter)
            video = FrameVideo.from_frame_paths(self._path_to_videos[video_index])
            self._loaded_video = (video, video_index)

        clip_start, clip_end, clip_index, aug_index, is_last_clip = self._clip_sampler(
            self._next_clip_start_time, video.duration, {})
        if aug_index == 0:
            # Segment sampling always spans the whole video (upstream :157).
            self._loaded_clip = video.get_clip(0, video.duration, self._frame_filter)

        self._next_clip_start_time = clip_end
        if is_last_clip:
            self._loaded_video = None
            self._next_clip_start_time = 0.0

        sample_dict = {
            "video": self._loaded_clip["video"],
            "label": self._labels[video_index],
            "video_name": str(video_index),
            "video_index": video_index,
            "clip_index": clip_index,
            "aug_index": aug_index,
        }
        if self._transform is not None:
            sample_dict = self._transform(sample_dict)
        return sample_dict

    def __iter__(self):
        return self


def _read_video_paths_and_labels(label_name_file: str, video_label_file: str,
                                 video_path_label_file: str, prefix: str = ""
                                 ) -> Tuple[List[List[str]], List[int]]:
    """The frame paths and label of each video of the label JSON that has
    frames in the CSV, in the JSON's order (upstream ssv2.py:182-249)."""
    paths = defaultdict(list)
    with open(video_path_label_file, "r") as f:
        for row in csv.DictReader(f, delimiter=" "):
            if len(row) != 5:
                raise ValueError(f"{video_path_label_file}: a row of {len(row)} columns, not 5")
            paths[row["original_vido_id"]].append(os.path.join(prefix, row["path"]))

    with open(label_name_file, "r") as f:
        label_name_dict = json.load(f)
    with open(video_label_file, "r") as f:
        video_label_json = json.load(f)

    labels, image_paths = [], []
    for video in video_label_json:
        video_name = video["id"]
        if video_name in paths:
            template = video["template"].replace("[", "").replace("]", "")
            labels.append(int(label_name_dict[template]))
            image_paths.append(paths[video_name])
    return image_paths, labels
