"""The Charades dataset (counterpart of pytorchvideo_tpu/data/charades.py;
upstream pytorchvideo/data/charades.py:19-219): an iterable over frame
videos with each frame's action labels, read from a space-separated CSV
(``original_vido_id video_id frame_id path labels``). A sample holds the
clip's per-frame label lists and the video's labels, their sorted union.
"""

from __future__ import annotations

import csv
import functools
import itertools
import os
from collections import defaultdict
from typing import Any, Callable, List, Optional, Tuple, Type

from pytorchvideo_tpu_torch.data.clip_sampling import ClipSampler
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo
from pytorchvideo_tpu_torch.data.samplers import RandomSampler
from pytorchvideo_tpu_torch.data.utils import MultiProcessSampler
from pytorchvideo_tpu_torch.transforms.functional import linspace_indices


class Charades:
    """Iterable over {"video", "label" (a list per frame of the clip's
    span), "video_label", "video_name", "video_index", "clip_index",
    "aug_index"}; "video" a (T, H, W, C) uint8 tensor."""

    NUM_CLASSES = 157

    def __init__(
        self,
        data_path: str,
        clip_sampler: ClipSampler,
        video_sampler: Type = RandomSampler,
        transform: Optional[Callable[[dict], Any]] = None,
        video_path_prefix: str = "",
        frames_per_clip: Optional[int] = None,
    ) -> None:
        self._transform = transform
        self._clip_sampler = clip_sampler
        self._path_to_videos, self._labels, self._video_labels = _read_video_paths_and_labels(
            data_path, prefix=video_path_prefix)
        self._video_sampler = video_sampler(self._path_to_videos)
        self._video_sampler_iter = None
        self._frame_filter = (
            functools.partial(Charades._sample_clip_frames, frames_per_clip=frames_per_clip)
            if frames_per_clip is not None else None)
        self._loaded_video = None
        self._loaded_clip = None
        self._next_clip_start_time = 0.0

    @staticmethod
    def _sample_clip_frames(frame_indices: List[int], frames_per_clip: int) -> List[int]:
        """``frames_per_clip`` of the indices, evenly spaced as numpy's
        ``linspace`` spaces them (upstream charades.py:83-98)."""
        picks = linspace_indices(len(frame_indices), frames_per_clip).tolist()
        return [frame_indices[i] for i in picks]

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
            self._loaded_clip = video.get_clip(clip_start, clip_end, self._frame_filter)

        frames = self._loaded_clip["video"]
        frame_indices = self._loaded_clip["frame_indices"]
        self._next_clip_start_time = clip_end
        if is_last_clip:
            self._loaded_video = None
            self._next_clip_start_time = 0.0

        labels_by_frame = [self._labels[video_index][i]
                           for i in range(min(frame_indices), max(frame_indices) + 1)]
        sample_dict = {
            "video": frames,
            "label": labels_by_frame,
            "video_label": self._video_labels[video_index],
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


def _read_video_paths_and_labels(
        video_path_label_file: str, prefix: str = ""
) -> Tuple[List[List[str]], List[List[List[int]]], List[List[int]]]:
    """Each video's frame paths, per-frame labels and label union, videos in
    first-seen order (upstream charades.py:183-219)."""
    image_paths = defaultdict(list)
    labels = defaultdict(list)
    with open(video_path_label_file, "r") as f:
        for row in csv.DictReader(f, delimiter=" "):
            if len(row) != 5:
                raise ValueError(f"{video_path_label_file}: a row of {len(row)} columns, not 5")
            video_name = row["original_vido_id"]
            image_paths[video_name].append(os.path.join(prefix, row["path"]))
            frame_labels = row["labels"].replace('"', "")
            labels[video_name].append([int(x) for x in frame_labels.split(",")]
                                      if frame_labels else [])
    video_names = list(image_paths.keys())
    labels_list = [labels[k] for k in video_names]
    video_labels = [sorted(set(itertools.chain(*label_list))) for label_list in labels_list]
    return [image_paths[k] for k in video_names], labels_list, video_labels
