"""The HMDB51 dataset (counterpart of pytorchvideo_tpu/data/hmdb51.py;
upstream pytorchvideo/data/hmdb51.py: Hmdb51LabeledVideoPaths :21, Hmdb51
:169). A fold's split files are ``<action>_test_split<fold>.txt``, one line
``<video> <0|1|2>`` a video: unused, train or test.
"""

from __future__ import annotations

import os
import pathlib
from typing import Any, Callable, List, Optional, Tuple, Type, Union

from pytorchvideo_tpu_torch.data.clip_sampling import ClipSampler
from pytorchvideo_tpu_torch.data.labeled_video_dataset import LabeledVideoDataset
from pytorchvideo_tpu_torch.data.samplers import RandomSampler


class Hmdb51LabeledVideoPaths:
    """(video path, {"label": action, "meta_tags": [...]}) pairs of one
    split of one fold."""

    _allowed_splits = [1, 2, 3]
    _split_type_dict = {"train": 1, "test": 2, "unused": 0}

    def __init__(self, paths_and_labels: List[Tuple[str, Optional[dict]]],
                 path_prefix: str = "") -> None:
        self._paths_and_labels = paths_and_labels
        self._path_prefix = path_prefix

    @classmethod
    def from_dir(cls, data_path: str, split_id: int = 1, split_type: str = "train"
                 ) -> "Hmdb51LabeledVideoPaths":
        """The split files of fold ``split_id`` in ``data_path``, in name
        order."""
        data_path = pathlib.Path(data_path)
        if not data_path.is_dir():
            raise FileNotFoundError(f"{data_path} not found or not a directory.")
        if int(split_id) not in cls._allowed_splits:
            raise ValueError(f"split_id must be one of {cls._allowed_splits}, got {split_id}")
        file_name_format = "_test_split" + str(int(split_id))
        file_paths = sorted(f for f in data_path.iterdir()
                            if f.is_file() and f.suffix == ".txt" and file_name_format in f.stem)
        return cls.from_csvs(file_paths, split_type)

    @classmethod
    def from_csvs(cls, file_paths: List[Union[pathlib.Path, str]], split_type: str = "train"
                  ) -> "Hmdb51LabeledVideoPaths":
        """The ``split_type`` videos of the split files: each video's path
        is ``<action>/<video>``, its meta tags the five ``_`` fields before
        the last."""
        video_paths_and_label: List[Tuple[str, Optional[dict]]] = []
        for file_path in file_paths:
            file_path = pathlib.Path(file_path)
            if not os.path.exists(file_path):
                raise FileNotFoundError(f"{file_path} not found.")
            if not (file_path.suffix == ".txt" and "_test_split" in file_path.stem):
                raise ValueError(f"Invalid file: {file_path}")
            action_name = "_".join(file_path.stem.split("_")[:-2])
            with open(file_path, "r") as f:
                for path_label in f.read().splitlines():
                    line_split = path_label.rsplit(None, 1)
                    if int(line_split[1]) != cls._split_type_dict[split_type]:
                        continue
                    video_path = os.path.join(action_name, line_split[0])
                    meta_tags = line_split[0].split("_")[-6:-1]
                    video_paths_and_label.append(
                        (video_path, {"label": action_name, "meta_tags": meta_tags}))
        if not video_paths_and_label:
            raise ValueError("Failed to load HMDB51 splits.")
        return cls(video_paths_and_label)

    @property
    def path_prefix(self):
        return self._path_prefix

    @path_prefix.setter
    def path_prefix(self, value):
        self._path_prefix = value

    def __getitem__(self, index) -> Tuple[str, dict]:
        path, label = self._paths_and_labels[index]
        return os.path.join(self._path_prefix, path), label

    def __len__(self) -> int:
        return len(self._paths_and_labels)


def Hmdb51(
    data_path: str,
    clip_sampler: ClipSampler,
    video_sampler: Type = RandomSampler,
    transform: Optional[Callable[[dict], Any]] = None,
    video_path_prefix: str = "",
    split_id: int = 1,
    split_type: str = "train",
    decode_audio: bool = False,
    decoder: str = "opencv",
) -> LabeledVideoDataset:
    """The HMDB51 clip dataset of one split of one fold (upstream
    hmdb51.py:169-231)."""
    labeled_video_paths = Hmdb51LabeledVideoPaths.from_dir(data_path, split_id=split_id,
                                                           split_type=split_type)
    labeled_video_paths.path_prefix = video_path_prefix
    return LabeledVideoDataset(labeled_video_paths, clip_sampler, video_sampler, transform,
                               decode_audio=decode_audio, decoder=decoder)
