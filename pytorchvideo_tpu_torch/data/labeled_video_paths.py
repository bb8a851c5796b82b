"""(video path, label) lists (counterpart of
pytorchvideo_tpu/data/labeled_video_paths.py; upstream
pytorchvideo/data/labeled_video_paths.py): csv lines ``<path> <label>`` or
a tree of class directories (classes indexed alphabetically).
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Tuple

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov")


class LabeledVideoPaths:
    """Pairs of video path and integer label with optional path prefix."""

    def __init__(
        self, paths_and_labels: List[Tuple[str, Optional[int]]], path_prefix: str = ""
    ):
        self._paths_and_labels = paths_and_labels
        self._path_prefix = path_prefix

    @classmethod
    def from_path(cls, data_path: str) -> "LabeledVideoPaths":
        if os.path.isfile(data_path):
            return cls.from_csv(data_path)
        if os.path.isdir(data_path):
            return cls.from_directory(data_path)
        raise FileNotFoundError(f"{data_path} not found.")

    @classmethod
    def from_csv(cls, file_path: str) -> "LabeledVideoPaths":
        """Lines of ``<path> <integer_label>`` (label optional -> -1)."""
        if not os.path.exists(file_path):
            raise FileNotFoundError(f"{file_path} not found.")
        pairs = []
        with open(file_path, "r") as f:
            for line in f.read().splitlines():
                if not line.strip():
                    continue
                split = line.rsplit(None, 1)
                if len(split) == 1:
                    pairs.append((split[0], -1))
                else:
                    path, label = split
                    pairs.append((path, int(label)))
        if not pairs:
            raise ValueError(f"Failed to load dataset from {file_path}.")
        return cls(pairs)

    @classmethod
    def from_directory(cls, dir_path: str) -> "LabeledVideoPaths":
        """dir/<class>/<video>.<ext> tree, classes alphabetical."""
        if not os.path.exists(dir_path):
            raise FileNotFoundError(f"{dir_path} not found.")
        classes = sorted(
            f.name for f in pathlib.Path(dir_path).iterdir() if f.is_dir()
        )
        class_to_idx = {c: i for i, c in enumerate(classes)}
        pairs = []
        for c in classes:
            class_dir = os.path.join(dir_path, c)
            for root, _, files in sorted(os.walk(class_dir, followlinks=True)):
                for fname in sorted(files):
                    if fname.lower().endswith(VIDEO_EXTENSIONS):
                        pairs.append((os.path.join(root, fname), class_to_idx[c]))
        if not pairs:
            raise ValueError(f"Failed to load dataset from {dir_path}.")
        return cls(pairs)

    @property
    def path_prefix(self):
        return self._path_prefix

    @path_prefix.setter
    def path_prefix(self, value):
        self._path_prefix = value

    def __getitem__(self, index) -> Tuple[str, dict]:
        path, label = self._paths_and_labels[index]
        return os.path.join(self._path_prefix, path), {"label": label}

    def __len__(self) -> int:
        return len(self._paths_and_labels)
