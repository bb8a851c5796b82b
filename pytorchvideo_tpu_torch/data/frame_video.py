"""A video stored as a directory of image frames (counterpart of
pytorchvideo_tpu/data/frame_video.py; upstream pytorchvideo/data/frame_video.py:
FrameVideo :33, from_directory :81, the frame index ceil(fps * t) :149-150,
frame_filter before any read :200-203, reads with 10 retries :223-258).

Frames are decoded with OpenCV, imported only where a frame is read (the
card's machine has no OpenCV). A clip is a (T, H, W, C) uint8 RGB tensor,
as the port's ``EncodedVideo`` gives; the JAX package's is float32.
"""

from __future__ import annotations

import logging
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pytorchvideo_tpu_torch.data.utils import optional_threaded_foreach
from pytorchvideo_tpu_torch.data.video import Video

logger = logging.getLogger(__name__)


def _natural_keys(text: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


class FrameVideo(Video):
    """Frames at ``fps``: frame i shows time i / fps, and a clip
    [start, end) holds frames ceil(fps * start) up to ceil(fps * end)."""

    def __init__(
        self,
        duration: float,
        fps: float,
        video_frame_to_path_fn: Optional[Callable[[int], str]] = None,
        video_frame_paths: Optional[List[str]] = None,
        multithreaded_io: bool = False,
    ):
        self._duration = duration
        self._fps = fps
        self._video_frame_to_path_fn = video_frame_to_path_fn
        self._video_frame_paths = video_frame_paths
        self._multithreaded_io = multithreaded_io
        self._name = (os.path.basename(os.path.dirname(video_frame_paths[0]))
                      if video_frame_paths else None)

    @classmethod
    def from_directory(cls, path: str, fps: float = 30.0, multithreaded_io: bool = False,
                       path_order_cache: Optional[dict] = None) -> "FrameVideo":
        """The directory's files in natural order (frame2 before frame10),
        the listing kept in ``path_order_cache`` where one is given
        (upstream frame_video.py:81-112)."""
        if path_order_cache is not None and path in path_order_cache:
            return cls.from_frame_paths(path_order_cache[path], fps, multithreaded_io)
        if not os.path.isdir(path):
            raise ValueError(f"{path} is not a directory")
        frame_paths = [os.path.join(path, f) for f in sorted(os.listdir(path), key=_natural_keys)]
        if path_order_cache is not None:
            path_order_cache[path] = frame_paths
        return cls.from_frame_paths(frame_paths, fps, multithreaded_io)

    @classmethod
    def from_frame_paths(cls, video_frame_paths: List[str], fps: float = 30.0,
                         multithreaded_io: bool = False) -> "FrameVideo":
        if not video_frame_paths:
            raise ValueError("video_frame_paths is empty")
        return cls(len(video_frame_paths) / fps, fps, video_frame_paths=video_frame_paths,
                   multithreaded_io=multithreaded_io)

    @property
    def name(self):
        return self._name

    @property
    def duration(self) -> float:
        return self._duration

    def _get_frame_index_for_time(self, time_sec: float) -> int:
        return math.ceil(self._fps * time_sec)

    def get_clip(self, start_sec: float, end_sec: float,
                 frame_filter: Optional[Callable[[List[int]], List[int]]] = None
                 ) -> Optional[Dict[str, object]]:
        """``{"video": (T, H, W, C) uint8 tensor, "frame_indices": [...],
        "audio": None}`` for the frames in [start_sec, end_sec), or None
        when ``start_sec`` lies outside the video. ``frame_filter`` picks
        among the frame indices before any image is read."""
        if start_sec < 0 or start_sec > self._duration:
            logger.warning("No frames found within %s and %s seconds; video is [0, %s]",
                           start_sec, end_sec, self._duration)
            return None
        end_sec = min(end_sec, self._duration)
        start_idx = self._get_frame_index_for_time(start_sec)
        end_idx = min(self._get_frame_index_for_time(end_sec),
                      len(self._video_frame_paths or []))
        frame_indices = list(range(start_idx, end_idx))
        if frame_filter:
            frame_indices = frame_filter(frame_indices)
        clip_paths = [self._video_frame_to_path(i) for i in frame_indices]
        frames = _load_images_with_retries(clip_paths, multithreaded=self._multithreaded_io)
        return {"video": frames, "frame_indices": frame_indices, "audio": None}

    def _video_frame_to_path(self, frame_index: int) -> str:
        if self._video_frame_to_path_fn:
            return self._video_frame_to_path_fn(frame_index)
        if self._video_frame_paths:
            return self._video_frame_paths[frame_index]
        raise ValueError("one of video_frame_to_path_fn or video_frame_paths must be set")


def _load_images_with_retries(image_paths: List[str], num_retries: int = 10,
                              multithreaded: bool = True) -> torch.Tensor:
    """RGB images decoded by OpenCV, each read up to ``num_retries`` times;
    a (T, H, W, C) uint8 tensor. Raises if any image stays unread."""
    import cv2

    imgs: List[Optional[np.ndarray]] = [None for _ in image_paths]

    def fetch_image(image_index: int, image_path: str) -> None:
        for i in range(num_retries):
            with open(image_path, "rb") as f:
                img_str = np.frombuffer(f.read(), np.uint8)
            img_bgr = cv2.imdecode(img_str, flags=cv2.IMREAD_COLOR)
            if img_bgr is not None:
                imgs[image_index] = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
                return
            logger.warning("Reading attempt %d/%d failed", i, num_retries)
            time.sleep(1e-6)

    optional_threaded_foreach(fetch_image, enumerate(image_paths), multithreaded)
    if any(img is None for img in imgs):
        raise RuntimeError(f"Failed to load images from {image_paths}")
    return torch.from_numpy(np.stack(imgs))
