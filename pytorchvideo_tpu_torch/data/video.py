"""The decoded-video interface and path dispatch (counterpart of
pytorchvideo_tpu/data/video.py; upstream pytorchvideo/data/video.py: Video
:53, VideoPathHandler :21-50). A clip is a (T, H, W, C) uint8 tensor."""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional


class Video(ABC):
    """A decoded video: its duration and clips by time."""

    @property
    @abstractmethod
    def duration(self) -> float:
        """Video duration in seconds."""

    @property
    def name(self) -> Optional[str]:
        return getattr(self, "_video_name", None)

    @abstractmethod
    def get_clip(self, start_sec: float, end_sec: float) -> Dict[str, Optional[Any]]:
        """{"video": (T, H, W, C) uint8 tensor or None, "audio": None} for
        the frames in [start_sec, end_sec)."""

    def close(self) -> None:
        """Release the decoder."""


class VideoPathHandler:
    """A path to its Video: a directory of frames to :class:`FrameVideo`
    (its listing cached), a file to :class:`EncodedVideo` (upstream
    data/video.py:21-50)."""

    def __init__(self) -> None:
        self.path_order_cache: Dict[str, list] = {}

    def video_from_path(self, filepath: str, decode_video: bool = True,
                        decode_audio: bool = False, decoder: str = "opencv",
                        fps: float = 30.0) -> Video:
        if os.path.isdir(filepath):
            from pytorchvideo_tpu_torch.data.frame_video import FrameVideo

            if decode_audio:
                raise ValueError("a frame directory has no audio: decode_audio must be False")
            return FrameVideo.from_directory(filepath, fps,
                                             path_order_cache=self.path_order_cache)
        from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo

        return EncodedVideo.from_path(filepath, decode_video=decode_video,
                                      decode_audio=decode_audio, decoder=decoder)
