"""Encoded-video decoding (counterpart of
pytorchvideo_tpu/data/encoded_video.py; upstream
pytorchvideo/data/encoded_video.py:17-76). Two backends: OpenCV's
``VideoCapture`` (FFmpeg underneath, video only), imported inside its
functions only, and the native decoder (``decoder="native"``,
data/encoded_video_native.py: FFmpeg through the C library under
``native/``, built at first use, video and audio). The machine with the
card may have neither, and the port's modules import without them."""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from pytorchvideo_tpu_torch.data import io as pvt_io
from pytorchvideo_tpu_torch.data.video import Video

logger = logging.getLogger(__name__)


class DecoderType:
    NATIVE = "native"
    OPENCV = "opencv"
    PYAV = "pyav"
    TORCHVISION = "torchvision"
    DECORD = "decord"


def select_video_class(decoder: str):
    """The backend class of ``decoder`` (upstream encoded_video.py:17-39):
    the native decoder for "native" (which raises at first use where it
    cannot be built: no OpenCV fallback); OpenCV for "opencv", and for
    "torchvision" and "decord" as in the JAX package; "pyav" raises."""
    if decoder == DecoderType.NATIVE:
        from pytorchvideo_tpu_torch.data.encoded_video_native import EncodedVideoNative

        return EncodedVideoNative
    if decoder == DecoderType.PYAV:
        raise NotImplementedError("decoder='pyav' is not ported (PyAV is not installed); use "
                                  "decoder='native' or 'opencv'")
    if decoder in (DecoderType.OPENCV, DecoderType.TORCHVISION, DecoderType.DECORD):
        return EncodedVideoOpenCV
    raise NotImplementedError(f"Unknown decoder type {decoder}")


class EncodedVideo(Video):
    """Factory entry (upstream encoded_video.py:48-76): a local path goes to
    the backend; a remote one is read through its scheme's opener
    (data/io.py) and decoded from memory (:meth:`from_bytes`)."""

    @classmethod
    def from_path(cls, file_path: str, decode_video: bool = True, decode_audio: bool = False,
                  decoder: str = "opencv", **other_args) -> "Video":
        video_cls = select_video_class(decoder)
        if not pvt_io.is_local_path(file_path):
            return cls.from_bytes(pvt_io.read_bytes(file_path), decode_video=decode_video,
                                  decode_audio=decode_audio, decoder=decoder,
                                  video_name=os.path.basename(str(file_path)), **other_args)
        return video_cls(pvt_io.local_path(file_path), decode_video=decode_video,
                         decode_audio=decode_audio, **other_args)

    @classmethod
    def from_bytes(cls, data: bytes, decode_video: bool = True, decode_audio: bool = False,
                   decoder: str = "opencv", **other_args) -> "Video":
        """Decode an in-memory container: from the buffer itself where the
        backend overrides ``from_bytes`` (the native one), else through a
        temporary file (``cv2.VideoCapture`` reads no memory buffer)."""
        video_cls = select_video_class(decoder)
        if video_cls.from_bytes.__func__ is not EncodedVideo.from_bytes.__func__:
            return video_cls.from_bytes(data, decode_video=decode_video,
                                        decode_audio=decode_audio, **other_args)
        tmp = _TempFileFromBytes(data)
        video = video_cls(tmp.path, decode_video=decode_video, decode_audio=decode_audio,
                          **other_args)
        video._tempfile_ref = tmp  # keeps the backing file alive
        return video


class _TempFileFromBytes:
    """Bytes spilled to a temporary file, removed when this object goes."""

    def __init__(self, data: bytes):
        import tempfile

        fd, self.path = tempfile.mkstemp(suffix=".video")
        with os.fdopen(fd, "wb") as f:
            f.write(data)

    def __del__(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass


class EncodedVideoOpenCV(EncodedVideo):
    """``cv2.VideoCapture`` with frame-accurate seeking (upstream's PyAV
    backend, encoded_video_pyav.py:19-364): the duration from the
    container, ``get_clip(start, end)`` the frames whose times lie in
    [start, end) as a (T, H, W, C) uint8 RGB tensor. OpenCV decodes no
    audio: ``audio`` is always None."""

    def __init__(self, file_path: str, decode_video: bool = True, decode_audio: bool = False,
                 video_name: Optional[str] = None):
        import cv2

        if not decode_video:
            raise NotImplementedError("decode_video=False unsupported")
        if decode_audio:
            logger.warning("OpenCV backend cannot decode audio (decoder='native' does); "
                           "returning audio=None")
        self._video_name = video_name or os.path.basename(file_path)
        self._path = str(file_path)
        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            raise RuntimeError(f"Failed to open video {file_path}")
        self._fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self._num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._next_frame_idx = 0

    @property
    def name(self) -> Optional[str]:
        return self._video_name

    @property
    def rate(self) -> float:
        return self._fps

    @property
    def duration(self) -> float:
        return self._num_frames / self._fps

    def _seek_to(self, frame_idx: int):
        import cv2

        if frame_idx != self._next_frame_idx:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
            self._next_frame_idx = frame_idx

    def get_clip(self, start_sec: float, end_sec: float) -> Dict[str, Optional[torch.Tensor]]:
        import cv2

        if start_sec > end_sec or start_sec > self.duration:
            logger.warning("Invalid clip times %s-%s for duration %s", start_sec, end_sec,
                           self.duration)
            return {"video": None, "audio": None}
        start_idx = max(int(math.ceil(self._fps * start_sec - 1e-9)), 0)
        if end_sec == math.inf:
            end_idx = self._num_frames
        else:
            end_idx = min(int(math.ceil(self._fps * end_sec - 1e-9)), self._num_frames)
        if end_idx <= start_idx:
            end_idx = min(start_idx + 1, self._num_frames)
        self._seek_to(start_idx)
        frames = []
        for _ in range(start_idx, end_idx):
            ok, frame = self._cap.read()
            if not ok:
                break
            self._next_frame_idx += 1
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if not frames:
            logger.debug("No frames decoded for %s-%s", start_sec, end_sec)
            return {"video": None, "audio": None}
        return {"video": torch.from_numpy(np.stack(frames)), "audio": None}

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None
