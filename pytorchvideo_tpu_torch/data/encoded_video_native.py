"""The native (C++/FFmpeg) encoded-video backend (counterpart of
pytorchvideo_tpu/data/encoded_video_native.py).

Binds ``libpvt_decode`` (``native/decode.cc``, built at first use by
:mod:`native_build`) through ctypes: a frame-accurate seek and range decode
written by one native call straight into a ``torch.uint8`` buffer, mono
float32 audio decode (upstream's PyAV semantics, encoded_video_pyav.py:285-318),
decoding from memory (``from_bytes``, no temporary file) and the A/V muxer
(:func:`mux_av`). Clips are (T, H, W, 3) uint8 RGB tensors on the CPU, as the
OpenCV backend gives them; audio is a float32 mono tensor. Where the library
cannot be built this backend raises; it never decodes with OpenCV instead.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from pytorchvideo_tpu_torch.data import native_build
from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo

logger = logging.getLogger(__name__)

_LIB = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every decode and mux entry point of ``lib`` with its C signature."""
    lib.pvt_open.restype = ctypes.c_void_p
    lib.pvt_open.argtypes = [ctypes.c_char_p]
    lib.pvt_open_buffer.restype = ctypes.c_void_p
    lib.pvt_open_buffer.argtypes = [_U8P, ctypes.c_int64]
    for name in ("pvt_width", "pvt_height", "pvt_has_audio", "pvt_audio_rate",
                 "pvt_audio_channels"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.pvt_fps.restype = ctypes.c_double
    lib.pvt_fps.argtypes = [ctypes.c_void_p]
    lib.pvt_num_frames.restype = ctypes.c_int64
    lib.pvt_num_frames.argtypes = [ctypes.c_void_p]
    lib.pvt_duration.restype = ctypes.c_double
    lib.pvt_duration.argtypes = [ctypes.c_void_p]
    lib.pvt_decode_range.restype = ctypes.c_int64
    lib.pvt_decode_range.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _U8P]
    lib.pvt_decode_audio.restype = ctypes.c_int64
    lib.pvt_decode_audio.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double, _F32P,
                                     ctypes.c_int64]
    lib.pvt_mux_av.restype = ctypes.c_int
    lib.pvt_mux_av.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_double, _F32P, ctypes.c_int64, ctypes.c_int]
    lib.pvt_close.restype = None
    lib.pvt_close.argtypes = [ctypes.c_void_p]
    return lib


def load_native_library() -> ctypes.CDLL:
    """The decode library, built at first use and loaded once. Raises
    ``RuntimeError`` where it cannot be built (see :mod:`native_build`)."""
    global _LIB
    if _LIB is None:
        _LIB = _typed(native_build.load_raw())
    return _LIB


def native_available() -> bool:
    """Whether the decode library can be had, without raising."""
    return _LIB is not None or native_build.native_available()


def _u8(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), _U8P)


def _f32(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), _F32P)


def _host(x, dtype: torch.dtype) -> torch.Tensor:
    """A tensor or array as a contiguous CPU tensor of ``dtype``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to("cpu", dtype).contiguous()


def mux_av(path: str, frames, fps: float, audio=None, audio_rate: int = 0) -> None:
    """Write (T, H, W, 3) uint8 RGB frames and, if given, mono float32 audio
    at ``audio_rate`` into a container: FFV1 video (lossless) and pcm_s16le
    audio. ``frames`` and ``audio`` are tensors or arrays."""
    lib = load_native_library()
    frames = _host(frames, torch.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got {tuple(frames.shape)}")
    t, h, w, _ = frames.shape
    audio_ptr, n_samples, rate = None, 0, 0
    if audio is not None:
        audio = _host(audio, torch.float32).reshape(-1)
        rate = int(audio_rate)
        if rate <= 0:
            raise ValueError("audio_rate must be positive when audio is given")
        audio_ptr, n_samples = _f32(audio), audio.numel()
    rc = lib.pvt_mux_av(str(path).encode(), _u8(frames), t, h, w, float(fps), audio_ptr,
                        n_samples, rate)
    if rc != 0:
        raise RuntimeError(f"pvt_mux_av failed for {path}")


class EncodedVideoNative(EncodedVideo):
    """A video over the native decoder, with the backends' ``get_clip``
    contract: {"video": (T, H, W, 3) uint8 tensor, "audio": float32 mono
    tensor or None} for the frames whose times lie in [start_sec, end_sec)."""

    def __init__(self, file_path: Optional[str] = None, decode_video: bool = True,
                 decode_audio: bool = False, video_name: Optional[str] = None,
                 _buffer: Optional[bytes] = None):
        if not decode_video and not decode_audio:
            raise ValueError("decode_video=False requires decode_audio=True (audio-only "
                             "decode, upstream encoded_video_decord.py:77-79)")
        lib = load_native_library()
        self._lib = lib
        self._decode_video = decode_video
        self._decode_audio = decode_audio
        if _buffer is not None:
            self._video_name = video_name or "<memory>"
            buf = np.frombuffer(_buffer, dtype=np.uint8)
            # pvt_open_buffer copies the bytes: the buffer need not outlive it.
            self._handle = lib.pvt_open_buffer(buf.ctypes.data_as(_U8P), buf.size)
            if not self._handle:
                raise RuntimeError("Failed to open video from memory buffer")
        else:
            self._video_name = video_name or os.path.basename(file_path)
            self._handle = lib.pvt_open(str(file_path).encode())
            if not self._handle:
                raise RuntimeError(f"Failed to open video {file_path}")
        self._fps = lib.pvt_fps(self._handle)
        self._num_frames = lib.pvt_num_frames(self._handle)
        self._width = lib.pvt_width(self._handle)
        self._height = lib.pvt_height(self._handle)
        self._has_audio = bool(lib.pvt_has_audio(self._handle))
        self._audio_rate = lib.pvt_audio_rate(self._handle)
        if decode_audio and not self._has_audio:
            logger.debug("decode_audio requested but %s has no audio stream", self._video_name)

    @classmethod
    def from_bytes(cls, data: bytes, decode_video: bool = True, decode_audio: bool = False,
                   video_name: Optional[str] = None) -> "EncodedVideoNative":
        """Decode from an in-memory container."""
        return cls(None, decode_video=decode_video, decode_audio=decode_audio,
                   video_name=video_name, _buffer=bytes(data))

    @property
    def name(self) -> Optional[str]:
        return self._video_name

    @property
    def rate(self) -> float:
        return self._fps

    @property
    def duration(self) -> float:
        return self._num_frames / self._fps

    @property
    def has_audio(self) -> bool:
        return self._has_audio

    @property
    def audio_rate(self) -> int:
        """The audio stream's sample rate (0 without one)."""
        return self._audio_rate

    def _get_audio(self, start_sec: float, end_sec: float) -> Optional[torch.Tensor]:
        if not (self._decode_audio and self._has_audio and self._audio_rate > 0):
            return None
        end = min(float(end_sec), self.duration + 1.0)
        # One extra second: audio frames are taken whole.
        max_samples = int(math.ceil((end - start_sec) * self._audio_rate)) + self._audio_rate
        if max_samples <= 0:
            return None
        buf = torch.empty(max_samples, dtype=torch.float32)
        n = self._lib.pvt_decode_audio(self._handle, float(start_sec), float(end_sec), _f32(buf),
                                       max_samples)
        if n <= 0:
            return None
        return buf[:n].clone()

    def get_clip(self, start_sec: float, end_sec: float) -> Dict[str, Optional[torch.Tensor]]:
        if start_sec > end_sec or start_sec > self.duration:
            logger.warning("Invalid clip times %s-%s for duration %s", start_sec, end_sec,
                           self.duration)
            return {"video": None, "audio": None}
        if not self._decode_video:
            # Audio alone: the video stream is never read.
            return {"video": None, "audio": self._get_audio(start_sec, end_sec)}
        start_idx = max(int(math.ceil(self._fps * start_sec - 1e-9)), 0)
        if end_sec == math.inf:
            end_idx = self._num_frames
        else:
            end_idx = min(int(math.ceil(self._fps * end_sec - 1e-9)), self._num_frames)
        if end_idx <= start_idx:
            end_idx = min(start_idx + 1, self._num_frames)
        n = end_idx - start_idx
        if n <= 0:
            return {"video": None, "audio": None}
        out = torch.empty((n, self._height, self._width, 3), dtype=torch.uint8)
        written = self._lib.pvt_decode_range(self._handle, start_idx, end_idx, _u8(out))
        if written <= 0:
            return {"video": None, "audio": None}
        return {"video": out[:written], "audio": self._get_audio(start_sec, end_sec)}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pvt_close(self._handle)
            self._handle = None
