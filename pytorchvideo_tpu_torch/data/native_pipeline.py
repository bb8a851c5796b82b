"""The native decode worker pool (counterpart of
pytorchvideo_tpu/data/native_pipeline.py).

Clip requests fan out to a C++ thread pool (``native/pipeline.cc``) that
decodes and, if asked, rescales through FFmpeg (``native/decode.cc``) into
staging buffers with the GIL released; finished clips come back in
completion order, each copied once into a (T, H, W, 3) uint8 CPU tensor.
Threads in one address space take the place of upstream's decoding
DataLoader worker processes, and the clips go on to
``data.loader.device_prefetch`` for the copy to the card.

Usage::

    with NativeDecodePipeline(num_threads=8) as pipe:
        for i, (path, s, e) in enumerate(requests):
            pipe.submit(i, path, s, e, out_h=182, out_w=242)
        for _ in range(len(requests)):
            req_id, frames = pipe.wait()     # (T, H, W, 3) uint8 tensor or None

The library is built at first use (data/native_build.py); ``is_available()``
says whether it can be.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Iterator, Optional, Tuple

import torch

from pytorchvideo_tpu_torch.data.encoded_video_native import load_native_library, native_available


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the pool's entry points typed (once per loaded library)."""
    if getattr(lib, "_pvtp_bound", False):
        return lib
    lib.pvtp_create.restype = ctypes.c_void_p
    lib.pvtp_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pvtp_submit.restype = ctypes.c_int
    lib.pvtp_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.pvtp_wait.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.pvtp_wait.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.pvtp_outstanding.restype = ctypes.c_int64
    lib.pvtp_outstanding.argtypes = [ctypes.c_void_p]
    lib.pvtp_release.restype = None
    lib.pvtp_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.pvtp_destroy.restype = None
    lib.pvtp_destroy.argtypes = [ctypes.c_void_p]
    lib._pvtp_bound = True
    return lib


def is_available() -> bool:
    """Whether the decode library can be had, without raising."""
    return native_available()


class NativeDecodePipeline:
    """A worker pool of clip decoders. Submit and wait from one thread: the
    C++ side is the concurrent part. Raises ``RuntimeError`` where the
    library cannot be built."""

    def __init__(self, num_threads: int = 4, capacity: int = 16):
        self._handle = None
        self._lib = _bind(load_native_library())
        self._handle = self._lib.pvtp_create(num_threads, capacity)
        if not self._handle:
            raise RuntimeError("pvtp_create failed")

    def submit(self, req_id: int, path: str, start_frame: int, end_frame: int, out_h: int = 0,
               out_w: int = 0) -> None:
        """Queue the decode of frames [start_frame, end_frame), rescaled to
        (out_h, out_w) (bilinear) where both are nonzero. Blocks while the
        queue is full."""
        rc = self._lib.pvtp_submit(self._handle, req_id, str(path).encode(), start_frame,
                                   end_frame, out_h, out_w)
        if rc != 0:
            raise RuntimeError("pipeline is shut down")

    def wait(self) -> Tuple[int, Optional[torch.Tensor]]:
        """The next finished request: (req_id, (T, H, W, 3) uint8 tensor), or
        (req_id, None) where its decode failed. Blocks forever with nothing
        outstanding: pair submits and waits (or read ``outstanding()``)."""
        req_id, frames = ctypes.c_uint64(), ctypes.c_int64()
        h, w = ctypes.c_int(), ctypes.c_int()
        buf = self._lib.pvtp_wait(self._handle, ctypes.byref(req_id), ctypes.byref(frames),
                                  ctypes.byref(h), ctypes.byref(w))
        if not buf or frames.value < 0:
            return int(req_id.value), None
        out = torch.empty((frames.value, h.value, w.value, 3), dtype=torch.uint8)
        ctypes.memmove(out.data_ptr(), buf, out.numel())
        self._lib.pvtp_release(self._handle, buf)
        return int(req_id.value), out

    def outstanding(self) -> int:
        """Requests submitted and not yet waited for."""
        return int(self._lib.pvtp_outstanding(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.pvtp_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def iter_decoded_clips(requests: Iterable[Tuple[str, int, int]], num_threads: int = 4,
                       capacity: int = 16, out_h: int = 0, out_w: int = 0
                       ) -> Iterator[Tuple[int, Optional[torch.Tensor]]]:
    """(index, clip) for each (path, start_frame, end_frame) of
    ``requests``, at most ``capacity`` clips in flight, in completion order
    (the index names the request)."""
    with NativeDecodePipeline(num_threads, capacity) as pipe:
        it = enumerate(iter(requests))
        in_flight, done = 0, False
        while True:
            while not done and in_flight < capacity:
                try:
                    i, (path, s, e) = next(it)
                except StopIteration:
                    done = True
                    break
                pipe.submit(i, path, s, e, out_h, out_w)
                in_flight += 1
            if in_flight == 0:
                return
            yield pipe.wait()
            in_flight -= 1
