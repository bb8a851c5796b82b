"""Data helpers (counterpart of pytorchvideo_tpu/data/utils.py; upstream
pytorchvideo/data/utils.py: thwc_to_cthw :26, secs_to_pts / pts_to_secs
:34-58, export_video_array :71, MultiProcessSampler :169,
optional_threaded_foreach :208). The CSV and dataclass helpers wait for
the manifest datasets."""

from __future__ import annotations

import itertools
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def thwc_to_cthw(data: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> (C, T, H, W), a view."""
    return data.permute(3, 0, 1, 2)


def cthw_to_thwc(data: torch.Tensor) -> torch.Tensor:
    """(C, T, H, W) -> (T, H, W, C), a view."""
    return data.permute(1, 2, 3, 0)


def secs_to_pts(time_in_seconds: float, time_base: float, start_pts: int,
                round_mode: str = "floor") -> int:
    """Seconds -> presentation timestamp (upstream data/utils.py:34-50)."""
    if time_in_seconds == math.inf:
        return math.inf
    if round_mode not in ("floor", "ceil"):
        raise ValueError(f"round_mode={round_mode} unsupported")
    if round_mode == "floor":
        return math.floor(time_in_seconds / time_base) + start_pts
    return math.ceil(time_in_seconds / time_base) + start_pts


def pts_to_secs(pts: int, time_base: float, start_pts: int) -> float:
    """Presentation timestamp -> seconds (upstream data/utils.py:53-58)."""
    if pts == math.inf:
        return math.inf
    return int(pts - start_pts) * time_base


def export_video_array(video, output_path: str, rate: float, layout: str = "THWC",
                       fourcc: str = "FFV1") -> None:
    """Write a uint8 clip (tensor or array) to ``output_path`` with OpenCV
    (FFV1 in AVI is lossless, so a decode gives the frames back exactly).
    Needs ``cv2``, imported here only."""
    import cv2

    if layout not in ("THWC", "CTHW"):
        raise ValueError(f"layout must be 'THWC' or 'CTHW', got {layout!r}")
    video = torch.as_tensor(video)
    if layout == "CTHW":
        video = cthw_to_thwc(video)
    frames = video.to(torch.uint8).cpu().numpy()
    t, h, w, c = frames.shape
    writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*fourcc), rate, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"could not open a video writer for {output_path}")
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


class MultiProcessSampler:
    """Splits a sampler's indices among ``torch.utils.data`` workers: worker
    i takes the i-th contiguous chunk; workers beyond the chunks get nothing
    (upstream data/utils.py:169-205)."""

    def __init__(self, sampler):
        self._sampler = sampler

    def __iter__(self):
        worker_info = torch.utils.data.get_worker_info()
        if worker_info is not None and worker_info.num_workers != 0:
            num_workers = int(worker_info.num_workers)
            worker_id = int(worker_info.id)
            splits = np.linspace(0, len(self._sampler), num_workers + 1).astype(np.int64)
            start, end = splits[worker_id], splits[worker_id + 1]
            if end <= start:
                logger.warning("More workers than videos: worker %d starved", worker_id)
                return iter(())
            return itertools.islice(iter(self._sampler), int(start), int(end))
        return iter(self._sampler)


def optional_threaded_foreach(target: Callable, args_iterable: Iterable[Tuple],
                              multithreaded: bool) -> None:
    """``target(*args)`` for each args, in a thread pool when
    ``multithreaded`` (upstream data/utils.py:208-238); every call's error
    is raised."""
    if multithreaded:
        with ThreadPoolExecutor() as pool:
            futures = [pool.submit(target, *args) for args in args_iterable]
            for f in futures:
                f.result()
    else:
        for args in args_iterable:
            target(*args)
