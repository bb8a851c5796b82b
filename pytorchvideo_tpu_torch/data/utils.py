"""Data helpers (counterpart of pytorchvideo_tpu/data/utils.py; upstream
pytorchvideo/data/utils.py: thwc_to_cthw :26, secs_to_pts / pts_to_secs
:34-58, export_video_array :71, MultiProcessSampler :169,
optional_threaded_foreach :208, DataclassFieldCaster :241, the CSV
helpers :315-388, get_logger :390). The CSV rows the manifest datasets read
are cast to their dataclasses' field types on construction."""

from __future__ import annotations

import csv
import itertools
import logging
import math
import sys
import typing
from concurrent.futures import ThreadPoolExecutor
from dataclasses import Field, field as dataclass_field, fields as dataclass_fields
from typing import Any, Callable, Dict, Iterable, List, Tuple

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
                       fourcc: str = "FFV1", audio=None, audio_rate: int = 0) -> None:
    """Write a uint8 clip (tensor or array) to ``output_path``: with OpenCV
    (FFV1 in AVI is lossless, so a decode gives the frames back exactly;
    ``cv2`` is imported here only), or, with ``audio`` (mono float32 in
    [-1, 1] at ``audio_rate``), through the native muxer as FFV1 and
    pcm_s16le (data/encoded_video_native.py ``mux_av``)."""
    if layout not in ("THWC", "CTHW"):
        raise ValueError(f"layout must be 'THWC' or 'CTHW', got {layout!r}")
    video = torch.as_tensor(video)
    if layout == "CTHW":
        video = cthw_to_thwc(video)
    if audio is not None:
        from pytorchvideo_tpu_torch.data.encoded_video_native import mux_av

        mux_av(output_path, video, rate, audio, audio_rate)
        return
    import cv2

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


class DataclassFieldCaster:
    """Dataclass mixin: each field given a value of another type is cast to
    its annotated type (a CSV cell "12" to ``int``), and a field made by
    :func:`complex_initialized_dataclass_field` is set to its initializer's
    result (upstream data/utils.py:241-312). A value the type cannot take
    is kept as it was."""

    COMPLEX_INITIALIZER = "DataclassFieldCaster__complex_initializer"

    def __post_init__(self) -> None:
        hints = typing.get_type_hints(type(self))
        for f in dataclass_fields(self):
            value = getattr(self, f.name)
            ftype = hints.get(f.name, f.type)
            initializer = f.metadata.get(self.COMPLEX_INITIALIZER)
            if initializer is not None:
                setattr(self, f.name, initializer(value))
            elif isinstance(ftype, type) and not isinstance(value, ftype):
                try:
                    setattr(self, f.name, ftype(value))
                except (TypeError, ValueError):
                    pass


def complex_initialized_dataclass_field(initializer: Callable, **kwargs) -> Field:
    """A dataclass field whose value is ``initializer(raw value)``, as
    :class:`DataclassFieldCaster` sets it."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata[DataclassFieldCaster.COMPLEX_INITIALIZER] = initializer
    return dataclass_field(metadata=metadata, **kwargs)


def load_dataclass_dict_from_csv(input_csv_file_path: str, dataclass_class: type,
                                 dict_key_field: str, list_per_key: bool = False
                                 ) -> Dict[Any, Any]:
    """A headered CSV's rows as ``dataclass_class`` objects, keyed by their
    ``dict_key_field``: one object a key, or with ``list_per_key`` the list
    of them in file order (upstream data/utils.py:315-360). The header must
    have one column per field; a key seen twice without ``list_per_key``
    raises."""
    out: Dict[Any, Any] = {}
    with open(input_csv_file_path) as f:
        reader = csv.reader(f, delimiter=",")
        columns = next(reader)
        if len(columns) != len(dataclass_fields(dataclass_class)):
            raise ValueError(f"{input_csv_file_path}: {len(columns)} columns, "
                             f"{dataclass_class.__name__} has "
                             f"{len(dataclass_fields(dataclass_class))} fields")
        for line in reader:
            datum = dataclass_class(*line)
            key = getattr(datum, dict_key_field)
            if list_per_key:
                out.setdefault(key, []).append(datum)
            elif key in out:
                raise ValueError(f"{input_csv_file_path}: duplicate key {key}")
            else:
                out[key] = datum
    return out


def save_dataclass_objs_to_headered_csv(dataclass_objs: List, file_name: str) -> None:
    """Objects of one dataclass as a CSV with their field names as the
    header (upstream data/utils.py:363-388); the loader reads it back."""
    if not dataclass_objs:
        raise ValueError("no objects to save")
    field_names = [f.name for f in dataclass_fields(type(dataclass_objs[0]))]
    with open(file_name, "w") as f:
        writer = csv.writer(f, delimiter=",")
        writer.writerow(field_names)
        for obj in dataclass_objs:
            writer.writerow([getattr(obj, name) for name in field_names])


def get_logger(name: str) -> logging.Logger:
    """An INFO-level logger writing to stdout, its handler added once
    (upstream data/utils.py:390-400)."""
    named = logging.getLogger(name)
    named.setLevel(logging.INFO)
    if not named.hasHandlers():
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] %(levelname)s %(message)s \t[%(filename)s.%(funcName)s:%(lineno)d]",
            datefmt="%y%m%d %H:%M:%S"))
        named.addHandler(handler)
    return named
