"""Datasets from JSON annotations: unannotated videos, and noun/verb clips
(counterpart of pytorchvideo_tpu/data/json_dataset.py; upstream
pytorchvideo/data/json_dataset.py:15-254: video_only_dataset,
clip_recognition_dataset, UntrimmedClipSampler).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Type

from pytorchvideo_tpu_torch.data.clip_sampling import ClipInfo, ClipSampler
from pytorchvideo_tpu_torch.data.labeled_video_dataset import LabeledVideoDataset
from pytorchvideo_tpu_torch.data.samplers import RandomSampler


def _load_annotations(data_path: str) -> dict:
    if not os.path.isfile(data_path):
        raise FileNotFoundError(f"{data_path} not found.")
    try:
        with open(data_path, "r") as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise FileNotFoundError(f"{data_path} must be json") from e


def video_only_dataset(
    data_path: str,
    clip_sampler: ClipSampler,
    video_sampler: Type = RandomSampler,
    transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    video_path_prefix: str = "",
    decode_audio: bool = False,
    decoder: str = "opencv",
) -> LabeledVideoDataset:
    """The videos named by the keys of a ``{"video_name": {...}}`` JSON,
    with no label."""
    annotations = _load_annotations(data_path)
    video_paths = [(os.path.join(video_path_prefix, x), {}) for x in annotations.keys()]
    return LabeledVideoDataset(video_paths, clip_sampler, video_sampler, transform,
                               decode_audio=decode_audio, decoder=decoder)


def clip_recognition_dataset(
    data_path: str,
    clip_sampler: ClipSampler,
    video_sampler: Type = RandomSampler,
    transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    video_path_prefix: str = "",
    decode_audio: bool = False,
    decoder: str = "opencv",
) -> LabeledVideoDataset:
    """The noun/verb clips of the ``forecasting_hands_objects`` benchmark
    (upstream json_dataset.py:85-208): one entry a clip, a clip without a
    noun or verb, or with either unsure, left out; the labels indexed in
    the order of a set of their names, as the JAX package indexes them."""
    annotations = _load_annotations(data_path)
    untrimmed_clip_annotations = []
    for video_name, child in annotations.items():
        video_path = os.path.join(video_path_prefix, video_name)
        for clip_annotation in child["benchmarks"]["forecasting_hands_objects"]:
            clip_start = clip_annotation["critical_frame_selection_parent_start_sec"]
            clip_end = clip_annotation["critical_frame_selection_parent_end_sec"]
            taxonomy = clip_annotation["taxonomy"]
            noun_label = taxonomy["noun"]
            verb_label = taxonomy["verb"]
            if (noun_label is None or verb_label is None or taxonomy["verb_unsure"]
                    or taxonomy["noun_unsure"]):
                continue
            untrimmed_clip_annotations.append((video_path, {
                "clip_start_sec": clip_start,
                "clip_end_sec": clip_end,
                "noun_label": noun_label,
                "verb_label": verb_label,
            }))

    def map_labels_to_index(label_name):
        labels = list({info[label_name] for _, info in untrimmed_clip_annotations})
        label_to_idx = {label: i for i, label in enumerate(labels)}
        for _, info in untrimmed_clip_annotations:
            info[label_name] = label_to_idx[info[label_name]]

    map_labels_to_index("noun_label")
    map_labels_to_index("verb_label")
    return LabeledVideoDataset(untrimmed_clip_annotations, UntrimmedClipSampler(clip_sampler),
                               video_sampler, transform, decode_audio=decode_audio,
                               decoder=decoder)


class UntrimmedClipSampler:
    """A trimmed-clip sampler run inside each annotation's
    [clip_start_sec, clip_end_sec] (upstream json_dataset.py:211-254).

    The span's duration is computed as the JAX package computes it,
    ``clip_start_sec - clip_end_sec`` (pytorchvideo_tpu/data/json_dataset.py:129),
    which is negative: every annotation gives one clip from its start, the
    last. The port keeps that formula so that both give the same clips."""

    def __init__(self, clip_sampler: ClipSampler) -> None:
        self._trimmed_clip_sampler = clip_sampler

    def __call__(self, last_clip_time, video_duration, clip_info: Dict[str, Any]) -> ClipInfo:
        clip_start_boundary = clip_info["clip_start_sec"]
        clip_end_boundary = clip_info["clip_end_sec"]
        duration = clip_start_boundary - clip_end_boundary
        info = self._trimmed_clip_sampler(last_clip_time, duration, clip_info)
        return ClipInfo(info.clip_start_sec + clip_start_boundary,
                        info.clip_end_sec + clip_start_boundary,
                        info.clip_index, info.aug_index, info.is_last_clip)

    def reset(self) -> None:
        pass
