"""The AVA actions dataset, stored as frames, with clips centred on the
annotated keyframes (counterpart of pytorchvideo_tpu/data/ava.py; upstream
pytorchvideo/data/ava.py:15-374): a frame-list file, a box-label CSV and an
optional ``.pbtxt`` label map become a :class:`LabeledVideoDataset` over
frame directories, one sample per annotated second.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Set, Tuple, Type

from pytorchvideo_tpu_torch.data.clip_sampling import ClipInfo, ClipSampler
from pytorchvideo_tpu_torch.data.labeled_video_dataset import LabeledVideoDataset
from pytorchvideo_tpu_torch.data.samplers import RandomSampler


class AvaLabeledVideoFramePaths:
    """Parses AVA's frame lists and per-keyframe box labels."""

    AVA_VALID_FRAMES = list(range(902, 1799))
    FPS = 30
    AVA_VIDEO_START_SEC = 900

    @classmethod
    def _aggregate_bboxes_labels(cls, inp: Dict) -> Dict:
        """Rows with the same box (to 2 decimals) merged into one box with a
        list of labels (upstream ava.py:40-70)."""
        labels_agg, extra_agg, boxes_agg = [], [], []
        bb_dict = {}
        for i in range(len(inp["labels"])):
            key = "{:.2f},{:.2f},{:.2f},{:.2f}".format(*inp["boxes"][i])
            if key not in bb_dict:
                bb_dict[key] = len(boxes_agg)
                boxes_agg.append(inp["boxes"][i])
                labels_agg.append([])
                extra_agg.append([])
            idx = bb_dict[key]
            labels_agg[idx].append(inp["labels"][i])
            extra_agg[idx].append(inp["extra_info"][i])
        return {"labels": labels_agg, "boxes": boxes_agg, "extra_info": extra_agg}

    @classmethod
    def from_csv(cls, frame_paths_file: str, frame_labels_file: str, video_path_prefix: str,
                 label_map_file: Optional[str] = None):
        """[(frame directory, labels)] with one entry per annotated second
        of each video: its boxes, their labels and extra info, and its
        ``video_index`` and ``clip_index`` (the second after the start)."""
        allowed_class_ids = None
        if label_map_file is not None:
            _, allowed_class_ids = cls.read_label_map(label_map_file)
        image_paths, _, video_name_to_idx = cls.load_image_lists(frame_paths_file,
                                                                 video_path_prefix)
        video_frame_labels = cls.load_and_parse_labels_csv(frame_labels_file, video_name_to_idx,
                                                           allowed_class_ids)
        labeled_video_paths = []
        for video_id, per_sec in video_frame_labels.items():
            for frame_video_sec, labels in per_sec.items():
                if len(labels["labels"]) > 0:
                    labels = cls._aggregate_bboxes_labels(labels)
                    labels["video_index"] = video_id
                    labels["clip_index"] = frame_video_sec
                    video_frames_dir = os.path.dirname(image_paths[video_id][0])
                    labeled_video_paths.append((video_frames_dir, labels))
        return labeled_video_paths

    @staticmethod
    def load_and_parse_labels_csv(frame_labels_file: str, video_name_to_idx: dict,
                                  allowed_class_ids: Optional[Set] = None) -> Dict:
        """Rows of video, second, x1, y1, x2, y2, action label, person id
        (upstream ava.py:119-186); seconds outside ``AVA_VALID_FRAMES`` and
        labels outside ``allowed_class_ids`` are dropped."""
        labels_dict: Dict = {}
        with open(frame_labels_file, "r") as f:
            for line in f:
                row = line.strip().split(",")
                video_idx = video_name_to_idx[row[0]]
                frame_sec = float(row[1])
                if (frame_sec > AvaLabeledVideoFramePaths.AVA_VALID_FRAMES[-1]
                        or frame_sec < AvaLabeledVideoFramePaths.AVA_VALID_FRAMES[0]):
                    continue
                frame_sec -= AvaLabeledVideoFramePaths.AVA_VIDEO_START_SEC
                bbox = list(map(float, row[2:6]))
                label = -1 if row[6] == "" else int(row[6])
                if allowed_class_ids is not None and label not in allowed_class_ids:
                    continue
                extra_info = float(row[7])
                labels_dict.setdefault(video_idx, {})
                if frame_sec not in labels_dict[video_idx]:
                    labels_dict[video_idx][frame_sec] = defaultdict(list)
                labels_dict[video_idx][frame_sec]["boxes"].append(bbox)
                labels_dict[video_idx][frame_sec]["labels"].append(label)
                labels_dict[video_idx][frame_sec]["extra_info"].append(extra_info)
        return labels_dict

    @staticmethod
    def load_image_lists(frame_paths_file: str, video_path_prefix: str) -> Tuple:
        """A header, then rows of ``video video_id frame_id path labels``
        (upstream ava.py:188-233): each video's frame paths in frame order,
        the video names by index and the index of each name."""
        image_paths = []
        video_name_to_idx: Dict = {}
        video_idx_to_name = []
        with open(frame_paths_file, "r") as f:
            f.readline()  # header
            for line in f:
                row = line.split()
                if len(row) != 5:
                    raise ValueError(f"expected 5 fields in {frame_paths_file}, got {line!r}")
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    video_name_to_idx[video_name] = len(video_name_to_idx)
                    video_idx_to_name.append(video_name)
                    image_paths.append({})
                image_paths[video_name_to_idx[video_name]][int(row[2])] = os.path.join(
                    video_path_prefix, row[3])
        image_paths_list = [[paths[k] for k in sorted(paths)] for paths in image_paths]
        return image_paths_list, video_idx_to_name, video_name_to_idx

    @staticmethod
    def read_label_map(label_map_file: str) -> Tuple:
        """A ``.pbtxt`` label map (upstream ava.py:235-264): {id: name} and
        the set of ids."""
        label_map = {}
        class_ids = set()
        name = ""
        with open(label_map_file, "r") as f:
            for line in f:
                if line.startswith("  name:"):
                    name = line.split('"')[1]
                elif line.startswith("  id:") or line.startswith("  label_id:"):
                    class_id = int(line.strip().split(" ")[-1])
                    label_map[class_id] = name
                    class_ids.add(class_id)
        return label_map, class_ids


class TimeStampClipSampler:
    """One clip of ``clip_sampler``'s duration centred on the annotation's
    keyframe second, ``annotation["clip_index"]`` (upstream
    ava.py:282-320)."""

    def __init__(self, clip_sampler: ClipSampler) -> None:
        self.clip_sampler = clip_sampler

    def __call__(self, last_clip_time, video_duration, annotation: Dict[str, Any]) -> ClipInfo:
        clip_start_sec = annotation["clip_index"] - self.clip_sampler._clip_duration / 2.0
        return ClipInfo(clip_start_sec, clip_start_sec + self.clip_sampler._clip_duration,
                        0, 0, True)

    def reset(self) -> None:
        pass


def Ava(
    frame_paths_file: str,
    frame_labels_file: str,
    video_path_prefix: str = "",
    label_map_file: Optional[str] = None,
    clip_sampler: Optional[ClipSampler] = None,
    video_sampler: Type = RandomSampler,
    transform: Optional[Callable[[dict], Any]] = None,
    seed: Optional[int] = None,
) -> LabeledVideoDataset:
    """The AVA dataset (upstream ava.py:323-374): each sample is the clip
    around one annotated keyframe, a (T, H, W, C) uint8 tensor, with that
    second's ``boxes``, ``labels``, ``extra_info``, ``video_index`` and
    ``clip_index``. ``seed`` seeds the video sampler's shuffle (the JAX
    dataset's is unseeded)."""
    labeled_video_paths = AvaLabeledVideoFramePaths.from_csv(
        frame_paths_file, frame_labels_file, video_path_prefix, label_map_file)
    return LabeledVideoDataset(
        labeled_video_paths=labeled_video_paths,
        clip_sampler=TimeStampClipSampler(clip_sampler),
        transform=transform,
        video_sampler=video_sampler,
        decode_audio=False,
        seed=seed,
    )
