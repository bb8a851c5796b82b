"""The clip-level iterable dataset (counterpart of
pytorchvideo_tpu/data/labeled_video_dataset.py; upstream
pytorchvideo/data/labeled_video_dataset.py:20-304): video sampler ->
decode -> clip sampler -> transform, with

- a retry loop over consecutive failures (``_MAX_CONSECUTIVE_FAILURES``),
- the loaded video kept open across its clips, closed after the last,
- one decode per clip for all its augmentation views (``aug_index``),
- multi-clip samplers (ClipInfoList) decoding all their clips at aug 0,
- a transform that returns None skipping the sample,
- the sampler split among ``torch.utils.data`` workers
  (MultiProcessSampler) with one shuffle seed shared by them,
- the ``plan_clips`` / ``load_clip`` split that lets BatchLoader's threads
  decode in parallel (data/loader.py).

Decoded clips are (T, H, W, C) uint8 tensors on the host.
"""

from __future__ import annotations

import gc
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from pytorchvideo_tpu_torch.data.clip_sampling import ClipSampler
from pytorchvideo_tpu_torch.data.labeled_video_paths import LabeledVideoPaths
from pytorchvideo_tpu_torch.data.samplers import RandomSampler
from pytorchvideo_tpu_torch.data.utils import MultiProcessSampler
from pytorchvideo_tpu_torch.data.video import VideoPathHandler

logger = logging.getLogger(__name__)


class _ClipGroup(NamedTuple):
    """One decode span within a video plan; aug_indices > 1 share it."""

    clip_start: Any  # Fraction or List[Fraction] (multi-clip)
    clip_end: Any
    clip_index: Any
    aug_indices: List[int]


class _ClipPlan(NamedTuple):
    """One decode work item of plan_clips(): ALL clip groups of one video,
    so load_clip opens one container per video (upstream keeps one handle
    across a video's clips, labeled_video_dataset.py:134)."""

    video_path: str
    info_dict: dict
    video_index: int
    groups: List[_ClipGroup]


class LabeledVideoDataset:
    """Iterable over {"video", "label", "video_name", "video_index",
    "clip_index", "aug_index", ...} sample dicts. ``seed`` seeds the
    RandomSampler's generator (None: fresh entropy, as the JAX package)."""

    _MAX_CONSECUTIVE_FAILURES = 10

    def __init__(
        self,
        labeled_video_paths: List[Tuple[str, Optional[dict]]],
        clip_sampler: ClipSampler,
        video_sampler: Type = RandomSampler,
        transform: Optional[Callable[[dict], Any]] = None,
        decode_audio: bool = False,
        decode_video: bool = True,
        decoder: str = "opencv",
        seed: Optional[int] = None,
    ) -> None:
        self._decode_audio = decode_audio
        self._decode_video = decode_video
        self._transform = transform
        self._clip_sampler = clip_sampler
        self._labeled_videos = labeled_video_paths
        self._decoder = decoder

        # One seed shared by the dataloader workers, for one shuffle
        # (upstream :72-80).
        self._video_random_generator = None
        if video_sampler is RandomSampler:
            self._video_sampler = RandomSampler(self._labeled_videos,
                                                generator=np.random.default_rng(seed))
            self._video_random_generator = self._video_sampler
        else:
            self._video_sampler = video_sampler(self._labeled_videos)

        self._video_sampler_iter = None
        self._loaded_video_label = None
        self._loaded_clip = None
        self._last_clip_end_time = None
        self.video_path_handler = VideoPathHandler()

    @property
    def video_sampler(self):
        return self._video_sampler

    @property
    def num_videos(self):
        return len(self.video_sampler)

    def __next__(self) -> dict:
        if not self._video_sampler_iter:
            self._video_sampler_iter = iter(MultiProcessSampler(self._video_sampler))

        for i_try in range(self._MAX_CONSECUTIVE_FAILURES):
            if self._loaded_video_label:
                video, info_dict, video_index = self._loaded_video_label
            else:
                video_index = next(self._video_sampler_iter)
                try:
                    video_path, info_dict = self._labeled_videos[video_index]
                    video = self.video_path_handler.video_from_path(
                        video_path,
                        decode_audio=self._decode_audio,
                        decode_video=self._decode_video,
                        decoder=self._decoder,
                    )
                    self._loaded_video_label = (video, info_dict, video_index)
                except Exception as e:
                    logger.debug(
                        "Failed to load video with error: %s; trial %d", e, i_try
                    )
                    continue

            (
                clip_start,
                clip_end,
                clip_index,
                aug_index,
                is_last_clip,
            ) = self._clip_sampler(
                self._last_clip_end_time, video.duration, info_dict
            )

            if isinstance(clip_start, list):
                # multi-clip (ClipInfoList): decode all once at aug 0
                if aug_index[0] == 0:
                    self._loaded_clip = {}
                    loaded = []
                    for s, e in zip(clip_start, clip_end):
                        clip = video.get_clip(s, e)
                        if clip is None or (
                            self._decode_video and clip["video"] is None
                        ):
                            self._loaded_clip = None
                            break
                        loaded.append(clip)
                    if self._loaded_clip is not None:
                        for key in loaded[0].keys():
                            self._loaded_clip[key] = [c[key] for c in loaded]
            else:
                if aug_index == 0:
                    self._loaded_clip = video.get_clip(clip_start, clip_end)

            self._last_clip_end_time = clip_end

            video_is_null = self._loaded_clip is None or (
                self._decode_video and self._loaded_clip["video"] is None
            )
            last = is_last_clip[-1] if isinstance(is_last_clip, list) else is_last_clip
            if last or video_is_null:
                # close + reset for the next video; collect to bound memory
                self._loaded_video_label[0].close()
                self._loaded_video_label = None
                self._last_clip_end_time = None
                self._clip_sampler.reset()
                gc.collect()
                if video_is_null:
                    logger.debug(
                        "Failed to load clip %s; trial %d", video.name, i_try
                    )
                    continue

            sample_dict = {
                "video": self._loaded_clip["video"],
                "video_name": video.name,
                "video_index": video_index,
                "clip_index": clip_index,
                "aug_index": aug_index,
                **info_dict,
            }
            audio = self._loaded_clip.get("audio")
            if audio is not None:
                sample_dict["audio"] = audio
            if self._transform is not None:
                sample_dict = self._transform(sample_dict)
                if sample_dict is None:
                    # transform vetoed this sample; move on
                    continue
            return sample_dict
        raise RuntimeError(
            f"Failed to load video after {self._MAX_CONSECUTIVE_FAILURES} retries."
        )

    # ---- parallel decode protocol (consumed by data.loader.BatchLoader) ----
    #
    # The sequential __next__ above interleaves cheap clip planning with
    # expensive decode and transform, so threads pulling from one shared
    # iterator would serialize on the decode. A sequential planner owns all
    # sampler state and emits self-contained work items; any number of
    # workers decode them concurrently, each with its own container.

    def plan_clips(self):
        """Yield one ClipPlan per video: all its clip groups. Sequential;
        only probes container metadata (duration), never decodes frames —
        and caches the probed duration per path so repeat epochs skip the
        open+header-parse entirely."""
        durations = getattr(self, "_duration_cache", None)
        if durations is None:
            durations = self._duration_cache = {}
        sampler_iter = iter(MultiProcessSampler(self._video_sampler))
        failures = 0
        while True:
            try:
                video_index = next(sampler_iter)
            except StopIteration:
                return
            video_path, info_dict = self._labeled_videos[video_index]
            duration = durations.get(video_path)
            if duration is None:
                try:
                    video = self.video_path_handler.video_from_path(
                        video_path,
                        decode_audio=self._decode_audio,
                        decode_video=self._decode_video,
                        decoder=self._decoder,
                    )
                    duration = video.duration
                    video.close()
                except Exception as e:
                    logger.debug("Failed to probe video %s: %s", video_path, e)
                    failures += 1
                    if failures >= self._MAX_CONSECUTIVE_FAILURES:
                        raise RuntimeError(
                            f"Failed to load video after "
                            f"{self._MAX_CONSECUTIVE_FAILURES} retries."
                        )
                    continue
                durations[video_path] = duration
            failures = 0

            # Enumerate this video's clips; group consecutive same-span
            # entries so aug>0 views reuse one decode (upstream :165-186).
            infos = []
            last_end = None
            while True:
                info = self._clip_sampler(last_end, duration, info_dict)
                infos.append(info)
                last_end = info[1]
                is_last = info[4]
                if isinstance(is_last, list):
                    is_last = is_last[-1]
                if is_last:
                    break
            self._clip_sampler.reset()

            groups: List[_ClipGroup] = []
            group = None
            for info in infos:
                clip_start, clip_end, clip_index, aug_index, _ = info
                key = (str(clip_start), str(clip_end), str(clip_index))
                if group is not None and group["key"] == key:
                    group["aug_indices"].append(aug_index)
                    continue
                if group is not None:
                    groups.append(
                        _ClipGroup(
                            group["start"],
                            group["end"],
                            group["clip_index"],
                            group["aug_indices"],
                        )
                    )
                group = {
                    "key": key,
                    "start": clip_start,
                    "end": clip_end,
                    "clip_index": clip_index,
                    "aug_indices": [aug_index],
                }
            if group is not None:
                groups.append(
                    _ClipGroup(
                        group["start"],
                        group["end"],
                        group["clip_index"],
                        group["aug_indices"],
                    )
                )
            if groups:
                yield _ClipPlan(video_path, info_dict, video_index, groups)

    def load_clip(self, plan: "_ClipPlan") -> List[dict]:
        """Decode + transform one ClipPlan — all clip groups of one video
        through a single container handle (thread-safe: the handle is
        private to this call). Returns the plan's sample dicts."""
        video = self.video_path_handler.video_from_path(
            plan.video_path,
            decode_audio=self._decode_audio,
            decode_video=self._decode_video,
            decoder=self._decoder,
        )
        samples: List[dict] = []
        try:
            for group in plan.groups:
                if isinstance(group.clip_start, list):
                    loaded = []
                    for s, e in zip(group.clip_start, group.clip_end):
                        clip = video.get_clip(s, e)
                        if clip is None or (
                            self._decode_video and clip["video"] is None
                        ):
                            loaded = None
                            break
                        loaded.append(clip)
                    if loaded is None:
                        continue
                    base_clip = {
                        key: [c[key] for c in loaded]
                        for key in loaded[0].keys()
                    }
                else:
                    base_clip = video.get_clip(group.clip_start, group.clip_end)
                    if base_clip is None or (
                        self._decode_video and base_clip["video"] is None
                    ):
                        logger.debug(
                            "Failed to decode clip %s", plan.video_path
                        )
                        continue
                for aug_index in group.aug_indices:
                    sample_dict = {
                        "video": base_clip["video"],
                        "video_name": video.name,
                        "video_index": plan.video_index,
                        "clip_index": group.clip_index,
                        "aug_index": aug_index,
                        **plan.info_dict,
                    }
                    audio = base_clip.get("audio")
                    if audio is not None:
                        sample_dict["audio"] = audio
                    if self._transform is not None:
                        sample_dict = self._transform(sample_dict)
                        if sample_dict is None:
                            continue
                    samples.append(sample_dict)
            return samples
        finally:
            video.close()

    def __iter__(self):
        self._video_sampler_iter = None
        # torch DataLoader workers: re-seed the shared generator identically
        # in every worker so MultiProcessSampler chunks a common permutation
        # (upstream :240-248).
        worker_info = torch.utils.data.get_worker_info()
        if self._video_random_generator is not None and worker_info is not None:
            base_seed = worker_info.seed - worker_info.id
            self._video_random_generator.manual_seed(base_seed % (2**32))
        return self


def labeled_video_dataset(
    data_path: str,
    clip_sampler: ClipSampler,
    video_sampler: Type = RandomSampler,
    transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    video_path_prefix: str = "",
    decode_audio: bool = False,
    decode_video: bool = True,
    decoder: str = "opencv",
    seed: Optional[int] = None,
) -> LabeledVideoDataset:
    """Build from a csv file or class-directory tree
    (upstream labeled_video_dataset.py:252-304)."""
    labeled_video_paths = LabeledVideoPaths.from_path(data_path)
    labeled_video_paths.path_prefix = video_path_prefix
    return LabeledVideoDataset(
        labeled_video_paths,
        clip_sampler,
        video_sampler,
        transform,
        decode_audio=decode_audio,
        decode_video=decode_video,
        decoder=decoder,
        seed=seed,
    )
