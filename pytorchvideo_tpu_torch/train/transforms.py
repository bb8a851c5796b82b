"""Trainer-level transforms (counterpart of
pytorchvideo_tpu/train/transforms.py; upstream
pytorchvideo_trainer/datamodule/transforms.py and collators.py):
``SlowFastPackPathway`` (upstream :99-139) and ``default_collate``, which
make SlowFast's pathway-list batches from clips, and
``MixVideoBatchWrapper`` (upstream :165). The SSL transforms and
``multiple_samples_collate`` wait for the SSL slice."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pytorchvideo_tpu_torch.transforms.mix import MixVideo


class MixVideoBatchWrapper:
    """MixVideo over a batch dict, on the batch's device; the random scalars
    come from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, mixup_alpha: float, cutmix_prob: float, cutmix_alpha: float,
                 label_smoothing: float, num_classes: int = 400) -> None:
        self.mix_video_transform = MixVideo(
            mixup_alpha=mixup_alpha,
            cutmix_prob=cutmix_prob,
            cutmix_alpha=cutmix_alpha,
            label_smoothing=label_smoothing,
            num_classes=num_classes,
        )

    def __call__(self, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        batch["video"], batch["label"] = self.mix_video_transform(
            batch["video"], batch["label"], generator)
        return batch


class SlowFastPackPathway:
    """A (C, T, H, W) clip -> ``[slow, fast]``: the slow pathway keeps T //
    alpha frames evenly spaced over the clip (the first and the last among
    them), the fast one all T."""

    def __init__(self, alpha: int) -> None:
        self.alpha = alpha

    def __call__(self, frames) -> List[torch.Tensor]:
        frames = torch.as_tensor(frames)
        t = frames.shape[1]
        index = torch.from_numpy(np.linspace(0, t - 1, t // self.alpha).astype(np.int64))
        return [frames.index_select(1, index.to(frames.device)), frames]


def _stack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` in the samples' memory order: each sample permuted to
    its strides' order, stacked, and the batch permuted back, so that CTHW
    views of THWC clips make a ``channels_last_3d`` batch."""
    first = tensors[0]
    order = sorted(range(first.dim()), key=lambda i: -first.stride(i))
    if order == list(range(first.dim())):
        return torch.stack(tensors)
    batch = torch.stack([t.permute(order) for t in tensors])
    return batch.permute(0, *[order.index(i) + 1 for i in range(first.dim())])


def default_collate(samples: List[Any]):
    """Stacks the samples' leaves into a batch, through dicts, lists and
    tuples (a list of ``[slow, fast]`` clips becomes ``[slow batch, fast
    batch]``); numbers become a tensor, strings stay a list. Tensors keep
    their memory order (:func:`_stack`)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, str):
        return list(samples)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return torch.as_tensor(np.asarray(samples))
    return _stack([torch.as_tensor(s) for s in samples])
