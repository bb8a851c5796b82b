"""Evaluation metrics (counterpart of pytorchvideo_tpu/train/metrics.py;
upstream instantiates torchmetrics Accuracy / AveragePrecision,
module/video_classification.py:117-123): top-k accuracy on the logits'
device, and the (multi-label) average precisions of Charades / AVA on the
host in float64."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def topk_accuracy(logits, labels, k: int = 1) -> torch.Tensor:
    """The fraction of rows whose label is among the row's k largest scores
    (a 0-d f32 tensor)."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device)
    topk = logits.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1).float().mean()


def top1_top5(logits, labels) -> Dict[str, float]:
    """{"top1": ..., "top5": ...} accuracies as floats."""
    return {"top1": float(topk_accuracy(logits, labels, 1)),
            "top5": float(topk_accuracy(logits, labels, 5))}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def average_precision(scores, targets) -> float:
    """One class's AP: the mean of the precision at each positive, in the
    order of decreasing score (torchmetrics' and sklearn's step rule); NaN
    without a positive."""
    scores = _host(scores).astype(np.float64)
    targets = _host(targets).astype(bool)
    if targets.sum() == 0:
        return float("nan")
    hits = targets[np.argsort(-scores)]
    precision = np.cumsum(hits) / (np.arange(len(hits)) + 1)
    return float((precision * hits).sum() / targets.sum())


def mean_average_precision(scores, targets) -> float:
    """The macro mean of the per-class APs of (N, C) scores and 0/1 targets,
    over the classes with a positive (0.0 if none has one)."""
    scores, targets = _host(scores), _host(targets)
    aps = [average_precision(scores[:, c], targets[:, c]) for c in range(scores.shape[1])]
    aps = [a for a in aps if not np.isnan(a)]
    return float(np.mean(aps)) if aps else 0.0
