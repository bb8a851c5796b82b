"""Precise BN: BatchNorm running stats re-estimated over extra batches
(counterpart of pytorchvideo_tpu/train/precise_batchnorm.py; upstream
pytorchvideo_trainer/callbacks/precise_batchnorm.py:13-70, which wraps
fvcore's ``update_bn_stats``).

Each running mean and variance becomes the arithmetic mean, over the
batches, of that batch's mean and biased variance in float32, in place of
the training run's moving average. Each batch is forwarded in train mode
with its BatchNorms' momentum set to 1, so that their running buffers hold
that batch's own statistics (layers/norms.py), which are summed. The
parameters do not change, nor does any other buffer: each norm's momentum,
``num_batches_tracked`` and every module's mode are restored.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.norms import BatchNorm


@torch.no_grad()
def update_bn_stats(model: nn.Module, batches: Iterable, num_batches: int,
                    input_key: str = "video") -> nn.Module:
    """Sets every ``BatchNorm`` of ``model`` to the mean of the batch
    statistics of the first ``num_batches`` of ``batches`` (dicts holding
    ``input_key``, or the inputs themselves: a clip or a list of pathways),
    on the device the model lives on. Returns the model."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm) and m.track_running_stats]
    if not norms:
        return model
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in norms]
    modes = [(m, m.training) for m in model.modules()]
    means = [torch.zeros_like(m.running_mean) for m in norms]
    variances = [torch.zeros_like(m.running_var) for m in norms]
    seen = 0
    try:
        for m in norms:
            m.momentum = 1.0
        model.train()
        for batch in batches:
            if seen >= num_batches:
                break
            model(batch[input_key] if isinstance(batch, dict) else batch)
            torch._foreach_add_(means, [m.running_mean for m in norms])
            torch._foreach_add_(variances, [m.running_var for m in norms])
            seen += 1
    finally:
        for m, (momentum, tracked) in zip(norms, saved):
            m.momentum = momentum
            m.num_batches_tracked.copy_(tracked)
        for m, training in modes:
            m.training = training
    if seen == 0:
        raise ValueError("update_bn_stats got no batches")
    for m, mean, var in zip(norms, means, variances):
        m.running_mean.copy_(mean / seen)
        m.running_var.copy_(var / seen)
    return model


class PreciseBn:
    """Callback form (upstream precise_batchnorm.py:13-70): call
    ``on_train_epoch_end`` with a fresh iterator of batches."""

    def __init__(self, num_batches: int):
        self.num_batches = num_batches

    def on_train_epoch_end(self, model: nn.Module, dataloader: Iterable, **kwargs) -> nn.Module:
        return update_bn_stats(model, dataloader, self.num_batches, **kwargs)
