"""Losses of the port (counterpart of pytorchvideo_tpu/losses)."""

from pytorchvideo_tpu_torch.losses.soft_target_cross_entropy import (  # noqa: F401
    SoftTargetCrossEntropyLoss,
    soft_target_cross_entropy,
)
