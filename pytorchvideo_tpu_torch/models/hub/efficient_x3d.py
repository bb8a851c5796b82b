"""Deployable X3D entries: counterpart of
pytorchvideo_tpu/models/hub/efficient_x3d_tpu.py (upstream
hub/efficient_x3d_mobile_cpu.py:40-85). Each returns an
:class:`~pytorchvideo_tpu_torch.accelerate.efficient_blocks.EfficientX3d`,
built on ``device`` ("cuda" unless the caller asks for the CPU), whose
``convert()`` is the X3D deploy form: BN folded, the stride-1 ``conv_b`` on
the depthwise kernel, bf16, and with an example clip batch on the card a
CUDA graph."""

from pytorchvideo_tpu_torch.accelerate.efficient_blocks import EfficientX3d


def efficient_x3d_xs(num_classes: int = 400, **kwargs) -> EfficientX3d:
    """X3D-XS 4x160."""
    return EfficientX3d(expansion="XS", num_classes=num_classes, **kwargs)


def efficient_x3d_s(num_classes: int = 400, **kwargs) -> EfficientX3d:
    """X3D-S 13x160."""
    return EfficientX3d(expansion="S", num_classes=num_classes, **kwargs)
