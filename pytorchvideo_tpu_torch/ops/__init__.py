"""Kernels of the port, each beside its plain PyTorch version."""

from pytorchvideo_tpu_torch.ops.depthwise_conv import (  # noqa: F401
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
    depthwise3x3x3_bn_swish_torch,
)
from pytorchvideo_tpu_torch.ops.roi_align import RoIAlign, roi_align  # noqa: F401
