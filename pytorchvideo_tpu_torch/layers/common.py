"""Conv and pool helpers.

Counterpart of pytorchvideo_tpu/layers/common.py. Tensors are NCTHW, as in
upstream pytorchvideo; models keep them in ``torch.channels_last_3d``. The
JAX package's ``WBlockedConv`` is a TPU layout rewrite of a plain conv with
the same parameters; the port uses ``nn.Conv3d`` in its place.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Size3 = Tuple[int, int, int]


def triple(v: Union[int, Size3]) -> Size3:
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def Conv3d(
    *,
    in_channels: int,
    out_channels: int,
    kernel_size,
    stride=(1, 1, 1),
    padding=(0, 0, 0),
    bias: bool = True,
    groups: int = 1,
    dilation=(1, 1, 1),
) -> nn.Conv3d:
    """Keyword-only ``nn.Conv3d`` factory for the builders' injectable-callable
    idiom (``conv_a=Conv3d``)."""
    return nn.Conv3d(
        in_channels,
        out_channels,
        kernel_size=triple(kernel_size),
        stride=triple(stride),
        padding=triple(padding),
        dilation=triple(dilation),
        groups=groups,
        bias=bias,
    )


def avg_pool3d(x: torch.Tensor, kernel_size, stride=None, padding=(0, 0, 0)) -> torch.Tensor:
    """Average pool over (T, H, W) with count_include_pad=True, summed in
    float32 at least (PyTorch's CPU avg_pool3d has no bfloat16; float64
    stays float64)."""
    k = triple(kernel_size)
    return F.avg_pool3d(
        x.to(torch.promote_types(x.dtype, torch.float32)),
        k,
        stride=triple(stride) if stride is not None else k,
        padding=triple(padding),
        count_include_pad=True,
    ).to(x.dtype)


def max_pool3d(x: torch.Tensor, kernel_size, stride=None, padding=(0, 0, 0)) -> torch.Tensor:
    """Max pool over (T, H, W) with MaxPool3d semantics: -inf padding, floor
    output size. Exact in any dtype: on the CPU a 16-bit x is pooled in
    float32 (PyTorch's CPU max_pool3d has no bfloat16), any other dtype as
    it is."""
    k = triple(kernel_size)
    return F.max_pool3d(
        x.float() if x.device.type == "cpu" and x.element_size() < 4 else x,
        k,
        stride=triple(stride) if stride is not None else k,
        padding=triple(padding),
    ).to(x.dtype)


def adaptive_avg_pool3d_to_1(x: torch.Tensor) -> torch.Tensor:
    """Global spatiotemporal average: (B, C, T, H, W) -> (B, C, 1, 1, 1)."""
    return x.mean(dim=(2, 3, 4), keepdim=True)
