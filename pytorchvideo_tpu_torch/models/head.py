"""Model heads (counterpart of pytorchvideo_tpu/models/head.py): the ResNet
basic head (upstream models/head.py:39-131, :330-391) and the vision
transformer's (``SequencePool``, ``VisionTransformerBasicHead``,
``create_vit_basic_head``; upstream :11-36, :134-200, :485-535)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import adaptive_avg_pool3d_to_1
from pytorchvideo_tpu_torch.layers.norms import make_act
from pytorchvideo_tpu_torch.layers.pooling import AdaptiveAvgPool3d, AvgPool3d
from pytorchvideo_tpu_torch.layers.stochastic import Dropout


def make_head_act(activation: Optional[Callable]) -> Optional[Callable]:
    """A head's activation: ``nn.Softmax`` over the class axis (dim 1, as
    upstream builds it), any other as :func:`make_act`."""
    return nn.Softmax(dim=1) if activation is nn.Softmax else make_act(activation)


class ResNetBasicHead(nn.Module):
    """pool -> dropout -> proj over channels -> activation -> global average
    -> (B, classes). Takes NCTHW; ``proj`` is a ``Linear`` on the
    channels-last view, as upstream's permute pair."""

    def __init__(
        self,
        *,
        proj: nn.Linear,
        pool: Optional[nn.Module] = None,
        dropout_rate: float = 0.0,
        activation: Optional[Callable] = None,
        output_with_global_average: bool = True,
    ):
        super().__init__()
        self.pool = pool
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None
        self.proj = proj
        self.activation = activation
        self.output_with_global_average = output_with_global_average

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool is not None:
            x = self.pool(x)
        if self.dropout is not None:
            x = self.dropout(x)
        x = self.proj(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        if self.activation is not None:
            x = self.activation(x)
        if self.output_with_global_average:
            x = adaptive_avg_pool3d_to_1(x).flatten(1)
        return x


def create_res_basic_head(
    *,
    in_features: int,
    out_features: int,
    pool: Optional[Callable] = AvgPool3d,
    output_size: Tuple[int, int, int] = (1, 1, 1),
    pool_kernel_size: Tuple[int, int, int] = (1, 7, 7),
    pool_stride: Tuple[int, int, int] = (1, 1, 1),
    pool_padding: Tuple[int, int, int] = (0, 0, 0),
    dropout_rate: float = 0.5,
    activation: Optional[Callable] = None,
    output_with_global_average: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> ResNetBasicHead:
    """ResNet head builder (upstream head.py:39-131), with its parameters on
    ``device``. ``pool`` is a pool class (``AvgPool3d``, ``MaxPool3d``,
    ``AdaptiveAvgPool3d``) or None."""
    if pool is None:
        pool_model = None
    elif pool is AdaptiveAvgPool3d:
        pool_model = pool(output_size)
    else:
        pool_model = pool(kernel_size=pool_kernel_size, stride=pool_stride, padding=pool_padding)
    return ResNetBasicHead(
        proj=nn.Linear(in_features, out_features, device=device),
        pool=pool_model,
        dropout_rate=dropout_rate,
        activation=make_head_act(activation),
        output_with_global_average=output_with_global_average,
    )


class SequencePool(nn.Module):
    """(B, L, C) tokens -> (B, C): the cls token (row 0) or the token mean."""

    def __init__(self, mode: str):
        super().__init__()
        if mode not in ("cls", "mean"):
            raise ValueError(f"sequence pool mode must be 'cls' or 'mean', got {mode!r}")
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, 0] if self.mode == "cls" else x.mean(dim=1)


class VisionTransformerBasicHead(nn.Module):
    """sequence pool -> dropout -> proj -> activation."""

    def __init__(
        self,
        *,
        proj: nn.Linear,
        sequence_pool: Optional[nn.Module] = None,
        dropout_rate: float = 0.0,
        activation: Optional[Callable] = None,
    ):
        super().__init__()
        self.sequence_pool = sequence_pool
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None
        self.proj = proj
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sequence_pool is not None:
            x = self.sequence_pool(x)
        if self.dropout is not None:
            x = self.dropout(x)
        x = self.proj(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def create_vit_basic_head(
    *,
    in_features: int,
    out_features: int,
    seq_pool_type: str = "cls",
    dropout_rate: float = 0.5,
    activation: Optional[Callable] = None,
    device: Union[str, torch.device] = "cuda",
) -> VisionTransformerBasicHead:
    """Head builder (upstream head.py:134-200), with its parameters on
    ``device``; ``seq_pool_type`` is "cls", "mean" or "none"."""
    if seq_pool_type not in ("cls", "mean", "none"):
        raise ValueError(f"seq_pool_type must be 'cls', 'mean' or 'none', got {seq_pool_type!r}")
    return VisionTransformerBasicHead(
        proj=nn.Linear(in_features, out_features, device=device),
        sequence_pool=SequencePool(seq_pool_type) if seq_pool_type != "none" else None,
        dropout_rate=dropout_rate,
        activation=make_act(activation),
    )
