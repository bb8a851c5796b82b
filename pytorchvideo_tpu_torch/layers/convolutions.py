"""Parallel-reduce and factorized (2+1)D convs.

Counterpart of pytorchvideo_tpu/layers/convolutions.py ``ConvReduce3D``,
``Conv2plus1d`` and ``create_conv_2plus1d`` (upstream
layers/convolutions.py:11-85, :88-237). The X3D
stem stores its spatial conv in the ``conv_t`` slot and its temporal
depthwise conv in ``conv_xy`` (upstream x3d.py:19-102); the slots keep those
names for ``state_dict`` parity.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import Conv3d, triple
from pytorchvideo_tpu_torch.layers.norms import BatchNorm, make_act, make_norm


def _nth(values: Optional[Sequence], i: int, default):
    """The i-th conv's setting: ``values[i]``, or ``default`` where the
    sequence or its entry is None."""
    if values is None or values[i] is None:
        return default
    return values[i]


class ConvReduce3D(nn.Module):
    """N parallel ``nn.Conv3d``s over one input (``convs``, one per entry of
    ``kernel_size``), their outputs summed (``"sum"``) or concatenated on the
    channel axis (``"cat"``): the acoustic stem's temporal and spatial convs.
    ``stride``, ``padding``, ``dilation``, ``groups`` and ``bias`` hold one
    entry per conv; a None sequence or entry takes 1, 0, 1, 1 and True."""

    def __init__(
        self,
        *,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[Tuple[int, int, int]],
        stride: Optional[Sequence] = None,
        padding: Optional[Sequence] = None,
        dilation: Optional[Sequence] = None,
        groups: Optional[Sequence[int]] = None,
        bias: Optional[Sequence[bool]] = None,
        reduction_method: str = "sum",
    ):
        super().__init__()
        if reduction_method not in ("sum", "cat"):
            raise ValueError(f"reduction_method must be 'sum' or 'cat', got {reduction_method!r}")
        self.reduction_method = reduction_method
        self.convs = nn.ModuleList(
            Conv3d(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=kernel,
                stride=_nth(stride, i, (1, 1, 1)),
                padding=_nth(padding, i, (0, 0, 0)),
                dilation=_nth(dilation, i, (1, 1, 1)),
                groups=_nth(groups, i, 1),
                bias=_nth(bias, i, True),
            )
            for i, kernel in enumerate(kernel_size)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs = [conv(x) for conv in self.convs]
        if self.reduction_method == "cat":
            return torch.cat(outputs, dim=1)
        return sum(outputs[1:], outputs[0])


class Conv2plus1d(nn.Module):
    """conv_t -> norm -> act -> conv_xy, or conv_xy first when
    ``conv_xy_first``."""

    def __init__(
        self,
        *,
        conv_t: nn.Module,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        conv_xy: nn.Module,
        conv_xy_first: bool = False,
    ):
        super().__init__()
        self.conv_t = conv_t
        self.norm = norm
        self.activation = activation
        self.conv_xy = conv_xy
        self.conv_xy_first = conv_xy_first

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_xy(x) if self.conv_xy_first else self.conv_t(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return self.conv_t(x) if self.conv_xy_first else self.conv_xy(x)


def create_conv_2plus1d(
    *,
    in_channels: int,
    out_channels: int,
    inner_channels: Optional[int] = None,
    conv_xy_first: bool = False,
    kernel_size: Tuple[int, int, int] = (3, 3, 3),
    stride: Tuple[int, int, int] = (2, 2, 2),
    padding: Tuple[int, int, int] = (1, 1, 1),
    bias: bool = False,
    dilation: Tuple[int, int, int] = (1, 1, 1),
    groups: int = 1,
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> Conv2plus1d:
    """(2+1)D conv builder (upstream convolutions.py:88-189), with its
    parameters on ``device``: a (kt, 1, 1) temporal and a (1, kh, kw)
    spatial conv, the norm and activation between them over
    ``inner_channels`` (default ``out_channels``)."""
    if inner_channels is None:
        inner_channels = out_channels
    if groups != 1:
        raise ValueError(f"a 2+1d conv takes no groups, got {groups}")
    if tuple(triple(dilation)) != (1, 1, 1):
        raise ValueError(f"a 2+1d conv takes no dilation, got {dilation}")
    (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = triple(kernel_size), triple(stride), triple(padding)
    t_in, t_out = (inner_channels, out_channels) if conv_xy_first else (in_channels, inner_channels)
    xy_in, xy_out = (in_channels, inner_channels) if conv_xy_first else (inner_channels, out_channels)
    with torch.device(device):
        return Conv2plus1d(
            conv_t=Conv3d(in_channels=t_in, out_channels=t_out, kernel_size=(kt, 1, 1),
                          stride=(st, 1, 1), padding=(pt, 0, 0), bias=bias),
            norm=make_norm(norm, inner_channels, norm_eps, norm_momentum),
            activation=make_act(activation),
            conv_xy=Conv3d(in_channels=xy_in, out_channels=xy_out, kernel_size=(1, kh, kw),
                           stride=(1, sh, sw), padding=(0, ph, pw), bias=bias),
            conv_xy_first=conv_xy_first,
        )
