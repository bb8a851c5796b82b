"""Video stems (counterpart of pytorchvideo_tpu/models/stem.py): the basic
conv stem and its builder (upstream models/stem.py:11-107, :215-260), the
acoustic stem (upstream :110-212) and MViT's conv patch embedding (upstream
:263-338)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import Conv3d
from pytorchvideo_tpu_torch.layers.convolutions import ConvReduce3D
from pytorchvideo_tpu_torch.layers.norms import BatchNorm, make_act, make_norm
from pytorchvideo_tpu_torch.layers.pooling import MaxPool3d


class ResNetBasicStem(nn.Module):
    """conv -> norm -> activation -> pool."""

    def __init__(
        self,
        *,
        conv: nn.Module,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        pool: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.conv = conv
        self.norm = norm
        self.activation = activation
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        if self.pool is not None:
            x = self.pool(x)
        return x


def create_res_basic_stem(
    *,
    in_channels: int = 3,
    out_channels: int = 64,
    conv_kernel_size: Tuple[int, int, int] = (3, 7, 7),
    conv_stride: Tuple[int, int, int] = (1, 2, 2),
    conv_padding: Tuple[int, int, int] = (1, 3, 3),
    conv_bias: bool = False,
    conv: Callable = Conv3d,
    pool: Optional[Callable] = MaxPool3d,
    pool_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    pool_stride: Tuple[int, int, int] = (1, 2, 2),
    pool_padding: Tuple[int, int, int] = (0, 1, 1),
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> ResNetBasicStem:
    """Basic stem builder (upstream stem.py:11-107), with its parameters on
    ``device``: conv -> norm -> activation -> pool. The JAX package's
    layout-blocked stem convs (``WBlockedConv``, ``WPackedConv3d``) are TPU
    rewrites of the same conv and are not ported."""
    with torch.device(device):
        return ResNetBasicStem(
            conv=conv(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=conv_kernel_size,
                stride=conv_stride,
                padding=conv_padding,
                bias=conv_bias,
            ),
            norm=make_norm(norm, out_channels, norm_eps, norm_momentum),
            activation=make_act(activation),
            pool=None if pool is None else pool(
                kernel_size=pool_kernel_size, stride=pool_stride, padding=pool_padding
            ),
        )


def create_acoustic_res_basic_stem(
    *,
    in_channels: int = 3,
    out_channels: int = 64,
    conv_kernel_size: Tuple[int, int, int] = (3, 7, 7),
    conv_stride: Tuple[int, int, int] = (1, 1, 1),
    conv_padding: Tuple[int, int, int] = (1, 3, 3),
    conv_bias: bool = False,
    pool: Optional[Callable] = MaxPool3d,
    pool_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    pool_stride: Tuple[int, int, int] = (1, 2, 2),
    pool_padding: Tuple[int, int, int] = (0, 1, 1),
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> ResNetBasicStem:
    """Acoustic stem builder (upstream stem.py:110-212), with its parameters
    on ``device``: a :class:`ResNetBasicStem` whose conv is a
    :class:`ConvReduce3D` of a (kt, 1, 1) and a (1, kh, kw) conv at the same
    stride, summed."""
    kt, kh, kw = conv_kernel_size
    pt, ph, pw = conv_padding
    with torch.device(device):
        return ResNetBasicStem(
            conv=ConvReduce3D(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=((kt, 1, 1), (1, kh, kw)),
                stride=(conv_stride, conv_stride),
                padding=((pt, 0, 0), (0, ph, pw)),
                bias=(conv_bias, conv_bias),
                reduction_method="sum",
            ),
            norm=make_norm(norm, out_channels, norm_eps, norm_momentum),
            activation=make_act(activation),
            pool=None if pool is None else pool(
                kernel_size=pool_kernel_size, stride=pool_stride, padding=pool_padding
            ),
        )


class PatchEmbed(nn.Module):
    """Conv patch embedding: an NCTHW clip becomes (B, T'*H'*W', C) tokens in
    (T, H, W) order. The conv runs in ``channels_last_3d``, so the flatten and
    transpose to tokens are a view of its output, not a copy."""

    def __init__(self, *, patch_model: nn.Module):
        super().__init__()
        self.patch_model = patch_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_model(x.contiguous(memory_format=torch.channels_last_3d))
        return x.flatten(2).transpose(1, 2)


def create_conv_patch_embed(
    *,
    in_channels: int,
    out_channels: int,
    conv_kernel_size: Tuple[int, int, int] = (1, 16, 16),
    conv_stride: Tuple[int, int, int] = (1, 4, 4),
    conv_padding: Tuple[int, int, int] = (1, 7, 7),
    conv_bias: bool = True,
    conv: Callable = Conv3d,
    device: Union[str, torch.device] = "cuda",
) -> PatchEmbed:
    """Conv patch-embed builder (upstream stem.py:295-338), with its
    parameters on ``device``. The JAX package's ``WBlockedConv`` (a TPU
    layout rewrite of the same conv) is not ported: the conv is a plain
    ``nn.Conv3d``."""
    with torch.device(device):
        return PatchEmbed(
            patch_model=conv(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=conv_kernel_size,
                stride=conv_stride,
                padding=conv_padding,
                bias=conv_bias,
            )
        )
