"""Squeeze-and-Excitation: the 3D layer of X3D's bottlenecks, the 2D layer
and the 2D residual block of the audio models.

Counterpart of pytorchvideo_tpu/layers/squeeze_excitation.py. Upstream X3D
uses fvcore's SqueezeExcitation, and the port keeps its ``state_dict`` layout:
``block = Sequential(Conv3d 1x1x1, ReLU, Conv3d 1x1x1, Sigmoid)``, where the
JAX package holds the same weights as two Dense layers (fc1, fc2). The 2D
pieces (upstream squeeze_excitation.py:10-180) keep the JAX package's
layout instead: :class:`SqueezeExcitation2d` holds fc1 and fc2 as 1x1
``nn.Conv2d``s, and the block on NCHW maps names its convs and norms as the
JAX block does.
"""

from __future__ import annotations

import operator
from typing import Callable, Optional, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import adaptive_avg_pool3d_to_1
from pytorchvideo_tpu_torch.layers.norms import BatchNorm2d, make_act, make_norm


class SqueezeExcitation(nn.Module):
    """x * sigmoid(W2 relu(W1 mean_{T,H,W}(x) + b1) + b2), per channel."""

    def __init__(self, num_channels: int, num_channels_reduced: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(num_channels, num_channels_reduced, kernel_size=1, bias=True),
            nn.ReLU(),
            nn.Conv3d(num_channels_reduced, num_channels, kernel_size=1, bias=True),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.block(adaptive_avg_pool3d_to_1(x))


class SqueezeExcitation2d(nn.Module):
    """x * sigmoid(fc2(relu(fc1(mean_{H,W}(x))))) on (B, C, H, W): the JAX
    package's rank-agnostic SE at rank 2, its Dense layers as 1x1 convs."""

    def __init__(self, num_channels: int, num_channels_reduced: int):
        super().__init__()
        self.fc1 = nn.Conv2d(num_channels, num_channels_reduced, kernel_size=1, bias=True)
        self.fc2 = nn.Conv2d(num_channels_reduced, num_channels, kernel_size=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(e)


class SqueezeAndExcitationLayer2D(nn.Module):
    """2D SE over ``in_planes`` channels, reduced to ``in_planes //
    reduction_ratio`` or to ``reduced_planes``: exactly one of the two is
    given (upstream squeeze_excitation.py:10-54)."""

    def __init__(self, in_planes: int, reduction_ratio: Optional[int] = 16,
                 reduced_planes: Optional[int] = None):
        super().__init__()
        if bool(reduction_ratio) == bool(reduced_planes):
            raise ValueError("give exactly one of reduction_ratio and reduced_planes, got "
                             f"{reduction_ratio} and {reduced_planes}")
        reduced = in_planes // reduction_ratio if reduced_planes is None else reduced_planes
        self.se = SqueezeExcitation2d(in_planes, reduced)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.se(x)


class _Audio2DSqueezeExcitationBlock(nn.Module):
    """conv_a -> norm_a -> act -> conv_b -> norm_b -> (SE), fused with the
    shortcut (projected by branch1_conv and branch1_norm where present) by
    ``branch_fusion``, then act. NCHW. Any norm may be None (the deploy form
    drops folded BNs).

    The shortcut and fusion repeat ``models.resnet.ResBlock``'s on purpose:
    the JAX block keeps conv_a..se flat beside branch1_conv, and the weight
    converter maps keys by their dotted path alone, so a ``ResBlock`` with a
    ``branch2`` would need a rename rule that cannot tell this block's
    ``conv_a`` from a bottleneck's. The layers package also imports nothing
    of the models package."""

    def __init__(
        self,
        *,
        conv_a: nn.Module,
        norm_a: Optional[nn.Module],
        conv_b: nn.Module,
        norm_b: Optional[nn.Module],
        se: Optional[nn.Module] = None,
        branch1_conv: Optional[nn.Module] = None,
        branch1_norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        branch_fusion: Callable = operator.add,
    ):
        super().__init__()
        self.branch1_conv = branch1_conv
        self.branch1_norm = branch1_norm
        self.conv_a = conv_a
        self.norm_a = norm_a
        self.conv_b = conv_b
        self.norm_b = norm_b
        self.se = se
        self.activation = activation
        self.branch_fusion = branch_fusion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.branch1_conv is not None:
            shortcut = self.branch1_conv(x)
            if self.branch1_norm is not None:
                shortcut = self.branch1_norm(shortcut)
        h = self.conv_a(x)
        if self.norm_a is not None:
            h = self.norm_a(h)
        if self.activation is not None:
            h = self.activation(h)
        h = self.conv_b(h)
        if self.norm_b is not None:
            h = self.norm_b(h)
        if self.se is not None:
            h = self.se(h)
        out = self.branch_fusion(shortcut, h)
        if self.activation is not None:
            out = self.activation(out)
        return out


def create_audio_2d_squeeze_excitation_block(
    dim_in: int,
    dim_out: int,
    use_se: bool = False,
    se_reduction_ratio: int = 16,
    branch_fusion: Callable = operator.add,
    conv_a_kernel_size: int = 3,
    conv_a_stride: int = 1,
    conv_a_padding: int = 1,
    conv_b_kernel_size: int = 3,
    conv_b_stride: int = 1,
    conv_b_padding: int = 1,
    norm: Optional[Callable] = BatchNorm2d,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> _Audio2DSqueezeExcitationBlock:
    """2D SE residual block builder (upstream squeeze_excitation.py:56-180),
    with its parameters on ``device``: bias-free square convs, the shortcut
    projected (a 1x1 conv at ``conv_a_stride``, and its norm) exactly where
    ``dim_in != dim_out`` or ``conv_a_stride != 1``; the SE reduces
    ``dim_out`` by ``se_reduction_ratio``."""

    def conv2d(c_in: int, k: int, s: int, p: int) -> nn.Conv2d:
        return nn.Conv2d(c_in, dim_out, kernel_size=k, stride=s, padding=p, bias=False)

    project = dim_in != dim_out or conv_a_stride != 1
    with torch.device(device):
        return _Audio2DSqueezeExcitationBlock(
            branch1_conv=conv2d(dim_in, 1, conv_a_stride, 0) if project else None,
            branch1_norm=make_norm(norm, dim_out, norm_eps, norm_momentum) if project else None,
            conv_a=conv2d(dim_in, conv_a_kernel_size, conv_a_stride, conv_a_padding),
            norm_a=make_norm(norm, dim_out, norm_eps, norm_momentum),
            conv_b=conv2d(dim_out, conv_b_kernel_size, conv_b_stride, conv_b_padding),
            norm_b=make_norm(norm, dim_out, norm_eps, norm_momentum),
            se=SqueezeExcitation2d(dim_out, dim_out // se_reduction_ratio) if use_se else None,
            activation=make_act(activation),
            branch_fusion=branch_fusion,
        )
