"""Efficient conv, SE, pool, activation and fc blocks with a train form and a
deploy form.

Counterpart of pytorchvideo_tpu/accelerate/conv_blocks.py (upstream
layers/accelerator/mobile_cpu/convolutions.py: Conv3dPwBnAct :29,
Conv3d3x3x3DwBnAct :182, Conv3dTemporalKernel1BnAct :304, Conv3d3x1x1BnAct
:421, Conv3d5x1x1BnAct :535; attention.py:16-107, activation_functions.py:
17-95, pool.py:14-115, fully_connected.py:9, and
models/accelerator/mobile_cpu/residual_blocks.py:22-200). Each factory
returns an efficient block (accelerate/efficient_blocks.py) whose ``.model``
is the train form, with the JAX package's field names (``conv``/``norm``,
``conv_a``..``conv_c``/``norm_a``..``norm_c``, ``se.fc1``/``se.fc2``, ``fc``), so
zoo/from_jax.py carries its weights across. Tensors are NCTHW (NCHW for the
2-D pools and a 4-D SE). The factories of blocks with weights build them on
``device``: the card unless the caller asks for the CPU.

``convert()`` is the deploy form's passes (accelerate/deploy.py): BN folds
into the conv, a stride-1 depthwise 3x3x3 conv whose BN folded into it runs
on the depthwise kernel (ops/depthwise_conv.py) through
:class:`~pytorchvideo_tpu_torch.accelerate.deploy.DepthwiseConv3x3x3BnAct`,
and the weights are cast. That covers ``Conv3d3x3x3DwBnAct`` and the stride-1
``conv_b`` of ``X3dBottleneckBlock``. Swish joins the kernel's epilogue
only where no SE comes between; ReLU, hswish and identity run after the
kernel. A strided ``conv_b`` stays ``F.conv3d``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.accelerate.deploy import (
    DepthwiseConv3x3x3BnAct,
    _is_kernel_conv,
    convert_to_deployable_form,
)
from pytorchvideo_tpu_torch.accelerate.efficient_blocks import TrainAndDeployForms
from pytorchvideo_tpu_torch.layers.norms import BatchNorm

Device = Union[str, torch.device]


def _hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


# upstream activation_functions.py:17-95 {relu, swish, hswish, identity}
supported_act_functions = {
    "relu": F.relu,
    "swish": F.silu,
    "hswish": _hswish,
    "identity": lambda x: x,
}


def _kernel_form(conv: nn.Module, apply_swish: bool) -> Optional[DepthwiseConv3x3x3BnAct]:
    """The kernel's module for a stride-1 depthwise 3x3x3 conv that carries
    its BN as a bias; None for any other conv."""
    if not _is_kernel_conv(conv) or conv.bias is None:
        return None
    return DepthwiseConv3x3x3BnAct.from_folded_conv(conv, apply_swish)


class _ConvBnAct(nn.Module):
    """conv -> BN -> act, with the fold's field names (conv/norm)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int, int],
                 stride=(1, 1, 1), padding=(0, 0, 0), groups: int = 1, bias: bool = True,
                 use_bn: bool = True, activation: str = "relu"):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, groups=groups, bias=bias)
        self.norm = BatchNorm(out_channels) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return supported_act_functions[self.activation](x)

    def swap_in_kernel(self) -> int:
        """The deploy pass: the folded depthwise conv onto the kernel."""
        fuse_swish = self.activation == "swish"
        kernel = None if self.norm is not None else _kernel_form(self.conv, fuse_swish)
        if kernel is None:
            return 0
        self.conv = kernel
        if fuse_swish:
            self.activation = "identity"
        return 1


class _EfficientConvBlock(TrainAndDeployForms):
    """A train-form module; ``convert()`` builds its deploy form."""

    def convert(self, example_input=None, dtype: Optional[torch.dtype] = torch.bfloat16,
                **kwargs) -> "_EfficientConvBlock":
        self._set_deploy(convert_to_deployable_form(self.model, dtype), dtype)
        return self


def Conv3dPwBnAct(in_channels: int, out_channels: int, bias: bool = False,
                  activation: str = "relu", use_bn: bool = True,
                  device: Device = "cuda") -> _EfficientConvBlock:
    """1x1x1 pointwise conv + BN + act (upstream convolutions.py:29-179)."""
    with torch.device(device):
        return _EfficientConvBlock(_ConvBnAct(in_channels, out_channels, (1, 1, 1), bias=bias,
                                              use_bn=use_bn, activation=activation))


def Conv3d3x3x3DwBnAct(in_channels: int, bias: bool = False, activation: str = "relu",
                       use_bn: bool = True, device: Device = "cuda") -> _EfficientConvBlock:
    """Depthwise 3x3x3 conv + BN + act (upstream convolutions.py:182-301)."""
    with torch.device(device):
        return _EfficientConvBlock(_ConvBnAct(
            in_channels, in_channels, (3, 3, 3), padding=(1, 1, 1), groups=in_channels,
            bias=bias, use_bn=use_bn, activation=activation))


def Conv3dTemporalKernel1BnAct(in_channels: int, out_channels: int, kernel_size=(3, 3),
                               stride=(1, 1), padding=(1, 1), groups: int = 1, bias: bool = False,
                               activation: str = "relu", use_bn: bool = True,
                               device: Device = "cuda") -> _EfficientConvBlock:
    """Spatial-only conv (temporal kernel 1) + BN + act (upstream
    convolutions.py:304-418)."""
    with torch.device(device):
        return _EfficientConvBlock(_ConvBnAct(
            in_channels, out_channels, (1, *kernel_size), stride=(1, *stride),
            padding=(0, *padding), groups=groups, bias=bias, use_bn=use_bn,
            activation=activation))


def Conv3d3x1x1BnAct(in_channels: int, out_channels: int, groups: int = 1, bias: bool = False,
                     activation: str = "relu", use_bn: bool = True,
                     device: Device = "cuda") -> _EfficientConvBlock:
    """Temporal-only 3x1x1 conv + BN + act (upstream convolutions.py:421-532)."""
    with torch.device(device):
        return _EfficientConvBlock(_ConvBnAct(
            in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0), groups=groups, bias=bias,
            use_bn=use_bn, activation=activation))


def Conv3d5x1x1BnAct(in_channels: int, out_channels: int, groups: int = 1, bias: bool = False,
                     activation: str = "relu", use_bn: bool = True,
                     device: Device = "cuda") -> _EfficientConvBlock:
    """Temporal-only 5x1x1 conv + BN + act (upstream convolutions.py:535-629)."""
    with torch.device(device):
        return _EfficientConvBlock(_ConvBnAct(
            in_channels, out_channels, (5, 1, 1), padding=(2, 0, 0), groups=groups, bias=bias,
            use_bn=use_bn, activation=activation))


class _SE(nn.Module):
    """Squeeze-excitation: the mean over (T, H, W) (over (H, W) when not
    ``is_3d``), two 1x1x1 convs (``fc1``, ``fc2``) with ``activation``
    between, a sigmoid gate (upstream layers/accelerator attention.py:16-107)."""

    def __init__(self, num_channels: int, num_channels_reduced: Optional[int] = None,
                 reduction_ratio: float = 2.0, is_3d: bool = True, activation: str = "relu"):
        super().__init__()
        reduced = num_channels_reduced or int(num_channels // reduction_ratio)
        self.fc1 = nn.Conv3d(num_channels, reduced, kernel_size=1)
        self.fc2 = nn.Conv3d(reduced, num_channels, kernel_size=1)
        self.is_3d = is_3d
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (2, 3, 4) if self.is_3d else (2, 3)
        g = F.linear(x.mean(dims), self.fc1.weight.flatten(1), self.fc1.bias)
        g = supported_act_functions[self.activation](g)
        g = F.linear(g, self.fc2.weight.flatten(1), self.fc2.bias)
        return x * torch.sigmoid(g).view(*g.shape, *(1,) * len(dims))


def SqueezeExcitation(num_channels: int, num_channels_reduced: Optional[int] = None,
                      reduction_ratio: float = 2.0, is_3d: bool = True, activation: str = "relu",
                      device: Device = "cuda") -> _EfficientConvBlock:
    with torch.device(device):
        return _EfficientConvBlock(_SE(num_channels, num_channels_reduced, reduction_ratio,
                                       is_3d, activation))


class _AdaptiveAvgPoolOut1(nn.Module):
    """Global average over (T, H, W) to (1, 1, 1) (upstream pool.py:14-41)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(-3, -2, -1), keepdim=True)


def AdaptiveAvgPool3dOutSize1() -> _EfficientConvBlock:
    return _EfficientConvBlock(_AdaptiveAvgPoolOut1())


class _AdaptiveAvgPool2dOut1(nn.Module):
    """Global average over (H, W) (upstream pool.py:45-75)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(-2, -1), keepdim=True)


def AdaptiveAvgPool2dOutSize1() -> _EfficientConvBlock:
    return _EfficientConvBlock(_AdaptiveAvgPool2dOut1())


class _AdaptiveAvgPoolAny(nn.Module):
    """Adaptive average pool to ``output_size`` over the last ``ndim`` axes,
    each of a size the output's divides (upstream pool.py:78-115)."""

    def __init__(self, output_size: Sequence[int], ndim: int = 3):
        super().__init__()
        self.output_size = tuple(output_size)
        self.ndim = ndim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, target in enumerate(self.output_size):
            axis = x.dim() - self.ndim + i
            n = x.shape[axis]
            if n % target:
                raise ValueError(f"adaptive pool needs divisible sizes, got {n} -> {target}")
            x = x.reshape(*x.shape[:axis], target, n // target, *x.shape[axis + 1:]).mean(axis + 1)
        return x


def AdaptiveAvgPool3d(output_size) -> _EfficientConvBlock:
    if isinstance(output_size, int):
        output_size = (output_size,) * 3
    return _EfficientConvBlock(_AdaptiveAvgPoolAny(output_size, ndim=3))


def AdaptiveAvgPool2d(output_size) -> _EfficientConvBlock:
    if isinstance(output_size, int):
        output_size = (output_size,) * 2
    return _EfficientConvBlock(_AdaptiveAvgPoolAny(output_size, ndim=2))


class _Act(nn.Module):
    """An activation as a module (upstream activation_functions.py:31-95)."""

    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return supported_act_functions[self.activation](x)


def Swish() -> _EfficientConvBlock:
    return _EfficientConvBlock(_Act("swish"))


def HardSwish() -> _EfficientConvBlock:
    return _EfficientConvBlock(_Act("hswish"))


def ReLU() -> _EfficientConvBlock:
    return _EfficientConvBlock(_Act("relu"))


def Identity() -> _EfficientConvBlock:
    return _EfficientConvBlock(_Act("identity"))


class _FC(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.fc = nn.Linear(in_features, out_features, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


def FullyConnected(in_features: int, out_features: int, bias: bool = True,
                   device: Device = "cuda") -> _EfficientConvBlock:
    """Linear layer (upstream fully_connected.py:9)."""
    with torch.device(device):
        return _EfficientConvBlock(_FC(in_features, out_features, bias))


class _X3dBottleneck(nn.Module):
    """1x1x1 expand -> depthwise 3x3x3 -> (SE) -> act -> 1x1x1 project, with
    the residual added at stride 1 with equal widths (upstream
    residual_blocks.py:22-200). SE sits between ``norm_b`` and the act."""

    def __init__(self, in_channels: int, out_channels: int, exp_channels: int,
                 use_residual: bool = True, spatial_stride: int = 1, se_ratio: float = 0.0625,
                 act_functions: Tuple[str, str, str] = ("relu", "relu", "relu"),
                 use_bn: Tuple[bool, bool, bool] = (True, True, True)):
        super().__init__()
        self.conv_a = nn.Conv3d(in_channels, exp_channels, 1, bias=not use_bn[0])
        self.norm_a = BatchNorm(exp_channels) if use_bn[0] else None
        self.conv_b = nn.Conv3d(exp_channels, exp_channels, 3,
                                stride=(1, spatial_stride, spatial_stride), padding=1,
                                groups=exp_channels, bias=not use_bn[1])
        self.norm_b = BatchNorm(exp_channels) if use_bn[1] else None
        self.se = (_SE(exp_channels, max(1, int(round(exp_channels * se_ratio))))
                   if se_ratio > 0 else None)
        self.conv_c = nn.Conv3d(exp_channels, out_channels, 1, bias=not use_bn[2])
        self.norm_c = BatchNorm(out_channels) if use_bn[2] else None
        self.act_functions = tuple(act_functions)
        self.residual = use_residual and spatial_stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = [supported_act_functions[a] for a in self.act_functions]
        h = self.conv_a(x)
        if self.norm_a is not None:
            h = self.norm_a(h)
        h = self.conv_b(acts[0](h))
        if self.norm_b is not None:
            h = self.norm_b(h)
        if self.se is not None:
            h = self.se(h)
        h = self.conv_c(acts[1](h))
        if self.norm_c is not None:
            h = self.norm_c(h)
        if self.residual:
            h = h + x
        return acts[2](h)

    def swap_in_kernel(self) -> int:
        """The deploy pass: a stride-1 ``conv_b`` onto the kernel, swish in
        its epilogue where no SE follows."""
        act_a, act_b, act_c = self.act_functions
        fuse_swish = self.se is None and act_b == "swish"
        kernel = None if self.norm_b is not None else _kernel_form(self.conv_b, fuse_swish)
        if kernel is None:
            return 0
        self.conv_b = kernel
        if fuse_swish:
            self.act_functions = (act_a, "identity", act_c)
        return 1


def X3dBottleneckBlock(in_channels: int, mid_channels: int, out_channels: int,
                       use_residual: bool = True, spatial_stride: int = 1,
                       se_ratio: float = 0.0625,
                       act_functions: Tuple[str, str, str] = ("relu", "relu", "relu"),
                       use_bn: Tuple[bool, bool, bool] = (True, True, True),
                       device: Device = "cuda") -> _EfficientConvBlock:
    with torch.device(device):
        return _EfficientConvBlock(_X3dBottleneck(in_channels, out_channels, mid_channels,
                                                  use_residual, spatial_stride, se_ratio,
                                                  tuple(act_functions), tuple(use_bn)))
