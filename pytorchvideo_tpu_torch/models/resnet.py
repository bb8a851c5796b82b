"""ResNet-family blocks and builders: Slow, C2D and I3D backbones, and the
acoustic ResNet over (B, C, T, 1, F) spectrograms.

Counterpart of pytorchvideo_tpu/models/resnet.py (upstream models/resnet.py:
create_bottleneck_block :17-148, create_acoustic_bottleneck_block :151-316,
create_res_block :326-462, create_res_stage :465-594, create_resnet
:601-841, create_acoustic_resnet :1022-1134, ResBlock :1137,
SeparableBottleneckBlock :1192, BottleneckBlock :1288, ResStage :1368).
Modules keep upstream's ``state_dict`` key layout.

Every builder creates its parameters on ``device``: the card ("cuda")
unless the caller asks for the CPU. Without a card, "cuda" raises.
"""

from __future__ import annotations

import operator
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import Conv3d
from pytorchvideo_tpu_torch.layers.norms import BatchNorm, make_act, make_norm
from pytorchvideo_tpu_torch.layers.pooling import AvgPool3d, MaxPool3d
from pytorchvideo_tpu_torch.models.head import create_res_basic_head
from pytorchvideo_tpu_torch.models.net import Net
from pytorchvideo_tpu_torch.models.stem import (
    create_acoustic_res_basic_stem,
    create_res_basic_stem,
)

MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BottleneckBlock(nn.Module):
    """conv_a -> norm_a -> act_a -> conv_b -> norm_b -> act_b -> conv_c -> norm_c.

    Any norm or activation may be None (the deploy form drops folded BNs)."""

    def __init__(
        self,
        *,
        conv_a: nn.Module,
        norm_a: Optional[nn.Module] = None,
        act_a: Optional[Callable] = None,
        conv_b: nn.Module,
        norm_b: Optional[nn.Module] = None,
        act_b: Optional[Callable] = None,
        conv_c: nn.Module,
        norm_c: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.conv_a = conv_a
        self.norm_a = norm_a
        self.act_a = act_a
        self.conv_b = conv_b
        self.norm_b = norm_b
        self.act_b = act_b
        self.conv_c = conv_c
        self.norm_c = norm_c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_a(x)
        if self.norm_a is not None:
            x = self.norm_a(x)
        if self.act_a is not None:
            x = self.act_a(x)
        x = self.conv_b(x)
        if self.norm_b is not None:
            x = self.norm_b(x)
        if self.act_b is not None:
            x = self.act_b(x)
        x = self.conv_c(x)
        if self.norm_c is not None:
            x = self.norm_c(x)
        return x


class SeparableBottleneckBlock(nn.Module):
    """conv_a -> norm_a -> act_a -> parallel branches (conv_b[i] -> norm_b[i]
    -> act_b[i]) reduced by ``reduce_method`` ("sum", or "cat" on the channel
    axis) -> conv_c -> norm_c: the acoustic bottleneck. ``conv_b``,
    ``norm_b`` and ``act_b`` are ``nn.ModuleList``s, one entry per branch;
    a norm or activation entry may be None (the deploy form drops folded
    BNs)."""

    def __init__(
        self,
        *,
        conv_a: nn.Module,
        norm_a: Optional[nn.Module] = None,
        act_a: Optional[Callable] = None,
        conv_b: Sequence[nn.Module],
        norm_b: Sequence[Optional[nn.Module]],
        act_b: Sequence[Optional[Callable]],
        conv_c: nn.Module,
        norm_c: Optional[nn.Module] = None,
        reduce_method: str = "sum",
    ):
        super().__init__()
        if reduce_method not in ("sum", "cat"):
            raise ValueError(f"reduce_method must be 'sum' or 'cat', got {reduce_method!r}")
        if not len(conv_b) == len(norm_b) == len(act_b):
            raise ValueError("conv_b, norm_b and act_b need one entry per branch")
        self.conv_a = conv_a
        self.norm_a = norm_a
        self.act_a = act_a
        self.conv_b = nn.ModuleList(conv_b)
        self.norm_b = nn.ModuleList(norm_b)
        self.act_b = nn.ModuleList(act_b)
        self.conv_c = conv_c
        self.norm_c = norm_c
        self.reduce_method = reduce_method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_a(x)
        if self.norm_a is not None:
            x = self.norm_a(x)
        if self.act_a is not None:
            x = self.act_a(x)
        outputs = []
        for conv, norm, act in zip(self.conv_b, self.norm_b, self.act_b):
            branch = conv(x)
            if norm is not None:
                branch = norm(branch)
            if act is not None:
                branch = act(branch)
            outputs.append(branch)
        if self.reduce_method == "cat":
            x = torch.cat(outputs, dim=1)
        else:
            x = sum(outputs[1:], outputs[0])
        x = self.conv_c(x)
        if self.norm_c is not None:
            x = self.norm_c(x)
        return x


class ResBlock(nn.Module):
    """shortcut (optionally projected) and branch2, fused by
    ``branch_fusion(shortcut, branch2)`` (their sum by default) ->
    activation."""

    def __init__(
        self,
        *,
        branch1_conv: Optional[nn.Module] = None,
        branch1_norm: Optional[nn.Module] = None,
        branch2: nn.Module,
        activation: Optional[Callable] = None,
        branch_fusion: Callable = operator.add,
    ):
        super().__init__()
        self.branch1_conv = branch1_conv
        self.branch1_norm = branch1_norm
        self.branch2 = branch2
        self.activation = activation
        self.branch_fusion = branch_fusion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.branch1_conv is not None:
            shortcut = self.branch1_conv(x)
            if self.branch1_norm is not None:
                shortcut = self.branch1_norm(shortcut)
        x = self.branch_fusion(shortcut, self.branch2(x))
        if self.activation is not None:
            x = self.activation(x)
        return x


class ResStage(nn.Module):
    """A sequence of residual blocks."""

    def __init__(self, *, res_blocks: Sequence[nn.Module]):
        super().__init__()
        self.res_blocks = nn.ModuleList(res_blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.res_blocks:
            x = block(x)
        return x


def stage_depths_of(model_depth: int) -> Tuple[int, ...]:
    if model_depth not in MODEL_STAGE_DEPTH:
        raise ValueError(f"model_depth must be one of {sorted(MODEL_STAGE_DEPTH)}, got {model_depth}")
    return MODEL_STAGE_DEPTH[model_depth]


def create_bottleneck_block(
    *,
    dim_in: int,
    dim_inner: int,
    dim_out: int,
    conv_a_kernel_size: Tuple[int, int, int] = (3, 1, 1),
    conv_a_stride: Tuple[int, int, int] = (2, 1, 1),
    conv_a_padding: Tuple[int, int, int] = (1, 0, 0),
    conv_a: Callable = Conv3d,
    conv_b_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    conv_b_stride: Tuple[int, int, int] = (1, 2, 2),
    conv_b_padding: Tuple[int, int, int] = (0, 1, 1),
    conv_b_num_groups: int = 1,
    conv_b_dilation: Tuple[int, int, int] = (1, 1, 1),
    conv_b: Callable = Conv3d,
    conv_c: Callable = Conv3d,
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> BottleneckBlock:
    """Bottleneck builder (upstream resnet.py:17-148): conv_a (temporal),
    conv_b (spatial, strided, grouped), conv_c (1x1x1), each with its norm."""
    with torch.device(device):
        return BottleneckBlock(
            conv_a=conv_a(
                in_channels=dim_in,
                out_channels=dim_inner,
                kernel_size=conv_a_kernel_size,
                stride=conv_a_stride,
                padding=conv_a_padding,
                bias=False,
            ),
            norm_a=make_norm(norm, dim_inner, norm_eps, norm_momentum),
            act_a=make_act(activation),
            conv_b=conv_b(
                in_channels=dim_inner,
                out_channels=dim_inner,
                kernel_size=conv_b_kernel_size,
                stride=conv_b_stride,
                padding=conv_b_padding,
                bias=False,
                groups=conv_b_num_groups,
                dilation=conv_b_dilation,
            ),
            norm_b=make_norm(norm, dim_inner, norm_eps, norm_momentum),
            act_b=make_act(activation),
            conv_c=conv_c(in_channels=dim_inner, out_channels=dim_out, kernel_size=(1, 1, 1),
                          bias=False),
            norm_c=make_norm(norm, dim_out, norm_eps, norm_momentum),
        )


def create_acoustic_bottleneck_block(
    *,
    dim_in: int,
    dim_inner: int,
    dim_out: int,
    conv_a_kernel_size: Tuple[int, int, int] = (3, 1, 1),
    conv_a_stride: Tuple[int, int, int] = (2, 1, 1),
    conv_a_padding: Tuple[int, int, int] = (1, 0, 0),
    conv_a: Callable = Conv3d,
    conv_b_kernel_size: Tuple[int, int, int] = (1, 1, 1),
    conv_b_stride: Tuple[int, int, int] = (1, 1, 1),
    conv_b_padding: Tuple[int, int, int] = (0, 0, 0),
    conv_b_num_groups: int = 1,
    conv_b_dilation: Tuple[int, int, int] = (1, 1, 1),
    conv_b: Callable = Conv3d,
    conv_c: Callable = Conv3d,
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> SeparableBottleneckBlock:
    """Acoustic bottleneck builder (upstream resnet.py:151-316): conv_b
    splits into a spatial (1, kh, kw) and a temporal (kt, 1, 1) branch at
    conv_b's stride, summed. The branches are in upstream's order, spatial
    first (``ModuleList([conv_b_2, conv_b_1])``): ``conv_b.0`` holds the JAX
    package's ``conv_b_0``, the (1, kh, kw) conv."""
    kt, kh, kw = conv_b_kernel_size
    pt, ph, pw = conv_b_padding
    dt, dh, dw = conv_b_dilation

    def branch(kernel, padding, dilation):
        return conv_b(in_channels=dim_inner, out_channels=dim_inner, kernel_size=kernel,
                      stride=conv_b_stride, padding=padding, bias=False,
                      groups=conv_b_num_groups, dilation=dilation)

    with torch.device(device):
        return SeparableBottleneckBlock(
            conv_a=conv_a(in_channels=dim_in, out_channels=dim_inner,
                          kernel_size=conv_a_kernel_size, stride=conv_a_stride,
                          padding=conv_a_padding, bias=False),
            norm_a=make_norm(norm, dim_inner, norm_eps, norm_momentum),
            act_a=make_act(activation),
            conv_b=[branch((1, kh, kw), (0, ph, pw), (1, dh, dw)),
                    branch((kt, 1, 1), (pt, 0, 0), (dt, 1, 1))],
            norm_b=[make_norm(norm, dim_inner, norm_eps, norm_momentum) for _ in range(2)],
            act_b=[make_act(activation) for _ in range(2)],
            conv_c=conv_c(in_channels=dim_inner, out_channels=dim_out, kernel_size=(1, 1, 1),
                          bias=False),
            norm_c=make_norm(norm, dim_out, norm_eps, norm_momentum),
        )


def create_res_block(
    *,
    dim_in: int,
    dim_inner: int,
    dim_out: int,
    bottleneck: Callable,
    use_shortcut: bool = False,
    branch_fusion: Callable = operator.add,
    conv_a_kernel_size: Tuple[int, int, int] = (3, 1, 1),
    conv_a_stride: Tuple[int, int, int] = (2, 1, 1),
    conv_a_padding: Tuple[int, int, int] = (1, 0, 0),
    conv_a: Callable = Conv3d,
    conv_b_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    conv_b_stride: Tuple[int, int, int] = (1, 2, 2),
    conv_b_padding: Tuple[int, int, int] = (0, 1, 1),
    conv_b_num_groups: int = 1,
    conv_b_dilation: Tuple[int, int, int] = (1, 1, 1),
    conv_b: Callable = Conv3d,
    conv_c: Callable = Conv3d,
    conv_skip: Callable = Conv3d,
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation_bottleneck: Optional[Callable] = nn.ReLU,
    activation_block: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> ResBlock:
    """Residual block builder (upstream resnet.py:326-462): the shortcut is
    projected where the width or the combined stride of conv_a and conv_b
    changes (or ``use_shortcut``); ``branch_fusion(shortcut, branch2)``
    joins the two."""
    branch1_stride = tuple(a * b for a, b in zip(conv_a_stride, conv_b_stride))
    needs_proj = dim_in != dim_out or int(np.prod(branch1_stride)) != 1
    with torch.device(device):
        return ResBlock(
            branch1_conv=(
                conv_skip(in_channels=dim_in, out_channels=dim_out, kernel_size=(1, 1, 1),
                          stride=branch1_stride, bias=False)
                if needs_proj or use_shortcut
                else None
            ),
            branch1_norm=(
                make_norm(norm, dim_out, norm_eps, norm_momentum)
                if use_shortcut or (norm is not None and needs_proj)
                else None
            ),
            branch2=bottleneck(
                dim_in=dim_in,
                dim_inner=dim_inner,
                dim_out=dim_out,
                conv_a_kernel_size=conv_a_kernel_size,
                conv_a_stride=conv_a_stride,
                conv_a_padding=conv_a_padding,
                conv_a=conv_a,
                conv_b_kernel_size=conv_b_kernel_size,
                conv_b_stride=conv_b_stride,
                conv_b_padding=conv_b_padding,
                conv_b_num_groups=conv_b_num_groups,
                conv_b_dilation=conv_b_dilation,
                conv_b=conv_b,
                conv_c=conv_c,
                norm=norm,
                norm_eps=norm_eps,
                norm_momentum=norm_momentum,
                activation=activation_bottleneck,
                device=device,
            ),
            activation=make_act(activation_block),
            branch_fusion=branch_fusion,
        )


def _per_block(sizes, depth: int) -> List:
    """One conv_a kernel size (or padding) per block: a single triple for
    all, or a list cycled through the blocks (I3D's alternating kernels)."""
    if isinstance(sizes[0], int):
        sizes = [sizes]
    return (list(sizes) * depth)[:depth]


def create_res_stage(
    *,
    depth: int,
    dim_in: int,
    dim_inner: int,
    dim_out: int,
    bottleneck: Callable,
    conv_a_kernel_size: Union[Tuple, List] = (3, 1, 1),
    conv_a_stride: Tuple[int, int, int] = (2, 1, 1),
    conv_a_padding: Union[Tuple, List] = (1, 0, 0),
    conv_a: Callable = Conv3d,
    conv_b_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    conv_b_stride: Tuple[int, int, int] = (1, 2, 2),
    conv_b_padding: Tuple[int, int, int] = (0, 1, 1),
    conv_b_num_groups: int = 1,
    conv_b_dilation: Tuple[int, int, int] = (1, 1, 1),
    conv_b: Callable = Conv3d,
    conv_c: Callable = Conv3d,
    conv_skip: Callable = Conv3d,
    norm: Optional[Callable] = BatchNorm,
    norm_eps: float = 1e-5,
    norm_momentum: float = 0.1,
    activation: Optional[Callable] = nn.ReLU,
    device: Union[str, torch.device] = "cuda",
) -> ResStage:
    """Stage builder (upstream resnet.py:465-594): ``depth`` blocks, the
    strides on block 0 only; per-block conv_a kernels cycle through a list
    if one is given."""
    kernels = _per_block(conv_a_kernel_size, depth)
    paddings = _per_block(conv_a_padding, depth)
    return ResStage(
        res_blocks=[
            create_res_block(
                dim_in=dim_in if idx == 0 else dim_out,
                dim_inner=dim_inner,
                dim_out=dim_out,
                bottleneck=bottleneck,
                conv_a_kernel_size=kernels[idx],
                conv_a_stride=conv_a_stride if idx == 0 else (1, 1, 1),
                conv_a_padding=paddings[idx],
                conv_a=conv_a,
                conv_b_kernel_size=conv_b_kernel_size,
                conv_b_stride=conv_b_stride if idx == 0 else (1, 1, 1),
                conv_b_padding=conv_b_padding,
                conv_b_num_groups=conv_b_num_groups,
                conv_b_dilation=conv_b_dilation,
                conv_b=conv_b,
                conv_c=conv_c,
                conv_skip=conv_skip,
                norm=norm,
                norm_eps=norm_eps,
                norm_momentum=norm_momentum,
                activation_bottleneck=activation,
                activation_block=activation,
                device=device,
            )
            for idx in range(depth)
        ]
    )


def half_padding(kernel_size):
    """k // 2 per axis, of one kernel size or of a per-block list of them."""
    if isinstance(kernel_size[0], int):
        return [k // 2 for k in kernel_size]
    return [[k // 2 for k in sizes] for sizes in kernel_size]


def dilated_padding(kernel_size, dilation) -> Tuple[int, int, int]:
    """conv_b's padding: k // 2 along T; along H and W the dilation where it
    exceeds 1 (upstream resnet.py:794-803)."""
    return (
        kernel_size[0] // 2,
        dilation[1] if dilation[1] > 1 else kernel_size[1] // 2,
        dilation[2] if dilation[2] > 1 else kernel_size[2] // 2,
    )


def _per_stage(value, stages: int):
    return (value,) * stages if isinstance(value[0], int) else value


def create_resnet(
    *,
    input_channel: int = 3,
    model_depth: int = 50,
    model_num_class: int = 400,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_dim_out: int = 64,
    stem_conv_kernel_size: Tuple[int, int, int] = (3, 7, 7),
    stem_conv_stride: Tuple[int, int, int] = (1, 2, 2),
    stem_pool: Optional[Callable] = MaxPool3d,
    stem_pool_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    stem_pool_stride: Tuple[int, int, int] = (1, 2, 2),
    stem: Callable = create_res_basic_stem,
    stage1_pool: Optional[Callable] = None,
    stage1_pool_kernel_size: Tuple[int, int, int] = (2, 1, 1),
    stage_conv_a_kernel_size: Union[Tuple, List] = ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1)),
    stage_conv_b_kernel_size: Union[Tuple, List] = ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
    stage_conv_b_num_groups: Tuple[int, ...] = (1, 1, 1, 1),
    stage_conv_b_dilation: Union[Tuple, List] = ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    stage_spatial_h_stride: Tuple[int, ...] = (1, 2, 2, 2),
    stage_spatial_w_stride: Tuple[int, ...] = (1, 2, 2, 2),
    stage_temporal_stride: Tuple[int, ...] = (1, 1, 1, 1),
    bottleneck: Union[Tuple[Callable, ...], Callable] = create_bottleneck_block,
    head: Optional[Callable] = create_res_basic_head,
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_size: Tuple[int, int, int] = (4, 7, 7),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = None,
    head_output_with_global_average: bool = True,
    stage_depths: Optional[Tuple[int, ...]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Net:
    """Slow / C2D / I3D ResNet builder (upstream resnet.py:601-841).
    ``stage_depths`` overrides ``model_depth``'s table, as in the JAX
    package (e.g. (1, 1, 1, 1) for small test models). ``stage1_pool``
    (C2D, I3D) is a pool block after stage 1, with no parameters."""
    if stage_depths is None:
        stage_depths = stage_depths_of(model_depth)
    stages = len(stage_depths)
    stage_conv_a_kernel_size = _per_stage(stage_conv_a_kernel_size, stages)
    stage_conv_b_kernel_size = _per_stage(stage_conv_b_kernel_size, stages)
    stage_conv_b_dilation = _per_stage(stage_conv_b_dilation, stages)
    if callable(bottleneck):
        bottleneck = (bottleneck,) * stages

    blocks = [
        stem(
            in_channels=input_channel,
            out_channels=stem_dim_out,
            conv_kernel_size=stem_conv_kernel_size,
            conv_stride=stem_conv_stride,
            conv_padding=tuple(s // 2 for s in stem_conv_kernel_size),
            pool=stem_pool,
            pool_kernel_size=stem_pool_kernel_size,
            pool_stride=stem_pool_stride,
            pool_padding=tuple(s // 2 for s in stem_pool_kernel_size),
            norm=norm,
            activation=activation,
            device=device,
        )
    ]
    stage_dim_in = stem_dim_out
    stage_dim_out = stage_dim_in * 4
    for idx in range(stages):
        blocks.append(
            create_res_stage(
                depth=stage_depths[idx],
                dim_in=stage_dim_in,
                dim_inner=stage_dim_out // 4,
                dim_out=stage_dim_out,
                bottleneck=bottleneck[idx],
                conv_a_kernel_size=stage_conv_a_kernel_size[idx],
                conv_a_stride=(stage_temporal_stride[idx], 1, 1),
                conv_a_padding=half_padding(stage_conv_a_kernel_size[idx]),
                conv_b_kernel_size=stage_conv_b_kernel_size[idx],
                conv_b_stride=(1, stage_spatial_h_stride[idx], stage_spatial_w_stride[idx]),
                conv_b_padding=dilated_padding(stage_conv_b_kernel_size[idx],
                                               stage_conv_b_dilation[idx]),
                conv_b_num_groups=stage_conv_b_num_groups[idx],
                conv_b_dilation=stage_conv_b_dilation[idx],
                norm=norm,
                activation=activation,
                device=device,
            )
        )
        stage_dim_in = stage_dim_out
        stage_dim_out = stage_dim_out * 2
        if idx == 0 and stage1_pool is not None:
            blocks.append(stage1_pool(kernel_size=stage1_pool_kernel_size,
                                      stride=stage1_pool_kernel_size, padding=(0, 0, 0)))
    if head is not None:
        blocks.append(
            head(
                in_features=stage_dim_in,
                out_features=model_num_class,
                pool=head_pool,
                output_size=head_output_size,
                pool_kernel_size=head_pool_kernel_size,
                dropout_rate=dropout_rate,
                activation=head_activation,
                output_with_global_average=head_output_with_global_average,
                device=device,
            )
        )
    return Net(blocks=blocks)


def create_acoustic_resnet(
    *,
    input_channel: int = 1,
    model_depth: int = 50,
    model_num_class: int = 400,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_dim_out: int = 64,
    stem_conv_kernel_size: Tuple[int, int, int] = (9, 1, 9),
    stem_conv_stride: Tuple[int, int, int] = (1, 1, 3),
    stem_pool: Optional[Callable] = None,
    stem_pool_kernel_size: Tuple[int, int, int] = (3, 1, 3),
    stem_pool_stride: Tuple[int, int, int] = (2, 1, 2),
    stem: Callable = create_acoustic_res_basic_stem,
    stage1_pool: Optional[Callable] = None,
    stage1_pool_kernel_size: Tuple[int, int, int] = (2, 1, 1),
    stage_conv_a_kernel_size: Union[Tuple, List] = (3, 1, 1),
    stage_conv_b_kernel_size: Union[Tuple, List] = (3, 1, 3),
    stage_conv_b_num_groups: Tuple[int, ...] = (1, 1, 1, 1),
    stage_conv_b_dilation: Union[Tuple, List] = (1, 1, 1),
    stage_spatial_h_stride: Tuple[int, ...] = (1, 1, 1, 1),
    stage_spatial_w_stride: Tuple[int, ...] = (1, 2, 2, 2),
    stage_temporal_stride: Tuple[int, ...] = (1, 2, 2, 2),
    bottleneck: Union[Tuple[Callable, ...], Callable] = (
        create_acoustic_bottleneck_block,
        create_acoustic_bottleneck_block,
        create_bottleneck_block,
        create_bottleneck_block,
    ),
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_size: Tuple[int, int, int] = (4, 1, 2),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = None,
    head_output_with_global_average: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Net:
    """Acoustic ResNet builder (upstream resnet.py:1022-1134): ``create_resnet``
    over (B, 1, T, 1, F) log-mel spectrograms, with the acoustic stem (no
    pool), two acoustic stages then two plain ones, and time and frequency
    halved at each stage after the first."""
    return create_resnet(
        input_channel=input_channel,
        model_depth=model_depth,
        model_num_class=model_num_class,
        dropout_rate=dropout_rate,
        norm=norm,
        activation=activation,
        stem_dim_out=stem_dim_out,
        stem_conv_kernel_size=stem_conv_kernel_size,
        stem_conv_stride=stem_conv_stride,
        stem_pool=stem_pool,
        stem_pool_kernel_size=stem_pool_kernel_size,
        stem_pool_stride=stem_pool_stride,
        stem=stem,
        stage1_pool=stage1_pool,
        stage1_pool_kernel_size=stage1_pool_kernel_size,
        stage_conv_a_kernel_size=stage_conv_a_kernel_size,
        stage_conv_b_kernel_size=stage_conv_b_kernel_size,
        stage_conv_b_num_groups=stage_conv_b_num_groups,
        stage_conv_b_dilation=stage_conv_b_dilation,
        stage_spatial_h_stride=stage_spatial_h_stride,
        stage_spatial_w_stride=stage_spatial_w_stride,
        stage_temporal_stride=stage_temporal_stride,
        bottleneck=bottleneck,
        head_pool=head_pool,
        head_pool_kernel_size=head_pool_kernel_size,
        head_output_size=head_output_size,
        head_activation=head_activation,
        head_output_with_global_average=head_output_with_global_average,
        device=device,
    )
