"""Detection heads and the AVA detectors (counterpart of
pytorchvideo_tpu/models/detection.py; upstream models/head.py
create_res_roi_pooling_head :203-327, ResNetRoIHead :394-483,
models/resnet.py create_resnet_with_roi_head :844-1019, models/slowfast.py
create_slowfast_with_roi_head :364-582).

The backbones are the port's ``create_resnet`` and ``create_slowfast``
without their head; the RoI head pools the keyframe features of each box
with :func:`~pytorchvideo_tpu_torch.ops.roi_align.roi_align` (plain
PyTorch, as the JAX package keeps it in XLA). Its output is NCTHW, upstream's
layout: (N, classes, 1, 1, 1) per box, or (N, classes) with the global
average; the JAX head gives the channels-last (N, 1, 1, 1, classes).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import adaptive_avg_pool3d_to_1
from pytorchvideo_tpu_torch.layers.norms import BatchNorm
from pytorchvideo_tpu_torch.layers.pooling import AdaptiveAvgPool3d, AvgPool3d, MaxPool3d
from pytorchvideo_tpu_torch.layers.stochastic import Dropout
from pytorchvideo_tpu_torch.models.head import make_head_act
from pytorchvideo_tpu_torch.models.net import DetectionBBoxNetwork
from pytorchvideo_tpu_torch.models.resnet import (
    create_bottleneck_block,
    create_resnet,
    stage_depths_of,
)
from pytorchvideo_tpu_torch.models.slowfast import create_slowfast
from pytorchvideo_tpu_torch.models.stem import create_res_basic_stem
from pytorchvideo_tpu_torch.ops.roi_align import RoIAlign


class ResNetRoIHead(nn.Module):
    """pool over T -> squeeze T (which must then be 1) -> RoIAlign per box ->
    spatial max pool -> dropout -> proj over channels -> activation ->
    optional global average (upstream head.py:394-483). Takes the
    backbone's NCTHW features and (N, 5) boxes; ``proj`` is a ``Linear`` on
    the channels-last view, as in :class:`ResNetBasicHead`."""

    def __init__(
        self,
        *,
        proj: nn.Linear,
        pool: Optional[nn.Module] = None,
        pool_spatial: Optional[nn.Module] = None,
        roi_layer: Optional[nn.Module] = None,
        dropout_rate: float = 0.0,
        activation: Optional[Callable] = None,
        output_with_global_average: bool = False,
    ):
        super().__init__()
        self.pool = pool
        self.pool_spatial = pool_spatial
        self.roi_layer = roi_layer
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None
        self.proj = proj
        self.activation = activation
        self.output_with_global_average = output_with_global_average

    def forward(self, x: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
        if self.pool is not None:
            x = self.pool(x)
        if self.roi_layer is not None:
            if x.shape[2] != 1:
                raise ValueError(f"the temporal dimension must be 1 at the RoI layer, got "
                                 f"{x.shape[2]}: change the pool layer")
            x = self.roi_layer(x.squeeze(2), bboxes)
            if self.pool_spatial is not None:
                x = self.pool_spatial(x)
            x = x.unsqueeze(2)
        if self.dropout is not None:
            x = self.dropout(x)
        x = self.proj(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        if self.activation is not None:
            x = self.activation(x)
        if self.output_with_global_average:
            x = adaptive_avg_pool3d_to_1(x).flatten(1)
        return x


def create_res_roi_pooling_head(
    *,
    in_features: int,
    out_features: int,
    resolution: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    roi: Callable = RoIAlign,
    pool: Optional[Callable] = AvgPool3d,
    output_size: Tuple[int, int, int] = (1, 1, 1),
    pool_kernel_size: Tuple[int, int, int] = (1, 7, 7),
    pool_stride: Tuple[int, int, int] = (1, 1, 1),
    pool_padding: Tuple[int, int, int] = (0, 0, 0),
    pool_spatial: Optional[str] = "max",
    dropout_rate: float = 0.5,
    activation: Optional[Callable] = None,
    output_with_global_average: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> ResNetRoIHead:
    """RoI head builder (upstream head.py:203-327), with ``proj`` on
    ``device``. ``activation`` is ``nn.Softmax`` (over the class axis),
    ``nn.Sigmoid`` or any other :func:`make_act` takes; ``pool_spatial``
    None drops the spatial max pool."""
    if pool is None:
        pool_model = None
    elif pool is AdaptiveAvgPool3d:
        pool_model = pool(output_size)
    else:
        pool_model = pool(kernel_size=pool_kernel_size, stride=pool_stride, padding=pool_padding)
    return ResNetRoIHead(
        proj=nn.Linear(in_features, out_features, device=device),
        pool=pool_model,
        pool_spatial=nn.MaxPool2d(resolution, stride=1) if pool_spatial is not None else None,
        roi_layer=roi(output_size=resolution, spatial_scale=spatial_scale,
                      sampling_ratio=sampling_ratio),
        dropout_rate=dropout_rate,
        activation=make_head_act(activation),
        output_with_global_average=output_with_global_average,
    )


def create_resnet_with_roi_head(
    *,
    input_channel: int = 3,
    model_depth: int = 50,
    model_num_class: int = 80,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_dim_out: int = 64,
    stem_conv_kernel_size: Tuple[int, int, int] = (1, 7, 7),
    stem_conv_stride: Tuple[int, int, int] = (1, 2, 2),
    stem_pool: Optional[Callable] = MaxPool3d,
    stem_pool_kernel_size: Tuple[int, int, int] = (1, 3, 3),
    stem_pool_stride: Tuple[int, int, int] = (1, 2, 2),
    stem: Callable = create_res_basic_stem,
    stage1_pool: Optional[Callable] = None,
    stage_conv_a_kernel_size=((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1)),
    stage_conv_b_kernel_size=((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
    stage_conv_b_num_groups=(1, 1, 1, 1),
    stage_conv_b_dilation=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 2, 2)),
    stage_spatial_h_stride=(1, 2, 2, 1),
    stage_spatial_w_stride=(1, 2, 2, 1),
    stage_temporal_stride=(1, 1, 1, 1),
    bottleneck: Union[Tuple[Callable, ...], Callable] = create_bottleneck_block,
    head: Callable = create_res_roi_pooling_head,
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_size: Tuple[int, int, int] = (4, 1, 1),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = nn.Sigmoid,
    head_output_with_global_average: bool = False,
    head_spatial_resolution: Tuple[int, int] = (7, 7),
    head_spatial_scale: float = 1.0 / 16.0,
    head_sampling_ratio: int = 0,
    stage_depths: Optional[Tuple[int, ...]] = None,
    device: Union[str, torch.device] = "cuda",
) -> DetectionBBoxNetwork:
    """Slow-R50 AVA detector (upstream resnet.py:844-1019): a ResNet whose
    last stage is dilated at stride 1 (features at 1/16 of the input), and a
    RoI head over the keyframe features. Takes NCTHW clips (4x256x256 for
    ``slow_r50_detection``) and (N, 5) boxes."""
    model = create_resnet(
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
        stage_conv_a_kernel_size=stage_conv_a_kernel_size,
        stage_conv_b_kernel_size=stage_conv_b_kernel_size,
        stage_conv_b_num_groups=stage_conv_b_num_groups,
        stage_conv_b_dilation=stage_conv_b_dilation,
        stage_spatial_h_stride=stage_spatial_h_stride,
        stage_spatial_w_stride=stage_spatial_w_stride,
        stage_temporal_stride=stage_temporal_stride,
        bottleneck=bottleneck,
        head=None,
        stage_depths=stage_depths,
        device=device,
    )
    n_stages = len(stage_depths or stage_depths_of(model_depth))
    detection_head = head(
        in_features=stem_dim_out * 2 ** (n_stages + 1),
        out_features=model_num_class,
        pool=head_pool,
        output_size=head_output_size,
        pool_kernel_size=head_pool_kernel_size,
        dropout_rate=dropout_rate,
        activation=head_activation,
        output_with_global_average=head_output_with_global_average,
        resolution=head_spatial_resolution,
        spatial_scale=head_spatial_scale,
        sampling_ratio=head_sampling_ratio,
        device=device,
    )
    return DetectionBBoxNetwork(model=model, detection_head=detection_head)


def create_slowfast_with_roi_head(
    *,
    slowfast_channel_reduction_ratio: Union[Tuple[int, ...], int] = (8,),
    slowfast_conv_channel_fusion_ratio: int = 2,
    slowfast_fusion_conv_kernel_size: Tuple[int, int, int] = (7, 1, 1),
    slowfast_fusion_conv_stride: Tuple[int, int, int] = (4, 1, 1),
    fusion_builder: Optional[Callable] = None,
    input_channels: Tuple[int, ...] = (3, 3),
    model_depth: int = 50,
    model_num_class: int = 80,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_function: Tuple[Callable, ...] = (create_res_basic_stem, create_res_basic_stem),
    stem_dim_outs: Tuple[int, ...] = (64, 8),
    stem_conv_kernel_sizes=((1, 7, 7), (5, 7, 7)),
    stem_conv_strides=((1, 2, 2), (1, 2, 2)),
    stem_pool: Union[Callable, Tuple] = (MaxPool3d, MaxPool3d),
    stem_pool_kernel_sizes=((1, 3, 3), (1, 3, 3)),
    stem_pool_strides=((1, 2, 2), (1, 2, 2)),
    stage_conv_a_kernel_sizes=(
        ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1)),
        ((3, 1, 1), (3, 1, 1), (3, 1, 1), (3, 1, 1)),
    ),
    stage_conv_b_kernel_sizes=(
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
    ),
    stage_conv_b_num_groups=((1, 1, 1, 1), (1, 1, 1, 1)),
    stage_conv_b_dilations=(
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 2, 2)),
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 2, 2)),
    ),
    stage_spatial_strides=((1, 2, 2, 1), (1, 2, 2, 1)),
    stage_temporal_strides=((1, 1, 1, 1), (1, 1, 1, 1)),
    bottleneck: Union[Callable, Tuple] = create_bottleneck_block,
    head: Callable = create_res_roi_pooling_head,
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_sizes=((8, 1, 1), (32, 1, 1)),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = nn.Sigmoid,
    head_output_with_global_average: bool = False,
    head_spatial_resolution: Tuple[int, int] = (7, 7),
    head_spatial_scale: float = 1.0 / 16.0,
    head_sampling_ratio: int = 0,
    stage_depths: Optional[Tuple[int, ...]] = None,
    device: Union[str, torch.device] = "cuda",
) -> DetectionBBoxNetwork:
    """SlowFast AVA detector (upstream slowfast.py:364-582): the pathways
    pooled over T and concatenated by the backbone, then the RoI head (no
    pool of its own). Takes ``[slow, fast]`` NCTHW clips ([8, 32] x 256 x 256
    for ``slowfast_r50_detection``) and (N, 5) boxes."""
    model = create_slowfast(
        slowfast_channel_reduction_ratio=slowfast_channel_reduction_ratio,
        slowfast_conv_channel_fusion_ratio=slowfast_conv_channel_fusion_ratio,
        slowfast_fusion_conv_kernel_size=slowfast_fusion_conv_kernel_size,
        slowfast_fusion_conv_stride=slowfast_fusion_conv_stride,
        fusion_builder=fusion_builder,
        input_channels=input_channels,
        model_depth=model_depth,
        model_num_class=model_num_class,
        dropout_rate=dropout_rate,
        norm=norm,
        activation=activation,
        stem_function=stem_function,
        stem_dim_outs=stem_dim_outs,
        stem_conv_kernel_sizes=stem_conv_kernel_sizes,
        stem_conv_strides=stem_conv_strides,
        stem_pool=stem_pool,
        stem_pool_kernel_sizes=stem_pool_kernel_sizes,
        stem_pool_strides=stem_pool_strides,
        stage_conv_a_kernel_sizes=stage_conv_a_kernel_sizes,
        stage_conv_b_kernel_sizes=stage_conv_b_kernel_sizes,
        stage_conv_b_num_groups=stage_conv_b_num_groups,
        stage_conv_b_dilations=stage_conv_b_dilations,
        stage_spatial_strides=stage_spatial_strides,
        stage_temporal_strides=stage_temporal_strides,
        bottleneck=bottleneck,
        head=None,
        head_pool=head_pool,
        head_pool_kernel_sizes=head_pool_kernel_sizes,
        stage_depths=stage_depths,
        device=device,
    )
    stage_dim_out = stem_dim_outs[0] * 2 ** (len(stage_depths or stage_depths_of(model_depth)) + 1)
    slow_fast_beta = stem_dim_outs[0] // stem_dim_outs[1]
    detection_head = head(
        in_features=stage_dim_out + stage_dim_out // slow_fast_beta,
        out_features=model_num_class,
        pool=None,
        output_size=head_output_size,
        dropout_rate=dropout_rate,
        activation=head_activation,
        output_with_global_average=head_output_with_global_average,
        resolution=head_spatial_resolution,
        spatial_scale=head_spatial_scale,
        sampling_ratio=head_sampling_ratio,
        device=device,
    )
    return DetectionBBoxNetwork(model=model, detection_head=detection_head)
