"""SlowFast networks (Feichtenhofer et al., 2019).

Counterpart of pytorchvideo_tpu/models/slowfast.py (upstream
models/slowfast.py: create_slowfast :20-363, PoolConcatPathway :586-620,
FastToSlowFusionBuilder :623-696, FuseFastToSlow :699-729). The model takes
a list ``[slow, fast]`` of NCTHW clips (audio-visual SlowFast, built on
:func:`create_slowfast` by models/audio_visual_slowfast.py, a third, the
spectrogram); the fusions concatenate on the channel axis, dim 1. The JAX
package's packed-channel pathways
(``pathway_packs``, ``packed_stages``) are a TPU layout rewrite with the
same parameters and are not ported: every port build is the plain one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import Conv3d
from pytorchvideo_tpu_torch.layers.norms import BatchNorm, make_act, make_norm
from pytorchvideo_tpu_torch.layers.pooling import AdaptiveAvgPool3d, AvgPool3d, MaxPool3d
from pytorchvideo_tpu_torch.models.head import create_res_basic_head
from pytorchvideo_tpu_torch.models.net import MultiPathWayWithFuse, Net
from pytorchvideo_tpu_torch.models.resnet import (
    create_bottleneck_block,
    create_res_stage,
    dilated_padding,
    half_padding,
    stage_depths_of,
)
from pytorchvideo_tpu_torch.models.stem import create_res_basic_stem


class FuseFastToSlow(nn.Module):
    """conv(fast) -> norm -> act, concatenated onto slow; returns
    ``[slow', fast]``."""

    def __init__(
        self,
        *,
        conv_fast_to_slow: nn.Module,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
    ):
        super().__init__()
        self.conv_fast_to_slow = conv_fast_to_slow
        self.norm = norm
        self.activation = activation

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x_s, x_f = x[0], x[1]
        fuse = self.conv_fast_to_slow(x_f)
        if self.norm is not None:
            fuse = self.norm(fuse)
        if self.activation is not None:
            fuse = self.activation(fuse)
        return [torch.cat([x_s, fuse], dim=1), x_f]


class FastToSlowFusionBuilder:
    """Per-stage :class:`FuseFastToSlow` factory (upstream slowfast.py:623-696)."""

    def __init__(
        self,
        slowfast_channel_reduction_ratio: int,
        conv_fusion_channel_ratio: float,
        conv_kernel_size: Tuple[int, int, int],
        conv_stride: Tuple[int, int, int],
        norm: Optional[Callable] = BatchNorm,
        norm_eps: float = 1e-5,
        norm_momentum: float = 0.1,
        activation: Optional[Callable] = nn.ReLU,
        max_stage_idx: int = 3,
        device: Union[str, torch.device] = "cuda",
    ):
        self.slowfast_channel_reduction_ratio = slowfast_channel_reduction_ratio
        self.conv_fusion_channel_ratio = conv_fusion_channel_ratio
        self.conv_kernel_size = conv_kernel_size
        self.conv_stride = conv_stride
        self.norm = norm
        self.norm_eps = norm_eps
        self.norm_momentum = norm_momentum
        self.activation = activation
        self.max_stage_idx = max_stage_idx
        self.device = device

    def create_module(self, fusion_dim_in: int, stage_idx: int) -> Optional[FuseFastToSlow]:
        if stage_idx > self.max_stage_idx:
            return None
        conv_dim_in = fusion_dim_in // self.slowfast_channel_reduction_ratio
        conv_dim_out = int(conv_dim_in * self.conv_fusion_channel_ratio)
        with torch.device(self.device):
            return FuseFastToSlow(
                conv_fast_to_slow=Conv3d(
                    in_channels=conv_dim_in,
                    out_channels=conv_dim_out,
                    kernel_size=self.conv_kernel_size,
                    stride=self.conv_stride,
                    padding=tuple(k // 2 for k in self.conv_kernel_size),
                    bias=False,
                ),
                norm=make_norm(self.norm, conv_dim_out, self.norm_eps, self.norm_momentum),
                activation=make_act(self.activation),
            )


class PoolConcatPathway(nn.Module):
    """An optional pool per pathway, then the pathways concatenated on the
    channel axis (a list of one if ``retain_list``)."""

    def __init__(self, *, retain_list: bool = False, pool: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        self.retain_list = retain_list
        self.pool = None if pool is None else nn.ModuleList(pool)

    def forward(self, x: List[torch.Tensor]):
        if self.pool is not None:
            if len(x) != len(self.pool):
                raise ValueError(f"{len(x)} pathways for {len(self.pool)} pools")
            x = [pool(pathway) for pool, pathway in zip(self.pool, x)]
        out = torch.cat(x, dim=1)
        return [out] if self.retain_list else out


def create_slowfast(
    *,
    slowfast_channel_reduction_ratio: Union[Tuple[int, ...], int] = (8,),
    slowfast_conv_channel_fusion_ratio: int = 2,
    slowfast_fusion_conv_kernel_size: Tuple[int, int, int] = (7, 1, 1),
    slowfast_fusion_conv_stride: Tuple[int, int, int] = (4, 1, 1),
    fusion_builder: Optional[Callable] = None,
    input_channels: Tuple[int, ...] = (3, 3),
    model_depth: int = 50,
    model_num_class: int = 400,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_function: Tuple[Callable, ...] = (create_res_basic_stem, create_res_basic_stem),
    stem_dim_outs: Tuple[int, ...] = (64, 8),
    stem_conv_kernel_sizes: Tuple = ((1, 7, 7), (5, 7, 7)),
    stem_conv_strides: Tuple = ((1, 2, 2), (1, 2, 2)),
    stem_pool: Union[Callable, Tuple] = (MaxPool3d, MaxPool3d),
    stem_pool_kernel_sizes: Tuple = ((1, 3, 3), (1, 3, 3)),
    stem_pool_strides: Tuple = ((1, 2, 2), (1, 2, 2)),
    stage_conv_a_kernel_sizes: Tuple = (
        ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1)),
        ((3, 1, 1), (3, 1, 1), (3, 1, 1), (3, 1, 1)),
    ),
    stage_conv_b_kernel_sizes: Tuple = (
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
    ),
    stage_conv_b_num_groups: Tuple = ((1, 1, 1, 1), (1, 1, 1, 1)),
    stage_conv_b_dilations: Tuple = (
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    ),
    stage_spatial_strides: Tuple = ((1, 2, 2, 2), (1, 2, 2, 2)),
    stage_temporal_strides: Tuple = ((1, 1, 1, 1), (1, 1, 1, 1)),
    bottleneck: Union[Callable, Tuple] = create_bottleneck_block,
    head: Optional[Callable] = create_res_basic_head,
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_sizes: Tuple = ((8, 7, 7), (32, 7, 7)),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = None,
    head_output_with_global_average: bool = True,
    stage_depths: Optional[Tuple[int, ...]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Net:
    """SlowFast builder (upstream slowfast.py:20-363). ``stage_depths``
    overrides ``model_depth``'s table, as in the JAX package. Takes
    ``[slow, fast]`` NCTHW clips (default 8 and 32 frames at 224x224)."""
    num_pathways = len(input_channels)
    if stage_depths is None:
        stage_depths = stage_depths_of(model_depth)
    if isinstance(slowfast_channel_reduction_ratio, int):
        slowfast_channel_reduction_ratio = (slowfast_channel_reduction_ratio,)
    if callable(stem_pool):
        stem_pool = (stem_pool,) * num_pathways
    if callable(bottleneck):
        bottleneck = ((bottleneck,) * len(stage_depths),) * num_pathways
    if fusion_builder is None:
        fusion_builder = FastToSlowFusionBuilder(
            slowfast_channel_reduction_ratio=slowfast_channel_reduction_ratio[0],
            conv_fusion_channel_ratio=slowfast_conv_channel_fusion_ratio,
            conv_kernel_size=slowfast_fusion_conv_kernel_size,
            conv_stride=slowfast_fusion_conv_stride,
            norm=norm,
            activation=activation,
            max_stage_idx=len(stage_depths) - 1,
            device=device,
        ).create_module

    stems = [
        stem_function[p](
            in_channels=input_channels[p],
            out_channels=stem_dim_outs[p],
            conv_kernel_size=stem_conv_kernel_sizes[p],
            conv_stride=stem_conv_strides[p],
            conv_padding=tuple(s // 2 for s in stem_conv_kernel_sizes[p]),
            pool=stem_pool[p],
            pool_kernel_size=stem_pool_kernel_sizes[p],
            pool_stride=stem_pool_strides[p],
            pool_padding=tuple(s // 2 for s in stem_pool_kernel_sizes[p]),
            norm=norm,
            activation=activation,
            device=device,
        )
        for p in range(num_pathways)
    ]
    stages = [MultiPathWayWithFuse(
        multipathway_blocks=stems,
        multipathway_fusion=fusion_builder(fusion_dim_in=stem_dim_outs[0], stage_idx=0),
    )]

    stage_dim_in = stem_dim_outs[0]
    stage_dim_out = stage_dim_in * 4
    for idx in range(len(stage_depths)):
        pathway_dim_in = [stage_dim_in + stage_dim_in * slowfast_conv_channel_fusion_ratio
                          // slowfast_channel_reduction_ratio[0]]
        pathway_dim_inner = [stage_dim_out // 4]
        pathway_dim_out = [stage_dim_out]
        for rr in slowfast_channel_reduction_ratio:
            pathway_dim_in.append(stage_dim_in // rr)
            pathway_dim_inner.append(stage_dim_out // 4 // rr)
            pathway_dim_out.append(stage_dim_out // rr)
        stage = []
        for p in range(num_pathways):
            conv_a_kernel = stage_conv_a_kernel_sizes[p][idx]
            conv_b_kernel = stage_conv_b_kernel_sizes[p][idx]
            stage.append(
                create_res_stage(
                    depth=stage_depths[idx],
                    dim_in=pathway_dim_in[p],
                    dim_inner=pathway_dim_inner[p],
                    dim_out=pathway_dim_out[p],
                    bottleneck=bottleneck[p][idx],
                    conv_a_kernel_size=conv_a_kernel,
                    conv_a_stride=(stage_temporal_strides[p][idx], 1, 1),
                    conv_a_padding=half_padding(conv_a_kernel),
                    conv_b_kernel_size=conv_b_kernel,
                    conv_b_stride=(1, stage_spatial_strides[p][idx],
                                   stage_spatial_strides[p][idx]),
                    conv_b_padding=dilated_padding(conv_b_kernel,
                                                   stage_conv_b_dilations[p][idx]),
                    conv_b_num_groups=stage_conv_b_num_groups[p][idx],
                    conv_b_dilation=stage_conv_b_dilations[p][idx],
                    norm=norm,
                    activation=activation,
                    device=device,
                )
            )
        stages.append(MultiPathWayWithFuse(
            multipathway_blocks=stage,
            multipathway_fusion=fusion_builder(fusion_dim_in=stage_dim_out, stage_idx=idx + 1),
        ))
        stage_dim_in = stage_dim_out
        stage_dim_out = stage_dim_out * 2

    if head_pool is None:
        pool_model = None
    elif head_pool is AdaptiveAvgPool3d:
        pool_model = [head_pool(head_output_size) for _ in range(num_pathways)]
    elif head_pool is AvgPool3d:
        pool_model = [head_pool(kernel_size=head_pool_kernel_sizes[p], stride=(1, 1, 1),
                                padding=(0, 0, 0)) for p in range(num_pathways)]
    else:
        raise NotImplementedError(f"unsupported head_pool {head_pool}")
    stages.append(PoolConcatPathway(retain_list=False, pool=pool_model))
    head_in_features = stage_dim_in + sum(stage_dim_in // rr
                                          for rr in slowfast_channel_reduction_ratio)
    if head is not None:
        stages.append(
            head(
                in_features=head_in_features,
                out_features=model_num_class,
                pool=None,
                output_size=head_output_size,
                dropout_rate=dropout_rate,
                activation=head_activation,
                output_with_global_average=head_output_with_global_average,
                device=device,
            )
        )
    return Net(blocks=stages)
