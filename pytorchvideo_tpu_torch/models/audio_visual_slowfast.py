"""Audio-visual SlowFast (Xiao et al., https://arxiv.org/abs/2001.08740).

Counterpart of pytorchvideo_tpu/models/audio_visual_slowfast.py (upstream
models/audio_visual_slowfast.py: create :20-238, AudioToSlowFastFusionBuilder
:240-380, FuseAudioToFastSlow :384-418). Three pathways, a list ``[slow,
fast, audio]``: NCTHW clips and a (B, 1, T, 1, F) log-mel spectrogram (the
JAX package's audio is (B, T, 1, F, C)). At each fusion the frequency axis
of the audio is averaged away and a conv stack brings it to the slow
pathway's frame rate and width, where it is added.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.common import Conv3d
from pytorchvideo_tpu_torch.layers.norms import BatchNorm, make_act, make_norm
from pytorchvideo_tpu_torch.layers.pooling import AvgPool3d, MaxPool3d
from pytorchvideo_tpu_torch.models.net import Net
from pytorchvideo_tpu_torch.models.resnet import (
    create_acoustic_bottleneck_block,
    create_bottleneck_block,
)
from pytorchvideo_tpu_torch.models.slowfast import create_slowfast
from pytorchvideo_tpu_torch.models.stem import (
    create_acoustic_res_basic_stem,
    create_res_basic_stem,
)


class _ConvNormAct(nn.Module):
    """conv -> norm -> activation (either may be None)."""

    def __init__(self, *, conv: nn.Module, norm: Optional[nn.Module] = None,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.conv = conv
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class _Sequential(nn.Module):
    """The audio conv stack: ``stages`` in order."""

    def __init__(self, *, stages: Sequence[nn.Module]):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.stages:
            x = stage(x)
        return x


class FuseAudioToFastSlow(nn.Module):
    """``[slow, fast, audio]`` -> ``[fuse_a + cat(slow, fast->slow), fast,
    audio]``: the fast pathway's conv concatenated onto the slow one, as in
    SlowFast, and the audio averaged over frequency, through its conv stack
    to (B, C, T_slow, 1, 1) and added to the slow pathway by broadcasting."""

    def __init__(self, *, block_fast_to_slow: nn.Module, block_audio_to_fastslow: nn.Module):
        super().__init__()
        self.block_fast_to_slow = block_fast_to_slow
        self.block_audio_to_fastslow = block_audio_to_fastslow

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x_s, x_f, x_a = x[0], x[1], x[2]
        fuse = self.block_fast_to_slow(x_f)
        fuse_a = self.block_audio_to_fastslow(x_a.mean(dim=-1, keepdim=True))
        return [fuse_a + torch.cat([x_s, fuse], dim=1), x_f, x_a]


class AudioToSlowFastFusionBuilder:
    """Per-stage :class:`FuseAudioToFastSlow` factory (upstream :240-380).
    ``conv_stride`` and ``conv_stride_a`` are one stride for every stage, or
    a tuple of them indexed by the stage; stages past ``max_stage_idx`` get
    no fusion."""

    def __init__(
        self,
        slowfast_channel_reduction_ratio: int,
        slowfast_audio_reduction_ratio: int,
        conv_fusion_channel_ratio: float,
        conv_kernel_size: Tuple[int, int, int],
        conv_kernel_size_a: Tuple[int, int, int],
        conv_stride: Union[Tuple, Tuple[Tuple, ...]],
        conv_stride_a: Union[Tuple, Tuple[Tuple, ...]],
        conv_fusion_channel_interm_dim: Union[int, float] = 0.25,
        conv_num_a: int = 2,
        norm: Optional[Callable] = BatchNorm,
        norm_eps: float = 1e-5,
        norm_momentum: float = 0.1,
        activation: Optional[Callable] = nn.ReLU,
        max_stage_idx: int = 3,
        device: Union[str, torch.device] = "cuda",
    ):
        self.slowfast_channel_reduction_ratio = slowfast_channel_reduction_ratio
        self.slowfast_audio_reduction_ratio = slowfast_audio_reduction_ratio
        self.conv_fusion_channel_ratio = conv_fusion_channel_ratio
        self.conv_kernel_size = conv_kernel_size
        self.conv_kernel_size_a = conv_kernel_size_a
        self.conv_stride = conv_stride
        self.conv_stride_a = conv_stride_a
        self.conv_fusion_channel_interm_dim = conv_fusion_channel_interm_dim
        self.conv_num_a = conv_num_a
        self.norm = norm
        self.norm_eps = norm_eps
        self.norm_momentum = norm_momentum
        self.activation = activation
        self.max_stage_idx = max_stage_idx
        self.device = device

    def _conv_norm_act(self, dim_in: int, dim_out: int, kernel_size, stride) -> _ConvNormAct:
        return _ConvNormAct(
            conv=Conv3d(in_channels=dim_in, out_channels=dim_out, kernel_size=kernel_size,
                        stride=stride, padding=tuple(k // 2 for k in kernel_size), bias=False),
            norm=make_norm(self.norm, dim_out, self.norm_eps, self.norm_momentum),
            activation=make_act(self.activation),
        )

    def create_module(self, fusion_dim_in: int, stage_idx: int) -> Optional[FuseAudioToFastSlow]:
        if stage_idx > self.max_stage_idx:
            return None
        conv_stride = (self.conv_stride[stage_idx]
                       if isinstance(self.conv_stride[0], (tuple, list)) else self.conv_stride)
        conv_stride_a = (self.conv_stride_a[stage_idx]
                         if isinstance(self.conv_stride_a[0], (tuple, list))
                         else self.conv_stride_a)
        conv_dim_in = fusion_dim_in // self.slowfast_channel_reduction_ratio
        conv_dim_in_a = fusion_dim_in // self.slowfast_audio_reduction_ratio
        fast_out = int(conv_dim_in * self.conv_fusion_channel_ratio)
        if isinstance(self.conv_fusion_channel_interm_dim, int):
            interm = self.conv_fusion_channel_interm_dim
        else:
            interm = int(conv_dim_in_a * self.conv_fusion_channel_interm_dim)
        with torch.device(self.device):
            stages, dim_in = [], conv_dim_in_a
            for idx in range(self.conv_num_a):
                last = idx == self.conv_num_a - 1
                dim_out = int(fast_out + fusion_dim_in) if last else interm
                stages.append(self._conv_norm_act(dim_in, dim_out, self.conv_kernel_size_a,
                                                  conv_stride_a if last else (1, 1, 1)))
                dim_in = dim_out
            return FuseAudioToFastSlow(
                block_fast_to_slow=self._conv_norm_act(conv_dim_in, fast_out,
                                                       self.conv_kernel_size, conv_stride),
                block_audio_to_fastslow=_Sequential(stages=stages),
            )


def create_audio_visual_slowfast(
    *,
    slowfast_channel_reduction_ratio: Tuple[int, int] = (8, 2),
    slowfast_conv_channel_fusion_ratio: int = 2,
    fusion_builder: Optional[Callable] = None,
    input_channels: Tuple[int, ...] = (3, 3, 1),
    model_depth: int = 50,
    model_num_class: int = 400,
    dropout_rate: float = 0.5,
    norm: Optional[Callable] = BatchNorm,
    activation: Optional[Callable] = nn.ReLU,
    stem_dim_outs: Tuple[int, ...] = (64, 8, 32),
    stem_conv_kernel_sizes: Tuple = ((1, 7, 7), (5, 7, 7), (9, 1, 9)),
    stem_conv_strides: Tuple = ((1, 2, 2), (1, 2, 2), (1, 1, 1)),
    stem_pool: Tuple = (MaxPool3d, MaxPool3d, None),
    stem_pool_kernel_sizes: Tuple = ((1, 3, 3), (1, 3, 3), (1, 3, 3)),
    stem_pool_strides: Tuple = ((1, 2, 2), (1, 2, 2), (1, 1, 1)),
    stage_conv_a_kernel_sizes: Tuple = (
        ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1)),
        ((3, 1, 1), (3, 1, 1), (3, 1, 1), (3, 1, 1)),
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    ),
    stage_conv_b_kernel_sizes: Tuple = (
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
        ((1, 3, 3), (1, 3, 3), (1, 3, 3), (1, 3, 3)),
        ((3, 1, 3), (3, 1, 3), (3, 1, 3), (3, 1, 3)),
    ),
    stage_conv_b_num_groups: Tuple = ((1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 1)),
    stage_conv_b_dilations: Tuple = (
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        ((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    ),
    stage_spatial_strides: Tuple = ((1, 2, 2, 2), (1, 2, 2, 2), (1, 2, 2, 2)),
    stage_temporal_strides: Tuple = ((1, 1, 1, 1), (1, 1, 1, 1), (1, 2, 2, 2)),
    bottleneck: Tuple = (
        (create_bottleneck_block,) * 4,
        (create_bottleneck_block,) * 4,
        (
            create_acoustic_bottleneck_block,
            create_acoustic_bottleneck_block,
            create_bottleneck_block,
            create_bottleneck_block,
        ),
    ),
    head_pool: Optional[Callable] = AvgPool3d,
    head_pool_kernel_sizes: Tuple = ((8, 7, 7), (32, 7, 7), (16, 1, 10)),
    head_output_size: Tuple[int, int, int] = (1, 1, 1),
    head_activation: Optional[Callable] = None,
    head_output_with_global_average: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Net:
    """Audio-visual SlowFast builder (upstream :20-238), with its parameters
    on ``device``: ``create_slowfast`` over three pathways, the acoustic
    stem and bottlenecks on the audio one and an
    :class:`AudioToSlowFastFusionBuilder` fusion. The defaults take slow 8 x
    224², fast 32 x 224² and 128 x 80 spectrograms (the head's pools)."""
    if fusion_builder is None:
        fusion_builder = AudioToSlowFastFusionBuilder(
            slowfast_channel_reduction_ratio=slowfast_channel_reduction_ratio[0],
            slowfast_audio_reduction_ratio=slowfast_channel_reduction_ratio[1],
            conv_fusion_channel_ratio=slowfast_conv_channel_fusion_ratio,
            conv_kernel_size=(7, 1, 1),
            conv_kernel_size_a=(5, 1, 1),
            conv_stride=(4, 1, 1),
            conv_stride_a=((16, 1, 1), (16, 1, 1), (8, 1, 1), (4, 1, 1), (2, 1, 1)),
            norm=norm,
            activation=activation,
            device=device,
        ).create_module
    return create_slowfast(
        slowfast_channel_reduction_ratio=slowfast_channel_reduction_ratio,
        slowfast_conv_channel_fusion_ratio=slowfast_conv_channel_fusion_ratio,
        fusion_builder=fusion_builder,
        input_channels=input_channels,
        model_depth=model_depth,
        model_num_class=model_num_class,
        dropout_rate=dropout_rate,
        norm=norm,
        activation=activation,
        stem_function=(create_res_basic_stem, create_res_basic_stem,
                       create_acoustic_res_basic_stem),
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
        head_pool=head_pool,
        head_pool_kernel_sizes=head_pool_kernel_sizes,
        head_output_size=head_output_size,
        head_activation=head_activation,
        head_output_with_global_average=head_output_with_global_average,
        device=device,
    )
