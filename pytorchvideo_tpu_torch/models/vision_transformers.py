"""Multiscale Vision Transformers (MViT).

Counterpart of pytorchvideo_tpu/models/vision_transformers.py (upstream
models/vision_transformers.py: MultiscaleVisionTransformers :18-182,
create_multiscale_vision_transformers :185-506). Takes NCTHW clips; modules
keep upstream's ``state_dict`` keys, so a port ``state_dict`` maps onto the
JAX tree through pytorchvideo_tpu/zoo/import_torch.py with
``MVIT_RENAME_RULES``. ``norm="batchnorm"`` builds the BatchNorm
variant (JAX vision_transformers.py:119-128): no final norm,
``TokenBatchNorm`` in the blocks and before the conv pools
(layers/attention.py); accelerate/fuse.py ``fuse_bn_mvit`` folds its norms
for serving.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.attention import MultiScaleBlock
from pytorchvideo_tpu_torch.layers.norms import LayerNorm, TokenBatchNorm
from pytorchvideo_tpu_torch.layers.positional_encoding import SpatioTemporalClsPositionalEncoding
from pytorchvideo_tpu_torch.layers.utils import round_width
from pytorchvideo_tpu_torch.models.head import create_vit_basic_head
from pytorchvideo_tpu_torch.models.stem import create_conv_patch_embed


class MultiscaleVisionTransformers(nn.Module):
    """patch_embed -> cls/pos encoding -> blocks (thw threaded) -> norm -> head.

    The cls token is split from the grid once after the positional encoding
    and joined back once before the final norm, as the JAX package does
    (vision_transformers.py:48-63): the blocks take and return the
    (cls, grid) pair."""

    def __init__(
        self,
        *,
        patch_embed: Optional[nn.Module],
        cls_positional_encoding: SpatioTemporalClsPositionalEncoding,
        blocks: Sequence[nn.Module],
        norm_embed: Optional[nn.Module] = None,
        head: Optional[nn.Module] = None,
        pos_dropout_rate: float = 0.0,
        patch_embed_shape: Tuple[int, int, int] = (1, 1, 1),
    ):
        super().__init__()
        self.patch_embed = patch_embed
        self.cls_positional_encoding = cls_positional_encoding
        self.pos_drop = nn.Dropout(pos_dropout_rate) if pos_dropout_rate > 0.0 else None
        self.blocks = nn.ModuleList(blocks)
        self.norm_embed = norm_embed
        self.head = head
        self.patch_embed_shape = tuple(patch_embed_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.patch_embed is not None:
            x = self.patch_embed(x)
        x = self.cls_positional_encoding(x)
        if self.pos_drop is not None:
            x = self.pos_drop(x)
        pair = (x[:, :1], x[:, 1:]) if self.cls_positional_encoding.has_cls else (None, x)
        thw = self.patch_embed_shape
        for block in self.blocks:
            pair, thw = block(pair, thw)
        cls_x, grid_x = pair
        x = grid_x if cls_x is None else torch.cat([cls_x, grid_x], dim=1)
        if self.norm_embed is not None:
            x = self.norm_embed(x)
        if self.head is not None:
            x = self.head(x)
        return x


def create_multiscale_vision_transformers(
    *,
    spatial_size: Union[int, Tuple[int, int]],
    temporal_size: int,
    cls_embed_on: bool = True,
    sep_pos_embed: bool = True,
    depth: int = 16,
    norm: str = "layernorm",
    enable_patch_embed: bool = True,
    input_channels: int = 3,
    patch_embed_dim: int = 96,
    conv_patch_embed_kernel: Tuple[int, int, int] = (3, 7, 7),
    conv_patch_embed_stride: Tuple[int, int, int] = (2, 4, 4),
    conv_patch_embed_padding: Tuple[int, int, int] = (1, 3, 3),
    enable_patch_embed_norm: bool = False,
    use_2d_patch: bool = False,
    num_heads: int = 1,
    mlp_ratio: float = 4.0,
    qkv_bias: bool = True,
    dropout_rate_block: float = 0.0,
    droppath_rate_block: float = 0.0,
    pooling_mode: str = "conv",
    pool_first: bool = False,
    residual_pool: bool = False,
    depthwise_conv: bool = True,
    bias_on: bool = True,
    separate_qkv: bool = True,
    embed_dim_mul: Optional[List[List[int]]] = None,
    atten_head_mul: Optional[List[List[int]]] = None,
    dim_mul_in_att: bool = False,
    pool_q_stride_size: Optional[List[List[int]]] = None,
    pool_kv_stride_size: Optional[List[List[int]]] = None,
    pool_kv_stride_adaptive: Optional[Tuple[int, int, int]] = None,
    pool_kvq_kernel: Optional[Tuple[int, int, int]] = None,
    head: Optional[Callable] = create_vit_basic_head,
    head_dropout_rate: float = 0.5,
    head_activation: Optional[Callable] = None,
    head_num_classes: int = 400,
    fused_kvpool: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> MultiscaleVisionTransformers:
    """MViT builder (upstream vision_transformers.py:185-506), with the
    parameters created on ``device`` (the card unless the caller asks for
    the CPU). MViT-B's configuration is in models/hub/vision_transformers.py.
    Takes NCTHW clips of ``temporal_size`` x ``spatial_size``.
    ``fused_kvpool`` (off by default) takes each block's kv pools and
    attention through the fused op where its geometry allows
    (layers/attention.py), the counterpart of the JAX package's
    ``PVT_FUSED_KVPOOL=1``."""
    if norm == "layernorm":
        norm_layer = block_norm_layer = partial(LayerNorm, eps=1e-6)
    elif norm == "batchnorm":
        norm_layer, block_norm_layer = None, TokenBatchNorm
    else:
        raise NotImplementedError("only layernorm and batchnorm are supported")
    if use_2d_patch and temporal_size != 1:
        raise ValueError("use_2d_patch requires temporal_size == 1")
    if pool_kv_stride_adaptive is not None and pool_kv_stride_size is not None:
        raise ValueError("give pool_kv_stride_adaptive or pool_kv_stride_size, not both")
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)

    def patch_triple(v):
        return (1,) + tuple(v) if use_2d_patch else tuple(v)

    input_stride = patch_triple(conv_patch_embed_stride)
    input_dims = (temporal_size, spatial_size[0], spatial_size[1])
    patch_embed_shape = (
        tuple(d // s for d, s in zip(input_dims, input_stride)) if enable_patch_embed else input_dims
    )

    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for i, mul in embed_dim_mul or []:
        dim_mul[i] = mul
    for i, mul in atten_head_mul or []:
        head_mul[i] = mul

    pool_q: List = [[] for _ in range(depth)]
    pool_kv: List = [[] for _ in range(depth)]
    stride_q: List = [[] for _ in range(depth)]
    stride_kv: List = [[] for _ in range(depth)]
    for entry in pool_q_stride_size or []:
        stride_q[entry[0]] = entry[1:]
        pool_q[entry[0]] = pool_kvq_kernel or [s + 1 if s > 1 else s for s in entry[1:]]
    if pool_kv_stride_adaptive is not None:
        _stride_kv = list(pool_kv_stride_adaptive)
        pool_kv_stride_size = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(len(_stride_kv))]
            pool_kv_stride_size.append([i] + list(_stride_kv))
    for entry in pool_kv_stride_size or []:
        stride_kv[entry[0]] = entry[1:]
        pool_kv[entry[0]] = pool_kvq_kernel or [s + 1 if s > 1 else s for s in entry[1:]]

    def or_ones(v):
        return tuple(v) if len(v) > 0 else (1, 1, 1)

    dpr = np.linspace(0, droppath_rate_block, depth)
    with torch.device(device):
        patch_embed = (
            create_conv_patch_embed(
                in_channels=input_channels,
                out_channels=patch_embed_dim,
                conv_kernel_size=patch_triple(conv_patch_embed_kernel),
                conv_stride=input_stride,
                conv_padding=(
                    (0,) + tuple(conv_patch_embed_padding)
                    if use_2d_patch
                    else conv_patch_embed_padding
                ),
                device=device,
            )
            if enable_patch_embed
            else None
        )
        cls_positional_encoding = SpatioTemporalClsPositionalEncoding(
            embed_dim=patch_embed_dim,
            patch_embed_shape=patch_embed_shape,
            sep_pos_embed=sep_pos_embed,
            has_cls=cls_embed_on,
        )
        blocks = []
        dim_in = patch_embed_dim
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i], min_width=1, divisor=1)
            if dim_mul_in_att:
                dim_out = round_width(
                    dim_in, dim_mul[i], divisor=round_width(num_heads, head_mul[i])
                )
            else:
                dim_out = round_width(
                    dim_in, dim_mul[i + 1], divisor=round_width(num_heads, head_mul[i + 1])
                )
            blocks.append(
                MultiScaleBlock(
                    dim=dim_in,
                    dim_out=dim_out,
                    num_heads=num_heads,
                    mlp_ratio=mlp_ratio,
                    qkv_bias=qkv_bias,
                    dropout_rate=dropout_rate_block,
                    droppath_rate=float(dpr[i]),
                    norm_layer=block_norm_layer,
                    attn_norm_layer=block_norm_layer,
                    dim_mul_in_att=dim_mul_in_att,
                    kernel_q=or_ones(pool_q[i]),
                    kernel_kv=or_ones(pool_kv[i]),
                    stride_q=or_ones(stride_q[i]),
                    stride_kv=or_ones(stride_kv[i]),
                    pool_mode=pooling_mode,
                    has_cls_embed=cls_embed_on,
                    pool_first=pool_first,
                    residual_pool=residual_pool,
                    depthwise_conv=depthwise_conv,
                    bias_on=bias_on,
                    separate_qkv=separate_qkv,
                    fused_kvpool=fused_kvpool,
                )
            )
            dim_in = dim_out
        head_model = (
            head(
                in_features=dim_in,
                out_features=head_num_classes,
                seq_pool_type="cls" if cls_embed_on else "mean",
                dropout_rate=head_dropout_rate,
                activation=head_activation,
                device=device,
            )
            if head is not None
            else None
        )
        return MultiscaleVisionTransformers(
            patch_embed=patch_embed,
            cls_positional_encoding=cls_positional_encoding,
            blocks=blocks,
            norm_embed=None if norm_layer is None else norm_layer(dim_in),
            head=head_model,
            pos_dropout_rate=dropout_rate_block,
            patch_embed_shape=patch_embed_shape,
        )
