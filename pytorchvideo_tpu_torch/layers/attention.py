"""MViT multiscale (pooled) attention.

Counterpart of pytorchvideo_tpu/layers/attention.py (upstream
pytorchvideo/layers/attention.py): ``Mlp``, ``TokenPool``,
``MultiScaleAttention`` and ``MultiScaleBlock``.

Tokens travel as a pair ``(cls, grid)``: the cls token (B, 1, C), or None
without one, and the grid tokens (B, L, C) in (T, H, W) order, as in the JAX
package's default path (attention.py:508-705). The grid is therefore always
a channels-last (B, T, H, W, C) token grid with no copy, which is what the
token-pool kernel reads, and no per-pool slicing or concatenation touches the
long token axis: k and v get their cls row back only at the pooled length.

Every pool goes through the token-pool dispatcher (ops/token_pool.py) and
every attention through the pooled-attention dispatcher
(ops/pooled_attention.py): on CUDA tensors both are the hand-written
kernels, including the single-row cls query, which is one Lq = 1 launch.

In training mode (``module.train()``) the dropouts of the JAX package are
active (Mlp, the attention's output projection) and ``MultiScaleBlock``
applies DropPath to both residual branches with one mask per sample shared by
the cls token and the grid; the kernels' backward runs through their
``torch.autograd.Function``s.

``MultiScaleAttention(fused_kvpool=True)`` is the explicit counterpart of the
JAX package's ``PVT_FUSED_KVPOOL=1`` (attention.py:376-448, 587-625), off by
default: where the block's geometry passes ``fusable``, the k and v pools,
their LayerNorms, the cls rows and both attentions go through one fused op
(ops/fused_kvpool_attention.py), which reads the unpooled k and v grids and,
on the card, makes one pool-LN launch and the two attention launches. It uses
the same ``pool_k``/``norm_k``/``pool_v``/``norm_v`` parameters, so the
``state_dict`` is the same with the flag on or off; both paths compute the
same function.

With BatchNorm norms (``TokenBatchNorm``, the BatchNorm MViT of
models/vision_transformers.py) a conv pool's norm comes before the pool:
BN + GELU on the grid, the cls token left alone (JAX attention.py:154-163
head-packed, :255-260 per-head), and no norm after the pool; the block's
``norm1`` and ``norm2`` normalise the cls token and the grid in two calls, as
the JAX package does. The fused kv-pool is never taken with BN.

A pool conv with ``depthwise_conv=False`` holds a (c, c, kt, kh, kw) weight
per head-channel group, shared across heads, as the JAX package declares
it (attention.py:166-168): the head-packed grid is convolved with the weight
tiled over its heads and one group per head (:188-197), the per-head grids
of ``pool_first`` with one group (:260-270). No TPU kernel computes it, so
``F.conv3d`` (cuDNN on the card) serves it on both devices, and the fused
kv-pool never takes it.

Tensor parallelism (parallel/tensor.py ``shard_model_``): an attention
whose q, k and v (or fused qkv) are column-parallel and whose ``proj`` is
row-parallel over a model group, and an ``Mlp`` whose ``fc1`` and ``fc2``
are, runs this rank's part: each head count and width comes from the local
weights, so every kernel runs at the local head count (the JAX package's
``ops/spmd.py`` derives its statics from local shapes too). The layer's
input enters the region through ``enter_region`` (the identity, its
gradient summed over the group), the column-parallel biases are taken at
this rank's rows, and the row-parallel products are summed over the group
by one all-reduce for the (cls, grid) pair before the bias. Modules outside
a model group run as before.

Modules keep upstream's ``state_dict`` keys (``attn.q``, ``attn.pool_q``,
``attn.norm_q``, ``mlp.fc1``, ...). Not ported: ``PVT_FUSED_QKV``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.layers.common import triple
from pytorchvideo_tpu_torch.layers.norms import LayerNorm, _SharedGroup
from pytorchvideo_tpu_torch.layers.stochastic import drop_path_pair
from pytorchvideo_tpu_torch.ops.fused_kvpool_attention import fused_kvpool_attention, fusable
from pytorchvideo_tpu_torch.ops.pooled_attention import pooled_attention, pooled_attention_packed
from pytorchvideo_tpu_torch.ops.token_pool import (
    avg_token_pool,
    depthwise_token_pool,
    max_token_pool,
)
from pytorchvideo_tpu_torch.parallel.collectives import enter_region, reduce_from_region

Size3 = Tuple[int, int, int]
Pair = Tuple[Optional[torch.Tensor], torch.Tensor]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation: ``jax.nn.gelu``'s default, which the JAX
    package's MViT uses (upstream torch uses the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _pair_map(fn: Callable, x: Pair) -> Pair:
    cls_x, grid_x = x
    return (None if cls_x is None else fn(cls_x), fn(grid_x))


class _ModelParallel:
    """The model group of a tensor-parallel layer (None: the whole layer on
    this rank; held through ``copy.deepcopy``, so a copy runs over the same
    group), this rank's index in it and its size; set by
    parallel/tensor.py ``shard_model_``."""

    _model_group = None
    model_index = 0
    model_size = 1

    @property
    def model_group(self):
        return None if self._model_group is None else self._model_group.group

    @model_group.setter
    def model_group(self, group) -> None:
        self._model_group = _SharedGroup(group)

    def _enter(self, x: Pair) -> Pair:
        return x if self.model_group is None else enter_region(x, self.model_group)

    def _column(self, linear: nn.Linear, x: torch.Tensor, parts: int = 1) -> torch.Tensor:
        """A column-parallel ``linear`` of ``x``: the local weight's rows and
        this rank's rows of the (replicated) bias, taken in each of its
        ``parts`` (3 for a fused qkv)."""
        if self.model_group is None:
            return linear(x)
        bias = linear.bias
        if bias is not None:
            bias = bias.view(parts, self.model_size, -1)[:, self.model_index].reshape(-1)
        return F.linear(x, linear.weight, bias)

    def _row(self, linear: nn.Linear, x: Pair) -> Pair:
        """A row-parallel ``linear`` of the pair: the local products summed
        over the group in one all-reduce, then the bias."""
        if self.model_group is None:
            return _pair_map(linear, x)
        parts = reduce_from_region(_pair_map(lambda t: F.linear(t, linear.weight), x),
                                   self.model_group)
        return parts if linear.bias is None else _pair_map(lambda t: t + linear.bias, parts)


class Mlp(_ModelParallel, nn.Module):
    """fc1 -> act -> dropout -> fc2 -> dropout, of a tensor or of a (cls,
    grid) pair; ``fc1`` column-parallel and ``fc2`` row-parallel over a
    model group where parallel/tensor.py placed them so."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        act_layer: Callable = gelu_tanh,
        dropout_rate: float = 0.0,
        bias_on: bool = True,
    ):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, bias=bias_on)
        self.act = act_layer
        self.fc2 = nn.Linear(hidden_features, out_features, bias=bias_on)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dropout is None else self.dropout(x)

    def forward(self, x):
        pair = isinstance(x, tuple)
        x = self._enter(x if pair else (None, x))
        x = _pair_map(lambda t: self._drop(self.act(self._column(self.fc1, t))), x)
        x = _pair_map(self._drop, self._row(self.fc2, x))
        return x if pair else x[1]


def dense_token_pool(grid: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """The non-depthwise pool conv of a channels-last (N, T, H, W, G*c) grid:
    each of its G head groups of c channels convolved with the same (c, c,
    kt, kh, kw) ``weight`` (``F.conv3d`` with the weight tiled G times and G
    groups; padding k // 2), channels-last out."""
    c = weight.shape[0]
    groups = grid.shape[-1] // c
    w = weight.to(grid.dtype).repeat(groups, 1, 1, 1, 1)
    out = F.conv3d(grid.permute(0, 4, 1, 2, 3), w, stride=stride,
                   padding=[k // 2 for k in weight.shape[2:]], groups=groups)
    return out.permute(0, 2, 3, 4, 1).contiguous()


class TokenPool(nn.Module):
    """Pools tokens through their (T, H, W) geometry: a conv (the ``weight``
    (c, 1, kt, kh, kw) of a depthwise conv, upstream's pool ``Conv3d``, or
    with ``depthwise=False`` (c, c, kt, kh, kw), shared across heads), max or
    avg, padding k // 2. ``forward(x, thw, norm)`` returns (pooled, thw');
    ``norm`` (a LayerNorm over the head width c) follows the pool, or with
    ``norm_before`` (a BatchNorm, or what folded it) precedes it, followed
    by GELU, on the grid only.

    ``x`` is either the head-packed pair (cls, grid (B, L, H*c)), whose grid
    is pooled as one (B, T, H, W, H*c) grid with the per-head weight shared
    by every head (JAX attention.py:138-232), or per-head tokens
    (B, heads, 1 + L, c) with the cls row first, pooled as (B*heads) grids
    of width c (JAX attention.py:234-287). The norm runs per head, on the
    grid and on the cls token."""

    def __init__(
        self,
        mode: str,
        kernel: Union[int, Size3],
        stride: Union[int, Size3],
        channels: Optional[int] = None,
        has_cls_embed: bool = True,
        norm_before: bool = False,
        depthwise: bool = True,
    ):
        super().__init__()
        if mode not in ("conv", "max", "avg"):
            raise ValueError(f"pool mode must be conv, max or avg, got {mode!r}")
        self.mode = mode
        self.kernel = triple(kernel)
        self.stride = triple(stride)
        self.has_cls_embed = has_cls_embed
        self.norm_before = norm_before
        self.depthwise = depthwise
        if mode == "conv":
            self.weight = nn.Parameter(
                torch.empty(channels, 1 if depthwise else channels, *self.kernel))
            # nn.Conv3d's default initialisation.
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def _pool(self, grid: torch.Tensor) -> torch.Tensor:
        grid = grid.contiguous()
        if self.mode == "conv":
            if not self.depthwise:
                return dense_token_pool(grid, self.weight, self.stride)
            return depthwise_token_pool(grid, self.weight, self.stride)
        if self.mode == "max":
            return max_token_pool(grid, self.kernel, self.stride)
        return avg_token_pool(grid, self.kernel, self.stride)

    def _norm_before(self, grid: torch.Tensor, norm: Optional[nn.Module]) -> torch.Tensor:
        """With ``norm_before``: BN over each channel of the head width c
        (the conv weight's), then GELU; else ``grid`` as it is."""
        if not self.norm_before:
            return grid
        shape, c = grid.shape, self.weight.shape[0]
        if norm is not None:
            grid = norm(grid.reshape(*shape[:-1], shape[-1] // c, c))
        return gelu_tanh(grid).reshape(shape)

    def forward(self, x, thw: Size3, norm: Optional[nn.Module] = None):
        T, H, W = thw
        if isinstance(x, tuple):
            cls_x, grid = x
            B, _, HC = grid.shape
            grid = self._norm_before(grid, norm)
            grid = self._pool(grid.reshape(B, T, H, W, HC))
            thw_out = tuple(grid.shape[1:4])
            grid = grid.reshape(B, -1, HC)
            if norm is not None and not self.norm_before:
                c = norm.normalized_shape[0]
                grid = norm(grid.view(B, -1, HC // c, c)).view(B, -1, HC)
                if cls_x is not None:
                    cls_x = norm(cls_x.reshape(B, 1, HC // c, c)).view(B, 1, HC)
            return (cls_x, grid), thw_out

        cls_x = None
        if self.has_cls_embed:
            cls_x, x = x[:, :, :1], x[:, :, 1:]
        B, N, _, c = x.shape
        grid = self._norm_before(x.reshape(B * N, T, H, W, c), norm)
        grid = self._pool(grid)
        thw_out = tuple(grid.shape[1:4])
        x = grid.reshape(B, N, -1, c)
        if cls_x is not None:
            x = torch.cat([cls_x, x], dim=2)
        if norm is not None and not self.norm_before:
            x = norm(x)
        return x, thw_out

    def extra_repr(self) -> str:
        return f"mode={self.mode}, kernel={self.kernel}, stride={self.stride}"


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float, residual_pool: bool) -> torch.Tensor:
    """softmax(q * scale @ k^T) @ v (+ q with ``residual_pool``) over per-head
    (B, heads, L, c) tensors: the JAX package's attention core (upstream
    attention.py:531-537), here :func:`pooled_attention` (kernel #2 on the
    card, its plain version on the CPU)."""
    return pooled_attention(q, k, v, scale, residual_pool)


def _maybe_kernel(kernel, stride) -> Optional[Size3]:
    """No pooling where kernel and stride are all ones (upstream attention.py:327-339)."""
    if kernel is None:
        return None
    if int(np.prod(triple(kernel))) == 1 and int(np.prod(triple(stride))) == 1:
        return None
    return triple(kernel)


class MultiScaleAttention(_ModelParallel, nn.Module):
    """Pooled multi-head attention of ``dim`` -> ``dim_out`` channels.

    The default path keeps q, k and v head-packed (B, L, H*c) from the
    projections through the pools and the attention kernel; ``pool_first``
    pools the raw per-head tokens, projects, and runs the per-head kernel on
    (B, H, L, c). ``fused_kvpool`` takes the default path's kv pools, norms
    and attention through the fused op wherever ``fusable`` allows (see the
    module docstring). ``forward((cls, grid), thw)`` returns ((cls, grid),
    thw').

    Over a model group (parallel/tensor.py) the rank runs its
    ``num_heads / size`` heads: H = the local q (or qkv) weight's rows /
    ``head_dim``. A fused ``qkv``'s local weight holds this rank's q rows,
    then its k rows, then its v rows (rank r's heads r*H..(r+1)*H-1 of each:
    the rows of the full weight viewed as (3, size, H*c) at [:, r]), so that
    its three chunks are the local q, k and v."""

    def __init__(
        self,
        dim: int,
        dim_out: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        dropout_rate: float = 0.0,
        kernel_q: Size3 = (1, 1, 1),
        kernel_kv: Size3 = (1, 1, 1),
        stride_q: Size3 = (1, 1, 1),
        stride_kv: Size3 = (1, 1, 1),
        norm_layer: Callable = LayerNorm,
        has_cls_embed: bool = True,
        pool_mode: str = "conv",
        pool_first: bool = False,
        residual_pool: bool = True,
        depthwise_conv: bool = True,
        bias_on: bool = True,
        separate_qkv: bool = True,
        fused_kvpool: bool = False,
    ):
        super().__init__()
        if pool_mode not in ("conv", "avg", "max"):
            raise ValueError(f"pool_mode must be conv, avg or max, got {pool_mode!r}")
        if fused_kvpool and pool_first:
            raise ValueError("the fused kv-pool runs on the head-packed path, not with pool_first")
        self.num_heads = num_heads
        self.pool_first = pool_first
        self.residual_pool = residual_pool
        self.separate_qkv = separate_qkv or pool_first
        self.fused_kvpool = fused_kvpool
        self.head_dim = dim_out // num_heads
        self.scale = self.head_dim**-0.5
        if self.separate_qkv:
            self.q = nn.Linear(dim, dim_out, bias=qkv_bias)
            self.k = nn.Linear(dim, dim_out, bias=qkv_bias)
            self.v = nn.Linear(dim, dim_out, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out, bias=bias_on)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None

        # The pools see the raw tokens (dim) with pool_first, the projected
        # ones (dim_out) otherwise; their conv weights and norms are per head.
        pool_c = (dim if pool_first else dim_out) // num_heads
        for name, kernel, stride in (
            ("q", kernel_q, stride_q),
            ("k", kernel_kv, stride_kv),
            ("v", kernel_kv, stride_kv),
        ):
            kernel = _maybe_kernel(kernel, stride)
            pool = norm = None
            if kernel is not None:
                if pool_mode == "conv":
                    norm = norm_layer(pool_c)
                pool = TokenPool(pool_mode, kernel, stride, pool_c, has_cls_embed,
                                 norm_before=isinstance(norm, nn.modules.batchnorm._BatchNorm),
                                 depthwise=depthwise_conv)
            setattr(self, f"pool_{name}", pool)
            setattr(self, f"norm_{name}", norm)

    def _pool(self, name: str, x, thw: Size3):
        pool = getattr(self, f"pool_{name}")
        if pool is None:
            return x, thw
        return pool(x, thw, getattr(self, f"norm_{name}"))

    def _out(self, x: Pair) -> Pair:
        x = self._row(self.proj, x)
        return x if self.dropout is None else _pair_map(self.dropout, x)

    def _local_heads(self) -> int:
        """The heads this rank runs (all of them outside a model group): the
        local q (or qkv) weight's rows over the head width."""
        if self.separate_qkv:
            return self.q.weight.shape[0] // self.head_dim
        return self.qkv.weight.shape[0] // (3 * self.head_dim)

    def forward(self, x: Pair, thw: Size3) -> Tuple[Pair, Size3]:
        x = self._enter(x)
        if self.pool_first:
            return self._forward_pool_first(x, thw)
        if self.separate_qkv:
            q, k, v = (_pair_map(lambda t, p=proj: self._column(p, t), x)
                       for proj in (self.q, self.k, self.v))
        else:
            qkv = _pair_map(lambda t: self._column(self.qkv, t, 3), x)
            q, k, v = (_pair_map(lambda t, i=i: t.chunk(3, dim=-1)[i].contiguous(), qkv)
                       for i in range(3))
        (cls_q, grid_q), q_thw = self._pool("q", q, thw)
        if self._fuses(thw):
            return self._out(self._fused_attention((cls_q, grid_q), k, v, thw)), q_thw
        (cls_k, grid_k), _ = self._pool("k", k, thw)
        (cls_v, grid_v), _ = self._pool("v", v, thw)
        # Every query attends to the cls key too: it goes in front, at the
        # pooled length.
        k_full = grid_k if cls_k is None else torch.cat([cls_k, grid_k], dim=1)
        v_full = grid_v if cls_v is None else torch.cat([cls_v, grid_v], dim=1)

        heads = self._local_heads()

        def attend(queries):
            return pooled_attention_packed(
                queries, k_full, v_full, heads, self.scale, self.residual_pool
            )

        return self._out(_pair_map(attend, (cls_q, grid_q))), q_thw

    def _fuses(self, thw: Size3) -> bool:
        """The fused path's gate (JAX attention.py:592-621): the flag, a
        depthwise conv kv pool with a LayerNorm after it, and a geometry
        ``fusable`` takes at the local width."""
        pool = self.pool_k
        return (self.fused_kvpool and pool is not None and pool.mode == "conv"
                and pool.depthwise and isinstance(self.norm_k, nn.LayerNorm)
                and fusable(tuple(thw), self._local_heads() * self.head_dim, pool.kernel,
                            pool.stride, self.head_dim))

    def _fused_attention(self, q: Pair, k: Pair, v: Pair, thw: Size3) -> Pair:
        """The kv pools, their LayerNorms and the attention of both queries in
        one fused op (JAX attention.py:376-448): per-head taps (kt*kh*kw, c)
        and LayerNorm parameters (2, c) that every head shares, cls rows
        normed here, the norm's eps."""
        (cls_q, grid_q), (cls_k, grid_k), (cls_v, grid_v) = q, k, v
        c = self.head_dim

        def taps(pool):
            return pool.weight.reshape(c, -1).t().contiguous()

        def ln(norm):
            return torch.stack([norm.weight, norm.bias])

        def norm_cls(t, norm):
            if t is None:
                return None
            return norm(t.reshape(t.shape[0], 1, -1, c)).reshape(t.shape)

        outs = fused_kvpool_attention(
            grid_q, grid_k, grid_v, taps(self.pool_k), taps(self.pool_v), ln(self.norm_k),
            ln(self.norm_v), norm_cls(cls_k, self.norm_k), norm_cls(cls_v, self.norm_v),
            tuple(thw), self._local_heads(), self.scale, self.residual_pool, self.pool_k.kernel,
            self.pool_k.stride, self.norm_k.eps, cls_q=cls_q,
        )
        return (None if cls_q is None else outs[3], outs[0])

    def _forward_pool_first(self, x: Pair, thw: Size3) -> Tuple[Pair, Size3]:
        cls_x, grid_x = x
        x = grid_x if cls_x is None else torch.cat([cls_x, grid_x], dim=1)
        B, L, C = x.shape
        N = self.num_heads
        heads = x.reshape(B, L, N, C // N).transpose(1, 2)

        def project(t, proj):
            # Every head's pooled tokens to this rank's heads.
            merged = t.transpose(1, 2).reshape(B, t.shape[2], -1)
            out = self._column(proj, merged)
            return out.reshape(B, t.shape[2], -1, self.head_dim).transpose(1, 2).contiguous()

        q, q_thw = self._pool("q", heads, thw)
        k, _ = self._pool("k", heads, thw)
        v, _ = self._pool("v", heads, thw)
        out = pooled_attention(
            project(q, self.q), project(k, self.k), project(v, self.v), self.scale,
            self.residual_pool,
        )
        _, out = self._out((None, out.transpose(1, 2).reshape(B, out.shape[2], -1)))
        if cls_x is None:
            return (None, out), q_thw
        return (out[:, :1], out[:, 1:]), q_thw


class MultiScaleBlock(nn.Module):
    """MViT block: x + attn(norm1(x)), then x + mlp(norm2(x)), with a max pool
    on the residual path where the queries are strided (kernel s + 1 where
    s > 1, stride s, padding k // 2; the cls token passes through) and a
    linear projection where the width changes. In training mode each branch
    goes through DropPath at ``droppath_rate``, its masks drawn from
    ``self.generator`` where one is set (None: torch's default generator of
    the device), as :class:`~pytorchvideo_tpu_torch.layers.stochastic.DropPath`
    draws them."""

    def __init__(
        self,
        dim: int,
        dim_out: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        dropout_rate: float = 0.0,
        droppath_rate: float = 0.0,
        act_layer: Callable = gelu_tanh,
        norm_layer: Callable = LayerNorm,
        attn_norm_layer: Callable = LayerNorm,
        dim_mul_in_att: bool = False,
        kernel_q: Size3 = (1, 1, 1),
        kernel_kv: Size3 = (1, 1, 1),
        stride_q: Size3 = (1, 1, 1),
        stride_kv: Size3 = (1, 1, 1),
        pool_mode: str = "conv",
        has_cls_embed: bool = True,
        pool_first: bool = False,
        residual_pool: bool = False,
        depthwise_conv: bool = True,
        bias_on: bool = True,
        separate_qkv: bool = True,
        fused_kvpool: bool = False,
    ):
        super().__init__()
        att_dim = dim_out if dim_mul_in_att else dim
        self.dim_mul_in_att = dim_mul_in_att
        self.droppath_rate = droppath_rate
        self.generator: Optional[torch.Generator] = None
        self.norm1 = norm_layer(dim)
        self.attn = MultiScaleAttention(
            dim,
            att_dim,
            num_heads=num_heads,
            qkv_bias=qkv_bias,
            dropout_rate=dropout_rate,
            kernel_q=kernel_q,
            kernel_kv=kernel_kv,
            stride_q=stride_q,
            stride_kv=stride_kv,
            norm_layer=attn_norm_layer,
            has_cls_embed=has_cls_embed,
            pool_mode=pool_mode,
            pool_first=pool_first,
            residual_pool=residual_pool,
            depthwise_conv=depthwise_conv,
            bias_on=bias_on,
            separate_qkv=separate_qkv,
            fused_kvpool=fused_kvpool,
        )
        self.norm2 = norm_layer(att_dim)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out, act_layer, dropout_rate, bias_on)
        self.proj = nn.Linear(dim, dim_out, bias=bias_on) if dim != dim_out else None
        stride_skip = triple(stride_q)
        self.pool_skip = None
        if int(np.prod(stride_skip)) > 1:
            kernel_skip = tuple(s + 1 if s > 1 else s for s in stride_skip)
            self.pool_skip = TokenPool("max", kernel_skip, stride_skip, has_cls_embed=has_cls_embed)

    def _drop_path(self, x: Pair) -> Pair:
        if not self.training:
            return x
        return drop_path_pair(x, self.droppath_rate, self.generator)

    def forward(self, x: Pair, thw: Size3) -> Tuple[Pair, Size3]:
        x_norm = _pair_map(self.norm1, x)
        x_block, thw_new = self.attn(x_norm, thw)
        if self.dim_mul_in_att and self.proj is not None:
            x = _pair_map(self.proj, x_norm)
        if self.pool_skip is not None:
            x, _ = self.pool_skip(x, thw)
        x = _add(x, self._drop_path(x_block))
        x_norm = _pair_map(self.norm2, x)
        x_mlp = self.mlp(x_norm)
        if not self.dim_mul_in_att and self.proj is not None:
            x = _pair_map(self.proj, x_norm)
        return _add(x, self._drop_path(x_mlp)), thw_new


def _add(a: Pair, b: Pair) -> Pair:
    return (None if a[0] is None else a[0] + b[0], a[1] + b[1])
