"""Fused kv-pool + per-head LayerNorm + pooled attention.

Counterpart of pytorchvideo_tpu/ops/fused_kvpool_attention.py, with its
public names and argument order (``pool_out``, ``fusable``,
``fused_kvpool_attention`` and its plain version). MViT's keys and values
arrive UNPOOLED, as the (B, T*H*W, H*c) outputs of their projections; the op
pools each with a depthwise stride-(st, sh, sw) conv at padding k // 2, applies
the per-head LayerNorm (f32 from the pool to the norm), puts the already-normed
cls row in front and runs head-packed attention of q over the result. Returns
(out, pooled k, pooled v); with ``cls_q`` (a port argument, keyword only) also
the cls query's output, which the JAX package computes outside the op.

- :func:`fused_kvpool_attention_cuda` makes two launches on one stream: the
  hand-written pool-LN kernel (``csrc/fused_kvpool_attention.cu``, the port of
  the pool phase of the TPU kernel ``_fused_local``) writes k and v into
  (B, 1 + Lk, H*c) buffers with the cls row at row 0, and the attention kernel
  (``pooled_attention_packed_cuda``, the port of the attention phase) runs over
  those buffers for q and, as an Lq = 1 launch, for ``cls_q``. The pooled
  grids it returns are views of the buffers: no concatenation. It counts its
  pool-LN launches in ``launches``, and per route in ``launches_by_route``;
  the attention launches are counted by ``pooled_attention_packed_cuda``.
  Why two launches and not the TPU kernel's one is in the CUDA source.
- :func:`fused_kvpool_attention_torch` is the plain version (the counterpart
  of ``fused_kvpool_attention_xla`` and ``_pool_ln_xla``): ``F.conv3d(groups=C)``,
  a per-head LayerNorm in f32, a concatenation of the cls row and
  ``pooled_attention_packed_torch``.
- :func:`fused_kvpool_attention` dispatches: a CPU tensor takes the plain
  version, a CUDA tensor the kernels (or the kernels' checks raise). Where
  autograd needs a gradient it goes through a ``torch.autograd.Function``
  whose backward recomputes through the unfused composition, as the JAX
  package's ``_fused_bwd`` does: the conv pool (``depthwise_token_pool``), the
  LayerNorm, the cls concatenation and ``pooled_attention_packed`` under
  autograd. On the card that backward runs the token-pool kernel and its dx
  and dw kernels, the attention kernel and its backward, and PyTorch's own
  LayerNorm backward. Under tracing (``torch.export``, ``torch.compile``)
  without autograd it calls one custom op per launch instead: the pool-LN
  as ``torch.ops.pvt.kvpool_ln`` (the buffers, cls rows in front; CUDA:
  :func:`kvpool_ln_cuda`, CPU: :func:`pool_ln_torch`), then
  ``torch.ops.pvt.pooled_attention_packed`` for q and ``cls_q``.

The pool-LN launch takes one of two routes, chosen before the launch by
:func:`pool_ln_route`; no route is tried after another fails:

- ``tiled``: float32 and bfloat16, a head width in ``POOL_LN_WIDTHS`` (rows
  of whole 16-byte vectors), 16-byte aligned k and v grids, kernel (3, 3, 3)
  at T stride 1 (every call ``fusable`` sends to the card). The token pool's
  tiled machinery (``csrc/pool_tiles.cuh``) with a slice one head wide: a
  block walks T over a tile of the pooled grid (:func:`pool_ln_tile_plan`)
  through a ring of planes in shared memory, and the output positions each
  warp pools (two at a time) get their head's LayerNorm as the walk's
  epilogue.
  :func:`pool_ln_tiled_torch` replays that walk in float32, for the tests.
- ``scalar``: the first version's kernel, for every other call.

Taps ``wk``/``wv`` are (kt*kh*kw, Cw) and LayerNorm parameters ``lnk``/``lnv``
(2, Cw) (scale, then shift), with H*c a multiple of Cw: channel j uses column
j % Cw. Cw = H*c is the JAX package's head-tiled layout; Cw = c the per-head
parameters that MViT shares across heads, which the port's layer passes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pytorchvideo_tpu_torch.ops.pooled_attention import (
    MAX_HEAD_DIM,
    pooled_attention_packed,
    pooled_attention_packed_cuda,
    pooled_attention_packed_torch,
)
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.ops.token_pool import depthwise_token_pool, depthwise_token_pool_torch

Size3 = Tuple[int, int, int]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZE = (3, 3, 3)
POOL_LN_ROUTES = ("tiled", "scalar")
# The tiled pool-LN kernel's head widths (its slice is one head: lane l holds
# the channel pairs 2l and 64 + 2l), the blocks of k and v together that fill
# the card twice over where the grid allows (two waves of 132 SMs), the
# shared memory of a block (the ring and the head's (27, c) f32 taps: three
# bf16 blocks an SM) and the planes its walk copies ahead. On the H100, three
# blocks an SM with one plane ahead beat two with two ahead, and two with one
# ahead (benchmarks_torch/pool_ln_variants.py; PERF.md section 6).
POOL_LN_WIDTHS = (32, 64, 96, 128)
POOL_LN_TARGET_BLOCKS = 264
POOL_LN_SMEM_BUDGET = 72 * 1024
POOL_LN_DEPTH = 1


def pool_out(d: int, k: int, s: int, p: int) -> int:
    """Output length of one axis of a pool: input d, kernel k, stride s, padding p."""
    return (d + 2 * p - k) // s + 1


def fusable(thw: Size3, hc: int, kernel: Optional[Size3], stride: Size3, head_dim: int) -> bool:
    """Whether the fused op takes a block's kv pool on the card.

    The conditions on what the op computes are the JAX gate's: a (3, 3, 3)
    pool kernel (padding k // 2), temporal stride 1 and a pooled grid that is
    not empty. The JAX gate's other two conditions came from the TPU (strides
    sh, sw >= 4, from a v5e Mosaic compile crash, and a 12 MB VMEM budget,
    for which it took the activations' itemsize) and are replaced by the
    card's own limits: head_dim <= 128, for the attention kernel and for the
    pool-LN kernel, whose lanes hold at most four channels of a head. No grid
    size bounds it: the pool-LN's tiled route cuts its tiles to fit shared
    memory, and its scalar route keeps nothing there.
    """
    if kernel is None or tuple(kernel) != (3, 3, 3) or stride[0] != 1 or min(stride) < 1:
        return False
    if not 1 <= head_dim <= MAX_HEAD_DIM or hc % head_dim:
        return False
    return min(pool_out(d, k, s, k // 2) for d, k, s in zip(thw, kernel, stride)) > 0


def _pool_ln(pool, grid, w, ln, thw, num_heads, kernel, stride, eps):
    """One tensor's pool through ``pool`` (a depthwise token pool), then the
    per-head LayerNorm in f32; (B, Lk, H*c) in the grid's dtype."""
    B, _, HC = grid.shape
    c, Cw = HC // num_heads, w.shape[1]
    weight = w.t().contiguous().reshape(Cw, 1, *kernel)
    pooled = pool(grid.reshape(B, *thw, HC), weight, stride)
    x = F.layer_norm(pooled.reshape(B, -1, num_heads, c).float(), (c,), eps=eps)
    x = x.reshape(B, -1, HC // Cw, Cw) * ln[0].float() + ln[1].float()
    return x.reshape(B, -1, HC).to(grid.dtype)


def _compose(pool, attend, q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads,
             scale, residual, kernel, stride, eps, cls_q):
    """The op as the unfused path computes it, through ``pool`` (a depthwise
    token pool) and ``attend`` (head-packed attention)."""
    kp, vp = (_pool_ln(pool, grid, w, ln, thw, num_heads, kernel, stride, eps)
              for grid, w, ln in ((k_grid, wk, lnk), (v_grid, wv, lnv)))
    k_full = kp if cls_k is None else torch.cat([cls_k, kp], dim=1)
    v_full = vp if cls_v is None else torch.cat([cls_v, vp], dim=1)
    outs = (attend(q, k_full, v_full, num_heads, scale, residual), kp, vp)
    if cls_q is not None:
        outs += (attend(cls_q, k_full, v_full, num_heads, scale, residual),)
    return outs


def fused_kvpool_attention_torch(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None,
):
    """Plain version: ``F.conv3d(groups=C)`` pools in f32, the per-head
    LayerNorm in f32, the cls rows in front, ``pooled_attention_packed_torch``.
    Returns (out, pooled k, pooled v[, cls out]) in q's dtype."""
    return _compose(depthwise_token_pool_torch, pooled_attention_packed_torch, q, k_grid, v_grid,
                    wk, wv, lnk, lnv, cls_k, cls_v, tuple(thw), num_heads, scale, residual,
                    tuple(kernel), tuple(stride), eps, cls_q)


def pool_ln_torch(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride,
                  eps=1e-6):
    """Plain version of the pool-LN launch: the (B, cls + Lk, H*c) k and v
    buffers, the cls rows (given or None) in front of the pooled and normed
    grids (``F.conv3d(groups=C)`` and the LayerNorm, in f32)."""
    outs = []
    for grid, w, ln, cls in ((k_grid, wk, lnk, cls_k), (v_grid, wv, lnv, cls_v)):
        x = _pool_ln(depthwise_token_pool_torch, grid, w, ln, tuple(thw), num_heads, tuple(kernel),
                     tuple(stride), eps)
        outs.append(x if cls is None else torch.cat([cls.to(x.dtype), x], dim=1))
    return tuple(outs)


def pool_ln_route(dtype: torch.dtype, c: int, aligned: bool, kernel=KERNEL_SIZE,
                  stride=(1, 1, 1)) -> str:
    """The route of a pool-LN launch: ``tiled`` for float32 and bfloat16 with
    a head width c in ``POOL_LN_WIDTHS`` (rows of whole 16-byte vectors), the
    k and v grids 16-byte aligned (``aligned``), kernel (3, 3, 3) and T
    stride 1; ``scalar`` for every other call."""
    if dtype not in _KERNEL_DTYPES or not aligned or c not in POOL_LN_WIDTHS:
        return "scalar"
    return "tiled" if tuple(kernel) == KERNEL_SIZE and stride[0] == 1 else "scalar"


@functools.lru_cache(maxsize=None)
def pool_ln_tile_plan(B: int, T: int, H: int, W: int, HC: int, heads: int, stride,
                      dtype) -> tp.PoolTilePlan:
    """The tiled pool-LN's plan for the (B, T, H, W, H*c) k and v grids of
    ``dtype`` (csrc/fused_kvpool_attention.cu ``kvpool_ln_tiled``), in the
    token pool's :class:`~pytorchvideo_tpu_torch.ops.token_pool.PoolTilePlan`
    with ``slices`` = heads: a plane of the ring holds ``rows x cols`` slots
    of one head's c channels; the ring holds 3 + POOL_LN_DEPTH planes, and
    with the head's (27, c) f32 taps must fit
    POOL_LN_SMEM_BUDGET. ``blocks`` counts one tensor's (the launch runs k
    and v side by side). Among the tiles that fit, the plan takes those with
    a pair of output positions along W for each of the kernel's 8 warps
    (``kWarps``; a warp pools two positions a pass), then those that give k
    and v together the most blocks up to POOL_LN_TARGET_BLOCKS, then the one
    that copies the fewest slots (the least halo), then the largest."""
    stride = tp._triple(stride)
    T2, H2, W2 = tp.check_geometry((B, T, H, W, HC), KERNEL_SIZE, stride)
    if stride[0] != 1 or heads < 1 or HC % heads:
        raise ValueError(f"the tiled pool-LN takes T stride 1 and H*c = {HC} a multiple of "
                         f"{heads} heads; got stride {stride}")
    c, itemsize = HC // heads, 4 if dtype == torch.float32 else 2
    depth = POOL_LN_DEPTH
    _, sh, sw = stride

    def make(th: int, tw: int) -> tp.PoolTilePlan:
        rows, cols = tp._slots(th, 3, sh, "forward"), tp._slots(tw, 3, sw, "forward")
        tiles_h, tiles_w = -(-H2 // th), -(-W2 // tw)
        return tp.PoolTilePlan(th, tw, tiles_h, tiles_w, heads, rows, cols, min(sh, 3),
                               min(sw, 3), 3 + depth, depth, 0, B * heads * tiles_h * tiles_w,
                               (3 + depth) * rows * cols * c * itemsize + 27 * c * 4)

    best, best_key = make(1, 1), None
    for th in range(1, min(H2, tp.POOL_MAX_TILE) + 1):
        for tw in range(1, min(W2, tp.POOL_MAX_TILE) + 1):
            plan = make(th, tw)
            if plan.smem_bytes > POOL_LN_SMEM_BUDGET:
                continue
            pairs = th * (tw // 2)  # full pairs of a plane
            key = (-min(pairs, 8), -min(2 * plan.blocks, POOL_LN_TARGET_BLOCKS),
                   plan.tiles_h * plan.tiles_w * plan.rows * plan.cols, -th * tw)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    return best


def pool_ln_tiled_torch(grid: torch.Tensor, taps: torch.Tensor, ln: torch.Tensor,
                        cls: Optional[torch.Tensor], thw, num_heads: int, stride, eps=1e-6,
                        plan: Optional[tp.PoolTilePlan] = None) -> torch.Tensor:
    """Plain replay of the tiled pool-LN walk for one tensor (tests only):
    for each head and tile of ``plan`` (default: the grid's), the slots of
    each input plane through the ring, a head's c channels at a time, the 27
    taps read from slot o * step + d and summed in f32, then the head's
    LayerNorm in two passes (mean, then the mean of squared deviations) with
    the scale and shift of column ch % Cw. Returns the kernel's (B, cls + Lk,
    H*c) buffer in the grid's dtype, the cls row (or none) in front."""
    B, _, HC = grid.shape
    T, H, W = thw
    stride = tp._triple(stride)
    T2, H2, W2 = tp.check_geometry((B, T, H, W, HC), KERNEL_SIZE, stride)
    plan = plan or pool_ln_tile_plan(B, T, H, W, HC, num_heads, stride, grid.dtype)
    c, Cw, has_cls = HC // num_heads, taps.shape[1], cls is not None
    xf = grid.float().reshape(B, T, H, W, HC)
    out = torch.empty((B, has_cls + T2 * H2 * W2, HC))
    if has_cls:
        out[:, :1] = cls.float()
    pooled = out[:, has_cls:].view(B, T2, H2, W2, HC)
    for head in range(plan.slices):
        ch = torch.arange(head * c, (head + 1) * c)
        wt, gain, shift = taps.float()[:, ch % Cw], ln.float()[0, ch % Cw], ln.float()[1, ch % Cw]
        for b, h0, w0, nh, nw in tp._tile_walk(plan, B, H2, W2):
            rows = tp.tile_slots(h0, nh, 3, stride[1], plan.row_step)
            cols = tp.tile_slots(w0, nw, 3, stride[2], plan.col_step)
            ring = tp._Ring(plan.ring)
            oy, ox = torch.arange(nh), torch.arange(nw)
            for t2 in tp._walk(plan, T2, lambda t: tp._load_fwd_planes(
                    ring, plan, xf[b], rows, cols, ch, KERNEL_SIZE, stride, t)):
                acc = torch.zeros((nh, nw, c))
                for dt in range(3):
                    ti = t2 + dt - 1
                    if not 0 <= ti < T:
                        continue
                    plane = ring.get(tp._fwd_slot(plan, 1, 3, t2, dt), ti)
                    for dy in range(3):
                        for dx in range(3):
                            v = plane[oy * plan.row_step + dy][:, ox * plan.col_step + dx]
                            acc = acc + v * wt[(dt * 3 + dy) * 3 + dx]
                mean = acc.mean(-1, keepdim=True)
                var = ((acc - mean) ** 2).mean(-1, keepdim=True)
                y = (acc - mean) * torch.rsqrt(var + eps) * gain + shift
                pooled[b, t2, h0:h0 + nh, w0:w0 + nw, ch] = y
    return out.to(grid.dtype)


def _choose(dtype, c: int, aligned: bool, kernel, stride, route: Optional[str]) -> str:
    """``route`` if given (``scalar`` takes any call; ``tiled`` only what
    :func:`pool_ln_route` sends there, else ValueError), else its choice."""
    chosen = pool_ln_route(dtype, c, aligned, kernel, stride)
    if route not in (None, *POOL_LN_ROUTES):
        raise ValueError(f"route must be one of {POOL_LN_ROUTES}, got {route!r}")
    if route == "tiled" and chosen != "tiled":
        raise ValueError(
            f"the tiled route takes float32 or bfloat16 with a head width in {POOL_LN_WIDTHS}, "
            f"16-byte aligned k and v grids, kernel {KERNEL_SIZE} and T stride 1; got {dtype}, "
            f"head width {c}, aligned {aligned}, kernel {tuple(kernel)}, stride {tuple(stride)}")
    return route or chosen


@functools.lru_cache(maxsize=None)
def _tiled_args(shape, heads: int, stride: Size3, pooled: Size3, Cw: int, dtype):
    """The int32 array of a tiled pool-LN call (the token pool's layout: B, T,
    H, W, H*c, T2, H2, W2, kernel, stride, Cw, mode 0, dtype, then the plan),
    built once per call signature."""
    plan = pool_ln_tile_plan(*shape, heads, stride, dtype)
    ints = (*shape, *pooled, *KERNEL_SIZE, *stride, Cw, 0, _KERNEL_DTYPES[dtype], *plan)
    return (ctypes.c_int32 * len(ints))(*ints)


def _check_cuda(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel,
                stride, cls_q) -> Size3:
    """The kernels take contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device, in the shapes of the module docstring, with
    head_dim <= 128 and odd kernel sizes; raises ValueError on anything else.
    ``q`` None (the pool-LN launch alone): k_grid sets the dtype, device, B
    and H*c. Returns the pooled grid (T2, H2, W2)."""
    ref_name, ref = ("k_grid", k_grid) if q is None else ("q", q)
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{ref_name} dtype must be float32 or bfloat16, got {ref.dtype}")
    if not ref.is_cuda:
        raise ValueError(f"{ref_name} must be a CUDA tensor, got device {ref.device}")
    if ref.dim() != 3:
        raise ValueError(f"{ref_name} must be (B, L, H*c), got {tuple(ref.shape)}")
    B, _, HC = ref.shape
    if HC % num_heads or not 1 <= HC // num_heads <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim = {HC} / {num_heads} heads must be a whole number in "
                         f"[1, {MAX_HEAD_DIM}]")
    if len(kernel) != 3 or any(k % 2 == 0 for k in kernel) or len(stride) != 3 or min(stride) < 1:
        raise ValueError(f"kernel must be three odd sizes and stride three positive steps, got "
                         f"{kernel}, {stride}")
    if (cls_k is None) != (cls_v is None):
        raise ValueError("give both cls_k and cls_v, or neither")
    Cw, L, taps = wk.shape[-1], math.prod(thw), math.prod(kernel)
    for name, t, shape in (
        ("q", q, None if q is None else tuple(q.shape)), ("k_grid", k_grid, (B, L, HC)),
        ("v_grid", v_grid, (B, L, HC)),
        ("wk", wk, (taps, Cw)), ("wv", wv, (taps, Cw)), ("lnk", lnk, (2, Cw)),
        ("lnv", lnv, (2, Cw)), ("cls_k", cls_k, (B, 1, HC)), ("cls_v", cls_v, (B, 1, HC)),
        ("cls_q", cls_q, (B, 1, HC)),
    ):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                f"{name} must be {ref.dtype} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if HC % Cw:
        raise ValueError(f"H*c = {HC} is not a multiple of the taps' {Cw} columns")
    pooled = tuple(pool_out(d, k, s, k // 2) for d, k, s in zip(thw, kernel, stride))
    if min(pooled) < 1:
        raise ValueError(f"the pool of {tuple(thw)} by {kernel}, {stride} is empty")
    return pooled


def _pool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride,
                  eps, pooled, route=None):
    """Launches the pool-LN kernel of ``route`` (default: :func:`pool_ln_route`'s);
    returns the (B, cls + Lk, H*c) k and v buffers and the route taken."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    B, _, HC = k_grid.shape
    aligned = k_grid.data_ptr() % 16 == 0 and v_grid.data_ptr() % 16 == 0
    route = _choose(k_grid.dtype, HC // num_heads, aligned, kernel, stride, route)
    rows = (cls_k is not None) + math.prod(pooled)
    k_full = torch.empty((B, rows, HC), dtype=k_grid.dtype, device=k_grid.device)
    v_full = torch.empty_like(k_full)
    lib = load_library()
    pointers = (k_grid.data_ptr(), v_grid.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                lnk.data_ptr(), lnv.data_ptr(), None if cls_k is None else cls_k.data_ptr(),
                None if cls_v is None else cls_v.data_ptr(), k_full.data_ptr(), v_full.data_ptr())
    stream, guard = tp._stream_and_guard(k_grid)
    with guard:
        if route == "tiled":
            args = _tiled_args((B, *thw, HC), num_heads, stride, pooled, wk.shape[1],
                               k_grid.dtype)
            err = lib.pvt_fused_kvpool_ln_tiled(*pointers, args, float(eps), stream)
        else:
            err = lib.pvt_fused_kvpool_ln(
                *pointers, B, *thw, HC, *pooled, *kernel, *stride, wk.shape[1], num_heads,
                float(eps), _KERNEL_DTYPES[k_grid.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused kv-pool LayerNorm kernel ({route}) launch failed: "
                           f"cudaError {err}")
    return k_full, v_full, route


def _attend(attend, q, k_full, v_full, has_cls: bool, num_heads, scale, residual, cls_q):
    """Head-packed attention (``attend``) of q, and of ``cls_q`` where given,
    over the pool-LN's k and v buffers: (out, pooled k, pooled v[, cls out]),
    the pooled grids views of the buffers."""
    off = int(has_cls)
    outs = (attend(q, k_full, v_full, num_heads, scale, residual), k_full[:, off:],
            v_full[:, off:])
    if cls_q is not None:
        outs += (attend(cls_q, k_full, v_full, num_heads, scale, residual),)
    return outs


def _count(route: str) -> None:
    fused_kvpool_attention_cuda.launches += 1
    fused_kvpool_attention_cuda.launches_by_route[route] += 1


def fused_kvpool_attention_cuda(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None, route=None,
):
    """The pool-LN kernel of ``route`` (default: :func:`pool_ln_route`'s),
    then the attention kernel over its buffers (for q, and for ``cls_q``
    where given). Returns (out, pooled k, pooled v[, cls out]); the pooled
    grids are views of the buffers. Raises ValueError on inputs the kernels
    do not take (and on ``tiled`` for a call that route does not take) and
    RuntimeError if a launch fails."""
    thw, kernel, stride = tuple(thw), tuple(kernel), tuple(stride)
    pooled = _check_cuda(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel,
                         stride, cls_q)
    k_full, v_full, route = _pool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw,
                                          num_heads, kernel, stride, eps, pooled, route)
    _count(route)
    return _attend(pooled_attention_packed_cuda, q, k_full, v_full, cls_k is not None, num_heads,
                   scale, residual, cls_q)


def kvpool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride,
                   eps=1e-6):
    """The pool-LN launch alone, on the route :func:`pool_ln_route` picks:
    the (B, cls + Lk, H*c) k and v buffers, the cls rows (given or None) in
    front (the CUDA implementation of ``torch.ops.pvt.kvpool_ln``). Checks
    and raises as :func:`fused_kvpool_attention_cuda`, and counts its launch
    there."""
    thw, kernel, stride = tuple(thw), tuple(kernel), tuple(stride)
    pooled = _check_cuda(None, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads,
                         kernel, stride, None)
    k_full, v_full, route = _pool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw,
                                          num_heads, kernel, stride, eps, pooled)
    _count(route)
    return k_full, v_full


fused_kvpool_attention_cuda.launches = 0
fused_kvpool_attention_cuda.launches_by_route = dict.fromkeys(POOL_LN_ROUTES, 0)


class _FusedKVPoolAttention(torch.autograd.Function):
    """The op with its backward: forward through the kernels on the card (the
    plain version on the CPU); backward by recomputing the unfused composition
    under autograd (JAX ``_fused_bwd``), whose ops take their kernels on the
    card and their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q, args):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q)
        ctx.args = args
        fn = fused_kvpool_attention_torch if q.device.type == "cpu" else fused_kvpool_attention_cuda
        return fn(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, *args, cls_q=cls_q)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:10]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = _compose(depthwise_token_pool, pooled_attention_packed, *leaves[:9], *ctx.args,
                            leaves[9])
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t, need in zip(leaves, needs) if need]
        if not pairs or not wanted:
            return (None,) * (len(needs) + 1)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
        return (*(next(got) if need else None for need in needs), None)


def fused_kvpool_attention(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None,
):
    """Fused kv-pool + LayerNorm + attention. q: (B, Lq, H*c) pooled queries;
    k_grid, v_grid: (B, T*H*W, H*c) UNPOOLED grids; wk, wv: (kt*kh*kw, Cw)
    taps; lnk, lnv: (2, Cw) LayerNorm scale and shift; cls_k, cls_v: (B, 1,
    H*c) ALREADY-NORMED cls rows or None; cls_q: (B, 1, H*c) cls query or
    None. Returns (out (B, Lq, H*c), pooled k (B, Lk, H*c), pooled v[, cls
    out (B, 1, H*c)]). CPU tensors take the plain version; CUDA tensors the
    kernels, the backward included where autograd needs it."""
    inputs = (q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q)
    args = (tuple(thw), num_heads, scale, residual, tuple(kernel), tuple(stride), eps)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _FusedKVPoolAttention.apply(*inputs, args)
    if torch.compiler.is_compiling():
        k_full, v_full = torch.ops.pvt.kvpool_ln(
            k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, list(thw), num_heads, list(kernel),
            list(stride), float(eps))
        return _attend(torch.ops.pvt.pooled_attention_packed, q, k_full, v_full,
                       cls_k is not None, num_heads, float(scale), residual, cls_q)
    fn = fused_kvpool_attention_torch if q.device.type == "cpu" else fused_kvpool_attention_cuda
    return fn(*inputs[:9], *args, cls_q=cls_q)


@torch.library.custom_op(
    "pvt::kvpool_ln", mutates_args=(), device_types="cpu",
    schema="(Tensor k_grid, Tensor v_grid, Tensor wk, Tensor wv, Tensor lnk, Tensor lnv, "
           "Tensor? cls_k, Tensor? cls_v, int[] thw, int num_heads, int[] kernel, int[] stride, "
           "float eps) -> (Tensor, Tensor)")
def _kvpool_ln_op(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride,
                  eps):
    return tuple(t.contiguous() for t in pool_ln_torch(
        k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride, eps))


@_kvpool_ln_op.register_kernel("cuda")
def _(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride, eps):
    return kvpool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel,
                          stride, eps)


@_kvpool_ln_op.register_fake
def _(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride, eps):
    rows = (cls_k is not None) + math.prod(
        pool_out(d, k, s, k // 2) for d, k, s in zip(thw, kernel, stride))
    shape = (k_grid.shape[0], rows, k_grid.shape[2])
    return k_grid.new_empty(shape), k_grid.new_empty(shape)
