"""Token pooling of a channels-last (B, T, H, W, C) grid: depthwise conv,
max or average.

Counterpart of pytorchvideo_tpu/ops/token_pool.py. MViT pools its q/k/v
tokens through their (T, H, W) geometry, and its residual path through a max
pool; all of them go through one kernel with a mode argument.

- :func:`depthwise_token_pool_cuda`, :func:`max_token_pool_cuda` and
  :func:`avg_token_pool_cuda` launch the hand-written CUDA kernel
  (``csrc/token_pool.cu``, the port of the TPU kernel ``_pool_pallas_call``
  behind ``depthwise_token_pool_pallas``, ``max_token_pool_pallas`` and
  ``_avg_pool_ad``). Each counts its launches in its ``launches`` attribute,
  and per route in ``launches_by_route``.
- The ``*_torch`` functions are the plain versions: ``F.conv3d(groups=C)``,
  ``F.max_pool3d`` and ``F.avg_pool3d(count_include_pad=True)``, computed in
  float32 and returned in x's dtype, as the kernel does.
- :func:`depthwise_token_pool`, :func:`max_token_pool` and
  :func:`avg_token_pool` dispatch on the device of ``x``: a CPU tensor takes
  the plain version, a CUDA tensor the kernel (or the kernel's checks raise).
  Under tracing (``torch.export``, ``torch.compile``) without autograd they
  call the custom ops ``torch.ops.pvt.token_pool_conv``, ``token_pool_max``
  and ``token_pool_avg`` instead: one graph node each, the kernel's wrapper
  on CUDA tensors and the plain version (contiguous, as the kernel's output
  is) on CPU tensors.

The conv pool's backward: :func:`depthwise_token_pool_dx_cuda` and
:func:`depthwise_token_pool_dw_cuda` launch the hand-written kernels of
``csrc/token_pool_bwd.cu`` (the port of ``_input_grad_pallas`` and of the
TPU kernel ``_dw_kernel``); ``*_dx_torch`` and ``*_dw_torch`` are their plain
versions, explicit tap-by-tap sums in float32. Where autograd needs a
gradient, the dispatchers go through a ``torch.autograd.Function`` whose
forward and backward follow the device rule above. The max and avg pools'
backward is PyTorch's own (``F.max_pool3d`` / ``F.avg_pool3d`` under
autograd), as the JAX package leaves it to XLA.

Every kernel call takes one of two routes, chosen before the launch by
:func:`pool_route`; no route is tried after another fails:

- ``tiled``: float32 and bfloat16 with rows of whole 16-byte vectors
  (C * itemsize % 16 == 0), 16-byte aligned tensors and a kernel size in
  ``TILED_KERNELS``. A block owns a tile of the grid (rows x columns, picked
  by :func:`pool_tile_plan`) and a 64-channel slice, and walks T through a
  ring of planes in shared memory; dw is one launch. The ``*_tiled_torch``
  functions replay that walk (the tiles, slot maps, ring slots and, for dw,
  the block partials and their reduction order) in float32, for the tests.
- ``scalar``: the first version's kernels, for every other call.

x is (B, T, H, W, C); the padding is k // 2 on each axis (odd k <= 5, kt <= 3,
as the TPU kernel); any stride. The conv weight keeps PyTorch's depthwise
layout (Cw, 1, kt, kh, kw) with C a multiple of Cw: channel c uses row
c % Cw, so head-packed tokens (C = heads * head_dim) share one per-head
weight without a tiled copy.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Size3 = Tuple[int, int, int]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"conv": 0, "max": 1, "avg": 2}
# The scalar dw kernel's blocks (csrc/token_pool_bwd.cu): 32 channels each;
# it cuts the output positions into at most this many blocks' worth of chunks.
_DW_CHANNELS = 32
_DW_TARGET_BLOCKS = 1056
POOL_ROUTES = ("tiled", "scalar")
# The kernel sizes the tiled kernels instantiate: MViT's conv and max pools.
TILED_KERNELS = ((3, 3, 3), (1, 3, 3))
# The tiled kernels' blocks (csrc/pool_tiles.cuh): 64 channels (32 lanes x
# 2); tiles of at most POOL_MAX_TILE rows and columns whose ring fits
# POOL_SMEM_BUDGET (two blocks on each of the H100's SMs); enough tiles for
# POOL_TARGET_BLOCKS blocks (two waves of 132 SMs) where the grid allows.
# dw gives each slice at most DW_MAX_GROUPS blocks, so its last block sums
# few partials, and takes as many as the grid allows.
# At T stride 1 the ring holds kt + depth planes, so the copies of the next
# ``depth`` planes are in flight while one is computed (POOL_MAX_DEPTH at
# most, fewer where the walk is shorter; dw copies one ahead, which its
# extra g plane and its blocks' longer walks favour on the card).
POOL_SLICE = 64
POOL_MAX_TILE = 64
POOL_MAX_DEPTH = 2
POOL_SMEM_BUDGET = 96 * 1024
POOL_TARGET_BLOCKS = 264
DW_MAX_GROUPS = 32


def _triple(v) -> Size3:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def pool_out_size(d: int, k: int, s: int) -> int:
    """Output length of one axis at padding k // 2."""
    return (d + 2 * (k // 2) - k) // s + 1


def check_geometry(x_shape, kernel_size: Size3, stride: Size3) -> Size3:
    """Validates a pool of a (B, T, H, W, C) grid; returns the output (T2, H2, W2)."""
    if len(x_shape) != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got shape {tuple(x_shape)}")
    kt, kh, kw = kernel_size
    if not (kt in (1, 3) and kh in (1, 3, 5) and kw in (1, 3, 5)):
        raise ValueError(f"kernel must be odd with kt <= 3 and kh, kw <= 5, got {kernel_size}")
    if min(stride) < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    return tuple(pool_out_size(d, k, s) for d, k, s in zip(x_shape[1:4], kernel_size, stride))


def pool_route(dtype: torch.dtype, C: int, aligned: bool, kernel_size) -> str:
    """The route a CUDA call takes: ``tiled`` for float32 and bfloat16 when
    C makes rows of whole 16-byte vectors, every tensor is 16-byte aligned
    (``aligned``) and the kernel size is one of ``TILED_KERNELS``;
    ``scalar`` for every other call."""
    if dtype not in _KERNEL_DTYPES or not aligned or tuple(kernel_size) not in TILED_KERNELS:
        return "scalar"
    itemsize = 4 if dtype == torch.float32 else 2
    return "tiled" if (C * itemsize) % 16 == 0 else "scalar"


class PoolTilePlan(NamedTuple):
    """How the tiled kernels cut a grid (csrc/pool_tiles.cuh), in the order
    the kernels read them. A tile is ``tile_h x tile_w`` output positions
    (dx: super-blocks, see :func:`dx_super_range`); a plane of its ring holds
    ``rows x cols`` slots of a 64-channel slice (:func:`tile_slots`); step =
    min(s, k). The ring holds ``ring`` planes and the walk copies ``depth``
    planes ahead. ``groups``: dw's blocks per slice (0 otherwise)."""

    tile_h: int
    tile_w: int
    tiles_h: int
    tiles_w: int
    slices: int
    rows: int
    cols: int
    row_step: int
    col_step: int
    ring: int
    depth: int
    groups: int
    blocks: int
    smem_bytes: int


def _slots(n: int, k: int, s: int, kind: str) -> int:
    """Slots along one axis of a tile of n positions (dx: super-blocks)."""
    if kind == "dx":
        return n + (k - 1) // min(s, k)
    return (n - 1) * min(s, k) + k


def dx_super_range(D: int, k: int, s: int) -> Tuple[int, int]:
    """(first, count) of the dx kernel's super-blocks along an input axis of
    D: super-block m covers inputs s * m - k // 2 + r, r < s; an input with
    residue r takes the taps d = r + s * j < k, from output m - j. The first
    is the one that reaches input 0."""
    p = k // 2
    return p // s, (D - 1 + p) // s - p // s + 1


@functools.lru_cache(maxsize=None)
def pool_tile_plan(B: int, T: int, H: int, W: int, C: int, kernel_size, stride, dtype,
                   kind: str = "forward", tile=None) -> PoolTilePlan:
    """The tiled route's plan for a pool of a (B, T, H, W, C) grid of
    ``dtype``: ``kind`` "forward" and "dw" tile the output grid, "dx" its
    super-blocks (:func:`dx_super_range`). At T stride 1 the ring holds
    kt + depth planes, depth = min(POOL_MAX_DEPTH, the planes the walk
    visits) (dw: 1); otherwise two sets of kt (depth 1). dw adds depth + 1 g
    planes. The ring must fit POOL_SMEM_BUDGET. Among the tiles that fit, the
    plan takes those that give the most blocks up to POOL_TARGET_BLOCKS (dw:
    the most, with at most DW_MAX_GROUPS a slice), and of those the one that
    copies the fewest slots (the least halo); ``tile`` = (tile_h, tile_w)
    forces a tile (tests)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    if kind not in ("forward", "dx", "dw"):
        raise ValueError(f"kind must be forward, dx or dw, got {kind!r}")
    T2, H2, W2 = check_geometry((B, T, H, W, C), kernel_size, stride)
    (kt, kh, kw), (st, sh, sw) = kernel_size, stride
    itemsize = 4 if dtype == torch.float32 else 2
    slices = -(-C // POOL_SLICE)
    walk = T if kind == "dx" else T2
    depth = max(1, min(POOL_MAX_DEPTH, walk)) if st == 1 and kind != "dw" else 1
    ring = kt + depth if st == 1 else 2 * kt
    if kind == "dx":
        span_h, span_w = dx_super_range(H, kh, sh)[1], dx_super_range(W, kw, sw)[1]
    else:
        span_h, span_w = H2, W2
    steps = (min(sh, kh), min(sw, kw))

    def make(th: int, tw: int) -> PoolTilePlan:
        rows, cols = _slots(th, kh, sh, kind), _slots(tw, kw, sw, kind)
        slots = ring * rows * cols + ((depth + 1) * th * tw if kind == "dw" else 0)
        tiles_h, tiles_w = -(-span_h // th), -(-span_w // tw)
        units = B * tiles_h * tiles_w
        groups = min(units, DW_MAX_GROUPS) if kind == "dw" else 0
        return PoolTilePlan(th, tw, tiles_h, tiles_w, slices, rows, cols, *steps, ring, depth,
                            groups,
                            slices * (groups if kind == "dw" else units),
                            slots * POOL_SLICE * itemsize)

    if tile is not None:
        return make(*tile)
    best, best_key = make(1, 1), None
    max_h, max_w = max(1, min(span_h, POOL_MAX_TILE)), max(1, min(span_w, POOL_MAX_TILE))
    for th in range(1, max_h + 1):
        for tw in sorted({*range(2, max_w + 1, 2), max_w}):
            plan = make(th, tw)
            if plan.smem_bytes > POOL_SMEM_BUDGET:
                continue
            key = (-(plan.blocks if kind == "dw" else min(plan.blocks, POOL_TARGET_BLOCKS)),
                   plan.tiles_h * plan.tiles_w * plan.rows * plan.cols, -th * tw)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    return best


def tile_slots(first: int, n: int, k: int, s: int, step: int, kind: str = "forward"):
    """Coordinates of the slots that the n positions of one tile axis from
    ``first`` on read (an edge tile reads fewer than the plan holds room
    for). Forward and dw: output o's window starts at slot o * step, and
    slot j holds input coordinate first * s - k // 2 + (j // step) * s +
    j % step. dx (``first`` and n count super-blocks): the g rows
    first - (k - 1) // step .. first + n - 1. Coordinates outside the grid
    are the kernels' zero fill."""
    if kind == "dx":
        return list(range(first - (k - 1) // step, first + n))
    return [first * s - k // 2 + (j // step) * s + j % step for j in range((n - 1) * step + k)]


def _ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).float()


def depthwise_token_pool_torch(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """Plain version of the conv pool: ``F.conv3d(groups=C)`` in float32."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    check_geometry(x.shape, kernel_size, stride)
    C = x.shape[-1]
    w = weight.float().repeat(C // weight.shape[0], 1, 1, 1, 1)
    out = F.conv3d(_ncthw(x), w, stride=stride, padding=[k // 2 for k in kernel_size], groups=C)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def max_token_pool_torch(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Plain version of the max pool: ``F.max_pool3d`` (-inf padding)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    check_geometry(x.shape, kernel_size, stride)
    out = F.max_pool3d(_ncthw(x), kernel_size, stride, [k // 2 for k in kernel_size])
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def avg_token_pool_torch(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Plain version of the average pool: ``F.avg_pool3d`` with
    count_include_pad. The zero padding is explicit, because ``F.avg_pool3d``
    refuses an input axis shorter than the kernel even where the padding
    covers it (T = 2 under a 3-tap kernel)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    check_geometry(x.shape, kernel_size, stride)
    pads = [k // 2 for k in reversed(kernel_size) for _ in range(2)]
    out = F.avg_pool3d(F.pad(_ncthw(x), pads), kernel_size, stride)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def _tap_windows(kernel_size: Size3, stride: Size3, out_size: Size3):
    """For each tap (dt, dy, dx), the slices of the zero-padded input grid
    that the tap reads across the output grid."""
    for taps in itertools.product(*(range(k) for k in kernel_size)):
        yield taps, tuple(slice(d, d + s * (n - 1) + 1, s)
                          for d, s, n in zip(taps, stride, out_size))


def depthwise_token_pool_dx_torch(g: torch.Tensor, weight: torch.Tensor, x_shape, stride):
    """Plain input gradient of the conv pool: each tap scatters g times its
    weight back onto the padded input grid; float32, returned in g's dtype."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    B, T, H, W, C = x_shape
    pads = [k // 2 for k in kernel_size]
    w = weight.float()[:, 0].repeat(C // weight.shape[0], 1, 1, 1)  # (C, kt, kh, kw)
    gf = g.float()
    dx = gf.new_zeros((B, T + 2 * pads[0], H + 2 * pads[1], W + 2 * pads[2], C))
    for (dt, dy, dx_), window in _tap_windows(kernel_size, stride, tuple(g.shape[1:4])):
        dx[(slice(None), *window)] += gf * w[:, dt, dy, dx_]
    return dx[:, pads[0]:pads[0] + T, pads[1]:pads[1] + H, pads[2]:pads[2] + W].to(g.dtype)


def depthwise_token_pool_dw_torch(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride):
    """Plain weight gradient of the conv pool: per tap, the sum over the batch
    and the output grid of the tap's input window times g, then over the heads
    that share each weight row (c % Cw); float32, returned shaped and typed
    like ``weight``."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    C, Cw = x.shape[-1], weight.shape[0]
    pads = [0, 0] + [k // 2 for k in reversed(kernel_size) for _ in range(2)]
    xp = F.pad(x.float(), pads)
    gf = g.float()
    rows = [(xp[(slice(None), *window)] * gf).sum((0, 1, 2, 3))
            for _, window in _tap_windows(kernel_size, stride, tuple(g.shape[1:4]))]
    dw = torch.stack(rows, dim=1).reshape(C // Cw, Cw, -1).sum(0)
    return dw.reshape(weight.shape).to(weight.dtype)


def _gather_slots(plane: torch.Tensor, rows, cols) -> torch.Tensor:
    """plane[rows][:, cols] of an (H, W, c) float32 plane, zero where a slot's
    coordinate falls outside it (the kernels' cp.async zero fill)."""
    r, c = torch.tensor(rows, dtype=torch.long), torch.tensor(cols, dtype=torch.long)
    inside = ((r >= 0) & (r < plane.shape[0]))[:, None] & ((c >= 0) & (c < plane.shape[1]))[None]
    got = plane[r.clamp(0, plane.shape[0] - 1)][:, c.clamp(0, plane.shape[1] - 1)]
    return torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype))


class _Ring:
    """The kernels' plane ring: each slot remembers which plane it holds, so
    a replay that reads a plane the ring no longer holds fails."""

    def __init__(self, size: int):
        self.slots = [(None, None)] * size

    def put(self, slot: int, tag, plane: torch.Tensor) -> None:
        self.slots[slot] = (tag, plane)

    def get(self, slot: int, tag) -> torch.Tensor:
        held, plane = self.slots[slot]
        assert held == tag, f"ring slot {slot} holds plane {held}, not {tag}"
        return plane


def _tile_walk(plan: PoolTilePlan, B: int, extent_h: int, extent_w: int):
    """(b, first row, first column, rows, columns) of every tile, in the
    kernels' block order within a slice."""
    for b in range(B):
        for i in range(plan.tiles_h):
            for j in range(plan.tiles_w):
                h0, w0 = i * plan.tile_h, j * plan.tile_w
                yield b, h0, w0, min(plan.tile_h, extent_h - h0), min(plan.tile_w, extent_w - w0)


def _slice_channels(C: int, s: int, copy_vec: Optional[int] = None) -> torch.Tensor:
    """The channels of slice s. With ``copy_vec``, the channels its copies
    bring in, each copy ``copy_vec`` channels from the slice's start, those
    that start past C left out (load_plane's chunks): a copy that runs past
    C fails to index, one short of it leaves the slice short."""
    if copy_vec is None:
        return torch.arange(s * POOL_SLICE, min(C, (s + 1) * POOL_SLICE))
    assert POOL_SLICE % copy_vec == 0 and C % copy_vec == 0, (
        f"rows of {C} channels are no whole number of {copy_vec}-channel copies")
    starts = range(s * POOL_SLICE, (s + 1) * POOL_SLICE, copy_vec)
    return torch.cat([torch.arange(c, c + copy_vec) for c in starts if c < C])


def _fwd_slot(plan: PoolTilePlan, st: int, kt: int, t2: int, dt: int) -> int:
    return (t2 + dt) % plan.ring if st == 1 else (t2 % 2) * kt + dt


def _walk(plan: PoolTilePlan, n: int, load):
    """The kernels' walk over n planes: the first ``depth`` planes' copies,
    then before each plane the copies ``depth`` planes ahead; yields each
    plane's index once its copies are in."""
    for j in range(min(plan.depth, n)):
        load(j)
    for i in range(n):
        if i + plan.depth < n:
            load(i + plan.depth)
        yield i


def _load_fwd_planes(ring: _Ring, plan, xb, rows, cols, ch, kernel_size, stride, t2) -> None:
    """The forward's copies for output plane t2: the planes it reads that
    the ring does not hold yet (at T stride 1 only the last, after t2 = 0)."""
    kt, st, T = kernel_size[0], stride[0], xb.shape[0]
    for dt in range(kt):
        if st == 1 and t2 > 0 and dt < kt - 1:
            continue
        ti = t2 * st + dt - kt // 2
        if 0 <= ti < T:
            ring.put(_fwd_slot(plan, st, kt, t2, dt), ti, _gather_slots(xb[ti][..., ch], rows, cols))


def token_pool_tiled_torch(x: torch.Tensor, weight: Optional[torch.Tensor], kernel_size, stride,
                           mode: str, plan: Optional[PoolTilePlan] = None,
                           copy_vec: Optional[int] = None) -> torch.Tensor:
    """Plain replay of the tiled forward (tests only): for each slice and
    tile, :func:`pool_tile_plan`'s slots of each input plane through the
    ring, the taps read from slot o * step + d, max's padded taps left out by
    their coordinates, in float32; returned in x's dtype. ``copy_vec``: the
    channels of one copy, where the replay checks the copies' chunks
    (:func:`_slice_channels`)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    T2, H2, W2 = check_geometry(x.shape, kernel_size, stride)
    B, T, H, W, C = x.shape
    (kt, kh, kw), (st, sh, sw) = kernel_size, stride
    plan = plan or pool_tile_plan(B, T, H, W, C, kernel_size, stride, x.dtype)
    xf = x.float()
    out = torch.empty((B, T2, H2, W2, C))
    for s in range(plan.slices):
        ch = _slice_channels(C, s, copy_vec)
        if mode == "conv":
            wt = weight.float().reshape(weight.shape[0], -1)[ch % weight.shape[0]]  # (c, taps)
        for b, h0, w0, nh, nw in _tile_walk(plan, B, H2, W2):
            rows = tile_slots(h0, nh, kh, sh, plan.row_step)
            cols = tile_slots(w0, nw, kw, sw, plan.col_step)
            ring = _Ring(plan.ring)
            oy, ox = torch.arange(nh), torch.arange(nw)
            for t2 in _walk(plan, T2, lambda t: _load_fwd_planes(
                    ring, plan, xf[b], rows, cols, ch, kernel_size, stride, t)):
                acc = torch.full((nh, nw, len(ch)), -torch.inf if mode == "max" else 0.0)
                for dt in range(kt):
                    ti = t2 * st + dt - kt // 2
                    if not 0 <= ti < T:
                        continue
                    plane = ring.get(_fwd_slot(plan, st, kt, t2, dt), ti)
                    for dy in range(kh):
                        for dx in range(kw):
                            v = plane[oy * plan.row_step + dy][:, ox * plan.col_step + dx]
                            if mode == "conv":
                                acc = acc + v * wt[:, (dt * kh + dy) * kw + dx]
                            elif mode == "max":
                                y = (h0 + oy) * sh - kh // 2 + dy
                                xx = (w0 + ox) * sw - kw // 2 + dx
                                inside = ((y >= 0) & (y < H))[:, None] & ((xx >= 0) & (xx < W))[None]
                                acc = torch.maximum(acc, torch.where(inside[..., None], v, -torch.inf))
                            else:
                                acc = acc + v
                if mode == "avg":
                    acc = acc * (1.0 / (kt * kh * kw))
                out[b, t2, h0:h0 + nh, w0:w0 + nw, ch] = acc
    return out.to(x.dtype)


def _hits(q: int, s: int, n: int) -> bool:
    """Whether q = i + p - d is the whole output position q / s of an axis of n."""
    return q >= 0 and q % s == 0 and q // s < n


def depthwise_token_pool_dx_tiled_torch(g: torch.Tensor, weight: torch.Tensor, x_shape, stride,
                                        plan: Optional[PoolTilePlan] = None) -> torch.Tensor:
    """Plain replay of the tiled dx kernel (tests only): tiles of
    super-blocks (:func:`dx_super_range`), the g rows and columns that reach
    each tile through the ring, each residue's taps d = r + s * j from
    output m - j in gather form, zeros where no tap reaches; float32,
    returned in g's dtype."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    B, T, H, W, C = x_shape
    T2, H2, W2 = check_geometry(x_shape, kernel_size, stride)
    (kt, kh, kw), (st, sh, sw) = kernel_size, stride
    pt, ph, pw = (k // 2 for k in kernel_size)
    plan = plan or pool_tile_plan(B, T, H, W, C, kernel_size, stride, g.dtype, "dx")
    (mh, Mh), (mw, Mw) = dx_super_range(H, kh, sh), dx_super_range(W, kw, sw)
    jh, jw = (kh - 1) // plan.row_step, (kw - 1) // plan.col_step
    gf = g.float()
    dx = torch.empty((B, T, H, W, C))
    for s in range(plan.slices):
        ch = _slice_channels(C, s)
        wt = weight.float().reshape(weight.shape[0], kt, kh, kw)[ch % weight.shape[0]]

        def slot(ti, dt):
            return (ti - dt + kt) % plan.ring if st == 1 else (ti % 2) * kt + dt

        for b, a0, q0, nh, nw in _tile_walk(plan, B, Mh, Mw):
            m0, n0 = mh + a0, mw + q0
            rows = tile_slots(m0, nh, kh, sh, plan.row_step, "dx")
            cols = tile_slots(n0, nw, kw, sw, plan.col_step, "dx")
            ring = _Ring(plan.ring)

            def load(ti):
                for dt in range(kt):
                    if st == 1 and ti > 0 and dt > 0:
                        continue
                    if _hits(ti + pt - dt, st, T2):
                        to = (ti + pt - dt) // st
                        ring.put(slot(ti, dt), to, _gather_slots(gf[b, to][..., ch], rows, cols))

            a, q = torch.arange(nh), torch.arange(nw)
            for ti in _walk(plan, T, load):
                # The tile's inputs as (super-row, residue, super-column,
                # residue, channel); residues no tap reaches stay zero.
                tile = torch.zeros((nh, sh, nw, sw, len(ch)))
                for dt in range(kt):
                    if not _hits(ti + pt - dt, st, T2):
                        continue
                    plane = ring.get(slot(ti, dt), (ti + pt - dt) // st)
                    for ry, j in itertools.product(range(plan.row_step), range(jh + 1)):
                        for rx, i in itertools.product(range(plan.col_step), range(jw + 1)):
                            dy, dxx = ry + plan.row_step * j, rx + plan.col_step * i
                            if dy < kh and dxx < kw:
                                v = plane[a + jh - j][:, q + jw - i]
                                tile[:, ry, :, rx] += v * wt[:, dt, dy, dxx]
                tile = tile.reshape(nh * sh, nw * sw, len(ch))
                y0, x0 = sh * m0 - ph, sw * n0 - pw
                ys = slice(max(0, y0), min(H, y0 + nh * sh))
                xs = slice(max(0, x0), min(W, x0 + nw * sw))
                dx[b, ti, ys, xs, ch] = tile[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
    return dx.to(g.dtype)


def depthwise_token_pool_dw_tiled_torch(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                                        stride, plan: Optional[PoolTilePlan] = None):
    """Plain replay of the one-launch tiled dw kernel (tests only): block
    (slice, group) sums x's tap windows times g over its units (group,
    group + groups, ... of the (batch element, tile) units) through the
    forward's ring; each slice's partials are then summed in group order and
    the heads that share a weight row (c % Cw) in head order. float32,
    returned shaped and typed like ``weight``."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    B, T, H, W, C = x.shape
    T2, H2, W2 = check_geometry(x.shape, kernel_size, stride)
    (kt, kh, kw), (st, sh, sw) = kernel_size, stride
    taps, Cw = kt * kh * kw, weight.shape[0]
    plan = plan or pool_tile_plan(B, T, H, W, C, kernel_size, stride, x.dtype, "dw")
    xf, gf = x.float(), g.float()
    units = list(_tile_walk(plan, B, H2, W2))
    slice_sum = torch.zeros((taps, C))
    for s in range(plan.slices):
        ch = _slice_channels(C, s)
        partials = []
        for grp in range(plan.groups):
            part = torch.zeros((taps, len(ch)))
            for b, h0, w0, nh, nw in units[grp::plan.groups]:
                rows = tile_slots(h0, nh, kh, sh, plan.row_step)
                cols = tile_slots(w0, nw, kw, sw, plan.col_step)
                ring = _Ring(plan.ring)
                oy, ox = torch.arange(nh), torch.arange(nw)
                for t2 in _walk(plan, T2, lambda t: _load_fwd_planes(
                        ring, plan, xf[b], rows, cols, ch, kernel_size, stride, t)):
                    gt = gf[b, t2, h0:h0 + nh, w0:w0 + nw][..., ch]
                    for dt in range(kt):
                        ti = t2 * st + dt - kt // 2
                        if not 0 <= ti < T:
                            continue
                        plane = ring.get(_fwd_slot(plan, st, kt, t2, dt), ti)
                        for dy in range(kh):
                            for dx in range(kw):
                                v = plane[oy * plan.row_step + dy][:, ox * plan.col_step + dx]
                                part[(dt * kh + dy) * kw + dx] += (v * gt).sum((0, 1))
            partials.append(part)
        total = torch.zeros((taps, len(ch)))
        for part in partials:
            total = total + part
        slice_sum[:, ch] = total
    dw = torch.zeros((Cw, taps))
    for h in range(C // Cw):
        dw = dw + slice_sum[:, h * Cw:(h + 1) * Cw].T
    return dw.reshape(weight.shape).to(weight.dtype)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _choose(dtype, C: int, aligned: bool, kernel_size, route: Optional[str]) -> str:
    """``route`` if given (``scalar`` takes any call; ``tiled`` only what
    :func:`pool_route` sends there, else ValueError), else pool_route's."""
    chosen = pool_route(dtype, C, aligned, kernel_size)
    if route not in (None, *POOL_ROUTES):
        raise ValueError(f"route must be one of {POOL_ROUTES}, got {route!r}")
    if route == "tiled" and chosen != "tiled":
        raise ValueError(
            f"the tiled route takes float32 or bfloat16 with C * itemsize % 16 == 0, 16-byte "
            f"aligned tensors and a kernel in {TILED_KERNELS}; got {dtype}, C {C}, kernel "
            f"{tuple(kernel_size)}, aligned {aligned}")
    return route or chosen


_geometry = functools.lru_cache(maxsize=None)(check_geometry)


@functools.lru_cache(maxsize=None)
def _tiled_args(kind: str, shape, kernel_size: Size3, stride: Size3, Cw: int, mode: int, dtype):
    """The plan of a tiled call and the int32 array its entry point takes
    (B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, Cw, mode, dtype, then
    the plan), built once per call signature."""
    plan = pool_tile_plan(*shape, kernel_size, stride, dtype, kind)
    ints = (*shape, *_geometry(shape, kernel_size, stride), *kernel_size, *stride, Cw, mode,
            _KERNEL_DTYPES[dtype], *plan)
    return plan, (ctypes.c_int32 * len(ints))(*ints)


def _stream_and_guard(t: torch.Tensor):
    """The current stream's raw handle of t's device, and a device guard only
    where t is not on the current device: a training step makes 108 of these
    calls, so none builds a Stream object or a guard it does not need."""
    index = t.device.index
    same = index == torch.cuda.current_device()
    return (torch._C._cuda_getCurrentRawStream(index),
            contextlib.nullcontext() if same else torch.cuda.device(index))


def _launch(
    x: torch.Tensor, weight: Optional[torch.Tensor], kernel_size: Size3, stride: Size3, mode: str,
    route: Optional[str] = None,
):
    """Checks the inputs and launches the kernel of ``route`` (default:
    :func:`pool_route`'s) on the current stream; returns (out, route taken).

    Takes a contiguous CUDA x of float32 or bfloat16 and, for the conv mode,
    a contiguous weight (Cw, 1, kt, kh, kw) of x's dtype and device with C a
    multiple of Cw. Raises ValueError on anything else (and on ``tiled`` for
    a call that route does not take) and RuntimeError if the launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    T2, H2, W2 = _geometry(x.shape, kernel_size, stride)
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, T, H, W, C = x.shape
    Cw = 1
    if weight is not None:
        Cw = weight.shape[0]
        if weight.dim() != 5 or tuple(weight.shape[1:]) != (1, *kernel_size) or C % Cw:
            raise ValueError(
                f"weight must be (Cw, 1, kt, kh, kw) with {C} % Cw == 0, got {tuple(weight.shape)}"
            )
        if weight.get_device() != x.get_device() or weight.dtype != x.dtype:
            raise ValueError(
                f"weight must be {x.dtype} on {x.device}, got {weight.dtype} on {weight.device}"
            )
        if not weight.is_contiguous():
            raise ValueError("weight must be contiguous")
    route = _choose(x.dtype, C, _aligned(x), kernel_size, route)
    lib = load_library()
    out = torch.empty((B, T2, H2, W2, C), dtype=x.dtype, device=x.device)
    wptr = None if weight is None else weight.data_ptr()
    stream, guard = _stream_and_guard(x)
    with guard:
        if route == "tiled":
            _, args = _tiled_args("forward", x.shape, kernel_size, stride, Cw, _MODES[mode],
                                  x.dtype)
            err = lib.pvt_token_pool_tiled(x.data_ptr(), wptr, out.data_ptr(), args, stream)
        else:
            err = lib.pvt_token_pool(
                x.data_ptr(), wptr, out.data_ptr(), B, T, H, W, C, T2, H2, W2, *kernel_size,
                *stride, Cw, _MODES[mode], _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"token_pool ({mode}, {route}) kernel launch failed: cudaError {err}")
    return out, route


def _count(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1


def depthwise_token_pool_cuda(x: torch.Tensor, weight: torch.Tensor, stride,
                              route: Optional[str] = None) -> torch.Tensor:
    """Conv pool through the CUDA kernel; see :func:`_launch` for the checks
    and ``route``."""
    if weight is None:
        raise ValueError("the conv pool needs a weight")
    out, route = _launch(x, weight, tuple(weight.shape[2:]), _triple(stride), "conv", route)
    _count(depthwise_token_pool_cuda, route)
    return out


def max_token_pool_cuda(x: torch.Tensor, kernel_size, stride,
                        route: Optional[str] = None) -> torch.Tensor:
    """Max pool through the CUDA kernel; see :func:`_launch`."""
    out, route = _launch(x, None, _triple(kernel_size), _triple(stride), "max", route)
    _count(max_token_pool_cuda, route)
    return out


def avg_token_pool_cuda(x: torch.Tensor, kernel_size, stride,
                        route: Optional[str] = None) -> torch.Tensor:
    """Average pool through the CUDA kernel; see :func:`_launch`."""
    out, route = _launch(x, None, _triple(kernel_size), _triple(stride), "avg", route)
    _count(avg_token_pool_cuda, route)
    return out


def _check_bwd(named, weight: torch.Tensor, x_shape, g_shape, stride: Size3) -> None:
    """The backward kernels take contiguous CUDA tensors of one dtype
    (float32 or bfloat16), a weight (Cw, 1, kt, kh, kw) with C % Cw == 0 and
    g shaped as the pool of x; raises ValueError on anything else."""
    kernel_size = tuple(weight.shape[2:])
    out_size = _geometry(tuple(x_shape), kernel_size, stride)
    ref_name, ref = named[0]
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{ref_name} dtype must be float32 or bfloat16, got {ref.dtype}")
    if not ref.is_cuda:
        raise ValueError(f"{ref_name} must be a CUDA tensor, got device {ref.device}")
    for name, t in named + (("weight", weight),):
        if t.get_device() != ref.get_device() or t.dtype != ref.dtype:
            raise ValueError(
                f"{name} must be {ref.dtype} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.dim() != 5 or weight.shape[1] != 1 or x_shape[-1] % weight.shape[0]:
        raise ValueError(f"weight must be (Cw, 1, kt, kh, kw) with {x_shape[-1]} % Cw == 0, "
                         f"got {tuple(weight.shape)}")
    if tuple(g_shape) != (x_shape[0], *out_size, x_shape[-1]):
        raise ValueError(f"g must be {(x_shape[0], *out_size, x_shape[-1])}, got {tuple(g_shape)}")


def _geometry_args(x_shape, g_shape, weight, stride: Size3):
    return (*x_shape, *g_shape[1:4], *weight.shape[2:], *stride, weight.shape[0])


def depthwise_token_pool_dx_cuda(g: torch.Tensor, weight: torch.Tensor, x_shape, stride,
                                 route: Optional[str] = None):
    """Input gradient of the conv pool through the CUDA kernel of ``route``
    (default: :func:`pool_route`'s over g): dx shaped ``x_shape``, in g's
    dtype. Raises ValueError on inputs the kernel does not take,
    RuntimeError if the launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    stride, x_shape = _triple(stride), tuple(x_shape)
    _check_bwd((("g", g),), weight, x_shape, g.shape, stride)
    kernel_size = tuple(weight.shape[2:])
    route = _choose(g.dtype, x_shape[-1], _aligned(g), kernel_size, route)
    dx = torch.empty(x_shape, dtype=g.dtype, device=g.device)
    lib = load_library()
    pointers = (g.data_ptr(), weight.data_ptr(), dx.data_ptr())
    stream, guard = _stream_and_guard(g)
    with guard:
        if route == "tiled":
            _, args = _tiled_args("dx", x_shape, kernel_size, stride, weight.shape[0], 0, g.dtype)
            err = lib.pvt_token_pool_dx_tiled(*pointers, args, stream)
        else:
            err = lib.pvt_token_pool_dx(*pointers, *_geometry_args(x_shape, g.shape, weight, stride),
                                        _KERNEL_DTYPES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"token_pool dx ({route}) kernel launch failed: cudaError {err}")
    _count(depthwise_token_pool_dx_cuda, route)
    return dx


def dw_chunks(positions: int, channels: int) -> Tuple[int, int]:
    """(chunks, positions per chunk) of the scalar dw kernel's output positions."""
    channel_blocks = -(-channels // _DW_CHANNELS)
    chunks = max(1, min(-(-positions // 8), -(-_DW_TARGET_BLOCKS // channel_blocks)))
    per_chunk = max(1, -(-positions // chunks))
    return max(1, -(-positions // per_chunk)), per_chunk


# The tiled dw kernel's counters (one per slice, one for the slices), zero
# between calls: each call's last blocks reset them. One buffer per device.
_DW_COUNTERS = {}
_DW_COUNTER_SLOTS = 1024


def _dw_counters(device: torch.device) -> torch.Tensor:
    counters = _DW_COUNTERS.get(device.index)
    if counters is None:
        counters = torch.zeros(_DW_COUNTER_SLOTS, dtype=torch.int32, device=device)
        _DW_COUNTERS[device.index] = counters
    return counters


def depthwise_token_pool_dw_cuda(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride,
                                 route: Optional[str] = None):
    """Weight gradient of the conv pool through the CUDA kernels of ``route``
    (default: :func:`pool_route`'s over x and g): ``tiled`` in one launch
    (block partials summed by the last blocks, in a fixed order), ``scalar``
    in two (per-chunk partials, then a reduction over chunks and heads). dw
    is shaped and typed like ``weight``. Raises as
    :func:`depthwise_token_pool_dx_cuda`."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    stride = _triple(stride)
    _check_bwd((("x", x), ("g", g)), weight, tuple(x.shape), g.shape, stride)
    kernel_size = tuple(weight.shape[2:])
    route = _choose(x.dtype, x.shape[-1], _aligned(x, g), kernel_size, route)
    B, T2, H2, W2, C = g.shape
    taps = weight[0].numel()
    dw = torch.empty_like(weight)
    lib = load_library()
    if route == "tiled" and B * T2 * H2 * W2 == 0:
        return dw.zero_()  # no position: nothing to launch
    stream, guard = _stream_and_guard(x)
    with guard:
        if route == "tiled":
            plan, args = _tiled_args("dw", x.shape, kernel_size, stride, weight.shape[0], 0,
                                     x.dtype)
            if plan.slices + 1 > _DW_COUNTER_SLOTS:
                raise ValueError(f"the tiled dw kernel takes at most "
                                 f"{(_DW_COUNTER_SLOTS - 1) * POOL_SLICE} channels, got {C}")
            # One scratch buffer: the blocks' partials, then the slices' sums.
            scratch = torch.empty(plan.blocks * taps * POOL_SLICE + taps * C,
                                  dtype=torch.float32, device=x.device)
            err = lib.pvt_token_pool_dw_tiled(
                x.data_ptr(), g.data_ptr(), scratch.data_ptr(), _dw_counters(x.device).data_ptr(),
                dw.data_ptr(), args, stream)
        else:
            chunks, per_chunk = dw_chunks(B * T2 * H2 * W2, C)
            part = torch.empty((chunks, taps, C), dtype=torch.float32, device=x.device)
            err = lib.pvt_token_pool_dw(
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                *_geometry_args(tuple(x.shape), g.shape, weight, stride), chunks, per_chunk,
                _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"token_pool dw ({route}) kernel launch failed: cudaError {err}")
    _count(depthwise_token_pool_dw_cuda, route)
    return dw


for _wrapper in (depthwise_token_pool_cuda, max_token_pool_cuda, avg_token_pool_cuda,
                 depthwise_token_pool_dx_cuda, depthwise_token_pool_dw_cuda):
    _wrapper.launches = 0
    _wrapper.launches_by_route = dict.fromkeys(POOL_ROUTES, 0)


def depthwise_token_pool_dx(g: torch.Tensor, weight: torch.Tensor, x_shape, stride):
    """Input gradient of the conv pool. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if g.device.type == "cpu":
        return depthwise_token_pool_dx_torch(g, weight, x_shape, stride)
    return depthwise_token_pool_dx_cuda(g, weight, x_shape, stride)


def depthwise_token_pool_dw(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride):
    """Weight gradient of the conv pool. CPU tensors take the plain version;
    CUDA tensors the kernels."""
    if x.device.type == "cpu":
        return depthwise_token_pool_dw_torch(x, g, weight, stride)
    return depthwise_token_pool_dw_cuda(x, g, weight, stride)


class _ConvPool(torch.autograd.Function):
    """The conv pool with its backward (dx and dw): the kernels on the card,
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        if x.device.type == "cpu":
            return depthwise_token_pool_torch(x, weight, stride)
        return depthwise_token_pool_cuda(x, weight, stride)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_token_pool_dx(g, weight, x.shape, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = depthwise_token_pool_dw(x, g, weight, ctx.stride)
        return dx, dw, None


class _KernelPool(torch.autograd.Function):
    """The max or avg pool's kernel with PyTorch's own backward: the plain
    version under autograd, recomputed in x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel_size, stride, mode: str):
        ctx.save_for_backward(x)
        ctx.args = (kernel_size, stride, mode)
        if mode == "max":
            return max_token_pool_cuda(x, kernel_size, stride)
        return avg_token_pool_cuda(x, kernel_size, stride)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        kernel_size, stride, mode = ctx.args
        pad = [k // 2 for k in kernel_size]
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            ncthw = xr.permute(0, 4, 1, 2, 3)
            if mode == "max":
                out = F.max_pool3d(ncthw, kernel_size, stride, pad)
            else:
                pads = [p for p in reversed(pad) for _ in range(2)]
                out = F.avg_pool3d(F.pad(ncthw, pads), kernel_size, stride)
            (dx,) = torch.autograd.grad(out, xr, g.permute(0, 4, 1, 2, 3))
        return dx.contiguous(), None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def depthwise_token_pool(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """Depthwise conv pool of x (B, T, H, W, C) by weight (Cw, 1, kt, kh, kw),
    padding k // 2. CPU tensors take the plain versions; CUDA tensors the
    kernels, the backward included where autograd needs it. The JAX
    package's function takes its packed (kt, kh, kw, 1, C) weight, an
    explicit padding and ``use_pallas``; here the weight is the conv's, the
    padding is always k // 2 (MViT's pools) and the tensor's device picks
    the path."""
    if _needs_grad(x, weight):
        return _ConvPool.apply(x, weight, _triple(stride))
    if torch.compiler.is_compiling():
        return torch.ops.pvt.token_pool_conv(x, weight, list(_triple(stride)))
    if x.device.type == "cpu":
        return depthwise_token_pool_torch(x, weight, stride)
    return depthwise_token_pool_cuda(x, weight, stride)


def max_token_pool(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Max pool of x (B, T, H, W, C), padding k // 2 with -inf (MaxPool3d).
    CPU tensors take the plain version; CUDA tensors the kernel. The JAX
    package's function also takes ``padding`` and ``use_pallas``: here the
    padding is always k // 2 and the tensor's device picks the path."""
    if torch.compiler.is_compiling() and not _needs_grad(x):
        return torch.ops.pvt.token_pool_max(x, list(_triple(kernel_size)), list(_triple(stride)))
    if x.device.type == "cpu":
        return max_token_pool_torch(x, kernel_size, stride)
    if _needs_grad(x):
        return _KernelPool.apply(x, _triple(kernel_size), _triple(stride), "max")
    return max_token_pool_cuda(x, kernel_size, stride)


def avg_token_pool(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Average pool of x (B, T, H, W, C), padding k // 2, count_include_pad.
    CPU tensors take the plain version; CUDA tensors the kernel. The JAX
    package's function also takes ``padding`` and ``use_pallas``: here the
    padding is always k // 2 and the tensor's device picks the path."""
    if torch.compiler.is_compiling() and not _needs_grad(x):
        return torch.ops.pvt.token_pool_avg(x, list(_triple(kernel_size)), list(_triple(stride)))
    if x.device.type == "cpu":
        return avg_token_pool_torch(x, kernel_size, stride)
    if _needs_grad(x):
        return _KernelPool.apply(x, _triple(kernel_size), _triple(stride), "avg")
    return avg_token_pool_cuda(x, kernel_size, stride)


def _pooled_like(x, kernel_size, stride):
    """The fake (and the kernel's) output of a pool of x: contiguous."""
    return x.new_empty(
        (x.shape[0], *check_geometry(x.shape, tuple(kernel_size), tuple(stride)), x.shape[4]))


@torch.library.custom_op("pvt::token_pool_conv", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor weight, int[] stride) -> Tensor")
def _conv_pool_op(x, weight, stride):
    return depthwise_token_pool_torch(x, weight, stride).contiguous()


@_conv_pool_op.register_kernel("cuda")
def _(x, weight, stride):
    return depthwise_token_pool_cuda(x, weight, stride)


@_conv_pool_op.register_fake
def _(x, weight, stride):
    return _pooled_like(x, weight.shape[2:], stride)


@torch.library.custom_op("pvt::token_pool_max", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, int[] kernel_size, int[] stride) -> Tensor")
def _max_pool_op(x, kernel_size, stride):
    return max_token_pool_torch(x, kernel_size, stride).contiguous()


@_max_pool_op.register_kernel("cuda")
def _(x, kernel_size, stride):
    return max_token_pool_cuda(x, kernel_size, stride)


@torch.library.custom_op("pvt::token_pool_avg", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, int[] kernel_size, int[] stride) -> Tensor")
def _avg_pool_op(x, kernel_size, stride):
    return avg_token_pool_torch(x, kernel_size, stride).contiguous()


@_avg_pool_op.register_kernel("cuda")
def _(x, kernel_size, stride):
    return avg_token_pool_cuda(x, kernel_size, stride)


_max_pool_op.register_fake(_pooled_like)
_avg_pool_op.register_fake(_pooled_like)
