"""pytorchvideo_tpu_torch.ops.token_pool against the JAX package's token
pool: the Pallas kernel in interpret mode (``depthwise_token_pool_pallas``,
``max_token_pool_pallas`` and ``_avg_pool_ad``, as
tests/test_ops_token_pool.py runs them) and the XLA paths, at MViT-B's pool
strides with narrow channels, plus the CUDA wrappers' checks that run
without a card. The kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.

The tiled route is held here by its plan and its arithmetic: the route
chooser, the tile plan at every MViT-B 16x4 pool geometry (chip_smoke's
MVIT_POOLS) and ``token_pool_tiled_torch``, the replay of the tiled walk,
against the plain versions and the JAX kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_tpu.layers.common import avg_pool3d as jax_avg_pool3d
from pytorchvideo_tpu.layers.common import max_pool3d as jax_max_pool3d
from pytorchvideo_tpu.ops.token_pool import (
    _avg_pool_ad,
    _xla_depthwise_pool,
    depthwise_token_pool_pallas,
    max_token_pool_pallas,
)
from chip_smoke import MVIT_POOLS, needed_positions
from pytorchvideo_tpu_torch.layers.common import max_pool3d
from pytorchvideo_tpu_torch.ops import token_pool as tp

# f32: at most 27 products of O(1) values per output, summed in another order.
ATOL = 2e-5

# (input grid (B, T, H, W, C), kernel, stride): MViT-B's kv pool strides
# (1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1) and its skip pool (1, 3, 3) /
# (1, 2, 2), on narrow grids; one odd geometry with a T stride.
GEOMETRIES = [
    ((2, 4, 16, 16, 8), (3, 3, 3), (1, 8, 8)),
    ((2, 4, 12, 12, 8), (3, 3, 3), (1, 4, 4)),
    ((2, 4, 9, 9, 8), (3, 3, 3), (1, 2, 2)),
    ((2, 3, 7, 7, 8), (3, 3, 3), (1, 1, 1)),
    ((2, 4, 9, 8, 6), (1, 3, 3), (1, 2, 2)),
    ((1, 5, 9, 11, 4), (3, 5, 3), (2, 3, 2)),
]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape, kernel, stride", GEOMETRIES)
def test_conv_pool_matches_jax(shape, kernel, stride):
    # The weight is per head channel (c = C / 2 rows), shared by 2 heads, as
    # MViT's head-packed pools share it; the JAX kernel takes it head-tiled.
    x = _x(shape, seed=0)
    C = shape[-1]
    w = (np.random.default_rng(1).normal(size=(C // 2, 1, *kernel)) * 0.3).astype(np.float32)
    out = tp.depthwise_token_pool(torch.from_numpy(x), torch.from_numpy(w), stride)
    w_packed = jnp.asarray(np.tile(np.transpose(w[:, 0], (1, 2, 3, 0)), (1, 1, 1, 2)))
    padding = tuple(k // 2 for k in kernel)
    pallas = depthwise_token_pool_pallas(jnp.asarray(x), w_packed, stride, padding, interpret=True)
    xla = _xla_depthwise_pool(jnp.asarray(x), w_packed, stride, padding)
    assert out.shape == pallas.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)


@pytest.mark.parametrize("shape, kernel, stride", GEOMETRIES)
def test_max_pool_matches_jax(shape, kernel, stride):
    x = _x(shape, seed=2)
    out = tp.max_token_pool(torch.from_numpy(x), kernel, stride)
    padding = tuple(k // 2 for k in kernel)
    pallas = max_token_pool_pallas(jnp.asarray(x), kernel, stride, padding, interpret=True)
    xla = jax_max_pool3d(jnp.asarray(x), kernel, stride, padding)
    assert out.shape == pallas.shape
    # A max picks one of its inputs: exact.
    np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(out.numpy(), np.asarray(xla))


@pytest.mark.parametrize("shape, kernel, stride", GEOMETRIES)
def test_avg_pool_matches_jax(shape, kernel, stride):
    x = _x(shape, seed=3)
    out = tp.avg_token_pool(torch.from_numpy(x), kernel, stride)
    padding = tuple(k // 2 for k in kernel)
    pallas = _avg_pool_ad(jnp.asarray(x), kernel, stride, padding, True)
    xla = jax_avg_pool3d(jnp.asarray(x), kernel, stride, padding)
    assert out.shape == pallas.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)


def test_max_pool_pads_with_minus_infinity():
    # All-negative input: a zero pad would win at every border output.
    x = -1.0 - torch.rand(1, 3, 5, 5, 2)
    out = tp.max_token_pool(x, (3, 3, 3), (1, 2, 2))
    assert (out < 0).all()
    ncthw = max_pool3d(x.permute(0, 4, 1, 2, 3), (3, 3, 3), (1, 2, 2), (1, 1, 1))
    torch.testing.assert_close(out, ncthw.permute(0, 2, 3, 4, 1), atol=0, rtol=0)


def test_bf16_is_computed_in_f32():
    x = torch.from_numpy(_x((1, 2, 6, 6, 4), seed=4))
    w = torch.from_numpy(_x((4, 1, 3, 3, 3), seed=5))
    for pool, args in ((tp.depthwise_token_pool, (w, (1, 2, 2))),
                       (tp.avg_token_pool, ((3, 3, 3), (1, 2, 2)))):
        low = pool(x.bfloat16(), *[a.bfloat16() if torch.is_tensor(a) else a for a in args])
        ref = pool(x.bfloat16().float(), *[a.bfloat16().float() if torch.is_tensor(a) else a
                                           for a in args])
        assert low.dtype == torch.bfloat16
        torch.testing.assert_close(low, ref.bfloat16(), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    x = torch.zeros(1, 2, 4, 4, 4)
    wrappers = (tp.depthwise_token_pool_cuda, tp.max_token_pool_cuda, tp.avg_token_pool_cuda)
    before = [f.launches for f in wrappers]
    tp.depthwise_token_pool(x, torch.zeros(4, 1, 3, 3, 3), (1, 2, 2))
    tp.max_token_pool(x, (1, 3, 3), (1, 2, 2))
    tp.avg_token_pool(x, (3, 3, 3), (1, 1, 1))
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize(
    "call, message",
    [
        (lambda x: tp.max_token_pool_cuda(x, (3, 3, 3), (1, 2, 2)), "CUDA tensor"),
        (lambda x: tp.avg_token_pool_cuda(x.double(), (3, 3, 3), (1, 2, 2)),
         "float32 or bfloat16"),
        (lambda x: tp.depthwise_token_pool_cuda(x, None, (1, 2, 2)), "needs a weight"),
        (lambda x: tp.max_token_pool(x, (2, 3, 3), (1, 2, 2)), "kernel must be odd"),
        (lambda x: tp.avg_token_pool(x, (3, 7, 3), (1, 2, 2)), "kernel must be odd"),
        (lambda x: tp.max_token_pool(x, (3, 3, 3), (1, 0, 2)), "stride must be positive"),
        (lambda x: tp.max_token_pool(x[0], (3, 3, 3), (1, 2, 2)), r"\(B, T, H, W, C\)"),
    ],
)
def test_bad_inputs_raise(call, message):
    with pytest.raises(ValueError, match=message):
        call(torch.zeros(1, 3, 6, 6, 4))


@pytest.mark.parametrize("dtype, C, aligned, kernel, route", [
    (torch.bfloat16, 96, True, (3, 3, 3), "tiled"),
    (torch.float32, 96, True, (1, 3, 3), "tiled"),
    (torch.bfloat16, 8, True, (3, 3, 3), "tiled"),  # one 16-byte vector a row
    (torch.float32, 12, True, (3, 3, 3), "tiled"),  # 48-byte rows
    (torch.bfloat16, 12, True, (3, 3, 3), "scalar"),  # 24-byte rows
    (torch.float32, 8, True, (3, 3, 3), "tiled"),
    (torch.float32, 6, True, (3, 3, 3), "scalar"),
    (torch.float16, 96, True, (3, 3, 3), "scalar"),
    (torch.float64, 96, True, (3, 3, 3), "scalar"),
    (torch.bfloat16, 96, False, (3, 3, 3), "scalar"),
    (torch.bfloat16, 96, True, (3, 5, 3), "scalar"),
    (torch.bfloat16, 96, True, (1, 1, 1), "scalar"),
])
def test_pool_route(dtype, C, aligned, kernel, route):
    assert tp.pool_route(dtype, C, aligned, kernel) == route


def test_pool_route_sees_a_view_off_16_bytes():
    # A contiguous view one element past a 16-byte boundary is not aligned.
    flat = torch.zeros(1 + 2 * 3 * 4 * 4 * 8)
    for x, aligned in ((flat[:-1].view(2, 3, 4, 4, 8), True), (flat[1:].view(2, 3, 4, 4, 8), False)):
        assert (x.data_ptr() % 16 == 0) == aligned
        assert tp.pool_route(x.dtype, 8, tp._aligned(x), (3, 3, 3)) == (
            "tiled" if aligned else "scalar")


def _axis_cover(extent: int, tile: int, tiles: int):
    """Each position of [0, extent) in exactly one tile of the axis."""
    seen = [t * tile + i for t in range(tiles) for i in range(min(tile, extent - t * tile))]
    assert sorted(seen) == list(range(extent))


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("geometry", MVIT_POOLS, ids=lambda g: "x%s_k%s_s%s_%s_%d" % g)
def test_pool_tile_plan_at_mvit_geometries(geometry, B):
    grid, kernel, stride, _, _ = geometry
    T, H, W, C = grid
    out = tp.check_geometry((B, *grid), kernel, stride)
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        for kind in ("forward", "dx", "dw"):
            plan = tp.pool_tile_plan(B, T, H, W, C, kernel, stride, dtype, kind)
            assert plan.slices * tp.POOL_SLICE >= C > (plan.slices - 1) * tp.POOL_SLICE
            # The ring (and dw's two g planes) fits the budget.
            ring = plan.ring * plan.rows * plan.cols + ((plan.depth + 1) * plan.tile_h * plan.tile_w
                                                        if kind == "dw" else 0)
            assert plan.smem_bytes == ring * tp.POOL_SLICE * itemsize <= tp.POOL_SMEM_BUDGET
            assert plan.depth == (min(tp.POOL_MAX_DEPTH, T if kind == "dx" else out[0])
                                  if stride[0] == 1 and kind != "dw" else 1)
            assert plan.ring == (kernel[0] + plan.depth if stride[0] == 1 else 2 * kernel[0])
            spans = ((tp.dx_super_range(H, kernel[1], stride[1])[1],
                      tp.dx_super_range(W, kernel[2], stride[2])[1]) if kind == "dx" else out[1:])
            assert max(plan.tile_h, plan.tile_w) <= tp.POOL_MAX_TILE
            # The tiles cover every output (dx: input) position exactly once.
            _axis_cover(spans[0], plan.tile_h, plan.tiles_h)
            _axis_cover(spans[1], plan.tile_w, plan.tiles_w)
            if kind == "dw":
                assert 1 <= plan.groups <= min(tp.DW_MAX_GROUPS, B * plan.tiles_h * plan.tiles_w)
                assert plan.blocks == plan.slices * plan.groups
            else:
                assert plan.blocks == B * plan.slices * plan.tiles_h * plan.tiles_w
            axes = ((H, kernel[1], stride[1], out[1], plan.tile_h, plan.tiles_h, plan.rows,
                     plan.row_step),
                    (W, kernel[2], stride[2], out[2], plan.tile_w, plan.tiles_w, plan.cols,
                     plan.col_step))
            for D, k, s, n_out, tile, tiles, slots, step in axes:
                assert step == min(s, k)
                assert len(tp.tile_slots(0, tile, k, s, step, kind)) <= slots
                if kind == "dx":
                    # The tiles' super-blocks cover each input once, and each
                    # tap that reaches an input reads a g slot of its tile.
                    first, count = tp.dx_super_range(D, k, s)
                    covered = []
                    for t in range(tiles):
                        m0, n = first + t * tile, min(tile, count - t * tile)
                        coords = tp.tile_slots(m0, n, k, s, step, "dx")
                        assert len(coords) <= slots
                        inputs = [i for i in range(s * m0 - k // 2, s * (m0 + n) - k // 2)
                                  if 0 <= i < D]
                        covered += inputs
                        for i in inputs:
                            for d in range(k):
                                q = i + k // 2 - d
                                if q >= 0 and q % s == 0 and q // s < n_out:
                                    assert q // s in coords
                    assert sorted(covered) == list(range(D))
                    continue
                # Output o's tap d reads slot o * step + d, which holds its
                # input coordinate; the slots in the grid, over all tiles, are
                # exactly the positions some output reads.
                read = set()
                for t in range(tiles):
                    coords = tp.tile_slots(t * tile, min(tile, n_out - t * tile), k, s, step)
                    for o in range(min(tile, n_out - t * tile)):
                        for d in range(k):
                            assert coords[o * step + d] == (t * tile + o) * s - k // 2 + d
                    read |= {c for c in coords if 0 <= c < D}
                assert len(read) == needed_positions(D, k, s, n_out)
                assert read == {o * s + d - k // 2 for o in range(n_out) for d in range(k)} & set(
                    range(D))


# The tiled walk's ragged cases, each with a forced tile: H2 not a multiple of
# the tile rows, W2 not of its columns; T = 2 under kt = 3; C = 96 (a ragged
# 32-channel slice); a T stride (two sets of kt ring slots).
TILED_CASES = [
    ((2, 4, 16, 16, 8), (3, 3, 3), (1, 8, 8), (1, 2)),
    ((2, 4, 12, 12, 8), (3, 3, 3), (1, 4, 4), (2, 2)),
    ((2, 4, 13, 11, 8), (3, 3, 3), (1, 2, 2), (3, 4)),
    ((2, 2, 7, 9, 8), (3, 3, 3), (1, 1, 1), (4, 4)),
    ((1, 3, 6, 6, 96), (3, 3, 3), (1, 2, 2), (2, 2)),
    ((2, 4, 9, 8, 6), (1, 3, 3), (1, 2, 2), (2, 3)),
    ((1, 5, 9, 11, 4), (3, 3, 3), (2, 3, 2), (2, 2)),
]


@pytest.mark.parametrize("mode", ["conv", "max", "avg"])
@pytest.mark.parametrize("shape, kernel, stride, tile", TILED_CASES)
def test_tiled_walk_matches_plain_and_jax(shape, kernel, stride, tile, mode):
    x = _x(shape, seed=6)
    C = shape[-1]
    Cw = C // 2 if C % 2 == 0 else C
    w = (np.random.default_rng(7).normal(size=(Cw, 1, *kernel)) * 0.3).astype(np.float32)
    wt = torch.from_numpy(w) if mode == "conv" else None
    plan = tp.pool_tile_plan(*shape, kernel, stride, torch.float32, tile=tile)
    got = tp.token_pool_tiled_torch(torch.from_numpy(x), wt, kernel, stride, mode, plan=plan)
    padding = tuple(k // 2 for k in kernel)
    if mode == "conv":
        plain = tp.depthwise_token_pool_torch(torch.from_numpy(x), wt, stride)
        w_packed = jnp.asarray(np.tile(np.transpose(w[:, 0], (1, 2, 3, 0)), (1, 1, 1, C // Cw)))
        jax_out = depthwise_token_pool_pallas(jnp.asarray(x), w_packed, stride, padding,
                                              interpret=True)
    elif mode == "max":
        plain = tp.max_token_pool_torch(torch.from_numpy(x), kernel, stride)
        jax_out = max_token_pool_pallas(jnp.asarray(x), kernel, stride, padding, interpret=True)
    else:
        plain = tp.avg_token_pool_torch(torch.from_numpy(x), kernel, stride)
        jax_out = _avg_pool_ad(jnp.asarray(x), kernel, stride, padding, True)
    assert got.shape == plain.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=ATOL)


def test_tiled_max_leaves_padding_out_by_coordinates():
    # All-negative input at a tile on the grid's edge: the zero-filled slots
    # of the padding must not win.
    x = -1.0 - torch.rand(1, 3, 5, 7, 8)
    plan = tp.pool_tile_plan(1, 3, 5, 7, 8, (3, 3, 3), (1, 1, 1), torch.float32, tile=(2, 2))
    out = tp.token_pool_tiled_torch(x, None, (3, 3, 3), (1, 1, 1), "max", plan=plan)
    assert (out < 0).all()
    torch.testing.assert_close(out, tp.max_token_pool_torch(x, (3, 3, 3), (1, 1, 1)), atol=0, rtol=0)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tiled_walk_reads_only_planes_its_ring_holds(depth):
    # The ring of kt + depth planes holds every plane until its last reader
    # (the replay checks each read); one plane short, the copies ahead
    # overwrite a plane an output plane still reads, and the replay catches it.
    x = torch.randn(1, 8, 6, 6, 8)
    plan = tp.pool_tile_plan(1, 8, 6, 6, 8, (3, 3, 3), (1, 1, 1), torch.float32)._replace(
        depth=depth, ring=3 + depth)
    torch.testing.assert_close(tp.token_pool_tiled_torch(x, None, (3, 3, 3), (1, 1, 1), "max",
                                                         plan=plan),
                               tp.max_token_pool_torch(x, (3, 3, 3), (1, 1, 1)), atol=0, rtol=0)
    with pytest.raises(AssertionError, match="ring slot"):
        tp.token_pool_tiled_torch(x, None, (3, 3, 3), (1, 1, 1), "max",
                                  plan=plan._replace(ring=plan.ring - 1))
