"""pytorchvideo_tpu_torch.ops.depthwise_conv against the JAX package's
depthwise3x3x3_bn_swish (Pallas kernel in interpret mode, and its XLA form),
plus the CUDA wrapper's checks and build plumbing that run without a card.
The kernel itself is tested on the card by tests/test_torch_kernels_cuda.py.

The tiled route is held here by its plan and its arithmetic: the route
chooser and the copy width, the tile plan at X3D-S's four stride-1 stage
shapes, and ``depthwise3x3x3_tiled_torch``, the replay of the tiled walk
(ring slots and copy chunks included), against the plain version and the JAX
kernel in interpret mode."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_tpu.ops.depthwise_conv import (
    depthwise3x3x3_bn_swish_pallas,
    depthwise3x3x3_bn_swish_xla,
)
from chip_smoke import STAGE_SHAPES
from pytorchvideo_tpu_torch.ops import _build
from pytorchvideo_tpu_torch.ops import depthwise_conv as dc
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.ops.depthwise_conv import (
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
)

def _inputs(C, affine, seed=0, B=2, T=4, S=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, S, S, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, C)) * 0.2).astype(np.float32)
    s = rng.uniform(0.5, 1.5, C).astype(np.float32) if affine else None
    b = (rng.normal(size=C) * 0.1).astype(np.float32) if affine else None
    return x, w, s, b


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("C", [5, 54])
@pytest.mark.parametrize("apply_swish", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_depthwise_matches_jax(C, apply_swish, affine):
    # Same atol as tests/test_ops_depthwise_conv.py (f32, 27-tap sums of O(1)).
    x, w, s, b = _inputs(C, affine)
    out = depthwise3x3x3_bn_swish(_torch(x), _torch(w), _torch(s), _torch(b), apply_swish)
    assert out.shape == x.shape and out.dtype == torch.float32
    args = (jnp.asarray(x), jnp.asarray(w), _jnp(s), _jnp(b), apply_swish)
    pallas = depthwise3x3x3_bn_swish_pallas(*args, interpret=True)
    xla = depthwise3x3x3_bn_swish_xla(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=2e-5)


# The tiled walk's ragged cases, (B, T, H, W, C) and a forced tile (None:
# the plan's own): H and W not multiples of the tile; T = 2 under kt = 3;
# C = 54 (a ragged 54-channel slice, 8-byte f32 copies), C = 108 (two
# slices, the second ragged), C = 216 (four slices, the last of 24).
TILED_CASES = [
    ((2, 4, 7, 9, 8), (3, 4)),
    ((1, 2, 6, 5, 8), (4, 2)),
    ((1, 3, 5, 6, 54), (2, 4)),
    ((1, 3, 4, 4, 108), (3, 3)),
    ((1, 2, 3, 4, 216), None),
]


def _tiled_plan(shape, tile, dtype=torch.float32):
    return tp.pool_tile_plan(*shape, (3, 3, 3), (1, 1, 1), dtype, tile=tile)


@pytest.mark.parametrize("apply_swish", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("shape, tile", TILED_CASES)
def test_tiled_walk_matches_plain_and_jax(shape, tile, affine, apply_swish):
    # f32, the atol of test_depthwise_matches_jax.
    C = shape[-1]
    _, w, s, b = _inputs(C, affine, seed=3)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    got = dc.depthwise3x3x3_tiled_torch(_torch(x), _torch(w), _torch(s), _torch(b), apply_swish,
                                        plan=_tiled_plan(shape, tile))
    plain = depthwise3x3x3_bn_swish(_torch(x), _torch(w), _torch(s), _torch(b), apply_swish)
    assert got.shape == x.shape and got.dtype == torch.float32
    args = (jnp.asarray(x), jnp.asarray(w), _jnp(s), _jnp(b), apply_swish)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        depthwise3x3x3_bn_swish_pallas(*args, interpret=True)), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(depthwise3x3x3_bn_swish_xla(*args)),
                               atol=2e-5)


@pytest.mark.parametrize("shape, tile", TILED_CASES[2:4])
def test_tiled_walk_copies_bf16_rows_at_4_and_8_bytes(shape, tile):
    # bf16 rows of 54 and 108 channels are copied 4 and 8 bytes at a time;
    # the replay gathers each slice chunk by chunk at that width. Against the
    # plain version in f32 on the same bf16 values, the replay differs by
    # its one rounding of the output to bf16 (2^-8 relative, half an ulp).
    C = shape[-1]
    assert dc.depthwise_copy_bytes(torch.bfloat16, C) == {54: 4, 108: 8}[C]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=shape).astype(np.float32)).bfloat16()
    _, w, s, b = _inputs(C, True, seed=6)
    w, s, b = (torch.from_numpy(a).bfloat16() for a in (w, s, b))
    got = dc.depthwise3x3x3_tiled_torch(x, w, s, b, True,
                                        plan=_tiled_plan(shape, tile, torch.bfloat16))
    ref = dc.depthwise3x3x3_bn_swish_torch(x.float(), w.float(), s.float(), b.float(), True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, atol=1e-6, rtol=2**-8)


def test_tiled_walk_refuses_copies_that_split_a_row():
    # 16-byte copies (8 bf16 channels) of 54-channel rows would run past C
    # at every position: the replay's chunk check refuses them.
    x = torch.randn(1, 2, 3, 3, 54)
    w = torch.randn(54, 1, 3, 3, 3)
    plan = _tiled_plan(x.shape, None, torch.bfloat16)
    with pytest.raises(AssertionError, match="no whole number"):
        tp.token_pool_tiled_torch(x, w, (3, 3, 3), (1, 1, 1), "conv", plan=plan, copy_vec=8)


@pytest.mark.parametrize("dtype, C, width", [
    (torch.bfloat16, 54, 4), (torch.bfloat16, 108, 8), (torch.bfloat16, 216, 16),
    (torch.bfloat16, 432, 16), (torch.float32, 54, 8), (torch.float32, 108, 16),
    (torch.float32, 5, 4), (torch.bfloat16, 5, 0), (torch.float16, 64, 0),
])
def test_depthwise_copy_bytes(dtype, C, width):
    assert dc.depthwise_copy_bytes(dtype, C) == width


@pytest.mark.parametrize("dtype, C, aligned, route", [
    (torch.bfloat16, 54, True, "tiled"),
    (torch.bfloat16, 108, True, "tiled"),
    (torch.bfloat16, 216, True, "tiled"),
    (torch.float32, 54, True, "tiled"),
    (torch.float32, 432, True, "tiled"),
    (torch.bfloat16, 54, False, "scalar"),
    (torch.float32, 108, False, "scalar"),
    (torch.float32, 5, True, "scalar"),
    (torch.bfloat16, 5, True, "scalar"),
    (torch.float16, 54, True, "scalar"),
    (torch.float64, 54, True, "scalar"),
])
def test_depthwise_route(dtype, C, aligned, route):
    assert dc.depthwise_route(dtype, C, aligned) == route


@pytest.mark.parametrize("C, offset, aligned", [(54, 0, True), (54, 1, False), (54, 2, True),
                                                (108, 2, False), (108, 4, True), (216, 4, False)])
def test_depthwise_route_sees_a_view_off_the_copy_width(C, offset, aligned):
    # bf16 elements past the start of a buffer the allocator aligned: the
    # copy width (4, 8, 16 bytes at C = 54, 108, 216) decides.
    flat = torch.zeros(offset + 2 * 3 * 3 * C + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    x = flat[offset:offset + 2 * 3 * 3 * C].view(1, 2, 3, 3, C)
    assert dc._aligned(x) == aligned
    assert dc.depthwise_route(x.dtype, C, dc._aligned(x)) == ("tiled" if aligned else "scalar")


@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: "T%dS%dC%d" % s)
def test_tiled_plan_at_x3d_s_stage_shapes(shape, B):
    # The token pool's plan at kernel (3, 3, 3), stride 1: the ring of
    # 3 + depth planes of (tile + 2)^2 slots fits POOL_SMEM_BUDGET, the tiles
    # cover the plane once, and the blocks cover every (b, tile, slice).
    T, S, C = shape
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        plan = tp.pool_tile_plan(B, T, S, S, C, (3, 3, 3), (1, 1, 1), dtype)
        assert plan.depth == min(tp.POOL_MAX_DEPTH, T) and plan.ring == 3 + plan.depth
        assert (plan.rows, plan.cols) == (plan.tile_h + 2, plan.tile_w + 2)
        assert plan.smem_bytes == plan.ring * plan.rows * plan.cols * tp.POOL_SLICE * itemsize
        assert plan.smem_bytes <= tp.POOL_SMEM_BUDGET
        assert plan.slices == -(-C // tp.POOL_SLICE)
        for tile, tiles in ((plan.tile_h, plan.tiles_h), (plan.tile_w, plan.tiles_w)):
            assert 0 < tile <= tp.POOL_MAX_TILE and (tiles - 1) * tile < S <= tiles * tile
        assert plan.blocks == B * plan.slices * plan.tiles_h * plan.tiles_w > 0
        if B == 128:
            assert plan.blocks >= tp.POOL_TARGET_BLOCKS


def test_depthwise_borders_are_zero_padded():
    # A single 1 at a corner: the output is the tap pattern cut at the border.
    x = torch.zeros(1, 2, 3, 3, 1)
    x[0, 0, 0, 0, 0] = 1.0
    w = torch.arange(27, dtype=torch.float32).reshape(3, 3, 3, 1)
    out = depthwise3x3x3_bn_swish(x, w)
    # out[t, h, w] = x[0,0,0] * w[1 - t, 1 - h, 1 - w] where that tap exists.
    expect = torch.zeros(2, 3, 3)
    for t in range(2):
        for h in range(2):
            for ww in range(2):
                expect[t, h, ww] = w[1 - t, 1 - h, 1 - ww, 0]
    torch.testing.assert_close(out[0, ..., 0], expect)


@pytest.mark.parametrize(
    "kwargs, message",
    [
        (dict(), "CUDA tensor"),
        (dict(x_shape=(2, 3, 4, 4)), r"\(B, T, H, W, C\)"),
        (dict(dtype=torch.float64), "float32 or bfloat16"),
    ],
)
def test_cuda_wrapper_rejects_bad_inputs(kwargs, message):
    x = torch.zeros(kwargs.get("x_shape", (1, 2, 3, 3, 4)), dtype=kwargs.get("dtype", torch.float32))
    with pytest.raises(ValueError, match=message):
        depthwise3x3x3_bn_swish_cuda(x, torch.zeros(3, 3, 3, 4))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc stand-in: writes its -o file, or fails on one source."""
    nvcc = tmp_path / "nvcc"
    fail = ""
    if fail_on:
        fail = f'case "$*" in *{fail_on}*) echo "error in {fail_on}"; exit 2;; esac\n'
    nvcc.write_text(
        "#!/bin/sh\n" + fail
        + 'args="$*"\n'
        + 'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then echo "$args" > "$2"; fi; shift; done\n'
    )
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    # The sources get a directory of their own: the library's hash covers
    # every file there, and the nvcc stand-in lives beside it.
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    so = _build.build_library()
    assert so == _build.library_path() and so.is_file()
    # The link step takes one object per source.
    link_args = so.read_text()
    assert "-shared" in link_args and "a.o" in link_args and "b.o" in link_args
    assert [p.name for p in (tmp_path / "build").iterdir()] == [so.name]

    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path, fail_on="b.cu"))
    (csrc / "b.cu").write_text("// b, edited\n")
    with pytest.raises(RuntimeError, match="error in b.cu"):
        _build.build_library()
    assert not _build.library_path().exists()


def test_library_path_follows_source_hash(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_path_follows_header_hash(monkeypatch, tmp_path):
    # A header the sources include is hashed too: an edited one is rebuilt.
    (tmp_path / "k.cu").write_text('#include "tiles.cuh"\n')
    header = tmp_path / "tiles.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    header.write_text("// two\n")
    assert _build.library_path() != first
