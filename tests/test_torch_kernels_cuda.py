"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so that on a machine with a card and no JAX it runs alone,
from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import importlib
import math

import pytest
import torch

from pytorchvideo_tpu_torch.accelerate import DepthwiseConv3x3x3BnAct
from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.ops import depthwise_conv as dc
from pytorchvideo_tpu_torch.ops.depthwise_conv import (
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
    depthwise3x3x3_bn_swish_torch,
)

# The module (the package exports the JAX package's function under its name).
pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

# X3D-S stride-1 conv_b shapes at 13x160x160: (T, H=W, C) per stage.
X3D_S_SHAPES = [(13, 40, 54), (13, 20, 108), (13, 10, 216), (13, 5, 432)]
# f32: summation order only. bf16: the reference takes the same bf16 inputs
# in f32, so the kernel differs by the rounding of its output (2^-7 relative
# at worst for one bf16 ulp).
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-3, rtol=2**-7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", X3D_S_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, dtype):
    T, S, C = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, T, S, S, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, 3, C, device=cuda, generator=g) * 0.2).to(dtype)
    s = (torch.rand(C, device=cuda, generator=g) + 0.5).to(dtype)
    b = (torch.randn(C, device=cuda, generator=g) * 0.1).to(dtype)
    for swish in (False, True):
        for scale, bias in ((None, None), (s, b)):
            out = depthwise3x3x3_bn_swish(x, w, scale, bias, swish)
            ref = depthwise3x3x3_bn_swish_torch(
                x.float(),
                w.float(),
                None if scale is None else scale.float(),
                None if bias is None else bias.float(),
                swish,
            )
            assert out.dtype == dtype and out.shape == x.shape
            torch.testing.assert_close(out.float(), ref, **TOL[dtype])


@pytest.mark.cuda
def test_module_counts_one_launch_per_call(cuda):
    C = 54
    g = torch.Generator(device=cuda).manual_seed(1)
    module = DepthwiseConv3x3x3BnAct(
        torch.randn(3, 3, 3, C, device=cuda, generator=g),
        torch.randn(C, device=cuda, generator=g),
        apply_swish=True,
    )
    x = torch.randn(1, C, 13, 40, 40, device=cuda, generator=g)
    before = depthwise3x3x3_bn_swish_cuda.launches
    out = module(x)
    assert depthwise3x3x3_bn_swish_cuda.launches == before + 1
    ref = depthwise3x3x3_bn_swish_torch(
        x.permute(0, 2, 3, 4, 1), module.weight, None, module.bias, True
    ).permute(0, 4, 1, 2, 3)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


@pytest.mark.cuda
def test_kernel_rejects_mixed_dtypes(cuda):
    x = torch.zeros(1, 2, 3, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="must be torch.float32"):
        depthwise3x3x3_bn_swish(x, torch.zeros(3, 3, 3, 4, device=cuda, dtype=torch.bfloat16))


def _depthwise_inputs(cuda, B, T, H, W, C, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, T, H, W, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, 3, C, device=cuda, generator=g) * 0.2).to(dtype)
    s = (torch.rand(C, device=cuda, generator=g) + 0.5).to(dtype)
    b = (torch.randn(C, device=cuda, generator=g) * 0.1).to(dtype)
    return x, w, s, b


def _depthwise_ref(x, w, scale, bias, swish):
    return depthwise3x3x3_bn_swish_torch(
        x.float(), w.float(), None if scale is None else scale.float(),
        None if bias is None else bias.float(), swish)


# (T, H, W, C): X3D-S's four stage shapes, and two ragged grids (T = 2
# under kt = 3; H and W off the tiles with C = 110, a 4-byte bf16 row).
DEPTHWISE_GRIDS = [(T, S, S, C) for T, S, C in X3D_S_SHAPES] + [(2, 7, 9, 8), (5, 13, 11, 110)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", DEPTHWISE_GRIDS, ids=lambda g: "T%dH%dW%dC%d" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_depthwise_route_matches_plain(cuda, grid, dtype):
    # At B2, swish and the affine each on and off: one launch each, on the
    # tiled route.
    T, H, W, C = grid
    x, w, s, b = _depthwise_inputs(cuda, 2, T, H, W, C, dtype, seed=20)
    assert dc.depthwise_route(dtype, C, dc._aligned(x)) == "tiled"
    for swish in (False, True):
        for scale, bias in ((None, None), (s, b), (None, b)):
            out = _routed(depthwise3x3x3_bn_swish_cuda,
                          lambda: depthwise3x3x3_bn_swish(x, w, scale, bias, swish), "tiled")
            assert out.dtype == dtype and out.shape == x.shape
            torch.testing.assert_close(out.float(), _depthwise_ref(x, w, scale, bias, swish),
                                       **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", X3D_S_SHAPES, ids=lambda s: "T%dS%dC%d" % s)
def test_forced_scalar_depthwise_matches_tiled(cuda, shape):
    # The first version stays callable on the tiled route's inputs (the
    # smoke run times it beside the tiled kernel), at B8 bf16.
    T, S, C = shape
    x, w, _, b = _depthwise_inputs(cuda, 8, T, S, S, C, torch.bfloat16, seed=21)
    tiled = _routed(depthwise3x3x3_bn_swish_cuda,
                    lambda: depthwise3x3x3_bn_swish_cuda(x, w, None, b, True), "tiled")
    scalar = _routed(depthwise3x3x3_bn_swish_cuda,
                     lambda: depthwise3x3x3_bn_swish_cuda(x, w, None, b, True, route="scalar"),
                     "scalar")
    ref = _depthwise_ref(x, w, None, b, True)
    for out in (tiled, scalar):
        torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_depthwise_calls_off_the_tiled_route_take_scalar(cuda):
    # A view one bf16 element off the 4-byte copy width of C = 54, an odd C,
    # and float16 (which no route takes) go to the first version or raise;
    # asking for tiled there raises.
    x, w, s, b = _depthwise_inputs(cuda, 2, 4, 9, 9, 54, torch.bfloat16, seed=22)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    off = buf[1:].view(x.shape).copy_(x)
    odd = _depthwise_inputs(cuda, 2, 4, 9, 9, 5, torch.bfloat16, seed=23)
    for args in ((off, w, s, b), odd):
        assert dc.depthwise_route(args[0].dtype, args[0].shape[-1], dc._aligned(args[0])) == "scalar"
        out = _routed(depthwise3x3x3_bn_swish_cuda,
                      lambda: depthwise3x3x3_bn_swish_cuda(*args, True), "scalar")
        torch.testing.assert_close(out.float(), _depthwise_ref(*args, True), **TOL[torch.bfloat16])
        with pytest.raises(ValueError, match="tiled route takes"):
            depthwise3x3x3_bn_swish_cuda(*args, True, route="tiled")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        depthwise3x3x3_bn_swish_cuda(x.half(), w.half())


# MViT-B 16x4 attention shapes (H*c, heads, Lq, Lk; Lk counts the cls row),
# the cls query (Lq 1), and MViT-B 32x3 block 14.
MVIT_ATTENTION = [
    (96, 1, 25088, 393), (192, 2, 6272, 1569), (192, 2, 6272, 393), (384, 4, 1568, 1569),
    (384, 4, 1568, 393), (768, 8, 392, 1569), (768, 8, 392, 393), (768, 8, 1, 1569),
    (96, 1, 1, 393), (768, 8, 784, 3137),
]
# f32: summation order only. bf16: the reference takes the same bf16 inputs
# in f32, so the kernel differs by the rounding of its output.
ATTN_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-3, rtol=2**-7)}


def _qkv(cuda, B, Lq, Lk, HC, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, L, HC, device=cuda, generator=g).to(dtype) for L in (Lq, Lk, Lk))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MVIT_ATTENTION, ids=lambda s: "hc%d_h%d_q%d_k%d" % s)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_matches_plain(cuda, shape, dtype):
    HC, heads, Lq, Lk = shape
    q, k, v = _qkv(cuda, 2, Lq, Lk, HC, dtype, seed=2)
    scale = (HC // heads) ** -0.5
    for residual in (False, True):
        before = pa.pooled_attention_packed_cuda.launches
        out = pa.pooled_attention_packed(q, k, v, heads, scale, residual)
        assert pa.pooled_attention_packed_cuda.launches == before + 1
        ref = pa.pooled_attention_packed_torch(q.float(), k.float(), v.float(), heads, scale, residual)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref, **ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MVIT_ATTENTION[::3] + [(40, 1, 77, 5), (256, 2, 130, 65)],
                         ids=lambda s: "hc%d_h%d_q%d_k%d" % s)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_head_attention_matches_plain(cuda, shape, dtype):
    HC, heads, Lq, Lk = shape
    c = HC // heads
    q, k, v = (t.reshape(2, -1, heads, c).transpose(1, 2).contiguous()
               for t in _qkv(cuda, 2, Lq, Lk, HC, dtype, seed=3))
    for residual in (False, True):
        before = pa.pooled_attention_cuda.launches
        out = pa.pooled_attention(q, k, v, c ** -0.5, residual)
        assert pa.pooled_attention_cuda.launches == before + 1
        ref = pa.pooled_attention_torch(q.float(), k.float(), v.float(), c ** -0.5, residual)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref, **ATTN_TOL[dtype])


# The bf16 routes at ragged edges: query rows on both sides of the split-key
# bound and of the 64- and 128-row tiles, keys from one to past a 64-key
# tile, head widths the tensor-core tiles pad (40) or fill.
ROUTE_LQ = [1, 2, 63, 65, 129]


@pytest.mark.cuda
@pytest.mark.parametrize("Lk", [1, 9, 393, 1569])
@pytest.mark.parametrize("c", [32, 40, 64, 96, 128])
def test_bf16_routes_match_plain(cuda, c, Lk):
    # Each call moves its route's counter (and the total) by one; the output
    # matches the plain version in f32 on the same bf16 inputs, the lse
    # attention_lse_torch, in both layouts, residual on and off.
    heads = 2
    g = torch.Generator(device=cuda).manual_seed(c + Lk)
    for Lq in ROUTE_LQ:
        q, k, v = (torch.randn(2, L, heads * c, device=cuda, generator=g).bfloat16()
                   for L in (Lq, Lk, Lk))
        route = pa.forward_route(torch.bfloat16, Lq, c)
        assert route == ("split_key" if Lq <= pa.SPLIT_MAX_LQ else "tensor_core")
        per_head = [pa._heads(t, heads).contiguous() for t in (q, k, v)]
        ref_lse = pa.attention_lse_torch(*(t.float() for t in per_head[:2]), c**-0.5)
        for residual in (False, True):
            for wrapper, args, plain, to_heads in (
                (pa.pooled_attention_packed_cuda, (q, k, v, heads),
                 pa.pooled_attention_packed_torch, lambda t: pa._heads(t, heads)),
                (pa.pooled_attention_cuda, per_head, pa.pooled_attention_torch, lambda t: t),
            ):
                before = wrapper.launches, dict(wrapper.launches_by_route)
                out, lse = wrapper(*args, c**-0.5, residual, return_lse=True)
                assert wrapper.launches == before[0] + 1
                assert wrapper.launches_by_route == {
                    r: n + (r == route) for r, n in before[1].items()}
                ref = plain(*(t.float() for t in args[:3]), *args[3:], c**-0.5, residual)
                assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
                torch.testing.assert_close(out.float(), ref, **ATTN_TOL[torch.bfloat16])
                torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_bf16_calls_off_the_vector_routes_take_the_cuda_cores(cuda):
    # c % 8 != 0, and a view 2 bytes off 16-byte alignment, are routed to the
    # CUDA-core kernel before the launch; asking the bf16 routes for them
    # raises, as does the split-key route past SPLIT_MAX_LQ rows.
    g = torch.Generator(device=cuda).manual_seed(14)
    narrow = [torch.randn(2, L, 2 * 36, device=cuda, generator=g).bfloat16() for L in (70, 9, 9)]
    flat = torch.randn(3 * 2 * 70 * 192 + 1, device=cuda, generator=g).bfloat16()
    off = [flat[1 + i * 2 * 70 * 192:1 + (i + 1) * 2 * 70 * 192].view(2, 70, 192) for i in range(3)]
    assert off[0].data_ptr() % 16 != 0 and all(t.is_contiguous() for t in off)
    for (q, k, v), c in ((narrow, 36), (off, 96)):
        before = dict(pa.pooled_attention_packed_cuda.launches_by_route)
        out = pa.pooled_attention_packed(q, k, v, 2, c**-0.5, True)
        after = pa.pooled_attention_packed_cuda.launches_by_route
        assert after == {r: n + (r == "cuda_core") for r, n in before.items()}
        ref = pa.pooled_attention_packed_torch(q.float(), k.float(), v.float(), 2, c**-0.5, True)
        torch.testing.assert_close(out.float(), ref, **ATTN_TOL[torch.bfloat16])
        strides = (70 * 2 * c, c, 2 * c) * 4
        for route in ("tensor_core", "split_key"):
            with pytest.raises(ValueError, match=f"the {route} route takes bfloat16"):
                pa._launch(q, k, v, 2, c, strides, c**-0.5, True, False, route=route)
    q, k, v = _qkv(cuda, 1, pa.SPLIT_MAX_LQ + 1, 9, 64, torch.bfloat16, seed=15)
    with pytest.raises(ValueError, match="at most"):
        pa._launch(q, k, v, 1, 64, (9 * 64, 64, 64) * 4, 0.1, False, False, route="split_key")


@pytest.mark.cuda
def test_attention_rejects_bad_inputs(cuda):
    q, k, v = _qkv(cuda, 1, 8, 4, 64, torch.float32, seed=4)
    with pytest.raises(ValueError, match="contiguous"):
        pa.pooled_attention_packed(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 1, 1.0)
    with pytest.raises(ValueError, match="must be torch.float32"):
        pa.pooled_attention_packed(q, k.bfloat16(), v, 1, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.pooled_attention_packed_cuda(q.double(), k.double(), v.double(), 1, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pa.pooled_attention_packed_cuda(q.cpu(), k.cpu(), v.cpu(), 1, 1.0)
    with pytest.raises(ValueError, match="head_dim"):
        pa.pooled_attention_packed(*_qkv(cuda, 1, 8, 4, 160, torch.float32, seed=5), 1, 1.0)


# MViT-B 16x4 pools: (input grid T, H, W, C), kernel, stride, and the weight's
# rows (the per-head width 96 that head-packed channels share).
MVIT_POOLS = [
    ((8, 56, 56, 96), (3, 3, 3), (1, 8, 8)),
    ((8, 56, 56, 192), (3, 3, 3), (1, 4, 4)),
    ((8, 56, 56, 192), (3, 3, 3), (1, 2, 2)),
    ((8, 28, 28, 192), (3, 3, 3), (1, 4, 4)),
    ((8, 28, 28, 384), (3, 3, 3), (1, 2, 2)),
    ((8, 14, 14, 384), (3, 3, 3), (1, 2, 2)),
    ((8, 14, 14, 768), (3, 3, 3), (1, 2, 2)),
    ((8, 14, 14, 768), (3, 3, 3), (1, 1, 1)),
    ((8, 7, 7, 768), (3, 3, 3), (1, 1, 1)),
    ((8, 56, 56, 192), (1, 3, 3), (1, 2, 2)),
    ((8, 28, 28, 384), (1, 3, 3), (1, 2, 2)),
    ((8, 14, 14, 768), (1, 3, 3), (1, 2, 2)),
    ((5, 9, 11, 64), (3, 5, 3), (2, 3, 2)),
]
POOL_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-3, rtol=2**-7)}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", MVIT_POOLS, ids=lambda g: "x%s_k%s_s%s" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_pool_matches_plain(cuda, geometry, dtype):
    grid, kernel, stride = geometry
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, *grid, device=cuda, generator=g).to(dtype)
    C = grid[-1]
    w = (torch.randn(min(C, 96), 1, *kernel, device=cuda, generator=g) * 0.2).to(dtype)
    cases = [
        (tp.depthwise_token_pool, tp.depthwise_token_pool_cuda,
         lambda a: tp.depthwise_token_pool_torch(a, w.float(), stride), (w, stride)),
        (tp.max_token_pool, tp.max_token_pool_cuda,
         lambda a: tp.max_token_pool_torch(a, kernel, stride), (kernel, stride)),
        (tp.avg_token_pool, tp.avg_token_pool_cuda,
         lambda a: tp.avg_token_pool_torch(a, kernel, stride), (kernel, stride)),
    ]
    for dispatch, wrapper, plain, args in cases:
        before = wrapper.launches
        out = dispatch(x, *args)
        assert wrapper.launches == before + 1
        ref = plain(x.float())
        assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
        torch.testing.assert_close(out.float(), ref, **POOL_TOL[dtype])


@pytest.mark.cuda
def test_token_pool_rejects_bad_inputs(cuda):
    x = torch.zeros(1, 4, 6, 6, 8, device=cuda)
    w = torch.zeros(8, 1, 3, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tp.depthwise_token_pool(x.transpose(2, 3), w, (1, 2, 2))
    with pytest.raises(ValueError, match="must be torch.float32"):
        tp.depthwise_token_pool(x, w.bfloat16(), (1, 2, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tp.max_token_pool_cuda(x.double(), (3, 3, 3), (1, 2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.avg_token_pool_cuda(x.cpu(), (3, 3, 3), (1, 2, 2))
    with pytest.raises(ValueError, match="Cw, 1, kt"):
        tp.depthwise_token_pool(x, torch.zeros(3, 1, 3, 3, 3, device=cuda), (1, 1, 1))


def _close(out, ref, rtol, atol_rel):
    """Elementwise: |out - ref| <= atol_rel * max |ref| + rtol * |ref|."""
    torch.testing.assert_close(out.float(), ref, rtol=rtol,
                               atol=atol_rel * ref.abs().max().item() + 1e-12)


# Backward vs its plain version in f32 on the same inputs. f32: sums over up
# to Lq (dk, dv) or Lk (dq) rows in another order. bf16: each gradient is
# rounded once to bf16 (2^-8 relative), on top of the f32 sums.
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol_rel=1e-5),
            torch.bfloat16: dict(rtol=2**-7, atol_rel=2e-3)}
# (H*c, heads, Lq, Lk): MViT's c = 96 with a grid and a cls query, a ragged Lq
# and Lk, narrow and wide head widths; and MViT-B's largest shape, taken at B1.
BWD_SHAPES = [(192, 2, 200, 57), (192, 2, 1, 57), (96, 1, 130, 393), (64, 2, 65, 64),
              (256, 2, 77, 5), (768, 8, 1, 393), (96, 1, 25088, 393)]
BWD_B1 = {(96, 1, 25088, 393)}


def _bwd_call(wrapper, call, route):
    """Runs ``call``; asserts that the backward ``wrapper`` launched once in
    it, on ``route``."""
    before = wrapper.launches, dict(wrapper.launches_by_route)
    got = call()
    assert wrapper.launches == before[0] + 1
    assert wrapper.launches_by_route == {r: n + (r == route) for r, n in before[1].items()}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "hc%d_h%d_q%d_k%d" % s)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_matches_plain(cuda, shape, dtype):
    HC, heads, Lq, Lk = shape
    B = 1 if shape in BWD_B1 else 2
    c = HC // heads
    route = pa.backward_route(dtype, Lq, c)
    q, k, v = _qkv(cuda, B, Lq, Lk, HC, dtype, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    g = torch.randn(B, Lq, HC, device=cuda, generator=gen).to(dtype)
    per_head = [t.reshape(B, -1, heads, c).transpose(1, 2).contiguous() for t in (q, k, v, g)]
    for residual in (False, True):
        # Head-packed.
        o, lse = pa.pooled_attention_packed_cuda(q, k, v, heads, c**-0.5, residual, return_lse=True)
        ref_lse = pa.attention_lse_torch(*(t.float() for t in per_head[:2]), c**-0.5)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
        got = _bwd_call(pa.pooled_attention_packed_bwd_cuda,
                        lambda: pa.pooled_attention_packed_bwd(
                            q, k, v, o, lse, g, heads, c**-0.5, residual), route)
        ref = pa.pooled_attention_packed_bwd_torch(
            *(t.float() for t in (q, k, v, o)), lse, g.float(), heads, c**-0.5, residual)
        for a, b, t in zip(got, ref, (q, k, v)):
            assert a.dtype == dtype and a.shape == t.shape
            _close(a, b, **GRAD_TOL[dtype])
        # Per-head.
        qh, kh, vh, gh = per_head
        o, lse = pa.pooled_attention_cuda(qh, kh, vh, c**-0.5, residual, return_lse=True)
        got = _bwd_call(pa.pooled_attention_bwd_cuda,
                        lambda: pa.pooled_attention_bwd(qh, kh, vh, o, lse, gh, c**-0.5, residual),
                        route)
        ref = pa.pooled_attention_bwd_torch(
            *(t.float() for t in (qh, kh, vh, o)), lse, gh.float(), c**-0.5, residual)
        for a, b in zip(got, ref):
            _close(a, b, **GRAD_TOL[dtype])


# The backward's bf16 routes at ragged edges: query rows on both sides of
# the split-key bound and of the 64- and 192-row tiles, keys from one to
# past several 128-key blocks, head widths the tiles pad (40) or fill.
BWD_ROUTE_LQ = [2, 8, 9, 63, 65, 129]


def _close_grads(got, ref, Lk, residual):
    """(dq, dk, dv) against the plain backward in f32 under the bf16
    GRAD_TOL. At one key without the residual the saved output is v itself,
    so ds = p (g.v - g.o) and with it dq and dk are exactly zero: the f32
    reference holds only its own rounding noise there, and they are held to
    the bf16 bound of dv, whose scale the same inputs set. (With the
    residual, o = bf16(v + q) and the reference's ds is the rounding of o,
    which both sides see.)"""
    tol = GRAD_TOL[torch.bfloat16]
    for i, (a, b) in enumerate(zip(got, ref)):
        if Lk == 1 and i < 2 and not residual:
            assert a.float().abs().max().item() <= tol["atol_rel"] * ref[2].abs().max().item()
        else:
            _close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Lk", [1, 9, 1569])
@pytest.mark.parametrize("c", [32, 40, 64, 128])
def test_bf16_backward_routes_match_plain(cuda, c, Lk):
    # Each call moves its route's counter (and the total) by one; dq, dk and
    # dv match the plain backward in f32 on the same bf16 inputs, in both
    # layouts, residual on and off.
    heads = 2
    gen = torch.Generator(device=cuda).manual_seed(c + Lk)
    for Lq in BWD_ROUTE_LQ:
        q, k, v, g = (torch.randn(2, L, heads * c, device=cuda, generator=gen).bfloat16()
                      for L in (Lq, Lk, Lk, Lq))
        route = pa.backward_route(torch.bfloat16, Lq, c)
        assert route == ("split_key" if Lq <= pa.SPLIT_MAX_LQ else "tensor_core")
        per_head = [pa._heads(t, heads).contiguous() for t in (q, k, v, g)]
        for residual in (False, True):
            o, lse = pa.pooled_attention_packed_cuda(q, k, v, heads, c**-0.5, residual,
                                                     return_lse=True)
            got = _bwd_call(pa.pooled_attention_packed_bwd_cuda,
                            lambda: pa.pooled_attention_packed_bwd_cuda(
                                q, k, v, o, lse, g, heads, c**-0.5, residual), route)
            ref = pa.pooled_attention_packed_bwd_torch(
                *(t.float() for t in (q, k, v, o)), lse, g.float(), heads, c**-0.5, residual)
            for a, t in zip(got, (q, k, v)):
                assert a.dtype == torch.bfloat16 and a.shape == t.shape
            _close_grads(got, ref, Lk, residual)
            o, lse = pa.pooled_attention_cuda(*per_head[:3], c**-0.5, residual, return_lse=True)
            got = _bwd_call(pa.pooled_attention_bwd_cuda,
                            lambda: pa.pooled_attention_bwd_cuda(
                                *per_head[:3], o, lse, per_head[3], c**-0.5, residual), route)
            ref = pa.pooled_attention_bwd_torch(
                *(t.float() for t in (*per_head[:3], o)), lse, per_head[3].float(), c**-0.5,
                residual)
            _close_grads(got, ref, Lk, residual)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq, Lk", [(1, 1569), (3, 393), (1000, 393), (392, 1569)])
def test_bf16_backward_is_deterministic(cuda, Lq, Lk):
    # No atomics: two calls give the same bits, whether the dk/dv kernel
    # splits the q axis (1000 x 393) or not (392 x 1569 at 8 heads), and on
    # the split-key route.
    heads, c = 8, 96
    q, k, v = _qkv(cuda, 2, Lq, Lk, heads * c, torch.bfloat16, seed=16)
    g = torch.randn_like(q)
    o, lse = pa.pooled_attention_packed_cuda(q, k, v, heads, c**-0.5, True, return_lse=True)
    first = pa.pooled_attention_packed_bwd_cuda(q, k, v, o, lse, g, heads, c**-0.5, True)
    second = pa.pooled_attention_packed_bwd_cuda(q, k, v, o, lse, g, heads, c**-0.5, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_backward_off_the_vector_routes_takes_the_cuda_cores(cuda):
    # c % 8 != 0, and views 2 bytes off 16-byte alignment, are routed to the
    # CUDA-core kernels before the launch; asking the bf16 routes for them
    # raises, as does the split-key route past SPLIT_MAX_LQ rows.
    gen = torch.Generator(device=cuda).manual_seed(17)
    narrow = [torch.randn(2, L, 2 * 36, device=cuda, generator=gen).bfloat16()
              for L in (70, 9, 9, 70)]
    n = 2 * 70 * 192
    flat = torch.randn(4 * n + 1, device=cuda, generator=gen).bfloat16()
    off = [flat[1 + i * n:1 + (i + 1) * n].view(2, 70, 192) for i in range(4)]
    assert off[0].data_ptr() % 16 != 0 and all(t.is_contiguous() for t in off)
    for (q, k, v, g), c in ((narrow, 36), (off, 96)):
        o, lse = pa.pooled_attention_packed_cuda(q, k, v, 2, c**-0.5, True, return_lse=True)
        got = _bwd_call(pa.pooled_attention_packed_bwd_cuda,
                        lambda: pa.pooled_attention_packed_bwd_cuda(
                            q, k, v, o, lse, g, 2, c**-0.5, True), "cuda_core")
        ref = pa.pooled_attention_packed_bwd_torch(
            *(t.float() for t in (q, k, v, o)), lse, g.float(), 2, c**-0.5, True)
        for a, b in zip(got, ref):
            _close(a, b, **GRAD_TOL[torch.bfloat16])
        sq, sk = pa._packed_strides(q, k, 2)
        for route in ("tensor_core", "split_key"):
            with pytest.raises(ValueError, match=f"the {route} route takes bfloat16"):
                pa._launch_bwd(q, k, v, o, lse, g, 2, c, sq, sk, c**-0.5, True, route=route)
    q, k, v = _qkv(cuda, 1, pa.SPLIT_MAX_LQ + 1, 9, 64, torch.bfloat16, seed=18)
    o, lse = pa.pooled_attention_packed_cuda(q, k, v, 1, 0.1, False, return_lse=True)
    sq, sk = pa._packed_strides(q, k, 1)
    with pytest.raises(ValueError, match="at most"):
        pa._launch_bwd(q, k, v, o, lse, torch.randn_like(q), 1, 64, sq, sk, 0.1, False,
                       route="split_key")


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_attention_autograd_runs_the_backward_kernel(cuda, residual):
    # Through the dispatcher under autograd: the forward and backward kernels
    # launch once each, and the gradients match autograd of the plain forward.
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 2, 150, 40, 192, torch.float32, seed=9))
    g = torch.randn(2, 150, 192, device=cuda)
    before = (pa.pooled_attention_packed_cuda.launches, pa.pooled_attention_packed_bwd_cuda.launches)
    got = torch.autograd.grad(pa.pooled_attention_packed(q, k, v, 2, 0.1, residual), (q, k, v), g)
    assert (pa.pooled_attention_packed_cuda.launches,
            pa.pooled_attention_packed_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(pa.pooled_attention_packed_torch(q, k, v, 2, 0.1, residual), (q, k, v), g)
    for a, b in zip(got, ref):
        _close(a, b, **GRAD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [gm for gm in MVIT_POOLS if gm[1][0] == 3],
                         ids=lambda g: "x%s_k%s_s%s" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_pool_backward_matches_plain(cuda, geometry, dtype):
    grid, kernel, stride = geometry
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(2, *grid, device=cuda, generator=g).to(dtype)
    C = grid[-1]
    # Head-packed where C > 32: the weight's rows are shared by C / Cw heads.
    w = (torch.randn(min(C, 32), 1, *kernel, device=cuda, generator=g) * 0.2).to(dtype)
    out_shape = (2, *tp.check_geometry(x.shape, kernel, stride), C)
    gy = torch.randn(out_shape, device=cuda, generator=g).to(dtype)
    before = (tp.depthwise_token_pool_dx_cuda.launches, tp.depthwise_token_pool_dw_cuda.launches)
    dx = tp.depthwise_token_pool_dx(gy, w, x.shape, stride)
    dw = tp.depthwise_token_pool_dw(x, gy, w, stride)
    assert (tp.depthwise_token_pool_dx_cuda.launches,
            tp.depthwise_token_pool_dw_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dtype and dx.shape == x.shape and dw.dtype == dtype and dw.shape == w.shape
    _close(dx, tp.depthwise_token_pool_dx_torch(gy.float(), w.float(), x.shape, stride),
           **GRAD_TOL[dtype])
    _close(dw, tp.depthwise_token_pool_dw_torch(x.float(), gy.float(), w.float(), stride),
           **GRAD_TOL[dtype])


@pytest.mark.cuda
def test_token_pool_autograd(cuda):
    # The conv pool's dx and dw kernels and the max pool's PyTorch backward,
    # under autograd, against autograd of the plain versions.
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 4, 12, 12, 64, device=cuda, generator=gen).requires_grad_()
    w = torch.randn(32, 1, 3, 3, 3, device=cuda, generator=gen).requires_grad_()
    before = {f: f.launches for f in (tp.depthwise_token_pool_cuda, tp.depthwise_token_pool_dx_cuda,
                                      tp.depthwise_token_pool_dw_cuda, tp.max_token_pool_cuda)}
    out = tp.depthwise_token_pool(x, w, (1, 2, 2))
    out2 = tp.max_token_pool(x, (1, 3, 3), (1, 2, 2))
    gy, gy2 = torch.randn_like(out), torch.randn_like(out2)
    got = torch.autograd.grad((out, out2), (x, w), (gy, gy2))
    assert all(f.launches == n + 1 for f, n in before.items())
    ref = torch.autograd.grad(
        (tp.depthwise_token_pool_torch(x, w, (1, 2, 2)), tp.max_token_pool_torch(x, (1, 3, 3), (1, 2, 2))),
        (x, w), (gy, gy2))
    for a, b in zip(got, ref):
        _close(a, b, **GRAD_TOL[torch.float32])


# The tiled route's ragged cases: T = 2 under kt = 3; H2 and W2 that no
# tile size divides; C = 96 (a ragged 32-channel slice); Cw < C.
TILED_RAGGED = [((2, 9, 11, 64), (3, 3, 3), (1, 2, 2)), ((3, 13, 11, 96), (3, 3, 3), (1, 1, 1)),
                ((4, 10, 10, 96), (1, 3, 3), (1, 2, 2)), ((3, 23, 19, 40), (3, 3, 3), (1, 4, 4)),
                ((5, 9, 11, 32), (3, 3, 3), (2, 3, 2))]


def _routed(wrapper, call, route):
    """Runs ``call``; asserts that ``wrapper`` launched once in it, on ``route``."""
    before = wrapper.launches, dict(wrapper.launches_by_route)
    got = call()
    assert wrapper.launches == before[0] + 1
    assert wrapper.launches_by_route == {r: n + (r == route) for r, n in before[1].items()}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [g for g in MVIT_POOLS if g[1] in tp.TILED_KERNELS]
                         + TILED_RAGGED, ids=lambda g: "x%s_k%s_s%s" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_pool_routes_match_plain(cuda, geometry, dtype):
    # The forward's three modes, dx and dw on the tiled route, at B2, against
    # the plain versions in f32 on the same inputs; the weight rows shared by
    # C / Cw heads where C > 32.
    grid, kernel, stride = geometry
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(2, *grid, device=cuda, generator=gen).to(dtype)
    C = grid[-1]
    w = (torch.randn(math.gcd(C, 32), 1, *kernel, device=cuda, generator=gen) * 0.2).to(dtype)
    cases = [
        (tp.depthwise_token_pool_cuda, (w, stride), lambda a: tp.depthwise_token_pool_torch(
            a, w.float(), stride)),
        (tp.max_token_pool_cuda, (kernel, stride), lambda a: tp.max_token_pool_torch(
            a, kernel, stride)),
        (tp.avg_token_pool_cuda, (kernel, stride), lambda a: tp.avg_token_pool_torch(
            a, kernel, stride)),
    ]
    for wrapper, args, plain in cases:
        out = _routed(wrapper, lambda: wrapper(x, *args), "tiled")
        ref = plain(x.float())
        assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
        torch.testing.assert_close(out.float(), ref, **POOL_TOL[dtype])
    gy = torch.randn((2, *tp.check_geometry(x.shape, kernel, stride), C), device=cuda,
                     generator=gen).to(dtype)
    dx = _routed(tp.depthwise_token_pool_dx_cuda,
                 lambda: tp.depthwise_token_pool_dx_cuda(gy, w, x.shape, stride), "tiled")
    dw = _routed(tp.depthwise_token_pool_dw_cuda,
                 lambda: tp.depthwise_token_pool_dw_cuda(x, gy, w, stride), "tiled")
    assert dx.dtype == dtype and dx.shape == x.shape and dw.dtype == dtype and dw.shape == w.shape
    _close(dx, tp.depthwise_token_pool_dx_torch(gy.float(), w.float(), x.shape, stride),
           **GRAD_TOL[dtype])
    _close(dw, tp.depthwise_token_pool_dw_torch(x.float(), gy.float(), w.float(), stride),
           **GRAD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [((8, 56, 56, 192), (3, 3, 3), (1, 2, 2)),
                                      ((8, 14, 14, 384), (3, 3, 3), (1, 2, 2)),
                                      ((8, 14, 14, 768), (3, 3, 3), (1, 1, 1))],
                         ids=lambda g: "x%s_k%s_s%s" % g)
def test_tiled_pool_routes_at_the_path_batches(cuda, geometry):
    # The forward at the serving batch (B32) and dx, dw at the training batch
    # (B8), in bf16: larger tiles and deeper rings than B2's plans, whose
    # shared memory passes 48 KB.
    grid, kernel, stride = geometry
    gen = torch.Generator(device=cuda).manual_seed(18)
    w = (torch.randn(96, 1, *kernel, device=cuda, generator=gen) * 0.2).bfloat16()
    x = torch.randn(32, *grid, device=cuda, generator=gen).bfloat16()
    out = _routed(tp.depthwise_token_pool_cuda,
                  lambda: tp.depthwise_token_pool_cuda(x, w, stride), "tiled")
    torch.testing.assert_close(out.float(), tp.depthwise_token_pool_torch(
        x.float(), w.float(), stride), **POOL_TOL[torch.bfloat16])
    x = x[:8].contiguous()
    gy = torch.randn((8, *tp.check_geometry(x.shape, kernel, stride), grid[-1]), device=cuda,
                     generator=gen).bfloat16()
    dx = _routed(tp.depthwise_token_pool_dx_cuda,
                 lambda: tp.depthwise_token_pool_dx_cuda(gy, w, x.shape, stride), "tiled")
    dw = _routed(tp.depthwise_token_pool_dw_cuda,
                 lambda: tp.depthwise_token_pool_dw_cuda(x, gy, w, stride), "tiled")
    _close(dx, tp.depthwise_token_pool_dx_torch(gy.float(), w.float(), x.shape, stride),
           **GRAD_TOL[torch.bfloat16])
    _close(dw, tp.depthwise_token_pool_dw_torch(x.float(), gy.float(), w.float(), stride),
           **GRAD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [((8, 56, 56, 96), (3, 3, 3), (1, 8, 8)),
                                      ((8, 14, 14, 768), (3, 3, 3), (1, 1, 1))],
                         ids=lambda g: "x%s_k%s_s%s" % g)
def test_token_pool_backward_is_deterministic(cuda, geometry):
    # dw's one launch sums its block partials in a fixed order (the counter
    # is its only atomic): two calls give the same bits, and so does dx.
    grid, kernel, stride = geometry
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(8, *grid, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(96, 1, *kernel, device=cuda, generator=gen) * 0.2).bfloat16()
    gy = torch.randn((8, *tp.check_geometry(x.shape, kernel, stride), grid[-1]), device=cuda,
                     generator=gen).bfloat16()
    before = dict(tp.depthwise_token_pool_dw_cuda.launches_by_route)
    first = tp.depthwise_token_pool_dw_cuda(x, gy, w, stride)
    second = tp.depthwise_token_pool_dw_cuda(x, gy, w, stride)
    assert tp.depthwise_token_pool_dw_cuda.launches_by_route["tiled"] == before["tiled"] + 2
    assert torch.equal(first, second)
    assert torch.equal(tp.depthwise_token_pool_dx_cuda(gy, w, x.shape, stride),
                       tp.depthwise_token_pool_dx_cuda(gy, w, x.shape, stride))


@pytest.mark.cuda
def test_pool_calls_off_the_tiled_route_take_scalar(cuda):
    # bf16 C = 12 (24-byte rows), a view one element off 16 bytes, and a
    # kernel size the tiled kernels do not instantiate take the first
    # version; asking for tiled there raises.
    gen = torch.Generator(device=cuda).manual_seed(16)

    def off_by_one(t):
        # t's values in a contiguous view one element past a 16-byte boundary.
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        return buf[1:].view(t.shape).copy_(t)

    cases = [
        (torch.randn(2, 4, 9, 9, 12, device=cuda, generator=gen).bfloat16(), (3, 3, 3), None),
        (off_by_one(torch.randn(2, 4, 9, 9, 16, device=cuda, generator=gen)), (3, 3, 3),
         off_by_one),
        (torch.randn(2, 4, 9, 9, 16, device=cuda, generator=gen), (3, 5, 3), None),
    ]
    for x, kernel, place in cases:
        assert tp.pool_route(x.dtype, x.shape[-1], x.data_ptr() % 16 == 0, kernel) == "scalar"
        w = (torch.randn(4, 1, *kernel, device=cuda, generator=gen) * 0.2).to(x.dtype)
        out = _routed(tp.depthwise_token_pool_cuda,
                      lambda: tp.depthwise_token_pool_cuda(x, w, (1, 2, 2)), "scalar")
        torch.testing.assert_close(out.float(), tp.depthwise_token_pool_torch(
            x.float(), w.float(), (1, 2, 2)), **POOL_TOL[x.dtype])
        gy = torch.randn_like(out)
        gy = place(gy) if place else gy
        _routed(tp.depthwise_token_pool_dx_cuda,
                lambda: tp.depthwise_token_pool_dx_cuda(gy, w, x.shape, (1, 2, 2)), "scalar")
        _routed(tp.depthwise_token_pool_dw_cuda,
                lambda: tp.depthwise_token_pool_dw_cuda(x, gy, w, (1, 2, 2)), "scalar")
        with pytest.raises(ValueError, match="tiled route takes"):
            tp.max_token_pool_cuda(x, kernel, (1, 2, 2), route="tiled")


@pytest.mark.cuda
def test_forced_scalar_route_matches_tiled(cuda):
    # The first version stays callable on the tiled route's inputs (the
    # smoke run times it beside the tiled kernels).
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(2, 8, 28, 28, 384, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(96, 1, 3, 3, 3, device=cuda, generator=gen) * 0.2).bfloat16()
    tiled = _routed(tp.depthwise_token_pool_cuda,
                    lambda: tp.depthwise_token_pool_cuda(x, w, (1, 2, 2)), "tiled")
    scalar = _routed(tp.depthwise_token_pool_cuda,
                     lambda: tp.depthwise_token_pool_cuda(x, w, (1, 2, 2), route="scalar"),
                     "scalar")
    torch.testing.assert_close(tiled.float(), scalar.float(), **POOL_TOL[torch.bfloat16])


# Fused kv-pool geometries: (grid T, H, W), H*c, heads, kv stride, cls rows.
# MViT-B 16x4 blocks 0, 3 and 15, and a ragged grid without a cls token.
FUSED_GEOMETRIES = [((8, 56, 56), 96, 1, (1, 8, 8), True), ((8, 28, 28), 384, 4, (1, 2, 2), True),
                    ((8, 7, 7), 768, 8, (1, 1, 1), True), ((3, 10, 13), 64, 2, (1, 3, 2), False)]


def _fused_inputs(cuda, geometry, dtype, seed, B=2, Lq=50):
    """q, the unpooled k and v grids, per-head taps and LayerNorm parameters
    (shared by every head, as the layer passes them), cls rows and a cls query."""
    thw, HC, heads, stride, has_cls = geometry
    c = HC // heads
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device=cuda, generator=g) * scale + shift).to(dtype)

    L = thw[0] * thw[1] * thw[2]
    cls = [randn(B, 1, HC) if has_cls else None for _ in range(3)]
    inputs = [randn(B, Lq, HC), randn(B, L, HC), randn(B, L, HC), randn(27, c, scale=0.2),
              randn(27, c, scale=0.2), randn(2, c, scale=0.3, shift=1.0),
              randn(2, c, scale=0.3, shift=1.0), cls[0], cls[1]]
    kw = dict(thw=thw, num_heads=heads, scale=c**-0.5, residual=True, kernel=(3, 3, 3),
              stride=stride, eps=1e-6)
    return inputs, cls[2], kw


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", FUSED_GEOMETRIES, ids=lambda g: "x%s_hc%d_h%d_s%s_cls%d" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kvpool_matches_plain(cuda, geometry, dtype):
    inputs, cls_q, kw = _fused_inputs(cuda, geometry, dtype, seed=12)
    before = (fk.fused_kvpool_attention_cuda.launches, pa.pooled_attention_packed_cuda.launches)
    outs = fk.fused_kvpool_attention(*inputs, **kw, cls_q=cls_q)
    assert (fk.fused_kvpool_attention_cuda.launches, pa.pooled_attention_packed_cuda.launches) == (
        before[0] + 1, before[1] + 1 + (cls_q is not None))
    f32 = [None if t is None else t.float() for t in inputs]
    ref = fk.fused_kvpool_attention_torch(*f32, **kw, cls_q=None if cls_q is None else cls_q.float())
    assert len(outs) == len(ref) and all(o.dtype == dtype for o in outs)
    # The pooled and normed k and v against the plain version in f32.
    for got, want in zip(outs[1:3], ref[1:3]):
        torch.testing.assert_close(got.float(), want, **POOL_TOL[dtype])
    # Each attention against the plain attention over the kernel's own k and v.
    k_full, v_full = (t if inputs[7] is None else torch.cat([c, t], dim=1)
                      for c, t in ((inputs[7], outs[1]), (inputs[8], outs[2])))
    queries = [inputs[0]] + ([] if cls_q is None else [cls_q])
    for got, qq in zip(outs[:1] + outs[3:], queries):
        want = pa.pooled_attention_packed_torch(qq.float(), k_full.float(), v_full.float(),
                                                kw["num_heads"], kw["scale"], True)
        torch.testing.assert_close(got.float(), want, **ATTN_TOL[dtype])
    if dtype == torch.float32:
        for got, want in zip(outs, ref):
            torch.testing.assert_close(got, want, **ATTN_TOL[dtype])
    with pytest.raises(ValueError, match="must be torch"):
        fk.fused_kvpool_attention(inputs[0], inputs[1].double(), *inputs[2:], **kw)


@pytest.mark.cuda
def test_fused_kvpool_autograd_runs_the_kernels(cuda):
    # Under autograd the forward is the pool-LN (on its tiled route) and
    # attention kernels; the backward recomputes through the conv-pool and
    # attention kernels and runs their backward kernels. Held against
    # autograd of the plain version.
    inputs, cls_q, kw = _fused_inputs(cuda, FUSED_GEOMETRIES[1], torch.float32, seed=13)
    leaves = [t.requires_grad_() for t in (*inputs, cls_q)]
    wrappers = (fk.fused_kvpool_attention_cuda, pa.pooled_attention_packed_cuda,
                pa.pooled_attention_packed_bwd_cuda, tp.depthwise_token_pool_cuda,
                tp.depthwise_token_pool_dx_cuda, tp.depthwise_token_pool_dw_cuda)
    before = [f.launches for f in wrappers]
    tiled = fk.fused_kvpool_attention_cuda.launches_by_route["tiled"]
    outs = fk.fused_kvpool_attention(*leaves[:9], **kw, cls_q=leaves[9])
    gys = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, leaves, gys)
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1, 4, 2, 2, 2, 2]
    assert fk.fused_kvpool_attention_cuda.launches_by_route["tiled"] == tiled + 1
    ref = torch.autograd.grad(fk.fused_kvpool_attention_torch(*leaves[:9], **kw, cls_q=leaves[9]),
                              leaves, gys)
    for a, b in zip(got, ref):
        _close(a, b, **GRAD_TOL[torch.float32])


# MViT-B 16x4's seven kv geometries at full size: (grid T, H, W), H*c, heads,
# kv stride. B2, with and without the cls rows.
POOL_LN_GEOMETRIES = [((8, 56, 56), 96, 1, (1, 8, 8)), ((8, 56, 56), 192, 2, (1, 4, 4)),
                      ((8, 28, 28), 192, 2, (1, 4, 4)), ((8, 28, 28), 384, 4, (1, 2, 2)),
                      ((8, 14, 14), 384, 4, (1, 2, 2)), ((8, 14, 14), 768, 8, (1, 1, 1)),
                      ((8, 7, 7), 768, 8, (1, 1, 1))]
# The tiled kernel's other head widths (32, 64, 128) on ragged grids, each
# W step (3, 1, 2).
POOL_LN_WIDTH_CASES = [((3, 10, 13), 64, 2, (1, 3, 3)), ((4, 9, 11), 128, 2, (1, 1, 1)),
                       ((5, 12, 9), 256, 2, (1, 2, 2))]


def _pool_ln_call(inputs, kw, pooled, route=None):
    """The pool-LN launch alone: (k buffer, v buffer, route taken)."""
    return fk._pool_ln_cuda(*inputs[1:9], kw["thw"], kw["num_heads"], kw["kernel"], kw["stride"],
                            kw["eps"], pooled, route)


def _pooled(kw):
    return tuple(fk.pool_out(d, 3, s, 1) for d, s in zip(kw["thw"], kw["stride"]))


@pytest.mark.cuda
@pytest.mark.parametrize("has_cls", [True, False], ids=["cls", "no_cls"])
@pytest.mark.parametrize("geometry", POOL_LN_GEOMETRIES + POOL_LN_WIDTH_CASES,
                         ids=lambda g: "x%s_hc%d_h%d_s%s" % g)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_pool_ln_matches_plain(cuda, geometry, has_cls, dtype):
    # The tiled route's k and v buffers (the cls row in front where given)
    # against the plain version in f32 on the same inputs; the op's launch
    # counted on the tiled route.
    inputs, cls_q, kw = _fused_inputs(cuda, (*geometry, has_cls), dtype, seed=19)
    k_full, v_full, route = _pool_ln_call(inputs, kw, _pooled(kw))
    assert route == "tiled"
    f32 = [None if t is None else t.float() for t in inputs]
    ref = fk.pool_ln_torch(*f32[1:9], kw["thw"], kw["num_heads"], kw["kernel"], kw["stride"],
                           kw["eps"])
    for got, want in zip((k_full, v_full), ref):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want, **POOL_TOL[dtype])
    outs = _routed(fk.fused_kvpool_attention_cuda,
                   lambda: fk.fused_kvpool_attention_cuda(*inputs, **kw, cls_q=cls_q), "tiled")
    for got, want in zip(outs[1:3], (k_full, v_full)):
        torch.testing.assert_close(got, want[:, has_cls:], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", POOL_LN_GEOMETRIES[::3], ids=lambda g: "x%s_hc%d_h%d_s%s" % g)
def test_forced_scalar_pool_ln_matches_tiled(cuda, geometry):
    # The first version stays callable on the tiled route's inputs (the
    # smoke run times it beside the tiled kernel).
    inputs, cls_q, kw = _fused_inputs(cuda, (*geometry, True), torch.bfloat16, seed=20)
    tiled = _routed(fk.fused_kvpool_attention_cuda,
                    lambda: fk.fused_kvpool_attention_cuda(*inputs, **kw, cls_q=cls_q), "tiled")
    scalar = _routed(fk.fused_kvpool_attention_cuda, lambda: fk.fused_kvpool_attention_cuda(
        *inputs, **kw, cls_q=cls_q, route="scalar"), "scalar")
    for a, b in zip(tiled, scalar):
        torch.testing.assert_close(a.float(), b.float(), **POOL_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_pool_ln_calls_off_the_tiled_route_take_scalar(cuda):
    # A head width the tiled kernel does not instantiate (40), k and v grids
    # one element off 16 bytes, and a T stride take the first version, held
    # against the plain version; asking for tiled there raises.
    def off_by_one(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        return buf[1:].view(t.shape).copy_(t)

    cases = []
    inputs, cls_q, kw = _fused_inputs(cuda, ((3, 10, 13), 80, 2, (1, 2, 2), True), torch.bfloat16,
                                      seed=21)
    cases.append((inputs, kw))
    inputs, cls_q, kw = _fused_inputs(cuda, ((4, 9, 9), 128, 2, (1, 2, 2), False), torch.float32,
                                      seed=22)
    inputs[1], inputs[2] = off_by_one(inputs[1]), off_by_one(inputs[2])
    cases.append((inputs, kw))
    inputs, cls_q, kw = _fused_inputs(cuda, ((5, 9, 9), 192, 2, (2, 2, 2), True), torch.bfloat16,
                                      seed=23)
    cases.append((inputs, kw))
    for inputs, kw in cases:
        outs = _routed(fk.fused_kvpool_attention_cuda,
                       lambda: fk.fused_kvpool_attention_cuda(*inputs, **kw), "scalar")
        f32 = [None if t is None else t.float() for t in inputs]
        ref = fk.fused_kvpool_attention_torch(*f32, **kw)
        for got, want in zip(outs[1:3], ref[1:3]):
            torch.testing.assert_close(got.float(), want, **POOL_TOL[inputs[0].dtype])
        with pytest.raises(ValueError, match="tiled route takes"):
            fk.fused_kvpool_attention_cuda(*inputs, **kw, route="tiled")


# CSN-R101 stride-1 conv_b shapes at 32x224x224: (T, H=W, C) per stage.
CSN_SHAPES = [(32, 112, 64), (16, 56, 128), (8, 28, 256), (4, 14, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CSN_SHAPES, ids=lambda s: "T%dS%dC%d" % s)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_depthwise_at_csn_shapes_matches_plain(cuda, shape, dtype):
    # At B1, bias only (CSN's deploy form) and with the affine and swish:
    # one launch each, on the tiled route.
    T, S, C = shape
    x, w, s, b = _depthwise_inputs(cuda, 1, T, S, S, C, dtype, seed=22)
    for scale, swish in ((None, False), (s, True)):
        out = _routed(depthwise3x3x3_bn_swish_cuda,
                      lambda: depthwise3x3x3_bn_swish(x, w, scale, b, swish), "tiled")
        torch.testing.assert_close(out.float(), _depthwise_ref(x, w, scale, b, swish),
                                   **TOL[dtype])


@pytest.mark.cuda
def test_csn_deploy_runs_the_kernel_on_its_stride1_conv_b(cuda):
    # A narrow CSN-R50 (13 stride-1 conv_b of 16): the f32 deploy form
    # launches the kernel once per stride-1 conv_b, all tiled, and matches
    # the eval model (cuDNN, TF32 off) up to the BN fold.
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import create_csn

    torch.manual_seed(23)
    model = create_csn(stem_dim_out=16, model_num_class=7, head_pool_kernel_size=(1, 2, 2)).eval()
    x = torch.randn(2, 3, 8, 32, 32, device=cuda)
    deploy = convert_to_deployable_form(model, dtype=None)
    wrapper = depthwise3x3x3_bn_swish_cuda
    before = wrapper.launches, dict(wrapper.launches_by_route)
    with torch.no_grad():
        out, ref = deploy(x), model(x)
    assert wrapper.launches == before[0] + 13
    assert wrapper.launches_by_route["tiled"] == before[1]["tiled"] + 13
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# --- the serving kernels as pvt:: custom ops, compiled serving, export -------

def _op_cases(cuda, dtype):
    """(op, args) of every pvt:: op at MViT-B-like and X3D-S-like shapes the
    kernels take (c 96, cls queries, ragged planes)."""
    g = torch.Generator(device=cuda).manual_seed(30)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=cuda, generator=g) * scale).to(dtype)

    s = 96 ** -0.5
    ln = torch.stack([1 + r(96, scale=0.1), r(96, scale=0.1)])
    ops = torch.ops.pvt
    return {
        "depthwise3x3x3_bn_swish": (ops.depthwise3x3x3_bn_swish, (
            r(2, 3, 10, 12, 54), r(3, 3, 3, 54, scale=0.2), r(54), r(54), True)),
        "depthwise3x3x3_bias_only": (ops.depthwise3x3x3_bn_swish, (
            r(1, 4, 14, 14, 64), r(3, 3, 3, 64, scale=0.2), None, r(64), False)),
        "pooled_attention_packed": (ops.pooled_attention_packed, (
            r(2, 197, 192), r(2, 50, 192), r(2, 50, 192), 2, s, True)),
        "pooled_attention_packed_cls": (ops.pooled_attention_packed, (
            r(2, 1, 192), r(2, 50, 192), r(2, 50, 192), 2, s, True)),
        "pooled_attention": (ops.pooled_attention, (
            r(2, 2, 197, 96), r(2, 2, 50, 96), r(2, 2, 50, 96), s, True)),
        "token_pool_conv": (ops.token_pool_conv, (
            r(2, 4, 14, 14, 192), r(96, 1, 3, 3, 3, scale=0.2), [1, 2, 2])),
        "token_pool_max": (ops.token_pool_max, (r(2, 4, 14, 14, 96), [1, 3, 3], [1, 2, 2])),
        "token_pool_avg": (ops.token_pool_avg, (r(2, 4, 14, 14, 96), [3, 3, 3], [1, 2, 2])),
        "kvpool_ln": (ops.kvpool_ln, (
            r(2, 4 * 14 * 14, 192), r(2, 4 * 14 * 14, 192), r(27, 96, scale=0.2),
            r(27, 96, scale=0.2), ln, ln.clone(), r(2, 1, 192), r(2, 1, 192), [4, 14, 14], 2,
            [3, 3, 3], [1, 2, 2], 1e-6)),
    }


OP_NAMES = ["depthwise3x3x3_bn_swish", "depthwise3x3x3_bias_only", "pooled_attention_packed",
            "pooled_attention_packed_cls", "pooled_attention", "token_pool_conv",
            "token_pool_max", "token_pool_avg", "kvpool_ln"]


# The wrapper behind each pvt:: op, whose counter its CUDA implementation moves.
SERVING_WRAPPERS = {"depthwise3x3x3_bn_swish": depthwise3x3x3_bn_swish_cuda,
                    "pooled_attention_packed": pa.pooled_attention_packed_cuda,
                    "pooled_attention": pa.pooled_attention_cuda,
                    "token_pool_conv": tp.depthwise_token_pool_cuda,
                    "token_pool_max": tp.max_token_pool_cuda,
                    "token_pool_avg": tp.avg_token_pool_cuda,
                    "kvpool_ln": fk.fused_kvpool_attention_cuda}


def _counts() -> dict:
    return {name: w.launches for name, w in SERVING_WRAPPERS.items()}


def _moved(before: dict) -> dict:
    return {name: n - before[name] for name, n in _counts().items() if n != before[name]}


def _launches() -> int:
    """The serving wrappers' launches, summed."""
    return sum(_counts().values())


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_opcheck_on_the_card(cuda, name, dtype):
    # The fake against the kernel's real shape, dtype and strides; the op
    # launches its kernel once a call and agrees with the plain version.
    op, args = _op_cases(cuda, dtype)[name]
    torch.library.opcheck(op.default, args)
    before = _launches()
    out = _outputs(op(*args))
    assert _launches() == before + 1
    # The plain version (the op's CPU implementation) on the same inputs in f32.
    ref = _outputs(op(*[a.float().cpu() if isinstance(a, torch.Tensor) else a for a in args]))
    tol = (TOL if name.startswith("depthwise") else
           POOL_TOL if name.startswith(("token", "kvpool")) else ATTN_TOL)[dtype]
    for got, want in zip(out, ref):
        assert got.is_contiguous() and got.dtype == dtype
        torch.testing.assert_close(got.float().cpu(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_replays_in_a_cuda_graph(cuda, name, dtype):
    # Captured alone, replayed on new input values: bit-identical to the
    # eager call on them; a replay runs no wrapper, so no counter moves.
    op, args = _op_cases(cuda, dtype)[name]
    op(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = _outputs(op(*args))
    for a in args:
        if isinstance(a, torch.Tensor):
            a.copy_(a.roll(1, -1))
    before = _launches()
    graph.replay()
    torch.cuda.synchronize()
    assert _launches() == before
    for got, want in zip(static, _outputs(op(*args))):
        assert torch.equal(got, want)


def _small_x3d(cuda):
    from pytorchvideo_tpu_torch.models.x3d import create_x3d

    torch.manual_seed(31)
    return create_x3d(input_clip_length=4, input_crop_size=64, model_num_class=10,
                      device=cuda).eval()


@pytest.mark.cuda
def test_compiled_forward_replays_the_eager_deploy_form(cuda):
    from pytorchvideo_tpu_torch.accelerate import CompiledForward, convert_to_deployable_form

    x = torch.randn(2, 3, 4, 64, 64, device=cuda)
    compiled = convert_to_deployable_form(_small_x3d(cuda), example_input=x)
    assert isinstance(compiled, CompiledForward)
    x1, x2 = x.bfloat16(), torch.randn_like(x).bfloat16()
    before = depthwise3x3x3_bn_swish_cuda.launches
    out1 = compiled(x1)
    keep = out1.clone()
    out2 = compiled(x2)
    assert depthwise3x3x3_bn_swish_cuda.launches == before  # replays run no wrapper
    with torch.no_grad():
        assert torch.equal(out1, compiled.module(x1)) and torch.equal(out2, compiled.module(x2))
    # A fresh tensor each call: the second call left the first one as it was.
    assert out1.data_ptr() != out2.data_ptr() and torch.equal(out1, keep)
    assert not torch.equal(out1, out2)
    # A second batch in the same pool, replayed in turns with the first.
    x4 = torch.randn(4, 3, 4, 64, 64, device=cuda).bfloat16()
    compiled4 = CompiledForward(compiled.module, x4, pool=compiled.pool)
    for _ in range(2):
        with torch.no_grad():
            assert torch.equal(compiled4(x4), compiled.module(x4))
            assert torch.equal(compiled(x1), compiled.module(x1))


@pytest.mark.cuda
def test_compiled_forward_refuses_other_inputs(cuda):
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form

    x = torch.randn(2, 3, 4, 64, 64, device=cuda)
    compiled = convert_to_deployable_form(_small_x3d(cuda), example_input=x)
    for bad in (x[:1].bfloat16(), x, x.bfloat16().cpu(), [x.bfloat16()]):
        with pytest.raises(ValueError, match="captured for"):
            compiled(bad)
    with pytest.raises(ValueError, match="needs the card"):
        convert_to_deployable_form(_small_x3d(cuda).cpu(), example_input=x)


@pytest.mark.cuda
def test_compiled_forward_takes_slowfast_pathways(cuda):
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import hub

    torch.manual_seed(32)
    model = hub.slowfast_r50(stage_depths=(1, 1, 1, 1), model_num_class=7, dropout_rate=0.0,
                             head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)), device=cuda).eval()
    x = [torch.randn(2, 3, 4, 32, 32, device=cuda), torch.randn(2, 3, 16, 32, 32, device=cuda)]
    compiled = convert_to_deployable_form(model, example_input=x)
    xb = [p.bfloat16() for p in x]
    with torch.no_grad():
        assert torch.equal(compiled(xb), compiled.module(xb))
    for bad in (xb[0], xb[::-1], xb[:1]):
        with pytest.raises(ValueError, match="captured for"):
            compiled(bad)


def _small_mvit(cuda, **kwargs):
    from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers

    torch.manual_seed(33)
    return create_multiscale_vision_transformers(
        spatial_size=32, temporal_size=4, depth=3, num_heads=2, patch_embed_dim=64,
        embed_dim_mul=[[1, 2.0]], atten_head_mul=[[1, 2.0]], pool_q_stride_size=[[1, 1, 2, 2]],
        pool_kv_stride_adaptive=[1, 2, 2], pool_kvq_kernel=[3, 3, 3], head_num_classes=7,
        device=cuda, **kwargs).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["unfused", "pool_first", "fused_kvpool"])
def test_small_mvit_compiled_and_exported_on_the_card(cuda, form):
    # The capture launches what an eager forward does (after the warm-up's
    # forwards); the exported program holds one pvt:: node per launch, and
    # running it launches each on the card.
    import io

    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, export_program
    from pytorchvideo_tpu_torch.accelerate.deploy import WARMUP_FORWARDS

    kwargs = {"unfused": {}, "pool_first": {"pool_first": True},
              "fused_kvpool": {"fused_kvpool": True}}[form]
    model = _small_mvit(cuda, **kwargs)
    deploy = convert_to_deployable_form(model)
    x = torch.randn(2, 3, 4, 32, 32, device=cuda).bfloat16()
    before = _counts()
    with torch.no_grad():
        eager = deploy(x)
    per_forward = _moved(before)
    assert per_forward
    before = _counts()
    compiled = convert_to_deployable_form(model, example_input=x)
    assert _moved(before) == {k: n * (WARMUP_FORWARDS + 1) for k, n in per_forward.items()}
    assert torch.equal(compiled(x), eager)

    program = torch.export.load(io.BytesIO(export_program(deploy, x)))
    nodes = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == "pvt":
            nodes[node.target._opname] = nodes.get(node.target._opname, 0) + 1
    assert nodes == per_forward
    before = _counts()
    with torch.no_grad():
        out = program.module()(x)
    assert _moved(before) == per_forward
    torch.testing.assert_close(out.float(), eager.float(), atol=1e-2, rtol=2**-7)


# X3D-S's stem BN (24 channels at 13x80x80) and its last stage's norm_b (432
# at 13x5x5), at B4.
BN_SHAPES = {"stem": (4, 24, 13, 80, 80), "last_stage": (4, 432, 13, 5, 5)}
# Train-mode BN against f64: f32 the statistics' summation order; bf16 one
# rounding of the f32 result. Running stats 1e-5 relative (of |ref| plus the
# batch's std for the mean).
BN_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: TOL[torch.bfloat16]}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BN_SHAPES.values()), ids=list(BN_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_forward_matches_f64(cuda, shape, dtype):
    from pytorchvideo_tpu_torch.layers.norms import BatchNorm

    C = shape[1]
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(shape, device=cuda, generator=g) * 2.0 + 0.5).to(dtype)
    bn = BatchNorm(C).to(cuda)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, device=cuda, generator=g))
        bn.bias.copy_(torch.randn(C, device=cuda, generator=g) * 0.1)
    weight, bias = bn.weight.to(dtype), bn.bias.to(dtype)
    out = torch.func.functional_call(bn.train(), {"weight": weight, "bias": bias}, (x,))
    assert out.dtype == dtype and bn.running_mean.dtype == torch.float32
    xd, dims, view = x.double(), (0, 2, 3, 4), (1, C, 1, 1, 1)
    mean, var = xd.mean(dims), xd.var(dims, unbiased=False)
    ref = ((xd - mean.view(view)) / torch.sqrt(var.view(view) + bn.eps)
           * weight.double().view(view) + bias.double().view(view))
    torch.testing.assert_close(out.double(), ref, **BN_TOL[dtype])
    ref_mean, ref_var = 0.1 * mean, 0.9 + 0.1 * var
    assert ((bn.running_mean.double() - ref_mean).abs()
            <= 1e-5 * (ref_mean.abs() + var.sqrt())).all()
    assert ((bn.running_var.double() - ref_var).abs() <= 1e-5 * ref_var).all()


@pytest.mark.cuda
def test_x3d_bf16_step_grads_near_f32_compute(cuda):
    # One step of a small X3D (4x64x64, B4, head dropout 0, the ResNet-style
    # init from a seeded generator) in bf16 and in f32 compute, TF32 off:
    # the loss within 3e-2 relative, all gradients together within 0.3
    # relative L2 error and above 0.95 cosine (chip_smoke.py's bf16 step
    # bounds for X3D-S), the masters and the BN buffers float32.
    from pytorchvideo_tpu_torch.layers.norms import BatchNorm
    from pytorchvideo_tpu_torch.models import init_net_weights
    from pytorchvideo_tpu_torch.models.x3d import create_x3d
    from pytorchvideo_tpu_torch.train import forward_backward

    model = create_x3d(input_clip_length=4, input_crop_size=64, model_num_class=10,
                       dropout_rate=0.0, device=cuda)
    init_net_weights(model, generator=torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(4, 3, 4, 64, 64, device=cuda, generator=g)
    y = torch.randint(0, 10, (4,), device=cuda, generator=g)
    grads, losses = {}, {}
    for dtype in (None, torch.bfloat16):
        model.zero_grad(set_to_none=True)
        loss, _ = forward_backward(model.train(), x, y, compute_dtype=dtype)
        grads[dtype] = [p.grad.double() for p in model.parameters()]
        losses[dtype] = loss.item()
    ref, got = grads[None], grads[torch.bfloat16]
    assert all(torch.isfinite(t).all() for t in got)
    ref_sq = sum(r.square().sum() for r in ref)
    rel = (sum((a - r).square().sum() for a, r in zip(got, ref)) / ref_sq).sqrt().item()
    cosine = (sum((a * r).sum() for a, r in zip(got, ref))
              / (ref_sq * sum(a.square().sum() for a in got)).sqrt()).item()
    assert abs(losses[torch.bfloat16] - losses[None]) <= 3e-2 * abs(losses[None])
    assert rel <= 0.3 and cosine >= 0.95, (rel, cosine)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.running_var.dtype == torch.float32 for m in model.modules()
               if isinstance(m, BatchNorm))


# --- the captured training step ---------------------------------------------

class _CardClips:
    """A datamodule of seeded clips on the card: ``train_dataloader(n)``
    yields n batches (the same n on every call; ``fixed``: one batch n
    times); ``val_dataloader(None)`` two batches of two videos' clips."""

    def __init__(self, clip, batch=2, classes=7, fixed=False):
        self.clip, self.batch, self.classes, self.fixed = clip, batch, classes, fixed

    def _batch(self, g, **extra):
        return {"video": torch.randn(self.batch, 3, *self.clip, device="cuda", generator=g),
                "label": torch.randint(0, self.classes, (self.batch,), device="cuda",
                                       generator=g), **extra}

    def train_dataloader(self, n):
        g = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(n):
            if self.fixed:
                g.manual_seed(0)
            yield self._batch(g)

    def val_dataloader(self, _):
        g = torch.Generator(device="cuda").manual_seed(1)
        for first in (0, 2):
            videos = torch.tensor([first, first, first + 1, first + 1], device="cuda")
            yield {**self._batch(g), "video_index": videos,
                   "clip_index": torch.tensor([0, 1, 0, 1], device="cuda")}


def _train_app(model, data, steps=3, **overrides):
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    cfg = get_preset("classification_mvit_16x4", **{
        "model.num_classes": 7, "trainer.max_epochs": 1, "trainer.log_every_n_steps": 1,
        "trainer.compute_dtype": "bfloat16", **overrides})
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=data, steps_per_epoch=steps)
    app.setup()
    return app


def _assert_grads_close(got: dict, ref: dict):
    """Gradients within phase 9's bf16 bound (chip_smoke.py STEP_GRAD_TOL:
    0.1 x the tensor's largest + 0.01 x its module's). The eager step is not
    bitwise repeatable itself (PyTorch's max-pool backward adds with
    atomics), so neither is a replay against it."""
    module_max = {}
    for n, r in ref.items():
        module = n.split(".")[0]
        module_max[module] = max(module_max.get(module, 0.0), r.abs().max().item())
    for n, r in ref.items():
        bound = 0.1 * r.abs().max().item() + 0.01 * module_max[n.split(".")[0]]
        assert (got[n] - r).abs().max().item() <= bound, n


def _steps(app, batches, captured):
    """One update per batch (``app._step``: captured on the card; else the
    eager step); the losses and each update's gradients."""
    losses, grads = [], []
    for batch in batches:
        batch = app._device_batch(batch)
        if captured:
            app.state, metrics = app._step(batch)
        else:
            app.state, metrics = app._train_step(app.state, batch, app.generator)
        losses.append(metrics["loss"].item())
        grads.append({n: p.grad.clone() for n, p in app.model.named_parameters()})
    return losses, grads


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [None, "full"])
def test_captured_step_equals_the_eager_step(cuda, remat):
    # A small MViT in bf16 on the recipe (MixUp, AdamW, clip), dropout 0:
    # five updates through the captured step (two eager warm-up updates, the
    # capture's replay, two replays) and five eager ones of a copy, from the
    # same weights, batches and MixUp draws: the losses within 1e-2, each
    # update's gradients within phase 9's bound.
    import copy

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    model = _small_mvit(cuda, head_dropout_rate=0.0)
    data = _CardClips((4, 32, 32))
    overrides = {"trainer.remat_policy": remat}
    captured = _train_app(model, data, **overrides)
    eager = _train_app(copy.deepcopy(model), data, **overrides)
    batches = list(data.train_dataloader(5))
    before = pa.pooled_attention_packed_cuda.launches
    losses, grads = _steps(captured, batches, captured=True)
    launched = pa.pooled_attention_packed_cuda.launches - before
    (step,) = captured._captured_steps.values()
    assert step.graph is not None and step.calls == 5 and captured.state.step == 5
    before = pa.pooled_attention_packed_cuda.launches
    eager_losses, eager_grads = _steps(eager, batches, captured=False)
    per_step = (pa.pooled_attention_packed_cuda.launches - before) // 5
    # The warm-up updates and the capture launch; replays none.
    assert launched == (WARMUP_STEPS + 1) * per_step > 0
    assert per_step == (12 if remat == "full" else 6)  # 3 blocks, grid + cls, x2 recomputed
    for a, b in zip(losses, eager_losses):
        assert abs(a - b) <= 1e-2 * abs(b), (losses, eager_losses)
    for got, ref in zip(grads, eager_grads):
        _assert_grads_close(got, ref)


@pytest.mark.cuda
def test_captured_step_refuses_another_batch_signature(cuda):
    from pytorchvideo_tpu_torch.train import CompiledTrainStep, TrainState
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    app = _train_app(_small_mvit(cuda, head_dropout_rate=0.0), _CardClips((4, 32, 32)))
    batch = next(app.datamodule.train_dataloader(1))
    step = CompiledTrainStep(app._train_step, app.state)
    step(app.state, batch)  # the first call fixes the signature
    with pytest.raises(ValueError, match="captured for the batch signature"):
        step(app.state, {**batch, "video": batch["video"][:1], "label": batch["label"][:1]})
    for _ in range(WARMUP_STEPS):
        step(app.state, batch)
    assert step.graph is not None
    for bad in ({**batch, "video": batch["video"][:1], "label": batch["label"][:1]},
                {**batch, "video": batch["video"].double()},
                {**batch, "video": [batch["video"]]}):
        with pytest.raises(ValueError, match="captured for the batch signature"):
            step(app.state, bad)
    with pytest.raises(ValueError, match="another train state"):
        step(TrainState(app.model, app.state.optimizer), batch)
    # The app keeps one graph per signature instead.
    app.datamodule = _CardClips((4, 32, 32), batch=4)
    app.train()
    app.datamodule = _CardClips((4, 32, 32), batch=2)
    app.train()
    assert [s.graph is not None for s in app._captured_steps.values()] == [True, True]


def _small_x3d(cuda):
    from pytorchvideo_tpu_torch.models.x3d import create_x3d

    torch.manual_seed(34)
    return create_x3d(input_clip_length=4, input_crop_size=32, model_num_class=7,
                      dropout_rate=0.0, device=cuda)


@pytest.mark.cuda
def test_captured_bn_step_is_the_eager_step_bitwise(cuda):
    # With cuDNN's deterministic algorithms the small X3D's f32 step repeats
    # itself bit for bit, so six updates through the captured step (two
    # warm-up updates, the capture's replay, three replays) equal six eager
    # updates of a copy exactly: parameters, running stats, counts and the
    # optimizer's momentum, at an LR that changes at every update.
    import copy

    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    data = _CardClips((4, 32, 32), batch=4)
    model = _small_x3d(cuda)
    apps = []
    for m in (model, copy.deepcopy(model)):
        cfg = get_preset("classification_x3d_xs", **{
            "model.num_classes": 7, "trainer.max_epochs": 1, "lr_scheduler.warmup_iters": 10,
            "lr_scheduler.warmup_start_lr": 0.01})
        app = VideoClassificationTrainApp(cfg, model=m, datamodule=data, steps_per_epoch=6)
        app.setup()
        apps.append(app)
    captured, eager = apps
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        losses, _ = _steps(captured, list(data.train_dataloader(6)), captured=True)
        eager_losses, _ = _steps(eager, list(data.train_dataloader(6)), captured=False)
    (step,) = captured._captured_steps.values()
    assert step.graph is not None and step.calls == 6
    assert losses == eager_losses
    ref = eager.model.state_dict()
    for n, t in captured.model.state_dict().items():
        assert torch.equal(t, ref[n]), n
    ours = [s["momentum_buffer"] for s in captured.state.optimizer.state.values()]
    theirs = [s["momentum_buffer"] for s in eager.state.optimizer.state.values()]
    assert len(ours) == len(theirs) > 0
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))


def _reference_update(optimizer, names, before, state, grads, lr):
    """torch.optim's update of ``optimizer``'s kind, groups and
    hyperparameters in float64, one tensor at a time at the float LR
    ``lr``, from the parameters ``before`` and the optimizer ``state`` at the
    gradients ``grads`` (each by name): {name: the parameter after}."""
    ref, groups = {}, []
    for group in optimizer.param_groups:
        members = []
        for p in group["params"]:
            q = before[names[p]].double().clone()
            q.grad = grads[names[p]].double()
            ref[names[p]] = q
            members.append(q)
        hyper = {k: v for k, v in group.items()
                 if k not in ("params", "lr", "foreach", "fused", "capturable")}
        groups.append({**hyper, "params": members, "lr": lr})
    reference = type(optimizer)(groups, lr=lr, foreach=False)
    for n, q in ref.items():
        if state.get(n):
            reference.state[q] = {k: v.cpu().float() if k == "step" else v.double()
                                  for k, v in state[n].items()}
    reference.step()
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mvit_adamw", "x3d_sgd"])
def test_captured_step_reads_the_scheduled_lr(cuda, kind):
    # f32 compute, dropout 0, an LR that changes at every update (the MViT
    # recipe's warm-up; X3D-XS's SGD with a 10-epoch warm-up): six updates
    # through the captured step (two warm-up updates, the capture's replay,
    # three replays), each held against torch.optim's update in float64 at
    # the float LR from the state before it and the gradients it took: per
    # tensor within 1e-5 of the change plus one f32 rounding of the result.
    # A graph that kept the capture's LR (30% off here) or skipped the
    # update misses by thousands of times the bound.
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    data = _CardClips((4, 32, 32), batch=4)
    if kind == "mvit_adamw":
        app = _train_app(_small_mvit(cuda, head_dropout_rate=0.0), data, steps=6,
                         **{"trainer.compute_dtype": "float32"})
    else:
        cfg = get_preset("classification_x3d_xs", **{
            "model.num_classes": 7, "trainer.max_epochs": 1, "lr_scheduler.warmup_iters": 10,
            "lr_scheduler.warmup_start_lr": 0.01})
        app = VideoClassificationTrainApp(cfg, model=_small_x3d(cuda), datamodule=data,
                                          steps_per_epoch=6)
        app.setup()
    model, optimizer = app.model, app.state.optimizer
    names = {p: n for n, p in model.named_parameters()}
    lrs = [app.state.lr_schedule(k) for k in range(6)]
    assert len(set(lrs)) == 6, lrs
    for k, batch in enumerate(data.train_dataloader(6)):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = {names[p]: {key: v.clone() for key, v in s.items()}
                 for p, s in optimizer.state.items()}
        app.state, _ = app._step(app._device_batch(batch))
        ref = _reference_update(optimizer, names, before, state,
                                {n: p.grad for n, p in model.named_parameters()}, lrs[k])
        for n, p in model.named_parameters():
            change = torch.linalg.vector_norm(ref[n] - before[n].double())
            bound = 1e-5 * change + 2.0**-23 * torch.linalg.vector_norm(ref[n])
            assert change > 0 and torch.linalg.vector_norm(p.double() - ref[n]) <= bound, (k, n)
    (step,) = app._captured_steps.values()
    assert step.graph is not None and step.calls == 6


@pytest.mark.cuda
@pytest.mark.parametrize("explicit", [False, True], ids=["default_generator", "own_generator"])
def test_replays_draw_new_dropout_masks(cuda, explicit):
    # Head dropout 0.5 and DropPath 0.3, LR 0, one fixed batch: the
    # parameters stay, and every update's loss differs (new masks at each
    # replay).
    model = _small_mvit(cuda, head_dropout_rate=0.5, droppath_rate_block=0.3)
    if explicit:
        for i, module in enumerate([*model.blocks, model.head.dropout]):
            module.generator = torch.Generator(device=cuda).manual_seed(40 + i)
    app = _train_app(model, _CardClips((4, 32, 32), fixed=True), steps=5, **{
        "lr_scheduler.lr_policy": "steps_with_relative_lrs", "lr_scheduler.lr": 0.0,
        "lr_scheduler.steps": [0], "lr_scheduler.lrs": [1.0], "lr_scheduler.warmup_iters": 0,
        "mix.enabled": False})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = app.train()  # two warm-up updates, then three replays
    assert len(set(losses)) == 5, losses
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.cuda
def test_load_checkpoint_then_step_equals_the_eager_step(cuda, tmp_path):
    # Train (captured), save, load into a fresh app that holds a graph
    # (which it drops), then three updates through the captured step (two
    # warm-up updates, the capture's replay): the same as eager updates from
    # the same checkpoint.
    model = _small_mvit(cuda, head_dropout_rate=0.0)
    data = _CardClips((4, 32, 32))
    app = _train_app(model, data, steps=4, **{"trainer.checkpoint_dir": str(tmp_path)})
    app.train()
    path = str(tmp_path / "ckpt_0.pt")
    grads = {}
    for form in ("captured", "eager"):
        other = _train_app(_small_mvit(cuda, head_dropout_rate=0.0), data, steps=3)
        other.train()
        assert all(s.graph is not None for s in other._captured_steps.values())
        other.load_checkpoint(path)
        assert not other._captured_steps and other.state.step == 4
        lr = other.state.optimizer.param_groups[0]["lr"]
        assert lr.device.type == "cuda" and lr.dtype == torch.float32
        assert all(g["lr"] is lr for g in other.state.optimizer.param_groups)
        other.generator.manual_seed(7)
        _, grads[form] = _steps(other, list(data.train_dataloader(3)), form == "captured")
        assert other.state.step == 7
        assert [s.graph is not None for s in other._captured_steps.values()] == (
            [True] if form == "captured" else [])
    for got, ref in zip(grads["captured"], grads["eager"]):
        _assert_grads_close(got, ref)


@pytest.mark.cuda
def test_app_on_the_card_captures_and_tests_through_graphs(cuda):
    # A small X3D on the X3D-XS preset (SGD, BN): train() captures, test()
    # and predict() replay one eval graph per clip shape, and test()'s
    # ensembling equals the one by hand from predict().
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    model = _small_x3d(cuda)
    cfg = get_preset("classification_x3d_xs", **{
        "model.num_classes": 7, "trainer.max_epochs": 1, "trainer.precise_bn_batches": 2})
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=_CardClips((4, 32, 32), 4),
                                      steps_per_epoch=3)
    app.train()
    (step,) = app._captured_steps.values()
    assert step.graph is not None and app.state.step == 3
    assert all(m.num_batches_tracked.item() == 3 for m in model.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))
    result = app.test()
    predictions = app.predict()
    assert len(app._captured_evals) == 1
    logits = torch.cat([p["logits"] for p in predictions])
    index = torch.cat([p["video_index"] for p in predictions])
    labels = torch.cat([p["label"] for p in predictions])
    summed = torch.zeros(4, 7).index_add_(0, index, logits.float())
    truth = torch.zeros(4, dtype=torch.long).index_copy_(0, index, labels)
    assert result == {"video_top1": (summed.argmax(-1) == truth).float().mean().item()}
    with torch.no_grad():
        eager = model.eval()(app._device_batch(next(app.datamodule.val_dataloader(None)))["video"])
    torch.testing.assert_close(predictions[0]["logits"], eager.cpu(), rtol=1e-5, atol=1e-5)


# The data feed on the card (no kernel: the prefetch's streams and events,
# and the transforms' device arithmetic against the CPU's).

@pytest.mark.cuda
def test_device_prefetch_on_the_card(cuda):
    import numpy as np

    from pytorchvideo_tpu_torch.data import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"video": rng.integers(0, 256, size=(4, 6, 32, 40, 3), dtype=np.uint8),
                "label": torch.arange(4) + i, "name": ["a", "b", "c", "d"],
                "pathways": [torch.rand(4, 3), np.zeros((4, 2), np.float32)]}
               for i in range(7)]
    # The consumer computes on a stream of its own: it must wait for each copy.
    consumer = torch.cuda.Stream(cuda)
    with torch.cuda.stream(consumer), device_prefetch(iter(batches), cuda, size=2) as stream:
        got = []
        for b in stream:
            assert b["video"].is_cuda and b["name"] == ["a", "b", "c", "d"]
            got.append({"video": b["video"].float().sum((1, 2, 3, 4)).cpu(),
                        "label": b["label"].cpu(), "p0": b["pathways"][0].cpu()})
        assert stream.pinned_allocations == stream.ring_size * 4
    for b, g in zip(batches, got):
        torch.testing.assert_close(g["video"], torch.from_numpy(b["video"]).float().sum(
            (1, 2, 3, 4)), rtol=0, atol=0)
        assert torch.equal(g["label"], b["label"]) and torch.equal(g["p0"], b["pathways"][0])

    # A store gathered straight into the pinned ring, transformed in the
    # prefetch's stream.
    import tempfile

    from pytorchvideo_tpu_torch.data import ClipStore, prepare_clip_store

    with tempfile.TemporaryDirectory() as tmp:
        prepare_clip_store([{"video": b["video"][0], "label": i, "video_index": i}
                            for i, b in enumerate(batches)], tmp, num_workers=1)
        store = ClipStore(tmp)
        with torch.cuda.stream(consumer), store.prefetch(
                2, cuda, seed=1, epochs=3,
                transform=lambda b: {**b, "video": b["video"].float() * 2}) as stream:
            got = [b["video"].sum().cpu() for b in stream]
            assert stream.pinned_allocations == stream.ring_size * 3
        want = [b["video"].float().sum() * 2 for b in store.batches(2, seed=1, epochs=3)]
        assert len(got) == 9 and all(torch.equal(a, b) for a, b in zip(got, want))

    def failing():
        yield {"x": torch.zeros(3)}
        raise KeyError("boom")

    stream = device_prefetch(failing(), cuda)
    assert next(stream)["x"].is_cuda
    with pytest.raises(KeyError, match="boom"):
        next(stream)

    def endless():
        while True:
            yield {"x": torch.zeros(1 << 20)}

    stream = device_prefetch(endless(), cuda)
    next(stream)
    stream.close(timeout=10)
    assert not stream.alive


@pytest.mark.cuda
def test_transforms_on_the_card_match_the_cpu(cuda):
    import numpy as np

    from pytorchvideo_tpu_torch.transforms import augmentations as A
    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms.augmix import AugMix
    from pytorchvideo_tpu_torch.transforms.rand_augment import RandAugment
    from pytorchvideo_tpu_torch.transforms.transforms_factory import create_video_transform

    u8 = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(8, 48, 64, 3),
                                                            dtype=np.uint8))
    f32 = u8.float() / 255.0
    exact = {"subsample": lambda x: F.uniform_temporal_subsample(x, 5),
             "crop": lambda x: F.uniform_crop(x, 40, 2), "flip": F.horizontal_flip,
             **{name: A._NAME_TO_TRANSFORM_FUNC[name] for name in ("Equalize", "Invert")},
             "Posterize": lambda x: A._posterize(x, 3), "Solarize": lambda x: A._solarize(x, 0.4)}
    for name, fn in exact.items():
        for x in (u8, f32):
            assert torch.equal(fn(x.to(cuda)).cpu(), fn(x)), name
    floats = {"resize": lambda x: F.resize(x, (30, 70)),
              "crop_and_resize": lambda x: F.crop_and_resize(x, 0.0, 0.0, 20.0, 25.0, 48, 64),
              "normalize": lambda x: F.normalize(x.float(), (0.45, 0.4, 0.35),
                                                 (0.2, 0.25, 0.3)),
              **{name: (lambda x, op=op: op(x, 0.7, fill=(0.5, 0.5, 0.5))) if name not in (
                  "AutoContrast", "Equalize", "Invert") else op
                 for name, op in A._NAME_TO_TRANSFORM_FUNC.items()},
              "RandAugment": lambda x: RandAugment(prob=1.0, seed=3)(x),
              "AugMix": lambda x: AugMix(seed=4)(x),
              "train chain": lambda x: create_video_transform(
                  "train", num_samples=4, min_size=48, max_size=56, crop_size=40,
                  aug_type="randaug", seed=5)(x if x.dtype == torch.uint8 else
                                              (x * 255).to(torch.uint8))}
    for name, fn in floats.items():
        for x in (u8, f32):
            want = fn(x)
            got = fn(x.to(cuda)).cpu()
            span = float(want.double().max() - want.double().min()) or 1.0
            assert float((got.double() - want.double()).abs().max()) <= 1e-5 * span, name


@pytest.mark.cuda
def test_captures_beside_a_running_prefetch(cuda):
    # The app's datamodule prefetches in a thread of its own (event waits,
    # pinned allocations) while the app captures its step and its eval
    # forward: the captures are thread-local, so they hold.
    import tempfile

    import numpy as np

    from pytorchvideo_tpu_torch.data import ClipStore, prepare_clip_store
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    class StoreData:
        def __init__(self, store):
            self.store = store

        def _batches(self, n, seed):
            def to_clip(batch):
                video = batch["video"].permute(0, 4, 1, 2, 3).float() / 255
                return {**batch, "video": video, "label": batch["label"] % 7}
            stream = self.store.prefetch(4, cuda, seed=seed, epochs=None, transform=to_clip)
            with stream:
                for _ in range(n):
                    yield next(stream)

        def train_dataloader(self, n):
            return self._batches(n, 0)

        def val_dataloader(self, _):
            return self._batches(2, 1)

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        prepare_clip_store([{"video": rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8),
                             "label": i, "video_index": i} for i in range(16)], tmp,
                           num_workers=1)
        cfg = get_preset("classification_x3d_xs", **{"model.num_classes": 7,
                                                    "trainer.max_epochs": 1})
        app = VideoClassificationTrainApp(cfg, model=_small_x3d(cuda),
                                          datamodule=StoreData(ClipStore(tmp)),
                                          steps_per_epoch=5)
        losses = app.train()
        (step,) = app._captured_steps.values()
        assert step.graph is not None and app.state.step == 5
        assert all(math.isfinite(h) for h in losses)
        assert len(app.predict()) == 2 and len(app._captured_evals) == 1
