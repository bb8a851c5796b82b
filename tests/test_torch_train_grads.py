"""Gradients of pytorchvideo_tpu_torch's kernel ops against the JAX package's
custom VJPs, whose backward runs its Pallas kernels in interpret mode (as
tests/test_ops_pooled_attention.py and tests/test_ops_token_pool.py run
them): the pooled attention in both layouts (``pooled_attention_packed_ad``,
``pooled_attention_pallas_ad``) and the conv token pool (``_token_pool_ad``),
head-packed included. Also the port's explicit plain backward formulas
against ``torch.autograd`` through the plain forwards. The CUDA backward
kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py.

The conv pool's tiled dx and dw kernels are held here by their arithmetic
too: ``depthwise_token_pool_dx_tiled_torch`` and
``depthwise_token_pool_dw_tiled_torch`` (the tiled walk, dw's block partials
and their reduction order) against the plain backward and ``jax.vjp`` of
``_token_pool_ad`` in interpret mode.

The attention backward's bf16 routes are held here by their arithmetic: the split-key
route's plain version (``pooled_attention_bwd_split_torch``) against the
one-pass plain backward and ``jax.vjp`` of the JAX package's XLA paths, and
an emulation of the tensor-core route's roundings against the f32 plain
backward, which pins down which of its operands carry a lo term."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.ops.pooled_attention import (
    pooled_attention_packed_ad,
    pooled_attention_packed_xla,
    pooled_attention_pallas_ad,
    pooled_attention_xla,
)
from pytorchvideo_tpu.ops.token_pool import _token_pool_ad
from pytorchvideo_tpu_torch.ops import token_pool as tp
from torch_port_helpers import TOL

# The module (the package exports the JAX package's function under its name).
pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

# The plain backward against autograd of the plain forward: both f32, one
# function differentiated two ways (summation order only).
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _torch_grads(fn, inputs, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(g))


# (B, Lq, Lk, heads, c, residual): c = 96 as in MViT; the cls query (Lq 1);
# an Lq that is not a multiple of the JAX kernel's 128-row tile.
PACKED_CASES = [
    (2, 130, 57, 2, 96, True),
    (2, 130, 57, 2, 96, False),
    (1, 1, 50, 4, 96, True),
    (1, 1, 50, 4, 96, False),
    (1, 77, 33, 1, 64, False),
]


@pytest.mark.parametrize("B, Lq, Lk, H, c, residual", PACKED_CASES)
def test_packed_grads_match_jax_pallas(B, Lq, Lk, H, c, residual):
    q, k, v, g = _arrays([(B, Lq, H * c), (B, Lk, H * c), (B, Lk, H * c), (B, Lq, H * c)], Lq + c)
    scale = c**-0.5
    before = pa.pooled_attention_packed_bwd_cuda.launches
    out, grads = _torch_grads(lambda *t: pa.pooled_attention_packed(*t, H, scale, residual),
                              (q, k, v), g)
    # On the CPU the wrapper takes the plain backward; no kernel runs.
    assert pa.pooled_attention_packed_bwd_cuda.launches == before
    ref_out, vjp = jax.vjp(
        lambda a, b, d: pooled_attention_packed_ad(a, b, d, H, scale, residual, 128, True),
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    for ours, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# (B, heads, Lq, Lk, c, residual), per-head layout of pool_first.
PER_HEAD_CASES = [
    (1, 2, 300, 57, 96, True),
    (2, 1, 130, 50, 96, False),
    (1, 2, 1, 50, 96, True),
    (1, 4, 77, 9, 32, False),
]


@pytest.mark.parametrize("B, H, Lq, Lk, c, residual", PER_HEAD_CASES)
def test_per_head_grads_match_jax_pallas(B, H, Lq, Lk, c, residual):
    q, k, v, g = _arrays([(B, H, Lq, c), (B, H, Lk, c), (B, H, Lk, c), (B, H, Lq, c)], Lq + Lk)
    scale = c**-0.5
    _, grads = _torch_grads(lambda *t: pa.pooled_attention(*t, scale, residual), (q, k, v), g)
    _, vjp = jax.vjp(lambda a, b, d: pooled_attention_pallas_ad(a, b, d, scale, residual, True, 256),
                     *map(jnp.asarray, (q, k, v)))
    for ours, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("Lq", [1, 70])
def test_plain_backward_formulas_match_autograd(residual, Lq):
    # The explicit (q, k, v, o, lse, g) -> (dq, dk, dv) formulas, given the
    # plain forward's own o and lse, against autograd through that forward.
    B, Lk, H, c = 2, 33, 2, 16
    q, k, v, g = (torch.from_numpy(a) for a in
                  _arrays([(B, Lq, H * c), (B, Lk, H * c), (B, Lk, H * c), (B, Lq, H * c)], 5))
    o = pa.pooled_attention_packed_torch(q, k, v, H, 0.3, residual)
    lse = pa.attention_lse_torch(pa._heads(q, H), pa._heads(k, H), 0.3)
    got = pa.pooled_attention_packed_bwd_torch(q, k, v, o, lse, g, H, 0.3, residual)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(pa.pooled_attention_packed_torch(*qkv, H, 0.3, residual), qkv, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)
    # The per-head formulas are the same function in the other layout.
    heads = [pa._heads(t, H) for t in (q, k, v, o, g)]
    per_head = pa.pooled_attention_bwd_torch(*heads[:4], lse, heads[4], 0.3, residual)
    for a, b in zip(per_head, got):
        torch.testing.assert_close(pa._packed(a), b, rtol=0, atol=0)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("Lk", [5, 393, 1569])
@pytest.mark.parametrize("Lq", [1, 3])
def test_split_backward_matches_plain_and_jax(Lq, Lk, residual):
    # The split-key route's arithmetic: dq partials per split of the keys
    # (split_plan) summed in split order, dk and dv per key in its split.
    B, H, c = 2, 2, 8
    scale = c**-0.5
    q, k, v, g = _arrays([(B, Lq, H * c), (B, Lk, H * c), (B, Lk, H * c), (B, Lq, H * c)],
                         Lq * Lk + residual)
    qh, kh, vh, gh = (pa._heads(torch.from_numpy(a), H) for a in (q, k, v, g))
    o = pa.pooled_attention_torch(qh, kh, vh, scale, residual)
    lse = pa.attention_lse_torch(qh, kh, scale)
    got = pa.pooled_attention_bwd_split_torch(qh, kh, vh, o, lse, gh, scale, residual)
    splits = pa.split_plan(B, H, Lk)[0]
    assert splits == 1 if Lk == 5 else splits > 1
    plain = pa.pooled_attention_bwd_torch(qh, kh, vh, o, lse, gh, scale, residual)
    for a, b in zip(got, plain):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, **TOL)
    # Head-packed against the JAX package's packed XLA path, per-head
    # against its per-head one.
    _, vjp = jax.vjp(lambda a, b, d: pooled_attention_packed_xla(a, b, d, H, scale, residual),
                     *map(jnp.asarray, (q, k, v)))
    for ours, ref in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(pa._packed(ours).numpy(), np.asarray(ref), **TOL)
    per_head = [np.ascontiguousarray(t.numpy()) for t in (qh, kh, vh, gh)]
    _, vjp = jax.vjp(lambda a, b, d: pooled_attention_xla(a, b, d, scale, residual),
                     *map(jnp.asarray, per_head[:3]))
    for ours, ref in zip(got, vjp(jnp.asarray(per_head[3]))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# The card's bf16 gradient tolerance (tests/test_torch_kernels_cuda.py,
# chip_smoke.GRAD_TOL): |err| <= rtol |ref| + atol_rel max |ref|.
BF16_GRAD_TOL = dict(rtol=2**-7, atol_rel=2e-3)


def _bf16_operand(x, lo: bool):
    """x as the tensor-core route passes an A operand: bf16(x), or hi + lo
    with hi = x with its low 16 bits cut and lo = bf16(x - hi)."""
    if not lo:
        return x.bfloat16().float()
    hi = (x.view(torch.int32) & ~0xFFFF).view(torch.float32)
    return hi + (x - hi).bfloat16().float()


def _tensor_core_rounding(q, k, v, o, lse, g, scale, residual, lo: bool):
    """The tensor-core backward's arithmetic on the CPU: S and dP exact in
    f32 (bf16 inputs), P and dS rounded as bf16 A operands, each gradient
    rounded once to bf16. Test-side only: no path runs it."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(torch.einsum("bhqc,bhkc->bhqk", qf * scale, kf) - lse[..., None])
    o_attn = o.float() - qf if residual else o.float()
    ds = p * (torch.einsum("bhqc,bhkc->bhqk", gf, vf) - (gf * o_attn).sum(-1, keepdim=True))
    p, ds = _bf16_operand(p, lo), _bf16_operand(ds, lo)
    dq = torch.einsum("bhqk,bhkc->bhqc", ds, kf) * scale + (gf if residual else 0.0)
    dk = torch.einsum("bhqk,bhqc->bhkc", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqc->bhkc", p, gf)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _share_of_bf16_bound(got, ref) -> float:
    """The worst element's |err| over its BF16_GRAD_TOL bound."""
    bound = BF16_GRAD_TOL["atol_rel"] * ref.abs().max() + BF16_GRAD_TOL["rtol"] * ref.abs()
    return ((got.float() - ref).abs() / bound).max().item()


def _bf16_case(seed, B, H, Lq, Lk, c, residual):
    """Seeded bf16 inputs, the plain forward's o and lse, and the f32 plain
    backward on them."""
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in
                  _arrays([(B, H, Lq, c), (B, H, Lk, c), (B, H, Lk, c), (B, H, Lq, c)], seed))
    o = pa.pooled_attention_torch(q, k, v, c**-0.5, residual)
    lse = pa.attention_lse_torch(q, k, c**-0.5)
    ref = pa.pooled_attention_bwd_torch(*(t.float() for t in (q, k, v, o)), lse, g.float(),
                                        c**-0.5, residual)
    return (q, k, v, o, lse, g), ref


# (seed, B, heads, Lq, Lk, c, residual): few keys, where the rounding of P
# and dS weighs most, and an MViT-B shape (384 / 4 heads, Lk 393) at B1.
LO_CASES = [(1, 2, 2, 65, 1, 64, True), (2, 2, 2, 65, 5, 64, False), (3, 2, 2, 129, 9, 96, True),
            (4, 1, 4, 1568, 393, 96, False)]


@pytest.mark.parametrize("case", LO_CASES, ids=lambda t: "q%d_k%d_c%d" % t[3:6])
def test_tensor_core_rounding_with_lo_terms_holds_the_bf16_tolerance(case):
    seed, *shape, residual = case
    inputs, ref = _bf16_case(seed, *shape, residual)
    got = _tensor_core_rounding(*inputs, shape[-1]**-0.5, residual, lo=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        # Within half the bound, as every seeded case tried.
        assert _share_of_bf16_bound(a, b) < 0.5, name


# A seeded case per gradient where bf16(P) or bf16(dS) alone breaks the
# tolerance: dq (dS K), dk (dS^T Q) and dv (P^T G) each need the lo term.
NO_LO_CASES = [("dq", (13, 2, 2, 65, 5, 64, False)), ("dk", (21, 2, 2, 17, 3, 96, True)),
               ("dv", (8, 2, 2, 17, 3, 96, False))]


@pytest.mark.parametrize("grad, case", NO_LO_CASES, ids=[name for name, _ in NO_LO_CASES])
def test_tensor_core_rounding_without_lo_terms_breaks_the_bf16_tolerance(grad, case):
    seed, *shape, residual = case
    inputs, ref = _bf16_case(seed, *shape, residual)
    without = _tensor_core_rounding(*inputs, shape[-1]**-0.5, residual, lo=False)
    with_lo = _tensor_core_rounding(*inputs, shape[-1]**-0.5, residual, lo=True)
    i = ("dq", "dk", "dv").index(grad)
    assert _share_of_bf16_bound(without[i], ref[i]) > 1.0
    assert _share_of_bf16_bound(with_lo[i], ref[i]) < 0.5


# (input grid (B, T, H, W, C), kernel, stride, weight rows Cw): MViT-B's kv
# pool strides and its q pool, head-packed (Cw < C: the rows are shared by
# C / Cw heads) and not, and an odd geometry with a T stride.
POOL_CASES = [
    ((2, 4, 16, 16, 8), (3, 3, 3), (1, 8, 8), 4),
    ((2, 4, 12, 12, 8), (3, 3, 3), (1, 4, 4), 8),
    ((2, 4, 9, 9, 12), (3, 3, 3), (1, 2, 2), 4),
    ((2, 3, 7, 7, 8), (3, 3, 3), (1, 1, 1), 2),
    ((1, 5, 9, 11, 4), (3, 5, 3), (2, 3, 2), 4),
]


@pytest.mark.parametrize("shape, kernel, stride, Cw", POOL_CASES)
def test_conv_pool_grads_match_jax_pallas(shape, kernel, stride, Cw):
    C = shape[-1]
    x, w = _arrays([shape, (Cw, 1, *kernel)], seed=C + Cw)
    out_shape = (shape[0], *tp.check_geometry(shape, kernel, stride), C)
    (g,) = _arrays([out_shape], seed=1)
    before = (tp.depthwise_token_pool_dx_cuda.launches, tp.depthwise_token_pool_dw_cuda.launches)
    out, (dx, dw) = _torch_grads(lambda a, b: tp.depthwise_token_pool(a, b, stride), (x, w), g)
    assert (tp.depthwise_token_pool_dx_cuda.launches,
            tp.depthwise_token_pool_dw_cuda.launches) == before
    padding = tuple(k // 2 for k in kernel)

    def jax_pool(xx, w_head):
        # The JAX kernel takes a (kt, kh, kw, C) weight: the per-head rows
        # tiled across the heads, so autograd sums the heads' gradients.
        return _token_pool_ad(xx, jnp.tile(w_head, (1, 1, 1, C // Cw)), stride, padding, True)

    ref_out, vjp = jax.vjp(jax_pool, jnp.asarray(x), jnp.asarray(np.transpose(w[:, 0], (1, 2, 3, 0))))
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
    np.testing.assert_allclose(dw.numpy()[:, 0], np.transpose(np.asarray(ref_dw), (3, 0, 1, 2)),
                               **TOL)


@pytest.mark.parametrize("shape, kernel, stride, Cw", POOL_CASES[:3])
def test_plain_pool_backward_matches_autograd(shape, kernel, stride, Cw):
    C = shape[-1]
    x, w = (torch.from_numpy(a) for a in _arrays([shape, (Cw, 1, *kernel)], seed=3))
    out_shape = (shape[0], *tp.check_geometry(shape, kernel, stride), C)
    g = torch.from_numpy(_arrays([out_shape], seed=4)[0])
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref_dx, ref_dw = torch.autograd.grad(tp.depthwise_token_pool_torch(xr, wr, stride), (xr, wr), g)
    torch.testing.assert_close(tp.depthwise_token_pool_dx_torch(g, w, x.shape, stride), ref_dx,
                               **AUTOGRAD_TOL)
    torch.testing.assert_close(tp.depthwise_token_pool_dw_torch(x, g, w, stride), ref_dw,
                               **AUTOGRAD_TOL)


def test_max_and_avg_pool_grads_are_autograd_on_the_cpu():
    # The max and avg pools' backward is PyTorch's own: on the CPU the plain
    # versions under autograd (the JAX package leaves both to XLA).
    x = torch.randn(2, 4, 9, 9, 6, requires_grad=True)
    for pool in (tp.max_token_pool, tp.avg_token_pool):
        out = pool(x, (1, 3, 3), (1, 2, 2))
        (dx,) = torch.autograd.grad(out.sum(), x)
        assert dx.shape == x.shape and torch.isfinite(dx).all() and dx.abs().sum() > 0


# The tiled dx and dw walks: POOL_CASES with the plan's own tiles, and
# ragged cases with forced tiles (H2 not a multiple of the tile rows, T = 2
# under kt = 3, C = 96 with its ragged 32-channel slice, Cw < C, a T stride).
TILED_POOL_CASES = [(*case, None) for case in POOL_CASES] + [
    ((2, 4, 13, 11, 8), (3, 3, 3), (1, 2, 2), 4, (3, 4)),
    ((2, 2, 7, 9, 8), (3, 3, 3), (1, 1, 1), 8, (4, 4)),
    ((1, 3, 6, 6, 96), (3, 3, 3), (1, 2, 2), 32, (2, 2)),
    ((2, 4, 16, 16, 8), (3, 3, 3), (1, 8, 8), 4, (3, 2)),
    ((1, 5, 9, 11, 8), (3, 3, 3), (2, 3, 2), 4, (2, 2)),
]


@pytest.mark.parametrize("shape, kernel, stride, Cw, tile", TILED_POOL_CASES)
def test_tiled_pool_backward_matches_plain_and_jax(shape, kernel, stride, Cw, tile):
    C = shape[-1]
    x, w = _arrays([shape, (Cw, 1, *kernel)], seed=C + Cw + 1)
    out_shape = (shape[0], *tp.check_geometry(shape, kernel, stride), C)
    (g,) = _arrays([out_shape], seed=2)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    plans = {kind: tile and tp.pool_tile_plan(*shape, kernel, stride, torch.float32, kind,
                                              tile=tile) for kind in ("dx", "dw")}
    dx = tp.depthwise_token_pool_dx_tiled_torch(gt, wt, shape, stride, plan=plans["dx"])
    dw = tp.depthwise_token_pool_dw_tiled_torch(xt, gt, wt, stride, plan=plans["dw"])
    assert dx.shape == shape and dw.shape == wt.shape
    torch.testing.assert_close(dx, tp.depthwise_token_pool_dx_torch(gt, wt, shape, stride),
                               **AUTOGRAD_TOL)
    torch.testing.assert_close(dw, tp.depthwise_token_pool_dw_torch(xt, gt, wt, stride),
                               **AUTOGRAD_TOL)
    padding = tuple(k // 2 for k in kernel)
    _, vjp = jax.vjp(lambda xx, w_head: _token_pool_ad(
        xx, jnp.tile(w_head, (1, 1, 1, C // Cw)), stride, padding, True),
        jnp.asarray(x), jnp.asarray(np.transpose(w[:, 0], (1, 2, 3, 0))))
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
    np.testing.assert_allclose(dw.numpy()[:, 0], np.transpose(np.asarray(ref_dw), (3, 0, 1, 2)),
                               **TOL)
