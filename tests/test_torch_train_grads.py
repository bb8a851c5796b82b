"""Gradients of pytorchvideo_tpu_torch's kernel ops against the JAX package's
custom VJPs, whose backward runs its Pallas kernels in interpret mode (as
tests/test_ops_pooled_attention.py and tests/test_ops_token_pool.py run
them): the pooled attention in both layouts (``pooled_attention_packed_ad``,
``pooled_attention_pallas_ad``) and the conv token pool (``_token_pool_ad``),
head-packed included. Also the port's explicit plain backward formulas
against ``torch.autograd`` through the plain forwards. The CUDA backward
kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.ops.pooled_attention import (
    pooled_attention_packed_ad,
    pooled_attention_pallas_ad,
)
from pytorchvideo_tpu.ops.token_pool import _token_pool_ad
from pytorchvideo_tpu_torch.ops import pooled_attention as pa
from pytorchvideo_tpu_torch.ops import token_pool as tp
from torch_port_helpers import TOL

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
