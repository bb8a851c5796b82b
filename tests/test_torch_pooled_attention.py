"""pytorchvideo_tpu_torch.ops.pooled_attention against the JAX package's
pooled attention: the Pallas kernels in interpret mode (as
tests/test_ops_pooled_attention.py runs them) and the XLA paths, in both
layouts, plus the CUDA wrappers' checks that run without a card. The kernel
itself is tested on the card by tests/test_torch_kernels_cuda.py."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_tpu.ops.pooled_attention import (
    pooled_attention_packed_pallas,
    pooled_attention_packed_xla,
    pooled_attention_pallas,
    pooled_attention_xla,
)

# The module (the package exports the JAX package's function under its name).
pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

# f32 throughout: the plain version and the JAX paths differ in summation
# order only (softmax over at most a few hundred keys of O(1) scores).
ATOL = 2e-5


def _qkv(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (shape_q, shape_k, shape_k)]


# (B, Lq, Lk, heads, c, residual): MViT's c = 96; the cls query (Lq 1); a
# ragged Lq that fills no q tile; a narrow c.
PACKED_CASES = [
    (2, 130, 57, 2, 96, True),
    (2, 130, 57, 2, 96, False),
    (1, 1, 50, 4, 96, True),
    (1, 1, 50, 4, 96, False),
    (1, 77, 33, 1, 64, False),
]


@pytest.mark.parametrize("B, Lq, Lk, H, c, residual", PACKED_CASES)
def test_packed_matches_jax(B, Lq, Lk, H, c, residual):
    q, k, v = _qkv((B, Lq, H * c), (B, Lk, H * c), seed=Lq + c)
    scale = c**-0.5
    out = pa.pooled_attention_packed(*map(torch.from_numpy, (q, k, v)), H, scale, residual)
    assert out.shape == (B, Lq, H * c) and out.dtype == torch.float32
    args = tuple(map(jnp.asarray, (q, k, v)))
    xla = pooled_attention_packed_xla(*args, H, scale, residual)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    pallas = pooled_attention_packed_pallas(*args, H, scale, residual, tile_q=128, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)


# (B, heads, Lq, Lk, c, residual), per-head layout of pool_first.
PER_HEAD_CASES = [
    (1, 2, 300, 57, 96, True),
    (2, 1, 130, 50, 96, False),
    (1, 2, 1, 50, 96, True),
    (1, 4, 77, 1, 32, False),
]


@pytest.mark.parametrize("B, H, Lq, Lk, c, residual", PER_HEAD_CASES)
def test_per_head_matches_jax(B, H, Lq, Lk, c, residual):
    q, k, v = _qkv((B, H, Lq, c), (B, H, Lk, c), seed=Lq + Lk)
    scale = c**-0.5
    out = pa.pooled_attention(*map(torch.from_numpy, (q, k, v)), scale, residual)
    assert out.shape == (B, H, Lq, c) and out.dtype == torch.float32
    args = tuple(map(jnp.asarray, (q, k, v)))
    xla = pooled_attention_xla(*args, scale, residual)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    pallas = pooled_attention_pallas(*args, scale, residual, interpret=True, tile_q=256)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)


def test_layouts_agree_and_bf16_is_computed_in_f32():
    # The packed and per-head plain versions are one function in two layouts;
    # bf16 inputs are taken in f32 and the result rounded once.
    B, Lq, Lk, H, c = 2, 20, 9, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv((B, Lq, H * c), (B, Lk, H * c), seed=7))
    packed = pa.pooled_attention_packed_torch(q, k, v, H, 0.3, True)

    def heads(t):
        return t.reshape(B, -1, H, c).transpose(1, 2)

    per_head = pa.pooled_attention_torch(heads(q), heads(k), heads(v), 0.3, True)
    torch.testing.assert_close(per_head.transpose(1, 2).reshape(B, Lq, H * c), packed)
    low = pa.pooled_attention_packed_torch(q.bfloat16(), k.bfloat16(), v.bfloat16(), H, 0.3, True)
    ref = pa.pooled_attention_packed_torch(
        q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(), H, 0.3, True
    )
    assert low.dtype == torch.bfloat16
    torch.testing.assert_close(low, ref.bfloat16(), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 5, 8), (1, 3, 8), seed=8))
    wrappers = (pa.pooled_attention_packed_cuda, pa.pooled_attention_cuda)
    before = [(f.launches, dict(f.launches_by_route)) for f in wrappers]
    pa.pooled_attention_packed(q, k, v, 2, 0.5)
    pa.pooled_attention(q[:, None], k[:, None], v[:, None], 0.5)
    assert [(f.launches, f.launches_by_route) for f in wrappers] == before


@pytest.mark.parametrize(
    "call, message",
    [
        (lambda q, k, v: pa.pooled_attention_packed_cuda(q, k, v, 2, 0.5), "CUDA tensor"),
        (lambda q, k, v: pa.pooled_attention_cuda(q[:, None], k[:, None], v[:, None], 0.5),
         "CUDA tensor"),
        (lambda q, k, v: pa.pooled_attention_packed_cuda(q.double(), k, v, 2, 0.5),
         "float32 or bfloat16"),
        (lambda q, k, v: pa.pooled_attention_packed_cuda(q, k[:, :, :4], v, 2, 0.5),
         r"\(B, Lk, H\*c\)"),
        (lambda q, k, v: pa.pooled_attention_packed_cuda(q, k, v, 3, 0.5), "multiple of 3 heads"),
        (lambda q, k, v: pa.pooled_attention_cuda(q, k, v, 0.5), r"\(B, H, Lq, c\)"),
    ],
)
def test_cuda_wrappers_reject_bad_inputs(call, message):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 5, 8), (1, 3, 8), seed=9))
    with pytest.raises(ValueError, match=message):
        call(q, k, v)


# (dtype, Lq, c, 16-byte aligned, route): bf16 with c % 8 == 0 takes the
# split-key route up to SPLIT_MAX_LQ query rows (MViT's cls query) and the
# tensor cores above; f32, a c that is not a multiple of 8 (no 16-byte rows)
# and a misaligned tensor take the CUDA cores.
ROUTE_CASES = [
    (torch.bfloat16, 1, 96, True, "split_key"),
    (torch.bfloat16, pa.SPLIT_MAX_LQ, 96, True, "split_key"),
    (torch.bfloat16, pa.SPLIT_MAX_LQ + 1, 96, True, "tensor_core"),
    (torch.bfloat16, 25089, 96, True, "tensor_core"),
    (torch.bfloat16, 77, 40, True, "tensor_core"),
    (torch.bfloat16, 1, 36, True, "cuda_core"),
    (torch.bfloat16, 392, 96, False, "cuda_core"),
    (torch.float32, 1, 96, True, "cuda_core"),
    (torch.float32, 392, 96, True, "cuda_core"),
]


@pytest.mark.parametrize("dtype, Lq, c, aligned, route", ROUTE_CASES)
def test_forward_route(dtype, Lq, c, aligned, route):
    assert pa.forward_route(dtype, Lq, c, aligned) == route


@pytest.mark.parametrize("Lk", [1, 9, 393, 1569, 3137])
@pytest.mark.parametrize("B, H", [(1, 1), (2, 2), (32, 2), (32, 8)])
def test_split_plan_covers_the_keys_once(B, H, Lk):
    splits, per = pa.split_plan(B, H, Lk)
    runs = [range(s * per, min((s + 1) * per, Lk)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [key for r in runs for key in r] == list(range(Lk))


def _split_case(Lq, Lk, residual, seed):
    """Head-packed q, k, v (B 2, H*c 2x8) and the plain split version's
    output (packed back) and lse."""
    H, c = 2, 8
    q, k, v = _qkv((2, Lq, H * c), (2, Lk, H * c), seed=seed)
    out, lse = pa.pooled_attention_split_torch(
        *(pa._heads(torch.from_numpy(a), H) for a in (q, k, v)), c**-0.5, residual)
    return (q, k, v), pa._packed(out), lse


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("Lk", [5, 393, 1569])
@pytest.mark.parametrize("Lq", [1, 3])
def test_split_matches_plain_and_jax(Lq, Lk, residual):
    # Per-split partials combined in split order against the one-pass plain
    # version and the JAX package's XLA path, at ROADMAP's parity tolerance.
    (q, k, v), out, _ = _split_case(Lq, Lk, residual, seed=Lq * Lk)
    assert out.shape == (2, Lq, 16) and out.dtype == torch.float32
    plain = pa.pooled_attention_packed_torch(*map(torch.from_numpy, (q, k, v)), 2, 8**-0.5,
                                             residual)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=5e-3, atol=5e-4)
    xla = pooled_attention_packed_xla(*map(jnp.asarray, (q, k, v)), 2, 8**-0.5, residual)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("Lk", [5, 393, 1569])
@pytest.mark.parametrize("Lq", [1, 3])
def test_split_lse_matches_plain(Lq, Lk):
    (q, k, _), _, lse = _split_case(Lq, Lk, False, seed=Lq + Lk)
    ref = pa.attention_lse_torch(*(pa._heads(torch.from_numpy(a), 2) for a in (q, k)), 8**-0.5)
    assert lse.shape == (2, 2, Lq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref, rtol=5e-3, atol=5e-4)


# backward_route by dtype, Lq on both sides of SPLIT_MAX_LQ, a c the
# tensor-core tiles pad (40) or fill (96), and alignment of q, k, v, o, g:
# the forward's rule.
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", [40, 96])
@pytest.mark.parametrize("Lq", [1, 8, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route(dtype, Lq, c, aligned):
    route = pa.backward_route(dtype, Lq, c, aligned)
    if dtype == torch.float32 or not aligned:
        assert route == "cuda_core"
    else:
        assert route == ("split_key" if Lq <= pa.SPLIT_MAX_LQ else "tensor_core")
    assert route == pa.forward_route(dtype, Lq, c, aligned)
    assert pa.backward_route(dtype, Lq, 36, aligned) == "cuda_core"


def test_cpu_backward_takes_the_plain_version():
    # The dispatchers' backward on CPU tensors launches nothing and moves no
    # route counter.
    B, Lq, Lk, H, c = 1, 3, 5, 2, 8
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv((B, Lq, H * c), (B, Lk, H * c),
                                                                   seed=10))
    wrappers = (pa.pooled_attention_packed_bwd_cuda, pa.pooled_attention_bwd_cuda)
    before = [(f.launches, dict(f.launches_by_route)) for f in wrappers]
    assert all(set(f.launches_by_route) == set(pa.BACKWARD_ROUTES) for f in wrappers)
    out = pa.pooled_attention_packed(q, k, v, H, 0.5, True)
    torch.autograd.grad(out.sum(), (q, k, v))
    heads = [pa._heads(t, H) for t in (q, k, v)]
    torch.autograd.grad(pa.pooled_attention(*heads, 0.5).sum(), (q, k, v))
    assert [(f.launches, f.launches_by_route) for f in wrappers] == before


@pytest.mark.parametrize("sizes", [(5, 0, 0), (7, 9, 9), (1, 30, 30), (12,)])
def test_backward_scratch_is_one_aligned_buffer(sizes):
    # (An empty piece, the dk/dv partials of a single q split, is never read.)
    pieces = pa._scratch(torch.device("cpu"), *sizes)
    assert [p.numel() for p in pieces] == list(sizes)
    used = [p for p in pieces if p.numel()]
    assert all(p.untyped_storage().data_ptr() == used[0].untyped_storage().data_ptr()
               for p in used)
    assert all((p.data_ptr() - used[0].data_ptr()) % 16 == 0 for p in used)
    ends = [p.data_ptr() + 4 * p.numel() for p in used]
    assert all(end <= nxt.data_ptr() for end, nxt in zip(ends, used[1:]))


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("B, H, Lq, Lk", [(8, 1, 25089, 393), (8, 8, 393, 1569), (2, 2, 9, 1),
                                          (8, 4, 1569, 393)])
def test_bwd_splits_cover_the_q_tiles_once(B, H, Lq, Lk, keys):
    # Every split of the dk/dv kernel's q axis has at least one 64-row tile,
    # the splits cover the tiles once, and the blocks reach the target
    # unless the q tiles run out.
    splits, per = pa.bwd_splits(B, H, Lq, Lk, keys)
    q_tiles = -(-Lq // 64)
    assert (splits - 1) * per < q_tiles <= splits * per
    blocks = -(-Lk // keys) * B * H * splits
    assert blocks >= pa._BWD_TARGET_BLOCKS or splits == q_tiles
