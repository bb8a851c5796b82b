"""pytorchvideo_tpu_torch's fused kv-pool + LayerNorm + attention against the
JAX package's (ops/fused_kvpool_attention.py, ``PVT_FUSED_KVPOOL=1``): the op
on the four cases of tests/test_ops_fused_kvpool.py against the JAX kernel in
Pallas interpret mode and against its XLA reference; its nine gradients
against ``jax.grad`` through the JAX custom VJP; a ``MultiScaleBlock`` and a
3-block MViT with ``fused_kvpool=True`` against the JAX ones under
``PVT_FUSED_KVPOOL=1``; the card's ``fusable`` gate against the TPU's. The
same seeded numpy arrays go to both. The CUDA kernel is held against the plain
version here on the card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.attention import MultiScaleBlock as JaxMultiScaleBlock
from pytorchvideo_tpu.ops import fused_kvpool_attention as jax_fk
from pytorchvideo_tpu.ops.pooled_attention import pooled_attention_packed_xla
from pytorchvideo_tpu_torch.layers import attention as port_attention
from pytorchvideo_tpu_torch.layers.attention import MultiScaleBlock
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import (
    SMALL_MVIT,
    TOL,
    init_variables,
    jax_logits,
    small_mvit_pair,
    torch_logits,
)

# The JAX op tests' own tolerances (tests/test_ops_fused_kvpool.py:71, :99).
# The gradients also get f32's relative precision: the LayerNorm parameters'
# gradients (up to ~500) sum ~1000 rows in another order than XLA's.
OUT_ATOL = 2e-4
GRAD_TOL = dict(atol=3e-4, rtol=1e-5)

# (thw, heads, head_dim, stride, has_cls, residual): tests/test_ops_fused_kvpool.py:23-29.
CASES = [
    ((4, 16, 16), 1, 32, (1, 8, 8), True, True),
    ((4, 16, 16), 2, 16, (1, 4, 4), True, False),
    ((2, 8, 8), 1, 96, (1, 4, 4), False, True),
    ((4, 12, 20), 2, 32, (1, 4, 4), True, True),
]


def _make(case, seed=0):
    """The arrays and keywords of tests/test_ops_fused_kvpool.py `_make`, as numpy."""
    thw, heads, head_dim, stride, has_cls, residual = case
    rng = np.random.default_rng(seed)
    B, HC, L = 2, heads * head_dim, int(np.prod(thw))

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    q, kg, vg = normal(B, L, HC), normal(B, L, HC), normal(B, L, HC)
    wk, wv = normal(27, HC, scale=0.2), normal(27, HC, scale=0.2)
    lnk, lnv = normal(2, HC, scale=0.3, shift=1.0), normal(2, HC, scale=0.3, shift=1.0)
    cls_k = normal(B, 1, HC) if has_cls else None
    cls_v = normal(B, 1, HC) if has_cls else None
    kw = dict(thw=thw, num_heads=heads, scale=head_dim**-0.5, residual=residual,
              kernel=(3, 3, 3), stride=stride)
    return (q, kg, vg, wk, wv, lnk, lnv, cls_k, cls_v), kw


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _jax_pallas(arrays, kw):
    # The JAX kernel in Pallas interpret mode, as tests/test_ops_fused_kvpool.py runs it.
    return jax_fk.fused_kvpool_attention(
        *arrays, kw["thw"], kw["num_heads"], kw["scale"], kw["residual"], kw["kernel"],
        kw["stride"], 1e-6, 128, True)


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_plain_matches_jax_kernel_and_reference(case):
    arrays, kw = _make(case)
    pallas = _jax_pallas(_jax(arrays), kw)
    xla = jax_fk.fused_kvpool_attention_xla(*_jax(arrays), **kw)
    before = fk.fused_kvpool_attention_cuda.launches
    ours = fk.fused_kvpool_attention(*_torch(arrays), **kw)
    assert fk.fused_kvpool_attention_cuda.launches == before  # the CPU takes the plain version
    assert len(ours) == 3
    for got, a, b in zip(ours, pallas, xla):
        assert got.shape == a.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=OUT_ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=OUT_ATOL)


def test_cls_query_matches_jax_layer_composition():
    # The port's cls_q output is what the JAX layer computes outside the op
    # (attention.py:441-447): the cls query over [cls row, pooled grid].
    arrays, kw = _make(CASES[0], seed=1)
    cls_q = np.random.default_rng(2).standard_normal(arrays[0][:, :1].shape).astype(np.float32)
    _, kp, vp = _jax_pallas(_jax(arrays), kw)
    ref = pooled_attention_packed_xla(
        jnp.asarray(cls_q), jnp.concatenate([jnp.asarray(arrays[7]), kp], axis=1),
        jnp.concatenate([jnp.asarray(arrays[8]), vp], axis=1), kw["num_heads"], kw["scale"],
        kw["residual"])
    ours = fk.fused_kvpool_attention(*_torch(arrays), **kw, cls_q=torch.from_numpy(cls_q))
    assert len(ours) == 4 and ours[3].shape == (2, 1, arrays[0].shape[2])
    np.testing.assert_allclose(ours[3].numpy(), np.asarray(ref), atol=OUT_ATOL)


def _loss_torch(out, kp, vp):
    return (out * torch.cos(out)).sum() + (kp * vp).sum()


def test_grads_match_jax():
    # tests/test_ops_fused_kvpool.py:76-99: all nine gradients, through the
    # JAX custom VJP (its backward recomputes through the XLA reference).
    arrays, kw = _make(CASES[1], seed=3)

    def loss_jax(*xs):
        out, kp, vp = _jax_pallas(xs, kw)
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(kp * vp)

    ref = jax.grad(loss_jax, argnums=tuple(range(9)))(*_jax(arrays))
    leaves = _torch(arrays, grad=True)
    ours = torch.autograd.grad(_loss_torch(*fk.fused_kvpool_attention(*leaves, **kw)), leaves)
    assert len(ours) == 9
    for got, want in zip(ours, ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_grads_with_per_head_taps_and_cls_query():
    # The layer's form: taps and LayerNorm parameters per head, (27, c) and
    # (2, c), shared by every head (column j % c), and the cls query. Held
    # against autograd through the plain version given the head-tiled copies.
    arrays, kw = _make(CASES[3], seed=4)
    c = arrays[0].shape[2] // kw["num_heads"]
    rng = np.random.default_rng(5)
    per_head = [(rng.standard_normal((27, c)) * 0.2).astype(np.float32),
                (rng.standard_normal((27, c)) * 0.2).astype(np.float32),
                (rng.standard_normal((2, c)) * 0.3 + 1.0).astype(np.float32),
                (rng.standard_normal((2, c)) * 0.3 + 1.0).astype(np.float32)]
    cls_q = rng.standard_normal((2, 1, arrays[0].shape[2])).astype(np.float32)
    inputs = [*arrays[:3], *per_head, *arrays[7:], cls_q]

    def loss(outs):
        return _loss_torch(*outs[:3]) + (outs[3] ** 2).sum()

    leaves = _torch(inputs, grad=True)
    ours = torch.autograd.grad(
        loss(fk.fused_kvpool_attention(*leaves[:9], **kw, cls_q=leaves[9])), leaves)
    ref_leaves = _torch(inputs, grad=True)
    tiled = [t.repeat(1, kw["num_heads"]) for t in ref_leaves[3:7]]
    ref = torch.autograd.grad(
        loss(fk.fused_kvpool_attention_torch(*ref_leaves[:3], *tiled, *ref_leaves[7:9], **kw,
                                             cls_q=ref_leaves[9])), ref_leaves)
    for got, want in zip(ours, ref):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_fusable_gate():
    # The JAX gate's refusals about what the op computes give the same answers.
    refused = [((8, 56, 56), 96, None, (1, 8, 8)),  # no pool
               ((8, 56, 56), 96, (3, 3, 3), (2, 8, 8)),  # t stride
               ((8, 56, 56), 96, (1, 3, 3), (1, 8, 8))]  # not (3, 3, 3)
    for args in refused:
        assert not jax_fk.fusable(*args)
        assert not fk.fusable(*args, head_dim=96)
    for args in [((8, 56, 56), 96, (3, 3, 3), (1, 8, 8)), ((8, 28, 28), 192, (3, 3, 3), (1, 4, 4))]:
        assert jax_fk.fusable(*args) and fk.fusable(*args, head_dim=96)
    # What the TPU refused (stride 2 and 1 splits, the VMEM budget), the card
    # takes: every kv pool of MViT-B 16x4.
    for args in [((8, 14, 14), 384, (3, 3, 3), (1, 2, 2)), ((8, 14, 14), 768, (3, 3, 3), (1, 1, 1)),
                 ((8, 7, 7), 768, (3, 3, 3), (1, 1, 1)), ((16, 112, 112), 768, (3, 3, 3), (1, 8, 8))]:
        assert not jax_fk.fusable(*args)
        assert fk.fusable(*args, head_dim=96)
    # The card's own limit: head_dim <= 128 (the kernels' width).
    assert not fk.fusable((8, 14, 14), 768, (3, 3, 3), (1, 2, 2), head_dim=192)
    assert fk.pool_out(56, 3, 8, 1) == 7 and fk.pool_out(12, 3, 4, 1) == 3


# tests/test_ops_fused_kvpool.py:111-150's block; a stride-2 kv pool (the
# JAX gate takes the unfused path there) and no cls token.
BLOCK_CASES = [((1, 4, 4), True), ((1, 2, 2), True), ((1, 4, 4), False)]


def _count_fused(monkeypatch):
    calls = []
    monkeypatch.setattr(port_attention, "fused_kvpool_attention",
                        lambda *a, **k: calls.append(1) or fk.fused_kvpool_attention(*a, **k))
    return calls


@pytest.mark.parametrize("stride_kv, has_cls", BLOCK_CASES, ids=["s4_cls", "s2_cls", "s4"])
def test_block_matches_jax_fused(stride_kv, has_cls, monkeypatch):
    kw = dict(dim=32, dim_out=32, num_heads=2, stride_q=(1, 2, 2), stride_kv=stride_kv,
              kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), residual_pool=True)
    thw = (4, 8, 8)
    x = np.random.default_rng(5).normal(size=(2, has_cls + 4 * 8 * 8, 32)).astype(np.float32)
    jax_block = JaxMultiScaleBlock(**kw, has_cls_embed=has_cls)
    monkeypatch.setenv("PVT_FUSED_KVPOOL", "0")
    variables = init_variables(jax_block, jnp.asarray(x), thw, False, seed=6)
    monkeypatch.setenv("PVT_FUSED_KVPOOL", "1")

    def jax_loss(params, xx):
        out, _ = jax_block.apply({"params": params}, xx, thw, False)
        return jnp.sum(out * jnp.cos(out)), out

    (_, ref), (ref_grads, ref_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    block = MultiScaleBlock(**kw, has_cls_embed=has_cls, fused_kvpool=True)
    block.load_state_dict(jax_variables_to_state_dict(variables["params"], {}), strict=True)
    block.eval()
    calls = _count_fused(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    (cls_out, grid_out), thw_out = block((xt[:, :1] if has_cls else None, xt[:, has_cls:]), thw)
    assert calls == [1] and thw_out == (4, 4, 4)
    out = grid_out if cls_out is None else torch.cat([cls_out, grid_out], dim=1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out * torch.cos(out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **TOL)
    ref_named = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), {})
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_named[name].numpy(), err_msg=name, **TOL)


def test_three_block_mvit_logits_match_jax(monkeypatch):
    # 4x64x64 clips (tokens (2, 16, 16)): block 0's kv stride (1, 4, 4) is one
    # the JAX gate fuses; blocks 1 and 2 (stride (1, 2, 2)) only the port's.
    monkeypatch.setenv("PVT_FUSED_KVPOOL", "1")
    monkeypatch.setenv("PVT_TOKEN_POOL", "xla")
    variant = dict(spatial_size=64, pool_kv_stride_adaptive=[1, 4, 4])
    jax_model, variables, model, x = small_mvit_pair(**variant)
    fused = create_multiscale_vision_transformers(**{**SMALL_MVIT, **variant}, fused_kvpool=True,
                                                  device="cpu")
    fused.load_state_dict(model.state_dict(), strict=True)
    calls = _count_fused(monkeypatch)
    ours = torch_logits(fused.eval(), x)
    assert len(calls) == 3
    ref = jax_logits(jax_model, variables, x)
    assert ours.shape == (2, 7) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_state_dict_keys_do_not_depend_on_the_flag():
    kw = dict(SMALL_MVIT, device="cpu")
    plain = create_multiscale_vision_transformers(**kw)
    fused = create_multiscale_vision_transformers(**kw, fused_kvpool=True)
    assert all(b.attn.fused_kvpool for b in fused.blocks)
    assert not any(b.attn.fused_kvpool for b in plain.blocks)
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in fused.state_dict().items()}
    # One checkpoint loads into both forms, and both compute the same logits.
    fused.load_state_dict(plain.state_dict(), strict=True)
    x = np.random.default_rng(0).normal(size=(1, 3, 4, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(torch_logits(fused.eval(), x), torch_logits(plain.eval(), x),
                               **TOL)


def test_fused_kvpool_refuses_pool_first():
    with pytest.raises(ValueError, match="pool_first"):
        port_attention.MultiScaleAttention(32, 32, 2, kernel_kv=(3, 3, 3), stride_kv=(1, 2, 2),
                                           pool_first=True, fused_kvpool=True)
