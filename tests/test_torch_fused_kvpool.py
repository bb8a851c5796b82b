"""pytorchvideo_tpu_torch's fused kv-pool + LayerNorm + attention against the
JAX package's (ops/fused_kvpool_attention.py, ``PVT_FUSED_KVPOOL=1``): the op
on the four cases of tests/test_ops_fused_kvpool.py against the JAX kernel in
Pallas interpret mode and against its XLA reference; its nine gradients
against ``jax.grad`` through the JAX custom VJP; a ``MultiScaleBlock`` and a
3-block MViT with ``fused_kvpool=True`` against the JAX ones under
``PVT_FUSED_KVPOOL=1``; the card's ``fusable`` gate against the TPU's. The
same seeded numpy arrays go to both. The CUDA kernel is held against the plain
version here on the card by tests/test_torch_kernels_cuda.py.

The pool-LN launch's tiled route is held here by its plan and its
arithmetic: ``pool_ln_route``, ``pool_ln_tile_plan`` at every MViT-B 16x4 kv
geometry (chip_smoke's MVIT_FUSED) at B1/B8/B32, and ``pool_ln_tiled_torch``,
the replay of the tiled walk, against the port's plain pooled k and v and the
JAX package's ``_pool_ln_xla``."""

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
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from chip_smoke import MVIT_FUSED, needed_positions
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


# The replay against the plain version: f32 sums of 27 products in another
# order, then a LayerNorm (tests/test_models_parity.py:24).
REPLAY_TOL = dict(rtol=5e-3, atol=5e-4)
# MViT-B 16x4's seven kv geometries (chip_smoke's MVIT_FUSED: H*c, heads and
# stride as they are), on grids cut to T = 4 (the ring of 3 + 2 planes wraps)
# and H, W that still give each stride at least two tiles along H2 or W2.
REPLAY_GRIDS = [(4, 20, 20), (4, 20, 20), (4, 12, 16), (4, 10, 10), (4, 7, 9), (4, 6, 6),
                (4, 5, 7)]
REPLAY_CASES = [(grid, HC, heads, stride) for grid, (_, HC, heads, stride, _, _)
                in zip(REPLAY_GRIDS, MVIT_FUSED)]


def _pool_ln_arrays(B, thw, HC, heads, per_head, has_cls, seed):
    """k and v grids, their taps and LayerNorm parameters (per head, (27, c)
    and (2, c), or head-tiled, (27, H*c) and (2, H*c)) and cls rows, as numpy."""
    rng = np.random.default_rng(seed)
    Cw = HC // heads if per_head else HC
    L = int(np.prod(thw))

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    grids = [normal(B, L, HC) for _ in range(2)]
    taps = [normal(27, Cw, scale=0.2) for _ in range(2)]
    lns = [normal(2, Cw, scale=0.3, shift=1.0) for _ in range(2)]
    cls = [normal(B, 1, HC) if has_cls else None for _ in range(2)]
    return grids, taps, lns, cls


@pytest.mark.parametrize("per_head", [True, False], ids=["Cw_c", "Cw_HC"])
@pytest.mark.parametrize("has_cls", [True, False], ids=["cls", "no_cls"])
@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda c: "x%s_hc%d_h%d_s%s" % c)
def test_pool_ln_tiled_walk_matches_plain_and_jax(case, has_cls, per_head):
    thw, HC, heads, stride = case
    B = 2 if heads <= 2 else 1
    grids, taps, lns, cls = _pool_ln_arrays(B, thw, HC, heads, per_head, has_cls, seed=8)
    plan = fk.pool_ln_tile_plan(B, *thw, HC, heads, stride, torch.float32)
    assert max(plan.tiles_h, plan.tiles_w) >= 2
    c = HC // heads
    q = np.random.default_rng(9).standard_normal((B, 3, HC)).astype(np.float32)
    _, kp, vp = fk.fused_kvpool_attention_torch(
        torch.from_numpy(q), *_torch(grids), *_torch(taps), *_torch(lns), *_torch(cls), thw,
        heads, c**-0.5, True, (3, 3, 3), stride)
    for grid, w, ln, cl, plain in zip(grids, taps, lns, cls, (kp, vp)):
        got = fk.pool_ln_tiled_torch(torch.from_numpy(grid), torch.from_numpy(w),
                                     torch.from_numpy(ln), None if cl is None else
                                     torch.from_numpy(cl), thw, heads, stride, 1e-6, plan=plan)
        assert got.shape == (B, has_cls + plain.shape[1], HC) and got.dtype == torch.float32
        if has_cls:
            assert torch.equal(got[:, :1], torch.from_numpy(cl))
        pooled = got[:, has_cls:]
        torch.testing.assert_close(pooled, plain, **REPLAY_TOL)
        ref = jax_fk._pool_ln_xla(jnp.asarray(grid.reshape(B, *thw, HC)),
                                  jnp.asarray(np.tile(w, (1, HC // w.shape[1]))),
                                  jnp.asarray(np.tile(ln, (1, HC // ln.shape[1]))),
                                  stride, (3, 3, 3), c, 1e-6)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(ref), **REPLAY_TOL)


def _axis_cover(extent: int, tile: int, tiles: int):
    """Each position of [0, extent) in exactly one tile of the axis."""
    seen = [t * tile + i for t in range(tiles) for i in range(min(tile, extent - t * tile))]
    assert sorted(seen) == list(range(extent))


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("geometry", MVIT_FUSED, ids=lambda g: "x%s_hc%d_h%d_s%s_q%d_n%d" % g)
def test_pool_ln_tile_plan_at_mvit_geometries(geometry, B):
    (T, H, W), HC, heads, stride, _, _ = geometry
    c = HC // heads
    out = tp.check_geometry((B, T, H, W, HC), (3, 3, 3), stride)
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        plan = fk.pool_ln_tile_plan(B, T, H, W, HC, heads, stride, dtype)
        assert plan.slices == heads and c in fk.POOL_LN_WIDTHS
        # A head-wide slice a slot; the ring of 3 + depth planes and the
        # head's f32 taps fit the budget.
        assert plan.depth == fk.POOL_LN_DEPTH and plan.ring == 3 + plan.depth
        assert plan.smem_bytes == plan.ring * plan.rows * plan.cols * c * itemsize + 27 * c * 4
        assert plan.smem_bytes <= fk.POOL_LN_SMEM_BUDGET
        assert plan.blocks == B * heads * plan.tiles_h * plan.tiles_w
        assert max(plan.tile_h, plan.tile_w) <= tp.POOL_MAX_TILE
        _axis_cover(out[1], plan.tile_h, plan.tiles_h)
        _axis_cover(out[2], plan.tile_w, plan.tiles_w)
        # Output o's tap d reads slot o * step + d, which holds its input
        # coordinate; over all tiles, the slots in the grid are exactly the
        # positions some output reads.
        for D, s, n_out, tile, tiles, slots, step in (
                (H, stride[1], out[1], plan.tile_h, plan.tiles_h, plan.rows, plan.row_step),
                (W, stride[2], out[2], plan.tile_w, plan.tiles_w, plan.cols, plan.col_step)):
            assert step == min(s, 3)
            read = set()
            for t in range(tiles):
                n = min(tile, n_out - t * tile)
                coords = tp.tile_slots(t * tile, n, 3, s, step)
                assert len(coords) <= slots
                for o in range(n):
                    for d in range(3):
                        assert coords[o * step + d] == (t * tile + o) * s - 1 + d
                read |= {x for x in coords if 0 <= x < D}
            assert len(read) == needed_positions(D, 3, s, n_out)


def test_pool_ln_tiled_walk_reads_only_planes_its_ring_holds():
    # One ring slot short, the copies ahead overwrite a plane that an output
    # plane still reads, and the replay catches it.
    thw, HC, heads, stride = (6, 5, 5), 64, 2, (1, 2, 2)
    grids, taps, lns, _ = _pool_ln_arrays(1, thw, HC, heads, True, False, seed=10)
    args = (torch.from_numpy(grids[0]), torch.from_numpy(taps[0]), torch.from_numpy(lns[0]), None,
            thw, heads, stride)
    plan = fk.pool_ln_tile_plan(1, *thw, HC, heads, stride, torch.float32)
    fk.pool_ln_tiled_torch(*args, plan=plan)
    with pytest.raises(AssertionError, match="ring slot"):
        fk.pool_ln_tiled_torch(*args, plan=plan._replace(ring=plan.ring - 1))


@pytest.mark.parametrize("dtype, c, aligned, kernel, stride, route", [
    (torch.bfloat16, 96, True, (3, 3, 3), (1, 8, 8), "tiled"),
    (torch.float32, 96, True, (3, 3, 3), (1, 1, 1), "tiled"),
    (torch.bfloat16, 32, True, (3, 3, 3), (1, 2, 2), "tiled"),
    (torch.bfloat16, 64, True, (3, 3, 3), (1, 4, 4), "tiled"),
    (torch.float32, 128, True, (3, 3, 3), (1, 3, 2), "tiled"),
    (torch.bfloat16, 40, True, (3, 3, 3), (1, 4, 4), "scalar"),  # not a kernel width
    (torch.float32, 16, True, (3, 3, 3), (1, 4, 4), "scalar"),
    (torch.float16, 96, True, (3, 3, 3), (1, 4, 4), "scalar"),
    (torch.bfloat16, 96, False, (3, 3, 3), (1, 4, 4), "scalar"),
    (torch.bfloat16, 96, True, (3, 3, 3), (2, 4, 4), "scalar"),  # T stride
    (torch.bfloat16, 96, True, (1, 3, 3), (1, 4, 4), "scalar"),
])
def test_pool_ln_route(dtype, c, aligned, kernel, stride, route):
    assert fk.pool_ln_route(dtype, c, aligned, kernel, stride) == route


@pytest.mark.parametrize("dtype, c, aligned", [(torch.bfloat16, 40, True),
                                               (torch.bfloat16, 96, False),
                                               (torch.float16, 96, True)])
def test_forcing_the_tiled_pool_ln_off_its_route_raises(dtype, c, aligned):
    with pytest.raises(ValueError, match="tiled route takes"):
        fk._choose(dtype, c, aligned, (3, 3, 3), (1, 2, 2), "tiled")
    assert fk._choose(dtype, c, aligned, (3, 3, 3), (1, 2, 2), "scalar") == "scalar"
    assert fk._choose(dtype, c, aligned, (3, 3, 3), (1, 2, 2), None) == "scalar"
    with pytest.raises(ValueError, match="route must be one of"):
        fk._choose(dtype, c, aligned, (3, 3, 3), (1, 2, 2), "fast")
