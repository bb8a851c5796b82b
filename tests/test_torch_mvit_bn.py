"""The port's BatchNorm MViT (``norm="batchnorm"``) and ``fuse_bn_mvit``
against the JAX package's, with the same seeded weights and BN statistics:
eval logits on the head-packed path, with a fused qkv, on ``pool_first`` and
without a cls token; one train-mode forward (logits and the updated running
statistics, the cls token and the grid normalised in two BN calls as JAX
does); the folded model against the JAX fold and against the unfused model;
the bf16 deploy form of the folded model."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.accelerate import fuse_bn_mvit as jax_fuse_bn_mvit
from pytorchvideo_tpu.models import create_multiscale_vision_transformers as jax_create_mvit
from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, fuse_bn_mvit
from pytorchvideo_tpu_torch.layers.norms import TokenBatchNorm
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import SMALL_MVIT, TOL, random_variables, torch_logits

# bf16 deploy form against the f32 model, relative to the largest logit (as
# tests/test_torch_mvit.py).
BF16_REL_TOL = 3e-2

VARIANTS = {
    "packed": {},
    "fused_qkv": {"separate_qkv": False},
    "pool_first": {"pool_first": True},
    "no_cls": {"cls_embed_on": False},
    "dim_mul_in_att": {"dim_mul_in_att": True},
}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The JAX token pools through their plain XLA version, as
    # tests/test_torch_mvit.py runs MViT-B's.
    monkeypatch.setenv("PVT_TOKEN_POOL", "xla")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bn_mvit_pair(variant, seed=0, batch=2):
    """The JAX and port BatchNorm MViT (SMALL_MVIT, no head dropout) with the
    same random weights and BN statistics; (jax_model, variables, model, x)."""
    kwargs = {**SMALL_MVIT, **VARIANTS[variant], "norm": "batchnorm", "head_dropout_rate": 0.0}
    T, S = kwargs["temporal_size"], kwargs["spatial_size"]
    jax_model = jax_create_mvit(**kwargs)
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, T, S, S, 3)), False))
    variables = random_variables(shapes, seed)
    model = create_multiscale_vision_transformers(**kwargs, device="cpu")
    model.load_state_dict(
        jax_variables_to_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    x = np.random.default_rng(seed + 1).normal(size=(batch, 3, T, S, S)).astype(np.float32)
    return jax_model, variables, model.eval(), x


def _jax_x(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def jax_logits(jax_model, variables, x):
    return np.asarray(jax.jit(lambda v, c: jax_model.apply(v, c, False))(variables, _jax_x(x)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bn_mvit_eval_matches_jax(variant):
    jax_model, variables, model, x = bn_mvit_pair(variant)
    assert model.norm_embed is None
    norms = [m for m in model.modules() if isinstance(m, TokenBatchNorm)]
    # norm1 and norm2 of 3 blocks, and a BN before each of the 7 conv pools
    # (q pool at block 1, k and v pools in every block).
    assert len(norms) == 2 * 3 + 7
    assert not any(b.attn._fuses((2, 8, 8)) for b in model.blocks)
    ours = torch_logits(model, x)
    ref = jax_logits(jax_model, variables, x)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("variant", ["packed", "pool_first"])
def test_bn_mvit_train_forward_and_running_stats_match_jax(variant):
    jax_model, variables, model, x = bn_mvit_pair(variant, seed=5)
    ref, mutated = jax.jit(lambda v, c: jax_model.apply(v, c, True, mutable=["batch_stats"]))(
        variables, _jax_x(x))
    model.train()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    expected = jax_variables_to_state_dict(variables["params"],
                                           jax.tree_util.tree_map(np.array,
                                                                  mutated["batch_stats"]))
    state = model.state_dict()
    stats = [k for k in expected if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 13
    for key in stats:
        np.testing.assert_allclose(state[key].numpy(), expected[key].numpy(), err_msg=key, **TOL)
    # norm1 and norm2 take the cls token and the grid in two calls: two
    # updates of their running statistics in one forward.
    assert int(state["blocks.0.norm1.num_batches_tracked"]) == 2
    assert int(state["blocks.0.attn.norm_k.num_batches_tracked"]) == 1


def test_two_bn_calls_differ_from_upstream_s_one_over_the_sequence_in_train_mode():
    # JAX (and the port, which the test above holds to it) normalises the
    # cls token and the grid as two batches; upstream's BatchNorm1d takes
    # the whole (B, 1 + L, C) sequence as one (ROADMAP queue 3).
    tokens = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 1 + 64, 32))
                              .astype(np.float32))
    two, one = TokenBatchNorm(32).train(), TokenBatchNorm(32).train()
    with torch.no_grad():
        split = torch.cat([two(tokens[:, :1]), two(tokens[:, 1:])], dim=1)
        joint = one(tokens)
    delta = (split - joint).abs()
    assert delta[:, 1:].max() < 0.2 < delta[:, :1].max()  # the cls rows move most
    assert int(two.num_batches_tracked) == 2 and int(one.num_batches_tracked) == 1


@pytest.mark.parametrize("variant", ["packed", "fused_qkv", "no_cls"])
def test_fuse_bn_mvit_matches_jax_and_the_unfused_model(variant):
    jax_model, variables, model, x = bn_mvit_pair(variant, seed=2)
    fused = fuse_bn_mvit(model)
    assert isinstance(model.blocks[0].norm1, TokenBatchNorm)  # left as it was
    left = [n for n, m in fused.named_modules() if isinstance(m, TokenBatchNorm)]
    # With a cls token the pool norms stay (the fold would normalise cls).
    assert left == ([] if variant == "no_cls" else
                    [n for n, m in model.named_modules()
                     if isinstance(m, TokenBatchNorm) and ".attn.norm_" in n])
    out = torch_logits(fused, x)
    np.testing.assert_allclose(out, torch_logits(model, x), **TOL)
    jax_fused = jax_fuse_bn_mvit(variables)
    ref = jax_logits(jax_model, jax_fused, x)
    np.testing.assert_allclose(out, ref, **TOL)


def test_fuse_bn_mvit_refuses_pool_first_where_the_jax_fold_is_off():
    jax_model, variables, model, x = bn_mvit_pair("pool_first", seed=2)
    with pytest.raises(ValueError, match="pool_first"):
        fuse_bn_mvit(model)
    # The JAX package folds norm1 into q, k and v anyway, past the pools'
    # BN and GELU (ROADMAP queue 3).
    ref = jax_logits(jax_model, variables, x)
    off = jax_logits(jax_model, jax_fuse_bn_mvit(variables), x)
    assert np.abs(off - ref).max() > 10 * (TOL["atol"] + TOL["rtol"] * np.abs(ref).max())


def test_fuse_bn_mvit_folds_norm1_into_dim_mul_in_att_s_proj_where_jax_raises():
    jax_model, variables, model, x = bn_mvit_pair("dim_mul_in_att", seed=2)
    np.testing.assert_allclose(torch_logits(fuse_bn_mvit(model), x), torch_logits(model, x), **TOL)
    # The JAX fold puts norm2 (64 channels) into block 1's proj, which reads
    # norm1's 32 (ROADMAP queue 3).
    with pytest.raises(ValueError, match="mismatch"):
        jax_fuse_bn_mvit(variables)


def test_fuse_bn_mvit_needs_bias_slots():
    model = create_multiscale_vision_transformers(**{**SMALL_MVIT, "norm": "batchnorm",
                                                     "qkv_bias": False}, device="cpu")
    with pytest.raises(ValueError, match="bias"):
        fuse_bn_mvit(model)


def test_fused_bn_mvit_deploy_bf16_close_to_f32():
    _, _, model, x = bn_mvit_pair("packed", seed=3)
    ref = torch_logits(model, x)
    deploy = convert_to_deployable_form(fuse_bn_mvit(model))
    assert all(p.dtype == torch.bfloat16 for p in deploy.parameters())
    assert not any(isinstance(b.norm1, nn.modules.batchnorm._BatchNorm) for b in deploy.blocks)
    out = torch_logits(deploy, x, dtype=torch.bfloat16)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_REL_TOL * np.abs(ref).max())
