"""pytorchvideo_tpu_torch MViT against the JAX package's MViT, with the same
seeded weights: the layers (positional encoding, patch embedding, head, Mlp
with tanh GELU), the JAX -> port weight converter and its round trip back
through pytorchvideo_tpu/zoo/import_torch.py, the logits of a small MViT on
the default (head-packed) path and on ``pool_first``, MViT-B 16x4 at full
width and depth on a small clip, and the bf16 deploy form."""

import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.attention import Mlp as JaxMlp
from pytorchvideo_tpu.layers.positional_encoding import (
    SpatioTemporalClsPositionalEncoding as JaxPositionalEncoding,
)
from pytorchvideo_tpu.models.head import create_vit_basic_head as jax_create_vit_basic_head
from pytorchvideo_tpu.models.hub.vision_transformers import mvit_base_16x4 as jax_mvit_base_16x4
from pytorchvideo_tpu.models.stem import create_conv_patch_embed as jax_create_conv_patch_embed
from pytorchvideo_tpu.zoo.import_torch import MVIT_RENAME_RULES, import_torch_checkpoint
from pytorchvideo_tpu_torch import layers as port_layers
from pytorchvideo_tpu_torch import models as port_models
from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
from pytorchvideo_tpu_torch.layers import attention as port_attention
from pytorchvideo_tpu_torch.models import hub
from torch_port_helpers import (
    TOL,
    build_mvit_pair,
    init_variables,
    load_jax_variables,
    small_mvit_pair,
    torch_logits,
)

# bf16 deploy form against the f32 model, relative to the largest logit (as
# for X3D, tests/test_torch_deploy.py).
BF16_REL_TOL = 3e-2


def _jax_input(x_ncthw):
    return jnp.asarray(np.moveaxis(x_ncthw, 1, -1))


def jax_logits(jax_model, variables, x_ncthw):
    fwd = jax.jit(lambda v, x: jax_model.apply(v, x, False))
    return np.asarray(fwd(variables, _jax_input(x_ncthw)))


@pytest.mark.parametrize("sep_pos_embed", [True, False])
@pytest.mark.parametrize("has_cls", [True, False])
def test_positional_encoding_matches_jax(sep_pos_embed, has_cls):
    thw, C = (2, 3, 4), 8
    x = np.random.default_rng(0).normal(size=(2, 24, C)).astype(np.float32)
    jax_pe = JaxPositionalEncoding(C, thw, sep_pos_embed=sep_pos_embed, has_cls=has_cls)
    variables = init_variables(jax_pe, jnp.asarray(x), seed=1)
    ref = np.asarray(jax_pe.apply(variables, jnp.asarray(x)))
    pe = load_jax_variables(
        port_layers.SpatioTemporalClsPositionalEncoding(C, thw, sep_pos_embed, has_cls), variables)
    with torch.no_grad():
        out = pe(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 24 + has_cls, C)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_patch_embed_matches_jax():
    # MViT-B's patch conv: k (3, 7, 7), s (2, 4, 4), p (1, 3, 3). The JAX
    # package runs it as WBlockedConv, with the same parameters.
    kw = dict(in_channels=3, out_channels=16, conv_kernel_size=(3, 7, 7), conv_stride=(2, 4, 4),
              conv_padding=(1, 3, 3))
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 32, 32)).astype(np.float32)
    jax_pe = jax_create_conv_patch_embed(**kw)
    variables = init_variables(jax_pe, _jax_input(x), False, seed=2)
    ref = np.asarray(jax_pe.apply(variables, _jax_input(x), False))
    pe = load_jax_variables(port_models.create_conv_patch_embed(**kw, device="cpu"), variables)
    with torch.no_grad():
        out = pe(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 2 * 8 * 8, 16)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seq_pool_type", ["cls", "mean", "none"])
def test_vit_head_matches_jax(seq_pool_type):
    x = np.random.default_rng(0).normal(size=(2, 9, 16)).astype(np.float32)
    kw = dict(in_features=16, out_features=5, seq_pool_type=seq_pool_type, dropout_rate=0.5)
    jax_head = jax_create_vit_basic_head(**kw)
    variables = init_variables(jax_head, jnp.asarray(x), False, seed=3)
    ref = np.asarray(jax_head.apply(variables, jnp.asarray(x), False))
    head = load_jax_variables(port_models.create_vit_basic_head(**kw, device="cpu"), variables)
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_mlp_matches_jax_tanh_gelu():
    # jax.nn.gelu defaults to the tanh approximation; upstream torch's Mlp
    # uses the exact erf GELU, which this input tells apart.
    x = (np.random.default_rng(0).normal(size=(2, 5, 16)) * 3).astype(np.float32)
    jax_mlp = JaxMlp(hidden_features=64, out_features=16)
    variables = init_variables(jax_mlp, jnp.asarray(x), seed=4)
    ref = np.asarray(jax_mlp.apply(variables, jnp.asarray(x)))
    mlp = load_jax_variables(port_layers.Mlp(16, 64, 16), variables)
    with torch.no_grad():
        out = mlp(torch.from_numpy(x)).numpy()
        erf = mlp.fc2(F.gelu(mlp.fc1(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(erf - ref).max() > 10 * 1e-5


def test_converter_round_trip_is_exact():
    _, variables, model, _ = small_mvit_pair()
    state_dict = model.state_dict()
    for key in ("blocks.1.attn.pool_q.weight", "blocks.1.attn.norm_q.bias",
                "blocks.0.attn.pool_k.weight", "cls_positional_encoding.pos_embed_spatial",
                "cls_positional_encoding.cls_token", "patch_embed.patch_model.weight",
                "blocks.1.proj.weight", "norm_embed.weight", "head.proj.weight"):
        assert key in state_dict, key
    assert state_dict["blocks.1.attn.pool_q.weight"].shape == (8, 1, 3, 3, 3)
    back, report = import_torch_checkpoint(
        state_dict, variables, rename_rules=MVIT_RENAME_RULES, strict=True
    )
    assert not report["missing"] and not report["extra"] and not report["reshaped"]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_orig = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(flat_back) == len(flat_orig)
    for path, leaf in flat_orig:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize(
    "variant", [{}, {"residual_pool": True}, {"separate_qkv": False}, {"pool_first": True}],
    ids=["packed", "packed_residual_pool", "packed_fused_qkv", "pool_first"],
)
def test_small_mvit_logits_match_jax(variant, monkeypatch):
    # The JAX package's token pools run its Pallas kernel in interpret mode
    # (as tests/test_ops_token_pool.py:190-194 does); its attention takes the
    # XLA path on the CPU.
    monkeypatch.setenv("PVT_TOKEN_POOL", "interpret")
    jax_model, variables, model, x = small_mvit_pair(**variant)
    assert all(b.attn.pool_first == variant.get("pool_first", False) for b in model.blocks)
    ours = torch_logits(model, x)
    ref = jax_logits(jax_model, variables, x)
    assert ours.shape == (2, 7) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_mvit_base_16x4_widths_depth_and_logits(monkeypatch):
    # MViT-B 16x4's full width and 16 blocks on a 4x64x64 clip (tokens
    # (2, 16, 16)); the JAX package on its default (XLA) pools.
    monkeypatch.setenv("PVT_TOKEN_POOL", "xla")
    jax_model, variables, model, x = build_mvit_pair(
        jax_mvit_base_16x4, hub.mvit_base_16x4, batch=1, spatial_size=64, temporal_size=4
    )
    blocks = model.blocks
    assert len(blocks) == 16
    assert [b.attn.num_heads for b in blocks] == [1] + [2] * 2 + [4] * 11 + [8] * 2
    assert [b.attn.proj.in_features for b in blocks] == [96] + [192] * 2 + [384] * 11 + [768] * 2
    assert [b.attn.pool_q is not None for b in blocks] == [i in (1, 3, 14) for i in range(16)]
    assert [b.pool_skip is not None for b in blocks] == [i in (1, 3, 14) for i in range(16)]
    assert [b.attn.pool_k.stride for b in blocks] == (
        [(1, 8, 8)] + [(1, 4, 4)] * 2 + [(1, 2, 2)] * 11 + [(1, 1, 1)] * 2
    )
    assert all(b.attn.scale == 96**-0.5 for b in blocks)
    # 36.6 M parameters at 16x224x224, where the spatial and temporal
    # position tables have 56 * 56 and 8 rows (16 * 16 and 2 here).
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params + (56 * 56 - 16 * 16 + 8 - 2) * 96 == 36_610_672

    # One forward calls the attention 32 times (16 grid + 16 cls queries),
    # the conv pool 35 times and the max pool 3 times: the launches a card
    # run counts.
    calls = {"attention": 0, "conv": 0, "max": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for attr, name in (("pooled_attention_packed", "attention"), ("depthwise_token_pool", "conv"),
                       ("max_token_pool", "max")):
        monkeypatch.setattr(port_attention, attr, counting(name, getattr(port_attention, attr)))
    ours = torch_logits(model, x)
    assert calls == {"attention": 32, "conv": 35, "max": 3}
    ref = jax_logits(jax_model, variables, x)
    assert ours.shape == (1, 400) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_deploy_bf16_close_to_f32():
    _, _, model, x = small_mvit_pair()
    ref = torch_logits(model, x)
    deploy = convert_to_deployable_form(model)
    assert not deploy.training and model.blocks[0].attn.q.weight.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in deploy.parameters())
    out = torch_logits(deploy, x, dtype=torch.bfloat16)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_REL_TOL * np.abs(ref).max())
    f32 = convert_to_deployable_form(model, dtype=None)
    np.testing.assert_allclose(torch_logits(f32, x), ref, rtol=0, atol=0)


BUILDERS = [
    port_models.create_multiscale_vision_transformers,
    port_models.create_conv_patch_embed,
    port_models.create_vit_basic_head,
    port_models.create_x3d,
    port_models.create_x3d_stem,
    port_models.create_x3d_bottleneck_block,
    port_models.create_x3d_res_block,
    port_models.create_x3d_res_stage,
    port_models.create_x3d_head,
]


@pytest.mark.parametrize("builder", BUILDERS, ids=lambda b: b.__name__)
def test_builders_default_to_the_card(builder):
    assert inspect.signature(builder).parameters["device"].default == "cuda"


@pytest.mark.parametrize("factory", [hub.mvit_base_16x4, hub.x3d_s], ids=lambda f: f.__name__)
def test_hub_factories_build_on_the_card(factory):
    if torch.cuda.is_available():
        model = factory()
        assert all(p.is_cuda for p in model.parameters())
    else:
        # No card: asking for one raises; nothing moves to the CPU quietly.
        with pytest.raises((AssertionError, RuntimeError)):
            factory()
    assert all(p.device.type == "cpu" for p in factory(device="cpu").parameters())
