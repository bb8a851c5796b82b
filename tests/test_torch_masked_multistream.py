"""pytorchvideo_tpu_torch's masked multistream modules against the JAX
package's (pytorchvideo_tpu/models/masked_multistream.py), with the same
seeded weights carried across by zoo/from_jax.py: each of the seven modules
on (B, L, C) rows whose masks are valid prefixes of several lengths, one
row with no valid entry among them; the LSTM one- and bidirectional, the
encoder at 2 layers x 2 heads; a ``MaskedSequential`` whose pooling must see
the caller's mask (the attention marks position 0 valid on a copy); and
padded tails filled with 99, from position max(length, 1) on, which change
no output (JAX's own check, tests/test_models_ssl_av.py:127-139).
Tolerance: rtol 5e-3 / atol 5e-4 (tests/test_models_parity.py:24).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers import make_fusion_layer as jax_make_fusion_layer
from pytorchvideo_tpu.models import masked_multistream as jax_mm
from pytorchvideo_tpu_torch.layers import make_fusion_layer
from pytorchvideo_tpu_torch.models import masked_multistream as mm
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, random_variables

B, L, C = 5, 7, 8
LENGTHS = (7, 4, 1, 0, 2)  # valid prefixes; row 3 has no valid entry


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, c=C, lengths=LENGTHS):
    x = np.random.default_rng(seed).normal(size=(len(lengths), L, c)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return x, mask


def _padded(x, lengths=LENGTHS):
    """x with each row's tail, from position max(length, 1) on, set to 99."""
    x = x.copy()
    for row, n in enumerate(lengths):
        x[row, max(n, 1):] = 99.0
    return x


def _pair(jax_module, port_module, x, mask, seed=1):
    """Seeded JAX variables for ``jax_module``, loaded into ``port_module``;
    returns (JAX forward of (x, mask), port forward, variables)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                    jnp.asarray(mask)))
    variables = random_variables(shapes, seed)
    port_module.load_state_dict(jax_variables_to_state_dict(variables.get("params", {}), {}),
                                strict=True)
    port_module.eval()
    jax_forward = jax.jit(lambda a, m: jax_module.apply(variables, a, m))

    def forward(a, m):
        with torch.no_grad():
            return port_module(torch.from_numpy(a), torch.from_numpy(m)).numpy()

    return lambda a, m: np.asarray(jax_forward(jnp.asarray(a), jnp.asarray(m))), forward


def _check(jax_forward, forward, x, mask, valid_rows_only=False):
    """The port against JAX on (x, mask), and on the padded x."""
    ref, out = jax_forward(x, mask), forward(x, mask)
    np.testing.assert_allclose(out, ref, **TOL)
    padded = forward(_padded(x), mask)
    if valid_rows_only:  # a (B, L, C) output: the valid positions (and 0)
        for row, n in enumerate(LENGTHS):
            np.testing.assert_allclose(padded[row, :max(n, 1)], out[row, :max(n, 1)],
                                       rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(padded, out, rtol=1e-5, atol=1e-6)
    return out


@pytest.mark.parametrize("method", ["max", "avg", "sum"])
def test_masked_temporal_pooling_matches_jax(method):
    x, mask = _inputs()
    out = _check(*_pair(jax_mm.MaskedTemporalPooling(method=method),
                        mm.MaskedTemporalPooling(method), x, mask), x, mask)
    np.testing.assert_array_equal(out[3], np.zeros(C))  # the empty row


@pytest.mark.parametrize("heads", [1, 2])
def test_transpose_multihead_attention_matches_jax(heads):
    x, mask = _inputs(seed=2)
    mask_before = mask.copy()
    _check(*_pair(jax_mm.TransposeMultiheadAttention(feature_dim=C, num_heads=heads),
                  mm.TransposeMultiheadAttention(C, heads, device="cpu"), x, mask, seed=3),
           x, mask, valid_rows_only=True)
    np.testing.assert_array_equal(mask, mask_before)


@pytest.mark.parametrize("init_method, freeze", [("gaussian", False), ("zeros", True)])
def test_learn_masked_default_matches_jax(init_method, freeze):
    x, mask = _inputs(seed=4)
    x = x[:, 0]
    ref_module = jax_mm.LearnMaskedDefault(feature_dim=C, init_method=init_method, freeze=freeze)
    module = mm.LearnMaskedDefault(C, init_method, freeze,
                                   generator=torch.Generator().manual_seed(0), device="cpu")
    if init_method == "zeros":
        assert not module._learned_defaults.any()
    jax_forward, forward = _pair(ref_module, module, x, mask, seed=5)
    out = forward(x, mask)
    np.testing.assert_allclose(out, jax_forward(x, mask), **TOL)
    np.testing.assert_array_equal(out[3], module._learned_defaults.detach().numpy())
    np.testing.assert_array_equal(np.delete(out, 3, axis=0), np.delete(x, 3, axis=0))
    y = module(torch.from_numpy(x), torch.from_numpy(mask)).sum()
    assert y.requires_grad != freeze


@pytest.mark.parametrize("bidirectional", [False, True], ids=["forward", "bidirectional"])
def test_lstm_matches_jax(bidirectional):
    x, mask = _inputs(seed=6, c=6)
    module = mm.LSTM(6, 5, bidirectional=bidirectional, device="cpu")
    assert module.output_dim == (10 if bidirectional else 5)
    out = _check(*_pair(jax_mm.LSTM(dim_in=6, hidden_dim=5, bidirectional=bidirectional),
                        module, x, mask, seed=7), x, mask)
    assert out.shape == (len(LENGTHS), module.output_dim)


def test_transpose_transformer_encoder_matches_jax():
    x, mask = _inputs(seed=8)
    module = mm.TransposeTransformerEncoder(C, num_heads=2, num_layers=2, device="cpu")
    assert module.norm1[0].eps == 1e-6 and module.ff1[1].out_features == 2048
    out = _check(*_pair(jax_mm.TransposeTransformerEncoder(dim_in=C, num_heads=2, num_layers=2),
                        module, x, mask, seed=9), x, mask)
    assert out.shape == (len(LENGTHS), C)


def test_masked_sequential_pools_with_the_callers_mask():
    # attention -> max pooling -> default: the pooling and the default see
    # the caller's mask, so the empty row pools to 0 and takes the learned
    # default, though the attention read its position 0.
    x, mask = _inputs(seed=10)
    ref = jax_mm.MaskedSequential(layers=(
        jax_mm.TransposeMultiheadAttention(feature_dim=C, num_heads=2),
        jax_mm.MaskedTemporalPooling(method="max"),
        jax_mm.LearnMaskedDefault(feature_dim=C)))
    module = mm.MaskedSequential([
        mm.TransposeMultiheadAttention(C, 2, device="cpu"), mm.MaskedTemporalPooling("max"),
        mm.LearnMaskedDefault(C, device="cpu")])
    out = _check(*_pair(ref, module, x, mask, seed=11), x, mask)
    np.testing.assert_array_equal(out[3], module.layers[2]._learned_defaults.detach().numpy())


def test_masked_multipathway_concat_matches_jax():
    # Two streams of the same rows: attention -> avg pooling, and a
    # bidirectional LSTM, fused by concatenation.
    x, mask = _inputs(seed=12)
    ref = jax_mm.MaskedMultiPathWay(
        multipathway_blocks=(
            jax_mm.MaskedSequential(layers=(jax_mm.TransposeMultiheadAttention(feature_dim=C),
                                            jax_mm.MaskedTemporalPooling(method="avg"))),
            jax_mm.MaskedSequential(layers=(jax_mm.LSTM(dim_in=C, hidden_dim=3,
                                                        bidirectional=True),))),
        multipathway_fusion=jax_make_fusion_layer("concat", [C, 6]))
    module = mm.MaskedMultiPathWay(
        [mm.MaskedSequential([mm.TransposeMultiheadAttention(C, device="cpu"),
                              mm.MaskedTemporalPooling("avg")]),
         mm.MaskedSequential([mm.LSTM(C, 3, bidirectional=True, device="cpu")])],
        make_fusion_layer("concat", [C, 6]))
    inputs = [(jnp.asarray(x), jnp.asarray(mask))] * 2
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), inputs))
    variables = random_variables(shapes, 13)
    module.load_state_dict(jax_variables_to_state_dict(variables["params"], {}), strict=True)
    expected = np.asarray(ref.apply(variables, inputs))
    with torch.no_grad():
        pair = (torch.from_numpy(x), torch.from_numpy(mask))
        out = module.eval()([pair, pair]).numpy()
        padded = (torch.from_numpy(_padded(x)), torch.from_numpy(mask))
        out_padded = module([padded, padded]).numpy()
    assert out.shape == (len(LENGTHS), C + 6)
    np.testing.assert_allclose(out, expected, **TOL)
    np.testing.assert_allclose(out_padded, out, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        module([pair])
