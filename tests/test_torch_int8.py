"""The port's int8 serving (accelerate/int8.py) against the JAX package's
int8_serving_fn: one int8 linear in f32 and bf16, prepared and dynamic; the
set of layers each package quantizes on a small MViT (q, k and v stay float
on the head-packed path, as JAX's ``_ProjParams``; the fused qkv and
``pool_first``'s q, k and v are quantized); prepared weights equal to dynamic
ones; the small MViT's int8 logits against JAX's."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from pytorchvideo_tpu.accelerate.int8 import int8_serving_fn as jax_int8_serving_fn
from pytorchvideo_tpu.accelerate.int8 import make_int8_interceptor as jax_make_int8_interceptor
from pytorchvideo_tpu_torch.accelerate import (
    int8_serving_fn,
    make_int8_interceptor,
    prepare_int8_weights,
)
from pytorchvideo_tpu_torch.accelerate.int8 import Int8Linear, int8_matmul, quantize_rows
from pytorchvideo_tpu_torch.zoo.from_jax import _dotted, jax_variables_to_state_dict
from torch_port_helpers import random_variables, small_mvit_pair, torch_logits

# The small MViT's widths are 32 and 64: at 2048, 32 x 32 layers stay float
# and 32 x 64 ones are quantized (JAX's rule is in x out >= min_weight_size).
MIN_WEIGHT_SIZE = 2048
# The small MViT's int8 logits against JAX's int8 logits, relative to the
# largest: the float parts (LayerNorm, GELU, softmax, the pools) round
# differently in the two packages, so now and then an activation lands on the
# other side of a rounding boundary of its int8 step in one package only, and
# the step it moves by (1/127 of its row's max |x|) carries on through the
# later layers. Bound: one int8 step of the largest logit. Measured at seeds
# 0-3: 4.1e-7, 5.9e-3, 1.9e-7, 9.2e-4 (this test's seed 3).
INT8_MVIT_REL_TOL = 1 / 127


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The JAX token pools on their XLA path (tests/test_torch_mvit.py runs
    # MViT-B so): the int8 layers are what these tests read.
    monkeypatch.setenv("PVT_TOKEN_POOL", "xla")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps_apart(a: np.ndarray, b: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """|a - b| in units of the last place of ``dtype`` at b."""
    mantissa = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), np.finfo(np.float32).tiny)))
                  - mantissa)
    return np.abs(a - b) / ulp


def dense_pair(features=48, in_features=40, seed=0):
    dense = flax_nn.Dense(features)
    variables = random_variables(
        jax.eval_shape(lambda: dense.init(jax.random.PRNGKey(0), jnp.zeros((1, in_features)))),
        seed)
    linear = nn.Linear(in_features, features)
    state = jax_variables_to_state_dict({"fc": variables["params"]}, {})
    linear.load_state_dict({k.removeprefix("fc."): v for k, v in state.items()})
    return dense, variables, linear


@pytest.mark.parametrize("prepare", [True, False], ids=["prepared", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_linear_matches_jax(dtype, prepare):
    dense, variables, linear = dense_pair()
    x = np.random.default_rng(1).normal(size=(3, 5, 40)).astype(np.float32) * 3
    x[0, 0] = 0.0  # a zero row: scale 1, as JAX's
    jax_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    fn = jax_int8_serving_fn(dense, min_weight_size=1, train_arg=None,
                             variables=variables if prepare else None)
    ref = np.asarray(fn(variables, jnp.asarray(x, jax_dtype)).astype(jnp.float32))
    prepared = prepare_int8_weights(linear, 1)[""] if prepare else None
    with torch.no_grad():
        out = Int8Linear(linear, prepared)(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype and out.shape == (3, 5, 48)
    assert _ulps_apart(out.float().numpy(), ref, dtype).max() <= 1


def test_int8_rows_round_half_to_even_in_the_activation_dtype():
    # 0.5 and 1.5 steps: half to even; the reciprocal of the scale is cast
    # to bf16 before the product, which is rounded in bf16.
    x = torch.tensor([[127.0, 0.5, 1.5, -2.5, 63.5]]).to(torch.bfloat16)
    q, scale = quantize_rows(x)
    assert scale.dtype == torch.float32 and float(scale) == 1.0
    assert q.tolist() == [[127, 0, 2, -2, 64]]
    w = torch.randint(-127, 128, (16, 24), dtype=torch.int8)
    a = torch.randint(-127, 128, (5, 24), dtype=torch.int8)
    assert torch.equal(int8_matmul(a, w), a.int() @ w.int().t())


def _jax_quantized_paths(jax_model, variables, x):
    """The module paths of the Dense layers JAX's interceptor quantizes in
    one forward (it calls on the Dense only where it does not)."""
    inner = jax_make_int8_interceptor(MIN_WEIGHT_SIZE)
    quantized = set()

    def recording(next_fn, args, kwargs, context):
        passed = []

        def through(*a, **k):
            passed.append(True)
            return next_fn(*a, **k)

        out = inner(through, args, kwargs, context)
        if isinstance(context.module, flax_nn.Dense) and context.method_name == "__call__" \
                and not passed:
            quantized.add(_dotted(context.module.path))
        return out

    def forward(v, clips):
        # The interceptor runs while jit traces: the set fills then.
        with flax_nn.intercept_methods(recording):
            return jax_model.apply(v, clips, False)

    jax.jit(forward).lower(variables, jnp.asarray(np.moveaxis(x, 1, -1)))
    return quantized


@pytest.mark.parametrize("variant", [{}, {"separate_qkv": False}, {"pool_first": True}],
                         ids=["packed", "fused_qkv", "pool_first"])
def test_int8_quantizes_the_layers_jax_does(variant):
    jax_model, variables, model, x = small_mvit_pair(**variant)
    int8 = int8_serving_fn(model, MIN_WEIGHT_SIZE)
    ours = {n for n, m in int8.named_modules() if isinstance(m, Int8Linear)}
    assert ours == _jax_quantized_paths(jax_model, variables, x)
    qkv = {n for n in ours if n.rsplit(".", 1)[-1] in ("q", "k", "v", "qkv")}
    if variant == {}:
        # JAX's _ProjParams: q, k and v stay float; the 32 x 32 projs too.
        assert not qkv and "blocks.1.attn.proj" not in ours
        assert {"blocks.2.attn.proj", "blocks.1.proj", "blocks.0.mlp.fc1"} <= ours
    else:
        assert qkv
    assert not any(isinstance(m, Int8Linear) for m in model.modules())  # left as it was


def test_the_rule_leaves_what_jax_leaves():
    _, _, model, _ = small_mvit_pair()
    rule = make_int8_interceptor(MIN_WEIGHT_SIZE)
    attn = model.blocks[2].attn  # 64 wide
    assert rule(attn.q, "blocks.2.attn.q", attn) is None
    assert isinstance(rule(attn.proj, "blocks.2.attn.proj", attn), Int8Linear)
    assert rule(model.blocks[1].attn.proj, "blocks.1.attn.proj", model.blocks[1].attn) is None
    assert rule(model.blocks[1].norm1, "blocks.1.norm1", model.blocks[1]) is None


def test_prepared_int8_equals_dynamic_and_jax_s_logits():
    jax_model, variables, model, x = small_mvit_pair(seed=3)
    prepared, dynamic = (int8_serving_fn(model, MIN_WEIGHT_SIZE, prepare=p) for p in (True, False))
    layer = prepared.blocks[2].attn.proj
    assert layer.weight is None and layer.weight_q.dtype == torch.int8
    ours = torch_logits(prepared, x)
    np.testing.assert_array_equal(ours, torch_logits(dynamic, x))
    fn = jax.jit(jax_int8_serving_fn(jax_model, MIN_WEIGHT_SIZE, variables=variables))
    ref = np.asarray(fn(variables, jnp.asarray(np.moveaxis(x, 1, -1))))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=INT8_MVIT_REL_TOL * np.abs(ref).max())
    # int8 against the float model: the quantization's own error, far above it.
    float_logits = torch_logits(model, x)
    assert np.abs(ours - float_logits).max() > np.abs(ours - ref).max()


def test_int8_on_a_bf16_deploy_form_keeps_f32_scales_and_refuses_a_late_cast():
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form

    _, _, model, x = small_mvit_pair(seed=4)
    int8 = int8_serving_fn(convert_to_deployable_form(model), MIN_WEIGHT_SIZE)
    layer = int8.blocks[2].attn.proj
    assert layer.weight_scale.dtype == torch.float32 and layer.bias.dtype == torch.bfloat16
    out = torch_logits(int8, x, dtype=torch.bfloat16)
    ref = torch_logits(model, x)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.1 * np.abs(ref).max())
    with pytest.raises(ValueError, match="cast the model"):
        torch_logits(int8.to(torch.bfloat16), x, dtype=torch.bfloat16)
