"""The port's efficient blocks, ``EfficientX3d`` and its hub factories, the
transmuter and weight-only int8 quantization, against the JAX package's
accelerate/ with the same seeded weights: every block's train form against
JAX's, ``convert()`` against the train form at JAX's own tolerance
(tests/test_accelerate_engine.py:305-307), the stride-1 depthwise convs on the
kernel's module; the transmuter's ``"cuda"`` target equal to the deploy form;
the quantized set, int8 values and scales equal to JAX's."""

import copy
import inspect

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

import pytorchvideo_tpu.accelerate as jax_accelerate
import pytorchvideo_tpu_torch
import pytorchvideo_tpu_torch.accelerate as accelerate
from pytorchvideo_tpu.models.hub import efficient_x3d_xs as jax_efficient_x3d_xs
from pytorchvideo_tpu_torch.accelerate import (
    DepthwiseConv3x3x3BnAct,
    EfficientX3d,
    convert_to_deployable_form,
    dequantize_variables,
    quantization_error,
    quantize_variables,
    transmute_model,
)
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import (
    TOL,
    build_pair,
    random_variables,
    small_mvit_pair,
    torch_logits,
)

# convert() against the train form, the JAX package's own bound
# (tests/test_accelerate_engine.py:305-307): folding reorders f32 arithmetic.
CONVERT_TOL = dict(rtol=2e-4, atol=2e-5)
# The train forms against JAX's: the same f32 ops in another order.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL_TOL = 3e-2

# (factory, args, kwargs, stride-1 depthwise convs the deploy form puts on the kernel)
BLOCKS = {
    "pw_swish": ("Conv3dPwBnAct", (8, 12), dict(activation="swish"), 0),
    "dw_relu": ("Conv3d3x3x3DwBnAct", (8,), dict(activation="relu"), 1),
    "dw_swish": ("Conv3d3x3x3DwBnAct", (8,), dict(activation="swish"), 1),
    "dw_hswish": ("Conv3d3x3x3DwBnAct", (8,), dict(activation="hswish"), 1),
    "dw_identity": ("Conv3d3x3x3DwBnAct", (8,), dict(activation="identity"), 1),
    "dw_no_bn": ("Conv3d3x3x3DwBnAct", (8,), dict(use_bn=False, bias=True), 1),
    "t1_3x3": ("Conv3dTemporalKernel1BnAct", (8, 12), dict(stride=(2, 2)), 0),
    "3x1x1": ("Conv3d3x1x1BnAct", (8, 12), dict(activation="hswish"), 0),
    "5x1x1": ("Conv3d5x1x1BnAct", (8, 8), dict(groups=8), 0),
    "se": ("SqueezeExcitation", (8,), dict(reduction_ratio=2.0), 0),
    "x3d_se": ("X3dBottleneckBlock", (8, 16, 8), dict(act_functions=("relu", "swish", "relu")), 1),
    "x3d_no_se": ("X3dBottleneckBlock", (8, 16, 8),
                  dict(se_ratio=0.0, act_functions=("swish", "swish", "hswish")), 1),
    "x3d_stride2": ("X3dBottleneckBlock", (8, 16, 12), dict(spatial_stride=2), 0),
    "x3d_no_bn_b": ("X3dBottleneckBlock", (8, 16, 12), dict(use_bn=(True, False, True)), 1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def block_pair(name, x_ncthw, seed=0):
    """The JAX and port block ``name`` with the same random weights."""
    factory, args, kwargs, _ = BLOCKS[name]
    jax_block = getattr(jax_accelerate, factory)(*args, **kwargs)
    x = jnp.asarray(np.moveaxis(x_ncthw, 1, -1))
    jax_block.variables = random_variables(
        jax.eval_shape(lambda: jax_block.model.init(jax.random.PRNGKey(0), x, False)), seed)
    block = getattr(accelerate, factory)(*args, **kwargs, device="cpu")
    block.model.load_state_dict(jax_variables_to_state_dict(
        jax_block.variables["params"], jax_block.variables.get("batch_stats", {})), strict=True)
    return jax_block, block.eval(), x


def _out(block, x, dtype=torch.float32):
    with torch.no_grad():
        return block(torch.from_numpy(x).to(dtype)).float().numpy()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_efficient_block_matches_jax_and_its_deploy_form(name):
    x = np.random.default_rng(1).normal(size=(2, 8, 4, 6, 6)).astype(np.float32)
    jax_block, block, x_jax = block_pair(name, x)
    ref = np.moveaxis(np.asarray(jax_block(x_jax)), -1, 1)
    train_form = _out(block, x)
    np.testing.assert_allclose(train_form, ref, **BLOCK_TOL)

    assert block.convert(dtype=None) is block
    on_kernel = [m for m in block.deploy_form.modules() if isinstance(m, DepthwiseConv3x3x3BnAct)]
    assert len(on_kernel) == BLOCKS[name][3]
    assert not any(isinstance(m, nn.BatchNorm3d) for m in block.deploy_form.modules())
    np.testing.assert_allclose(_out(block, x), train_form, **CONVERT_TOL)
    jax_block.convert(x_jax, dtype=None)
    np.testing.assert_allclose(_out(block, x), np.moveaxis(np.asarray(jax_block(x_jax)), -1, 1),
                               **CONVERT_TOL)
    # bf16: the input is cast to the deploy dtype.
    block.convert()
    out = _out(block, x, torch.float32)
    np.testing.assert_allclose(out, train_form, rtol=0,
                               atol=BF16_REL_TOL * np.abs(train_form).max())
    # Train mode runs the train form; the state_dict is the train form's.
    assert set(block.state_dict()) == {f"model.{k}" for k in block.model.state_dict()}
    out = block.train()(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == train_form.shape


def test_swish_joins_the_kernel_only_without_se():
    x = np.zeros((1, 8, 4, 6, 6), np.float32)
    fused = {}
    for name in ("dw_swish", "dw_hswish", "x3d_se", "x3d_no_se"):
        _, block, _ = block_pair(name, x)
        block.convert(dtype=None)
        (kernel,) = [m for m in block.deploy_form.modules()
                     if isinstance(m, DepthwiseConv3x3x3BnAct)]
        fused[name] = kernel.apply_swish
    assert fused == {"dw_swish": True, "dw_hswish": False, "x3d_se": False, "x3d_no_se": True}


@pytest.mark.parametrize("size", [1, (2, 3, 3)])
def test_pools_activations_and_fc_match_jax(size):
    x = np.random.default_rng(2).normal(size=(2, 5, 4, 6, 6)).astype(np.float32)
    x_jax = jnp.asarray(np.moveaxis(x, 1, -1))
    blocks = [("AdaptiveAvgPool3d", (size,)), ("AdaptiveAvgPool3dOutSize1", ()),
              ("AdaptiveAvgPool2dOutSize1", ()), ("AdaptiveAvgPool2d", (size if size == 1 else
                                                                         size[1:],)),
              ("Swish", ()), ("HardSwish", ()), ("ReLU", ()), ("Identity", ())]
    for factory, args in blocks:
        jax_block = getattr(jax_accelerate, factory)(*args)
        jax_block.init(jax.random.PRNGKey(0), x_jax)
        ref = np.moveaxis(np.asarray(jax_block(x_jax)), -1, 1)
        block = getattr(accelerate, factory)(*args).eval()
        np.testing.assert_allclose(_out(block, x), ref, err_msg=factory, **BLOCK_TOL)
        block.convert(dtype=None)
        np.testing.assert_allclose(_out(block, x), ref, err_msg=factory, **BLOCK_TOL)
    v = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    jax_fc = jax_accelerate.FullyConnected(8, 3)
    jax_fc.variables = random_variables(
        jax.eval_shape(lambda: jax_fc.model.init(jax.random.PRNGKey(0), v, False)), 4)
    fc = accelerate.FullyConnected(8, 3, device="cpu")
    fc.model.load_state_dict(jax_variables_to_state_dict(jax_fc.variables["params"], {}))
    np.testing.assert_allclose(_out(fc.eval(), v), np.asarray(jax_fc(v)), **BLOCK_TOL)


def test_efficient_x3d_matches_jax_converts_on_the_cpu_and_trains_in_its_train_form():
    kwargs = dict(num_classes=10, input_crop_size=64, width_factor=1.0, depth_factor=0.5)
    jax_model = jax_efficient_x3d_xs(**kwargs)
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 64, 64)).astype(np.float32)
    x_jax = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = random_variables(
        jax.eval_shape(lambda: jax_model.model.init(jax.random.PRNGKey(0), x_jax, False)), 6)
    jax_model.load_variables(variables)
    model = hub.efficient_x3d_xs(**kwargs, device="cpu")
    assert isinstance(model, EfficientX3d) and model.expansion == "XS"
    assert model.config == dict(input_clip_length=4, input_crop_size=64, width_factor=1.0,
                                depth_factor=0.5)
    model.model.load_state_dict(
        jax_variables_to_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    model.eval()
    ref = np.asarray(jax_model(x_jax))
    train_form = _out(model, x)
    np.testing.assert_allclose(train_form, ref, **TOL)

    # On the CPU the example is not compiled: the eager deploy module.
    model.convert(torch.from_numpy(x), dtype=None)
    assert isinstance(model.deploy_form, nn.Module)
    assert sum(isinstance(m, DepthwiseConv3x3x3BnAct) for m in model.deploy_form.modules()) > 0
    jax_model.convert(x_jax, dtype=None)
    np.testing.assert_allclose(_out(model, x), np.asarray(jax_model(x_jax)), **TOL)
    np.testing.assert_allclose(_out(model, x), train_form, **CONVERT_TOL)
    model.convert()
    assert model.deploy_dtype == torch.bfloat16
    np.testing.assert_allclose(_out(model, x), train_form, rtol=0,
                               atol=BF16_REL_TOL * np.abs(train_form).max())
    # fold_bn=False: BN kept, no conv on the kernel.
    model.convert(dtype=None, fold_bn=False)
    assert not any(isinstance(m, DepthwiseConv3x3x3BnAct) for m in model.deploy_form.modules())
    np.testing.assert_allclose(_out(model, x), train_form, rtol=0, atol=0)
    model.train()
    out = model(torch.from_numpy(x))
    assert out.requires_grad and out.dtype == torch.float32


@pytest.mark.parametrize("factory, expansion, clip", [
    ("efficient_x3d_xs", "XS", (4, 160)), ("efficient_x3d_s", "S", (13, 160))])
def test_efficient_x3d_hub_factories_put_22_conv_b_on_the_kernel(factory, expansion, clip):
    assert getattr(pytorchvideo_tpu_torch, factory) is getattr(hub, factory)
    model = getattr(hub, factory)(device="cpu")
    assert model.expansion == expansion
    assert (model.config["input_clip_length"], model.config["input_crop_size"]) == clip
    # 3.79 M parameters, MODEL_ZOO.md.
    assert round(sum(p.numel() for p in model.parameters()) / 1e6, 2) == 3.79
    model.convert()
    kernels = [m for m in model.deploy_form.modules() if isinstance(m, DepthwiseConv3x3x3BnAct)]
    assert len(kernels) == 22
    assert sum(k.apply_swish for k in kernels) == 11


def test_transmuter_cuda_target_is_the_deploy_form():
    _, _, model, x = build_pair(input_clip_length=4, input_crop_size=32, width_factor=1.0,
                                depth_factor=0.5, model_num_class=10)
    for dtype in (torch.bfloat16, None):
        deploy = convert_to_deployable_form(model, dtype=dtype)
        transmuted = transmute_model(model, "cuda", dtype=dtype)
        assert [type(m) for m in transmuted.modules()] == [type(m) for m in deploy.modules()]
        a, b = transmuted.state_dict(), deploy.state_dict()
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    # The bare target casts to bf16; the model is left as it was.
    assert all(p.dtype == torch.bfloat16 for p in transmute_model(model).parameters())
    assert any(isinstance(m, nn.BatchNorm3d) for m in model.modules()) and model.training is False
    kept = transmute_model(model, "cuda", dtype=None, fold_bn=False)
    assert sum(isinstance(m, nn.BatchNorm3d) for m in kept.modules()) == sum(
        isinstance(m, nn.BatchNorm3d) for m in model.modules())
    np.testing.assert_allclose(torch_logits(kept, x), torch_logits(model, x), rtol=0, atol=0)
    for target in ("tpu", "mobile_cpu"):
        with pytest.raises(ValueError, match="not registered"):
            transmute_model(model, target)
    assert list(accelerate.EFFICIENT_BLOCK_TRANSMUTER_REGISTRY) == ["cuda"]


@pytest.mark.parametrize("factory", ["Conv3dPwBnAct", "Conv3d3x3x3DwBnAct", "X3dBottleneckBlock",
                                     "SqueezeExcitation", "FullyConnected"])
def test_block_factories_default_to_the_card(factory):
    assert inspect.signature(getattr(accelerate, factory)).parameters["device"].default == "cuda"
    assert inspect.signature(EfficientX3d).parameters["device"].default == "cuda"


def test_register_transmuter_adds_a_pass():
    calls = []
    accelerate.register_transmuter("test_target", lambda m, **kw: calls.append(kw))
    try:
        model = nn.Linear(2, 2)
        out = transmute_model(model, "test_target", dtype=None)
        assert calls == [{"dtype": None}] and out is not model and not out.training
    finally:
        del accelerate.EFFICIENT_BLOCK_TRANSMUTER_REGISTRY["test_target"]


def _quantized_nodes(tree):
    """The quantized nodes of a JAX ``quantize_variables`` params tree, each
    as a node {"kernel": its int8 values, "bias": its scale}; the rest dropped.
    Through the converter, "kernel" takes the port's layout."""
    if not isinstance(tree, dict):
        return None
    if isinstance(tree.get("kernel"), dict):
        return {"kernel": np.asarray(tree["kernel"]["q"], np.float32),
                "bias": np.asarray(tree["kernel"]["scale"])}
    if "kernel" in tree or "bn" in tree or "ln" in tree:
        return None
    kept = {k: _quantized_nodes(v) for k, v in tree.items()}
    return {k: v for k, v in kept.items() if v}


@pytest.mark.parametrize("family", ["x3d", "mvit"])
def test_quantize_variables_equals_jax_after_the_layout_transpose(family):
    if family == "x3d":
        _, variables, model, x = build_pair(input_clip_length=4, input_crop_size=32,
                                            width_factor=1.0, depth_factor=0.5,
                                            model_num_class=10)
    else:
        _, variables, model, x = small_mvit_pair()
    # 256: the small MViT's pool kernels (16 x 27) are quantized too.
    ours = quantize_variables(model.state_dict(), min_size=256)
    quantized = {k: v for k, v in ours.items() if isinstance(v, dict)}
    jax_quantized = jax_accelerate.quantize_variables(variables, min_size=256)
    expected = jax_variables_to_state_dict(_quantized_nodes(jax_quantized["params"]), {})
    assert len(quantized) > 0
    assert set(quantized) == {k for k in expected if k.endswith(".weight")}
    if family == "mvit":  # the pool's bare TokenPool.weight, and q, k, v
        assert {"blocks.0.attn.pool_k.weight", "blocks.1.attn.q.weight"} <= set(quantized)
    for name, v in quantized.items():
        assert v["q"].dtype == torch.int8 and v["scale"].dtype == torch.float32
        torch.testing.assert_close(v["q"].float(), expected[name], rtol=0, atol=0)
        torch.testing.assert_close(v["scale"], expected[name[: -len("weight")] + "bias"],
                                   rtol=0, atol=0)
    assert quantization_error(model.state_dict()) == pytest.approx(
        jax_accelerate.quantization_error(variables), rel=1e-6)

    # The dequantized weights load into the model and serve near its logits.
    dequantized = copy.deepcopy(model)
    dequantized.load_state_dict(dequantize_variables(ours, torch.float32))
    ref = torch_logits(model, x)
    np.testing.assert_allclose(torch_logits(dequantized, x), ref, rtol=0,
                               atol=0.05 * np.abs(ref).max())
    # bf16: the int8 value and the scale each in bf16, then their product.
    name, v = next(iter(quantized.items()))
    q_bf16 = dequantize_variables(ours)[name]
    scale = v["scale"].to(torch.bfloat16).view(-1, *(1,) * (v["q"].dim() - 1))
    assert torch.equal(q_bf16, v["q"].to(torch.bfloat16) * scale)
