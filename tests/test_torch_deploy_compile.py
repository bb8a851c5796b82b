"""The port's serving kernels as ``pvt::`` custom ops, and the deploy form's
export (``export_program``) and compiled serving (``CompiledForward``) on the
CPU.

- ``torch.library.opcheck`` on every op with CPU tensors at small ragged
  shapes (its fake against the plain version's shape, dtype and strides).
- ``export_program`` round trips (bytes -> ``torch.export.load`` -> run) of
  the deploy forms of ``hub.x3d_xs``, a small MViT (unfused, ``pool_first``
  and ``fused_kvpool``), a narrow CSN and SlowFast: the loaded program
  against the eager deploy form (f32, max |diff| <= 1e-6) and against the
  JAX model's ``apply`` on the same seeded numpy weights (the model parity
  tolerance); each exported graph holds one ``pvt::`` node per plain-path
  kernel call of an eager forward, and running it makes as many.
- Compiled serving needs the card: on a CPU model ``example_input`` raises.

The card's side (the ops' CUDA implementations, their capture in a CUDA
graph, ``CompiledForward``'s refusals) is in ``test_torch_kernels_cuda.py``.
"""

import collections
import importlib
import io

import numpy as np
import pytest
import torch

import jax

from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu.models.csn import create_csn as jax_create_csn
from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, export_program
from pytorchvideo_tpu_torch.models import create_csn, create_multiscale_vision_transformers, hub
from pytorchvideo_tpu_torch.ops import depthwise_conv as dc
from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import (
    SMALL_MVIT,
    TOL,
    build_pair,
    jax_logits,
    random_variables,
    small_mvit_pair,
)

# The module (the package exports the JAX package's function under its name).
pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

# The loaded program against the eager deploy form: the same plain versions
# on the same f32 inputs, up to the order of a few sums.
EXACT = dict(rtol=0, atol=1e-6)


def _rand(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.normal(size=shape).astype(np.float32) * scale)


def _op_cases():
    """(op, args) at small ragged shapes, one per op and variant."""
    g = np.random.default_rng(0)
    cases = {
        "depthwise3x3x3_bn_swish": (torch.ops.pvt.depthwise3x3x3_bn_swish, (
            _rand(g, 2, 3, 5, 7, 6), _rand(g, 3, 3, 3, 6, scale=0.2), _rand(g, 6), _rand(g, 6),
            True)),
        "depthwise3x3x3_bias_only": (torch.ops.pvt.depthwise3x3x3_bn_swish, (
            _rand(g, 1, 2, 3, 4, 10), _rand(g, 3, 3, 3, 10, scale=0.2), None, _rand(g, 10),
            False)),
        "pooled_attention_packed": (torch.ops.pvt.pooled_attention_packed, (
            _rand(g, 2, 5, 12), _rand(g, 2, 7, 12), _rand(g, 2, 7, 12), 3, 0.5, True)),
        "pooled_attention_packed_cls": (torch.ops.pvt.pooled_attention_packed, (
            _rand(g, 2, 1, 12), _rand(g, 2, 9, 12), _rand(g, 2, 9, 12), 2, 0.35, False)),
        "pooled_attention": (torch.ops.pvt.pooled_attention, (
            _rand(g, 2, 3, 5, 4), _rand(g, 2, 3, 9, 4), _rand(g, 2, 3, 9, 4), 0.5, True)),
        "token_pool_conv": (torch.ops.pvt.token_pool_conv, (
            _rand(g, 2, 3, 5, 7, 8), _rand(g, 4, 1, 3, 3, 3, scale=0.2), [1, 2, 2])),
        "token_pool_max": (torch.ops.pvt.token_pool_max, (
            _rand(g, 2, 3, 5, 7, 6), [1, 3, 3], [1, 2, 2])),
        "token_pool_avg": (torch.ops.pvt.token_pool_avg, (
            _rand(g, 1, 2, 5, 3, 6), [3, 3, 3], [2, 2, 1])),
        "kvpool_ln": (torch.ops.pvt.kvpool_ln, (
            _rand(g, 2, 3 * 5 * 7, 8), _rand(g, 2, 3 * 5 * 7, 8), _rand(g, 27, 4, scale=0.2),
            _rand(g, 27, 4, scale=0.2), _rand(g, 2, 4), _rand(g, 2, 4), _rand(g, 2, 1, 8),
            _rand(g, 2, 1, 8), [3, 5, 7], 2, [3, 3, 3], [1, 2, 2], 1e-6)),
        "kvpool_ln_no_cls": (torch.ops.pvt.kvpool_ln, (
            _rand(g, 1, 2 * 4 * 3, 8), _rand(g, 1, 2 * 4 * 3, 8), _rand(g, 27, 8, scale=0.2),
            _rand(g, 27, 8, scale=0.2), _rand(g, 2, 8), _rand(g, 2, 8), None, None, [2, 4, 3],
            2, [3, 3, 3], [1, 1, 1], 1e-6)),
    }
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_passes_opcheck(name):
    op, args = OP_CASES[name]
    torch.library.opcheck(op.default, args)
    out = op(*args)
    for t in out if isinstance(out, tuple) else (out,):
        assert t.is_contiguous() and torch.isfinite(t).all()


def test_ops_compute_their_plain_versions():
    """Each op's CPU implementation is its wrapper's plain version."""
    op, args = OP_CASES["pooled_attention_packed"]
    torch.testing.assert_close(op(*args), pa.pooled_attention_packed_torch(*args), rtol=0, atol=0)
    op, args = OP_CASES["token_pool_conv"]
    torch.testing.assert_close(op(*args), tp.depthwise_token_pool_torch(*args), rtol=0, atol=0)
    op, args = OP_CASES["kvpool_ln"]
    for got, ref in zip(op(*args), fk.pool_ln_torch(*args)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain-path kernel calls, by op name: each plain version a
    dispatcher (or an op's CPU implementation) takes on the CPU, where a
    CUDA tensor would launch that op's kernel. The fused op's plain version
    counts its pool-LN launch and its one or two attention launches."""
    calls = collections.Counter()

    def count(module, name, op):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[op] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    for module, name, op in (
            (dc, "depthwise3x3x3_bn_swish_torch", "depthwise3x3x3_bn_swish"),
            (pa, "pooled_attention_packed_torch", "pooled_attention_packed"),
            (pa, "pooled_attention_torch", "pooled_attention"),
            (tp, "depthwise_token_pool_torch", "token_pool_conv"),
            (tp, "max_token_pool_torch", "token_pool_max"),
            (tp, "avg_token_pool_torch", "token_pool_avg"),
            (fk, "pool_ln_torch", "kvpool_ln")):
        count(module, name, op)
    fused = fk.fused_kvpool_attention_torch

    def fused_counted(*args, cls_q=None, **kwargs):
        calls["kvpool_ln"] += 1
        calls["pooled_attention_packed"] += 1 + (cls_q is not None)
        return fused(*args, cls_q=cls_q, **kwargs)

    monkeypatch.setattr(fk, "fused_kvpool_attention_torch", fused_counted)
    return calls


def _pvt_nodes(program) -> collections.Counter:
    """The ``pvt::`` call nodes of an exported program, by op name."""
    nodes = collections.Counter()
    for node in program.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == "pvt":
            nodes[node.target._opname] += 1
    return nodes


def _torch_input(x):
    return [torch.from_numpy(p) for p in x] if isinstance(x, list) else torch.from_numpy(x)


def _check_round_trip(model, x, ref, calls, kernels: int):
    """The f32 deploy form of ``model`` exported, saved, loaded and run on
    ``x``: against the eager deploy form and the JAX ``ref``; its ``pvt::``
    nodes and the loaded run's plain-path calls against the eager forward's
    (``kernels`` in all)."""
    deploy = convert_to_deployable_form(model, dtype=None)
    xt = _torch_input(x)
    calls.clear()
    with torch.no_grad():
        eager = deploy(xt)
    eager_calls = collections.Counter(calls)
    assert sum(eager_calls.values()) == kernels, eager_calls

    data = export_program(deploy, xt)
    assert isinstance(data, bytes)
    program = torch.export.load(io.BytesIO(data))
    assert _pvt_nodes(program) == eager_calls
    calls.clear()
    with torch.no_grad():
        out = program.module()(xt)
    assert calls == eager_calls
    assert out.shape == eager.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), eager.numpy(), **EXACT)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    return eager_calls


def test_x3d_xs_deploy_exports_with_22_kernel_nodes(plain_calls):
    # The JAX X3D of hub.x3d_xs's configuration (4x160x160, 400 classes) and
    # hub.x3d_xs itself, with the same seeded weights.
    jax_model, variables, built, x = build_pair(input_clip_length=4, input_crop_size=160,
                                                batch=1)
    model = hub.x3d_xs(device="cpu")
    model.load_state_dict(built.state_dict(), strict=True)
    ref = jax_logits(jax_model, variables, x)
    calls = _check_round_trip(model.eval(), x, ref, plain_calls, kernels=22)
    assert calls == {"depthwise3x3x3_bn_swish": 22}


# (variant of SMALL_MVIT, plain-path kernel calls a forward): 3 blocks, each
# two attention launches (grid and cls query) and conv pools for k and v,
# block 1 also a conv pool for q and the max-pooled skip; pool_first: one
# per-head launch a block; fused (64x64 clips, block 0's kv stride (1, 4, 4)
# one the JAX gate fuses): one pool-LN launch a block replaces its k and v
# pools.
MVIT_VARIANTS = {
    "unfused": ({}, {"pooled_attention_packed": 6, "token_pool_conv": 7, "token_pool_max": 1}),
    "pool_first": ({"pool_first": True},
                   {"pooled_attention": 3, "token_pool_conv": 7, "token_pool_max": 1}),
    "fused_kvpool": ({"spatial_size": 64, "pool_kv_stride_adaptive": [1, 4, 4]},
                     {"kvpool_ln": 3, "pooled_attention_packed": 6, "token_pool_conv": 1,
                      "token_pool_max": 1}),
}


@pytest.mark.parametrize("form", list(MVIT_VARIANTS))
def test_small_mvit_deploy_exports_with_one_node_per_kernel(form, plain_calls, monkeypatch):
    variant, expected = MVIT_VARIANTS[form]
    monkeypatch.setenv("PVT_TOKEN_POOL", "xla")
    if form == "fused_kvpool":
        monkeypatch.setenv("PVT_FUSED_KVPOOL", "1")
    jax_model, variables, model, x = small_mvit_pair(batch=1, **variant)
    if form == "fused_kvpool":
        fused = create_multiscale_vision_transformers(**{**SMALL_MVIT, **variant},
                                                      fused_kvpool=True, device="cpu")
        fused.load_state_dict(model.state_dict(), strict=True)
        model = fused.eval()
    ref = jax_logits(jax_model, variables, x)
    calls = _check_round_trip(model, x, ref, plain_calls, kernels=sum(expected.values()))
    assert calls == expected


def _resnet_pair(jax_model, torch_model, x, seed=0):
    """Loads seeded numpy variables of ``jax_model`` into ``torch_model``;
    returns the JAX eval logits on the NCTHW numpy ``x`` (a list of pathways
    for SlowFast)."""
    clips = [np.moveaxis(p, 1, -1) for p in x] if isinstance(x, list) else np.moveaxis(x, 1, -1)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), clips, False))
    variables = random_variables(shapes, seed)
    torch_model.load_state_dict(jax_variables_to_state_dict(variables["params"],
                                                            variables["batch_stats"]), strict=True)
    torch_model.eval()
    return np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, False))(variables, clips))


def _clip(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_narrow_csn_deploy_exports_its_stride1_conv_b_as_kernel_nodes(plain_calls):
    # CSN-R50 at stem width 8, 8x32x32: 13 stride-1 depthwise conv_b of 16.
    config = dict(stem_dim_out=8, model_num_class=7, head_pool_kernel_size=(1, 2, 2))
    x = _clip((1, 3, 8, 32, 32), 13)
    model = create_csn(**config, device="cpu")
    ref = _resnet_pair(jax_create_csn(**config), model, x)
    calls = _check_round_trip(model, x, ref, plain_calls, kernels=13)
    assert calls == {"depthwise3x3x3_bn_swish": 13}


def test_narrow_slowfast_deploy_exports_with_its_list_input(plain_calls):
    # SlowFast-R50, one block a stage, 4- and 16-frame 32x32 clips: no kernel
    # of the port on its path, so the program holds no pvt:: node.
    config = dict(stage_depths=(1, 1, 1, 1), head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)),
                  model_num_class=7, dropout_rate=0.0)
    x = [_clip((1, 3, 4, 32, 32), 11), _clip((1, 3, 16, 32, 32), 12)]
    model = hub.slowfast_r50(**config, device="cpu")
    ref = _resnet_pair(jax_hub.slowfast_r50(**config, pathway_packs=None), model, x)
    assert _check_round_trip(model, x, ref, plain_calls, kernels=0) == {}


def test_compiled_serving_refuses_a_cpu_model():
    model = create_csn(stem_dim_out=8, model_num_class=7, head_pool_kernel_size=(1, 2, 2),
                       device="cpu")
    x = torch.zeros(1, 3, 8, 32, 32)
    with pytest.raises(ValueError, match="needs the card"):
        convert_to_deployable_form(model, example_input=x)
    with pytest.raises(ValueError, match="needs the card"):
        convert_to_deployable_form(model, dtype=None, example_input=[x, x])
    # Without example_input the CPU keeps its eager deploy form.
    deploy = convert_to_deployable_form(model, dtype=None)
    assert isinstance(deploy, torch.nn.Module)
