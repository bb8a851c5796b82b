"""pytorchvideo_tpu_torch's tensor parallelism, FSDP and sequence parallelism
on a (2, 2) ``(data, model)`` mesh of four gloo ranks on the CPU
(tests/torch_parallel_worker.py ``tensor_parallel``, one spawn for the file),
against the port's unsharded model and the JAX package on one device, with
the same seeded weights:

- the forward of the small MViT (tests/torch_port_helpers.py ``SMALL_MVIT``,
  B4, each rank its 2 rows) with ``MEGATRON_ATTENTION_RULES``: the default
  path, ``pool_first``, ``fused_kvpool``, a fused qkv and the non-depthwise
  pool conv, against the port's unsharded forward at rtol 1e-4 / atol 1e-5
  (tests/test_train_parallel.py:220-223) and the JAX forward at rtol 5e-3 /
  atol 5e-4 (tests/test_models_parity.py:24);
- one tensor-parallel step of the MViT of tests/test_train_parallel.py:196-209
  and one FSDP step of its X3D-tiny (tests/test_train_parallel.py:374-438,
  FSDP over ``data`` from 256 elements, its BatchNorms over the data axis),
  and ``run_sharded_step`` on the dry run's BatchNorm MViT-tiny (MixUp, the
  clip at 1.0) and a SlowFast-tiny (``__graft_entry__.py:186-229``; its widths
  cut to a 16-channel stem, the JAX side packing its fast pathway as the hub
  does): the loss and the whole state against the JAX step jitted on the
  whole batch at rtol 1e-4 / atol 1e-5;
- every split parameter's local shard and its momentum hold numel / 2
  elements;
- sequence parallelism over ``model`` composed with the batch over ``data``
  against tests/test_parallel_sequence.py:45's reference at 1e-5.

Dropout is 0. MixUp's lambda is fixed on both sides (the frameworks draw
different bits). The JAX references are computed while the ranks run.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu import models as jax_models
from pytorchvideo_tpu.models.hub.slowfast import DEFAULT_PATHWAY_PACKS
from pytorchvideo_tpu.models.slowfast import create_slowfast as jax_create_slowfast
from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu.ops.pooled_attention import pooled_attention_packed_xla
from pytorchvideo_tpu.train import OptimizerConfig as JaxOptimizerConfig
from pytorchvideo_tpu.train import construct_optimizer as jax_construct_optimizer
from pytorchvideo_tpu.train import create_train_state as jax_create_train_state
from pytorchvideo_tpu.train import make_train_step as jax_make_train_step
from pytorchvideo_tpu.transforms import mix as jax_mix
from pytorchvideo_tpu.transforms.mix import MixUp as JaxMixUp
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.parallel import MEGATRON_ATTENTION_RULES
from pytorchvideo_tpu_torch.train.sharded import SHARDED_STEP_OPTIMIZER
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_parallel_worker import collect, start
from torch_port_helpers import SMALL_MVIT, TOL, init_variables

WORLD, BATCH, LAM = 4, 4, 0.3
SHARD_TOL = dict(rtol=1e-4, atol=1e-5)
SP_TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_CASES = {"default": {}, "pool_first": {"pool_first": True},
                 "fused_kvpool": {"fused_kvpool": True}, "fused_qkv": {"separate_qkv": False},
                 "dense_pool": {"depthwise_conv": False}}
# tests/test_train_parallel.py:196-209 and :28-36.
TP_MVIT = dict(spatial_size=32, temporal_size=2, depth=2, num_heads=2, patch_embed_dim=32,
               head_num_classes=4, head_dropout_rate=0.0)
X3D_TINY = dict(input_clip_length=2, input_crop_size=32, model_num_class=5, stem_dim_in=8,
                depth_factor=0.1, dropout_rate=0.0)
# __graft_entry__.py:186-200 and :218-229 (dropout 0; the SlowFast's stem cut to 16).
BN_MVIT = dict(spatial_size=32, temporal_size=4, depth=2, num_heads=2, patch_embed_dim=32,
               norm="batchnorm", pool_q_stride_size=[[1, 1, 2, 2]],
               pool_kv_stride_adaptive=[1, 2, 2], pool_kvq_kernel=[3, 3, 3],
               head_num_classes=10, head_dropout_rate=0.0)
SLOWFAST_TINY = dict(model_num_class=10, stage_depths=(1, 1, 1, 1),
                     head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)), dropout_rate=0.0,
                     stem_dim_outs=(16, 2))
MIX = dict(num_classes=10, label_smoothing=0.1)


def _ncthw(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _nthwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX models, their seeded variables and the inputs of every case."""
    rng = np.random.default_rng(0)
    setup = {"forward_x": _ncthw(rng, BATCH, 3, 4, 32, 32), "forward": {}}
    for name, variant in FORWARD_CASES.items():
        jax_kwargs = {**SMALL_MVIT, **{k: v for k, v in variant.items() if k != "fused_kvpool"}}
        setup["forward"][name] = (jax_models.create_multiscale_vision_transformers(**jax_kwargs),
                                  {**SMALL_MVIT, **variant})
    setup["steps"] = {
        "tp_mvit": (jax_models.create_multiscale_vision_transformers(**TP_MVIT), TP_MVIT,
                    _ncthw(rng, BATCH, 3, 2, 32, 32), np.arange(BATCH) % 4,
                    dict(rules=MEGATRON_ATTENTION_RULES, fsdp_axis=None,
                         optim=SHARDED_STEP_OPTIMIZER, clip=1.0)),
        "fsdp_x3d": (jax_create_x3d(**X3D_TINY), X3D_TINY, _ncthw(rng, 8, 3, 2, 32, 32),
                     np.arange(8) % 5,
                     dict(rules=(), fsdp_axis="data", optim=dict(lr=0.05), clip=None)),
    }
    setup["sharded"] = {
        "mvit_bn": (jax_models.create_multiscale_vision_transformers(**BN_MVIT), BN_MVIT,
                    _ncthw(rng, BATCH, 3, 4, 32, 32), np.arange(BATCH) % 10, MIX),
        "slowfast": (jax_create_slowfast(**SLOWFAST_TINY, pathway_packs=DEFAULT_PATHWAY_PACKS),
                     SLOWFAST_TINY, [_ncthw(rng, BATCH, 3, 4, 32, 32),
                                     _ncthw(rng, BATCH, 3, 16, 32, 32)],
                     np.arange(BATCH) % 10, None),
    }
    q, k, v = (rng.normal(size=(4, n, 32)).astype(np.float32) for n in (64, 24, 24))
    setup["sp_dp"] = (q, k, v, 2, 16**-0.5)
    return setup


def _video(x):
    return [_nthwc(p) for p in x] if isinstance(x, list) else _nthwc(x)


def _torch(x):
    return [torch.from_numpy(p) for p in x] if isinstance(x, list) else torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def _variables(name, group):
    """The seeded variables of a case's JAX model."""
    entry = _setup()[group][name]
    x = _setup()["forward_x"] if group == "forward" else entry[2]
    sample = [p[:1] for p in x] if isinstance(x, list) else x[:1]
    return init_variables(entry[0], _video(sample), False, seed=2)


def _state_dict(variables):
    return jax_variables_to_state_dict(variables["params"], variables.get("batch_stats", {}))


def _inputs():
    setup = _setup()
    forward_cases = {name: {"config": config,
                            "state_dict": _state_dict(_variables(name, "forward"))}
                     for name, (_, config) in setup["forward"].items()}
    step_cases = {name: {"config": config, "state_dict": _state_dict(_variables(name, "steps")),
                         "video": _torch(x), "label": torch.from_numpy(y), **case}
                  for name, (_, config, x, y, case) in setup["steps"].items()}
    sharded_cases = {name: {"config": config,
                            "state_dict": _state_dict(_variables(name, "sharded")),
                            "video": _torch(x), "label": torch.from_numpy(y), "mix": mix}
                     for name, (_, config, x, y, mix) in setup["sharded"].items()}
    return {"lam": LAM, "centre": (0, 0), "forward_x": torch.from_numpy(setup["forward_x"]),
            "forward_cases": forward_cases, "step_cases": step_cases,
            "sharded_cases": sharded_cases,
            "sp_dp": tuple(torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                           for t in setup["sp_dp"])}


def _jax_step(model, variables, x, y, optim, clip, mix=None):
    """The JAX step jitted on the whole batch: (loss, state_dict after)."""
    tx = jax_construct_optimizer(variables["params"], JaxOptimizerConfig(**optim))
    state = jax_create_train_state(variables, tx)
    transform = None
    if mix is not None:
        mixer = JaxMixUp(**mix)
        transform = lambda k, v, l: mixer(k, v, l)  # noqa: E731 (the dry run's form)
    step = jax.jit(jax_make_train_step(model, tx, batch_transform=transform,
                                       clip_grad_norm=clip))
    state, metrics = step(state, {"video": _video(x), "label": jnp.asarray(y)},
                          jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    return float(metrics["loss"]), _state_dict(tree)


def _references(monkeypatch):
    setup = _setup()
    refs = {"forward": {}, "steps": {}, "sharded": {}}
    x = setup["forward_x"]
    for name, (model, config) in setup["forward"].items():
        variables = _variables(name, "forward")
        with monkeypatch.context() as m:
            if config.get("fused_kvpool"):
                m.setenv("PVT_FUSED_KVPOOL", "1")
                m.setenv("PVT_TOKEN_POOL", "xla")
            jax_out = np.asarray(jax.jit(lambda v, a: model.apply(v, a, False))(
                variables, _nthwc(x)))
        port = create_multiscale_vision_transformers(**config, device="cpu")
        port.load_state_dict(_state_dict(variables), strict=True)
        with torch.no_grad():
            refs["forward"][name] = (jax_out, port.eval()(torch.from_numpy(x)).numpy())
    for name, (model, _, x, y, case) in setup["steps"].items():
        refs["steps"][name] = _jax_step(model, _variables(name, "steps"), x, y, case["optim"],
                                        case["clip"])
    monkeypatch.setattr(jax_mix, "_sample_beta", lambda key, alpha: jnp.float32(LAM))
    for name, (model, _, x, y, mix) in setup["sharded"].items():
        refs["sharded"][name] = _jax_step(model, _variables(name, "sharded"), x, y,
                                          SHARDED_STEP_OPTIMIZER, 1.0, mix)
    return refs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(each rank's results, the JAX and unsharded references)."""
    directory = tmp_path_factory.mktemp("tensor_parallel")
    torch.save(_inputs(), directory / "inputs.pt")
    context = start(str(directory), "tensor_parallel", WORLD)
    with pytest.MonkeyPatch.context() as monkeypatch:
        refs = _references(monkeypatch)
    return collect(context, str(directory)), refs


def _rows(results, get):
    """The data ranks' rows of a per-rank output, model coordinate 0 first;
    every model rank of a data coordinate holds the same ones."""
    by_data = {}
    for res in results:
        d, m = res["coords"]
        out = get(res)
        if d in by_data:
            np.testing.assert_array_equal(out, by_data[d])
        by_data[d] = out
    return np.concatenate([by_data[d] for d in sorted(by_data)])


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_tensor_parallel_forward_matches_unsharded_and_jax(ranks, name):
    results, refs = ranks
    jax_out, unsharded = refs["forward"][name]
    got = _rows(results, lambda r: r["forward"][name][0].numpy())
    np.testing.assert_allclose(got, unsharded, **SHARD_TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)
    # Every q, k, v (or qkv), proj, fc1 and fc2 weight of the 3 blocks is split.
    assert results[0]["forward"][name][1] == (18 if name != "fused_qkv" else 12)


def _assert_state(ours, ref, label):
    compared = 0
    for n, t in ref.items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(ours[n].double().numpy(), t.double().numpy(),
                                   err_msg=f"{label}: {n}", **SHARD_TOL)
        compared += 1
    assert compared == len([n for n in ours if not n.endswith("num_batches_tracked")])


def _assert_halves(shards, label):
    assert shards, f"{label}: no parameter split"
    for n, (local, full, momentum) in shards.items():
        assert local * 2 == full and momentum == local, (label, n, local, full, momentum)


@pytest.mark.parametrize("name", ["tp_mvit", "fsdp_x3d"])
def test_sharded_step_matches_the_jax_step(ranks, name):
    results, refs = ranks
    ref_loss, ref_state = refs["steps"][name]
    for res in results:
        loss, state, shards = res["steps"][name]
        np.testing.assert_allclose(loss, ref_loss, rtol=SHARD_TOL["rtol"])
        _assert_state(state, ref_state, name)
        _assert_halves(shards, name)


@pytest.mark.parametrize("name", ["mvit_bn", "slowfast"])
def test_run_sharded_step_matches_the_jax_step(ranks, name):
    results, refs = ranks
    ref_loss, ref_state = refs["sharded"][name]
    for res in results:
        loss, state, shards, placements = res["sharded"][name]
        np.testing.assert_allclose(loss, ref_loss, rtol=SHARD_TOL["rtol"])
        _assert_state(state, ref_state, name)
        _assert_halves(shards, name)
        # FSDP over data everywhere it divides; on the MViT the Megatron
        # weights over model.
        assert any(p[0].startswith("S(") for p in placements.values())
        assert (name == "mvit_bn") == any(p[1].startswith("S(") for p in placements.values())


def test_sequence_parallel_composes_with_the_data_axis(ranks):
    results, _ = ranks
    q, k, v, heads, scale = _setup()["sp_dp"]
    ref = np.asarray(pooled_attention_packed_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 heads, scale, False))
    for res in results:
        d, m = res["coords"]
        np.testing.assert_allclose(res["sp_dp"].numpy(), ref[2 * d:2 * d + 2, 32 * m:32 * m + 32],
                                   **SP_TOL)
