"""pytorchvideo_tpu_torch's training of its BatchNorm models against the JAX
package's, on the CPU at a small size (X3D at width factor 1 with 7 blocks, a Slow R50 and
a SlowFast R50 of one block a stage at narrow widths, 4x32x32 clips and a
16-frame fast pathway, B2-B4, head dropout 0), with the same seeded numpy
weights carried across by zoo/from_jax.py and the port's running stats
carried back by the JAX package's zoo/import_torch.py.

Tolerances:
- the BatchNorm layer in f32 against flax's: output rtol 1e-6 / atol 1e-5,
  running stats rtol 1e-6 / atol 1e-6;
- one f32 step's loss and every gradient: rtol 5e-3 / atol 5e-4
  (tests/test_models_parity.py:24); its running stats rtol 1e-5 / atol 1e-5
  (the batch statistics of layers deep in a model carry the two
  frameworks' f32 conv rounding);
- three accumulated updates and precise BN run in float64 on
  both sides (the port's modules in f64, the JAX package's under
  ``jax.enable_x64``), where the semantics meet without f32's rounding:
  each parameter's change rtol 5e-3 / atol 5e-4 and the running stats rtol
  1e-6 / atol 1e-6. In f32 some batches of these tiny models are ill
  conditioned: on some B4 X3D batches the JAX f32 gradients lie several
  times TOL from the f64 ones while the port's stay well inside it, and an
  update carries that further;
- a bf16 step: its loss within 3e-2 relative of the JAX bf16 step's, its
  gradients' relative L2 distance from the port's f32 ones within twice
  the JAX bf16 step's from the JAX f32 one (bf16 rounding moves a BN
  network's gradients far, by tens of percent here, in both packages);
- the BatchNorm layer in bf16 against flax's in bf16: output rtol 2**-7 /
  atol 1e-2 (a rounding of the f32 result to bf16 apart), stats as in f32.
"""

import copy
import functools
import inspect

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.norms import BatchNorm as JaxBatchNorm
from pytorchvideo_tpu.losses import soft_target_cross_entropy as jax_soft_target_cross_entropy
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train import presets as jax_presets
from pytorchvideo_tpu.train.precise_batchnorm import update_bn_stats as jax_update_bn_stats
from pytorchvideo_tpu.train.train_loop import create_train_state as jax_create_train_state
from pytorchvideo_tpu.train.train_loop import make_train_step as jax_make_train_step
from pytorchvideo_tpu.train.transforms import SlowFastPackPathway as JaxSlowFastPackPathway
from pytorchvideo_tpu.train.transforms import default_collate as jax_default_collate
from pytorchvideo_tpu.zoo.import_torch import X3D_RENAME_RULES, import_torch_checkpoint
from pytorchvideo_tpu_torch.layers.norms import BatchNorm
from pytorchvideo_tpu_torch.layers.stochastic import Dropout
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.models.x3d import create_x3d
from pytorchvideo_tpu_torch.train import (
    OptimizerConfig,
    PreciseBn,
    SlowFastPackPathway,
    TrainState,
    VideoClassificationTrainApp,
    construct_optimizer,
    default_collate,
    forward_backward,
    get_preset,
    lr_schedule_from_config,
    make_eval_step,
    make_train_step,
    update_bn_stats,
)
from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, random_variables

LAYER_TOL = dict(rtol=1e-6, atol=1e-5)
LAYER_STAT_TOL = dict(rtol=1e-6, atol=1e-6)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
F64_STAT_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2**-7, atol=1e-2)
CLASSES = 7

SMALL_X3D = dict(input_clip_length=4, input_crop_size=32, model_num_class=CLASSES,
                 width_factor=1.0, depth_factor=0.5, head_dim_out=32, dropout_rate=0.0)
SMALL_SLOW = dict(stem_dim_out=8, stage_depths=(1, 1, 1, 1), model_num_class=CLASSES,
                  dropout_rate=0.0, head_pool_kernel_size=(4, 1, 1))
SMALL_SLOWFAST = dict(stem_dim_outs=(16, 2), stage_depths=(1, 1, 1, 1),
                      head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)), model_num_class=CLASSES,
                      dropout_rate=0.0)

# name -> (JAX model, port model builder, clip shapes per pathway, rename rules)
MODELS = {
    "x3d": (lambda: jax_create_x3d(**SMALL_X3D),
            lambda: create_x3d(**SMALL_X3D, device="cpu"), [(3, 4, 32, 32)], X3D_RENAME_RULES),
    "slow_r50": (lambda: jax_hub.slow_r50(**SMALL_SLOW),
                 lambda: hub.slow_r50(**SMALL_SLOW, device="cpu"), [(3, 4, 32, 32)], None),
    "slowfast_plain": (lambda: jax_hub.slowfast_r50(**SMALL_SLOWFAST, pathway_packs=None),
                       lambda: hub.slowfast_r50(**SMALL_SLOWFAST, device="cpu"),
                       [(3, 4, 32, 32), (3, 16, 32, 32)], None),
    "slowfast_packed": (lambda: jax_hub.slowfast_r50(**SMALL_SLOWFAST, pathway_packs=(1, 2)),
                        lambda: hub.slowfast_r50(**SMALL_SLOWFAST, device="cpu"),
                        [(3, 4, 32, 32), (3, 16, 32, 32)], None),
}


def _jax(x):
    """NCTHW numpy (or a list of them) -> the JAX package's channels-last."""
    if isinstance(x, list):
        return [_jax(p) for p in x]
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _torch(x):
    if isinstance(x, list):
        return [torch.from_numpy(p) for p in x]
    return torch.from_numpy(x)


def _clips(shapes, batch, seed):
    rng = np.random.default_rng(seed)
    clips = [rng.normal(size=(batch, *s)).astype(np.float32) for s in shapes]
    return clips if len(clips) > 1 else clips[0]


def _labels(batch, seed=3):
    return np.random.default_rng(seed).integers(0, CLASSES, size=batch)


@functools.lru_cache(maxsize=None)
def _jax_setup(name):
    """The JAX model and its seeded numpy variables (built once per name)."""
    jax_builder, _, shapes, _ = MODELS[name]
    jax_model = jax_builder()
    example = _jax(_clips(shapes, 1, 0))
    abstract = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), example, False))
    return jax_model, random_variables(abstract, 0)


def _pair(name, batch=2, seed=1, dtype=np.float32):
    """(JAX model, its variables, the port model with the same weights in
    train mode, a seeded NCTHW batch or pathway list, hard labels), in
    ``dtype`` (float64: call it and the JAX side under ``jax.enable_x64``)."""
    jax_model, variables = _jax_setup(name)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    model = MODELS[name][1]()
    model.load_state_dict(
        jax_variables_to_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    model.to(torch.float64 if dtype == np.float64 else torch.float32)
    return (jax_model, variables, model.train(), _cast(_clips(MODELS[name][2], batch, seed), dtype),
            _labels(batch))


def _cast(x, dtype):
    return [p.astype(dtype) for p in x] if isinstance(x, list) else x.astype(dtype)


def _port_named(tree, batch_stats):
    """A JAX params-shaped tree (numpy leaves) -> {port name: tensor}."""
    return jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), batch_stats)


def _assert_stats_match(name, model, jax_stats, tol):
    """The port's running stats, carried to the JAX tree by import_torch.py,
    against ``jax_stats``."""
    _, variables = _jax_setup(name)
    back, _ = import_torch_checkpoint(model.state_dict(), variables, MODELS[name][3], strict=True)
    flat = jax.tree_util.tree_flatten_with_path(jax_stats)[0]
    assert flat
    for path, ref in flat:
        ours = back["batch_stats"]
        for key in path:
            ours = ours[key.key]
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _jax_loss_grads_stats(jax_model, variables, x, labels, dtype=None):
    """The JAX train-mode loss, its gradient and the mutated batch stats."""

    def loss_of(params):
        inputs = _jax(x)
        if dtype is not None:
            params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
            inputs = jax.tree_util.tree_map(lambda a: a.astype(dtype), inputs)
        logits, mutated = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, inputs, True,
            mutable=["batch_stats"])
        return (jax_soft_target_cross_entropy(logits.astype(jnp.float32), jnp.asarray(labels)),
                mutated["batch_stats"])

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    return loss, grads, stats


@functools.lru_cache(maxsize=None)
def _jax_default_step(name, dtype=None):
    """``_jax_loss_grads_stats`` on ``_pair(name)``'s default batch, computed
    once per (name, dtype): the one-step and bf16 tests share the X3D one."""
    jax_model, variables = _jax_setup(name)
    return _jax_loss_grads_stats(jax_model, variables, _clips(MODELS[name][2], 2, 1),
                                 _labels(2), dtype)


# --- the BatchNorm layer ----------------------------------------------------

def _flax_bn(x_ncthw, weight, bias, mean, var, dtype=None):
    """flax's train-mode BatchNorm through the JAX package's wrapper:
    (output NCTHW, new mean, new var)."""
    bn = JaxBatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"bn": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}
    x = _jax(x_ncthw)
    if dtype is not None:
        variables["params"] = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                                     variables["params"])
        x = x.astype(dtype)
    out, mutated = bn.apply(variables, x, True, mutable=["batch_stats"])
    stats = mutated["batch_stats"]["bn"]
    return (np.moveaxis(np.asarray(out.astype(jnp.float32)), -1, 1), np.asarray(stats["mean"]),
            np.asarray(stats["var"]))


def _bn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    mean = (rng.normal(size=c) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, weight, bias, mean, var


def _port_bn(cls, weight, bias, mean, var):
    bn = cls(len(weight))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return bn.train()


@pytest.mark.parametrize("shape", [(2, 5, 1, 1, 1), (3, 5, 2, 3, 4)], ids=["n2", "nBTHW"])
def test_batchnorm_train_matches_flax(shape):
    # n values per channel: 2 (X3D's head BN after the pool at B2 sees
    # that few), then B*T*H*W = 72.
    x, weight, bias, mean, var = _bn_inputs(shape)
    ref_out, ref_mean, ref_var = _flax_bn(x, weight, bias, mean, var)
    bn = _port_bn(BatchNorm, weight, bias, mean, var)
    out = bn(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **LAYER_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_mean, **LAYER_STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_var, **LAYER_STAT_TOL)
    assert bn.num_batches_tracked.item() == 1
    # nn.BatchNorm3d moves running_var towards the unbiased variance: off
    # flax's by the variance term's factor n / (n - 1).
    n = x.size // shape[1]
    stock = _port_bn(nn.BatchNorm3d, weight, bias, mean, var)
    stock(torch.from_numpy(x))
    batch_var = x.transpose(1, 0, 2, 3, 4).reshape(shape[1], -1).var(axis=1)
    np.testing.assert_allclose(stock.running_var.numpy() - 0.9 * var,
                               0.1 * batch_var * n / (n - 1), rtol=1e-4)
    assert np.abs(stock.running_var.numpy() - ref_var).max() > 1e-3


def test_batchnorm_bf16_params_beside_f32_buffers():
    # A bf16 step's cast copies: bf16 input, weight and bias, float32 running
    # buffers on the module. nn.BatchNorm3d refuses the mix.
    x, weight, bias, mean, var = _bn_inputs((2, 6, 2, 3, 3), seed=1)
    xb = torch.from_numpy(x).bfloat16()
    stock = _port_bn(nn.BatchNorm3d, weight, bias, mean, var)
    with pytest.raises(RuntimeError):
        torch.func.functional_call(stock, {"weight": stock.weight.bfloat16(),
                                           "bias": stock.bias.bfloat16()}, (xb,))
    bn = _port_bn(BatchNorm, weight, bias, mean, var)
    wb = bn.weight.detach().bfloat16().requires_grad_()
    out = torch.func.functional_call(bn, {"weight": wb, "bias": bn.bias.bfloat16()}, (xb,))
    assert out.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    out.float().square().sum().backward()
    assert wb.grad.dtype == torch.bfloat16 and torch.isfinite(wb.grad).all()
    # flax: the batch statistics in f32 of the same bf16 values.
    ref_out, ref_mean, ref_var = _flax_bn(xb.float().numpy(), weight, bias, mean, var,
                                          jnp.bfloat16)
    np.testing.assert_allclose(out.detach().float().numpy(), ref_out, **BF16_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_mean, **LAYER_STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_var, **LAYER_STAT_TOL)


def test_batchnorm_eval_and_cumulative_momentum_are_torch_s():
    x, weight, bias, mean, var = _bn_inputs((2, 4, 2, 3, 3), seed=2)
    ours, stock = (_port_bn(c, weight, bias, mean, var).eval() for c in (BatchNorm, nn.BatchNorm3d))
    torch.testing.assert_close(ours(torch.from_numpy(x)), stock(torch.from_numpy(x)),
                               rtol=0, atol=0)
    # momentum=None: a cumulative average, so after a reset one batch sets
    # the stats (its mean and biased variance).
    ours.train().reset_running_stats()
    ours.momentum = None
    ours(torch.from_numpy(x))
    flat = x.transpose(1, 0, 2, 3, 4).reshape(4, -1)
    np.testing.assert_allclose(ours.running_mean.numpy(), flat.mean(1), **LAYER_STAT_TOL)
    np.testing.assert_allclose(ours.running_var.numpy(), flat.var(1), rtol=1e-5, atol=1e-6)


def test_every_builder_makes_the_flax_batchnorm():
    for model in (create_x3d(**SMALL_X3D, device="cpu"), hub.slow_r50(**SMALL_SLOW, device="cpu"),
                  hub.slowfast_r50(**SMALL_SLOWFAST, device="cpu"),
                  hub.csn_r101(model_num_class=CLASSES, device="meta"),
                  hub.r2plus1d_r50(model_num_class=CLASSES, device="meta")):
        norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        assert norms and all(type(m) is BatchNorm for m in norms)


# --- a step against the JAX package's ---------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_one_step_loss_grads_and_stats_match_jax(name):
    # SlowFast: the JAX hub's packed fast pathway and the plain one, both
    # against the one port build.
    _, variables, model, x, labels = _pair(name)
    loss, _ = forward_backward(model, _torch(x), torch.from_numpy(labels))
    ref_loss, ref_grads, ref_stats = _jax_default_step(name)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **TOL)
    ref = _port_named(ref_grads, variables["batch_stats"])
    params = dict(model.named_parameters())
    assert set(params) <= set(ref)
    for n, p in params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), err_msg=n, **TOL)
    _assert_stats_match(name, model, ref_stats, STAT_TOL)


def _sgd_nesterov():
    # Warmup then cosine, so the LR changes every step. The peak LR is small
    # enough that three steps of these tiny models stay well conditioned: at
    # 0.5 the port's own f32 and f64 runs part far beyond TOL.
    cfg = jax_optimizer.OptimizerConfig(method="sgd", lr=0.02, momentum=0.9, weight_decay=1e-2,
                                        nesterov=True, zero_weight_decay_1d_param=True)
    sched = jax_presets.classification_x3d_xs().lr_scheduler
    sched.lr, sched.max_iters, sched.warmup_iters, sched.warmup_start_lr = 0.02, 6, 2, 0.002
    return cfg, sched


def _assert_updates_match(model, before, jax_params, batch_stats):
    """Each parameter's change from ``before`` against the JAX one's (TOL)."""
    ref = _port_named(jax_params, batch_stats)
    for n, p in model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(),
                                   ref[n].numpy() - before[n].numpy(), err_msg=n, **TOL)


def _jax_state(variables, cfg, sched):
    tx = jax_optimizer.construct_optimizer(variables["params"], cfg,
                                           jax_optimizer.lr_schedule_from_config(sched, 1))
    return tx, jax_create_train_state(variables, tx)


def _port_state(model, cfg, sched):
    return TrainState(model, construct_optimizer(model, OptimizerConfig(**vars(cfg))),
                      lr_schedule_from_config(LRSchedulerConfig(**vars(sched)), 1))


def _relative_l2(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over all tensors of two {name: gradient}."""
    err = sum(float(((got[n].double() - r.double()) ** 2).sum()) for n, r in ref.items())
    return (err / sum(float((r.double() ** 2).sum()) for r in ref.values())) ** 0.5


def test_bf16_step_as_near_f32_as_jax_s_and_keeps_f32_masters_and_stats():
    # bf16 rounding moves a BN network's gradients far (the JAX package's own
    # bf16 step lies tens of percent from its f32 one here): the port's bf16
    # gradients must lie within twice the JAX package's distance from their
    # own f32 gradients, and its loss within 3e-2 of the JAX bf16 loss.
    name = "x3d"
    _, variables, model, x, labels = _pair(name)
    jax_grads = {}
    for dtype in (None, jnp.bfloat16):
        loss, grads, _ = _jax_default_step(name, dtype)
        named = _port_named(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads),
                            variables["batch_stats"])
        jax_grads[dtype] = {n: named[n] for n, _ in model.named_parameters()}
    ref_loss = float(loss)
    f32 = copy.deepcopy(model)
    forward_backward(f32, _torch(x), torch.from_numpy(labels))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    # Without oneDNN: its CPU bf16 convolutions do not repeat from run to run
    # (benchmarks_torch/cpu_bf16_repeat.py), PyTorch's own ones do.
    with torch.backends.mkldnn.flags(enabled=False):
        state, metrics = make_train_step(compute_dtype=torch.bfloat16)(
            state, {"video": _torch(x), "label": torch.from_numpy(labels)})
    assert abs(metrics["loss"].item() - ref_loss) < 3e-2 * abs(ref_loss)
    ours = _relative_l2({n: p.grad for n, p in model.named_parameters()},
                        {n: p.grad for n, p in f32.named_parameters()})
    theirs = _relative_l2(jax_grads[jnp.bfloat16], jax_grads[None])
    assert ours <= 2.0 * theirs, (ours, theirs)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p).all(), n
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        assert m.running_mean.dtype == m.running_var.dtype == torch.float32
        assert m.num_batches_tracked.item() == 1
        assert torch.isfinite(m.running_mean).all() and (m.running_var > 0).all()


@jax.enable_x64(True)
def test_three_accumulated_sgd_nesterov_steps_on_pathway_lists_match_jax():
    # The recipes' optimizer (nesterov SGD, zero-wd 1-D params, the BN group)
    # at an LR that changes every step, three steps on three [slow, fast]
    # batches of 4, each step two microbatches of 2 whose running stats go
    # through them in order, as the JAX step's lax.scan threads them (not
    # the full batch's statistics). In float64.
    name = "slowfast_plain"
    jax_model, variables, model, _, _ = _pair(name, dtype=np.float64)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg, sched = _sgd_nesterov()
    tx, jax_state = _jax_state(variables, cfg, sched)
    jax_step = jax.jit(jax_make_train_step(jax_model, tx, grad_accum_steps=2))
    state = _port_state(model, cfg, sched)
    step = make_train_step(grad_accum_steps=2)
    for i in range(3):
        x, labels = _cast(_clips(MODELS[name][2], 4, 10 + i), np.float64), _labels(4, 20 + i)
        jax_state, jax_metrics = jax_step(
            jax_state, {"video": _jax(x), "label": jnp.asarray(labels)}, jax.random.PRNGKey(i))
        state, metrics = step(state, {"video": _torch(x), "label": torch.from_numpy(labels)})
        np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jax_metrics["loss"]),
                                   **TOL)
        np.testing.assert_allclose(metrics["accuracy"].numpy(),
                                   np.asarray(jax_metrics["accuracy"]))
    assert state.step == 3
    _assert_updates_match(model, before, jax_state.params, variables["batch_stats"])
    _assert_stats_match(name, model, jax_state.batch_stats, F64_STAT_TOL)
    assert all(m.num_batches_tracked.item() == 6 for m in model.modules()
               if isinstance(m, BatchNorm))


@jax.enable_x64(True)
def test_update_bn_stats_matches_jax_and_changes_only_the_stats():
    # In float64: each stat the mean of three batches' statistics.
    name = "x3d"
    jax_model, variables, model, _, _ = _pair(name, dtype=np.float64)
    batches = [_clips(MODELS[name][2], 2, 30 + i).astype(np.float64) for i in range(4)]
    ref = jax_update_bn_stats(jax_model, variables, [_jax(b) for b in batches], 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    update_bn_stats(model, ({"video": _torch(b)} for b in batches), 3)
    assert not model.training and not any(m.training for m in model.modules())
    _assert_stats_match(name, model, ref["batch_stats"], F64_STAT_TOL)
    after = model.state_dict()
    for k, v in before.items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(after[k], v), k
        else:
            torch.testing.assert_close(after[k], v, rtol=0, atol=0, msg=k)
    # The mean of each batch's statistics, taken separately, one batch each.
    singles = []
    for b in batches[:3]:
        single = MODELS[name][1]().double()
        single.load_state_dict(before)
        update_bn_stats(single, [_torch(b)], 1)
        singles.append(single.state_dict())
    for k in before:
        if k.endswith(("running_mean", "running_var")):
            mean = torch.stack([s[k] for s in singles]).mean(0)
            torch.testing.assert_close(after[k], mean, rtol=1e-12, atol=1e-12, msg=k)
    # The callback form, and no batch at all.
    PreciseBn(3).on_train_epoch_end(model, [_torch(b) for b in batches])
    torch.testing.assert_close(model.state_dict(), after, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no batches"):
        update_bn_stats(model, [], 3)


# --- the head, the transforms and the app -----------------------------------

def test_head_dropout_in_train_mode_only_from_its_generator():
    x = torch.ones(4000, 8)
    drop = Dropout(0.25, torch.Generator().manual_seed(0))
    assert drop.eval()(x) is x
    out = drop.train()(x)
    assert set(torch.unique(out).tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((out > 0).float().mean().item() - 0.75) < 0.01
    again = Dropout(0.25, torch.Generator().manual_seed(0)).train()(x)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    model = create_x3d(**{**SMALL_X3D, "dropout_rate": 0.5}, device="cpu")
    assert isinstance(model.blocks[-1].dropout, Dropout)
    clip = torch.randn(2, 3, 4, 32, 32)
    with torch.no_grad():
        model.eval()
        torch.testing.assert_close(model(clip), model(clip), rtol=0, atol=0)


def test_slowfast_pack_pathway_and_collate_match_jax():
    frames = np.random.default_rng(0).normal(size=(3, 32, 4, 5)).astype(np.float32)
    slow, fast = SlowFastPackPathway(4)(frames)
    ref_slow, ref_fast = JaxSlowFastPackPathway(4)(np.moveaxis(frames, 0, -1))
    np.testing.assert_array_equal(np.moveaxis(slow.numpy(), 0, -1), ref_slow)
    np.testing.assert_array_equal(fast.numpy(), frames)
    samples = [{"video": SlowFastPackPathway(4)(frames + i), "label": i, "name": f"v{i}"}
               for i in range(3)]
    batch = default_collate(samples)
    ref = jax_default_collate([{"video": [np.asarray(p) for p in s["video"]], "label": s["label"],
                                "name": s["name"]} for s in samples])
    assert [tuple(p.shape) for p in batch["video"]] == [(3, 3, 8, 4, 5), (3, 3, 32, 4, 5)]
    for ours, theirs in zip(batch["video"], ref["video"]):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(batch["label"].numpy(), ref["label"])
    assert batch["name"] == ref["name"] == ["v0", "v1", "v2"]


class _Clips:
    """A datamodule of seeded random clips: ``train_dataloader(n)`` yields n
    collated batches, ``val_dataloader(None)`` two batches of two videos'
    clips (two clips a video), with their video and clip indices."""

    def __init__(self, clip, batch=2, alpha=None):
        self.clip, self.batch = clip, batch
        self.pack = None if alpha is None else SlowFastPackPathway(alpha)

    def _batch(self, rng, labels, **extra):
        clips = [rng.normal(size=(3, *self.clip)).astype(np.float32) for _ in labels]
        videos = [c if self.pack is None else self.pack(c) for c in clips]
        return default_collate([{"video": v, "label": int(y), **{k: int(e[i]) for k, e in
                                                                 extra.items()}}
                                for i, (v, y) in enumerate(zip(videos, labels))])

    def train_dataloader(self, n):
        rng = np.random.default_rng(0)
        for _ in range(n):
            yield self._batch(rng, rng.integers(0, CLASSES, size=self.batch))

    def val_dataloader(self, _):
        rng = np.random.default_rng(1)
        for first in (0, 2):
            videos = np.array([first, first, first + 1, first + 1])
            yield self._batch(rng, videos % CLASSES, video_index=videos,
                              clip_index=np.array([0, 1, 0, 1]))


def _bn_app(preset, model, datamodule, **overrides):
    cfg = get_preset(preset, **{"model.num_classes": CLASSES, "trainer.max_epochs": 1,
                                "trainer.log_every_n_steps": 1, **overrides})
    return VideoClassificationTrainApp(cfg, model=model, datamodule=datamodule,
                                       steps_per_epoch=2, device="cpu")


def test_app_trains_slowfast_on_pathway_lists():
    _, _, model, _, _ = _pair("slowfast_plain")
    app = _bn_app("classification_slowfast_8x8_r50", model,
                  _Clips((16, 32, 32), alpha=4), **{"trainer.precise_bn_batches": 0})
    history = app.train()
    assert len(history) == 2 and np.isfinite(history).all() and app.state.step == 2
    assert [g["label"] for g in app.state.optimizer.param_groups] == ["main", "bn"]
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    val = app._device_batch(next(app.datamodule.val_dataloader(None)))
    logits = make_eval_step()(app.state, val)
    assert logits.shape == (4, CLASSES) and torch.isfinite(logits).all()


def test_app_precise_bn_changes_only_bn_buffers_then_test_and_predict():
    # classification_x3d_xs on the small X3D, with and without precise BN.
    runs = {}
    for batches in (0, 2):
        _, _, model, _, _ = _pair("x3d")
        app = _bn_app("classification_x3d_xs", model, _Clips((4, 32, 32)),
                      **{"trainer.precise_bn_batches": batches})
        app.train()
        runs[batches] = app
    plain, precise = (runs[b].state.model.state_dict() for b in (0, 2))
    for k, v in plain.items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(precise[k], v), k
        else:
            torch.testing.assert_close(precise[k], v, rtol=0, atol=0, msg=k)
    app = runs[2]
    result = app.test()
    assert set(result) == {"video_top1"} and 0.0 <= result["video_top1"] <= 1.0
    assert app.test(num_videos=6).keys() == result.keys()
    predictions = app.predict()
    assert len(predictions) == 2 and len(app.predict(max_batches=1)) == 1
    first = predictions[0]
    assert first["logits"].shape == (4, CLASSES) and torch.isfinite(first["logits"]).all()
    assert first["video_index"].tolist() == [0, 0, 1, 1]
    assert first["clip_index"].tolist() == [0, 1, 0, 1]
    # The video-level top-1 from the ensembled predictions, by hand.
    logits = torch.cat([p["logits"] for p in predictions])
    index = torch.cat([p["video_index"] for p in predictions])
    labels = torch.cat([p["label"] for p in predictions])
    summed = torch.stack([logits[index == v].sum(0) for v in range(4)])
    truth = torch.stack([labels[index == v][0] for v in range(4)])
    assert result["video_top1"] == (summed.argmax(-1) == truth).float().mean().item()


def test_bn_entry_points_default_to_the_card():
    assert inspect.signature(VideoClassificationTrainApp).parameters["device"].default == "cuda"
    for factory in (hub.x3d_s, hub.x3d_xs, hub.slow_r50, hub.slowfast_r50):
        model = factory(device="meta")
        assert all(p.is_meta for p in model.parameters())
    if not torch.cuda.is_available():
        for preset, name in (("classification_x3d_xs", None), ("classification_x3d_xs", "x3d_s"),
                             ("classification_slow_8x8_r50", None),
                             ("classification_slowfast_8x8_r50", None)):
            overrides = {} if name is None else {"model.name": name, "model.clip_length": 13}
            with pytest.raises((AssertionError, RuntimeError)):
                VideoClassificationTrainApp(get_preset(preset, **overrides),
                                            datamodule=_Clips((4, 32, 32)))
