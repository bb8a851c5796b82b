"""Activation rematerialisation of the port's train step (``remat_policy``),
on the CPU at a small size: a narrow X3D (width factor 1, depth factor
0.25, 4x32x32 clips, BatchNorm) and a 3-block MViT, with head dropout and (MViT) DropPath
above 0, each drawing its masks from an explicit generator, and seeded numpy
weights.

- One step in float64 under every policy name gives the unchecked step's
  loss, parameters and BatchNorm buffers (running mean and variance,
  ``num_batches_tracked``) within 1e-12 (expected: equal): the masks of the
  recomputation are the forward's and the running stats move once.
- The policies' answers on the aten ops of one step: the dots policies save
  the matrix products they name and recompute the convolutions, and the
  kernels' forwards (their plain versions here) run again.
- A ``"full"`` step of the X3D against the JAX package's step under
  ``remat_policy="full"`` on the same weights, in float64 on both sides, at
  tests/test_torch_train_bn.py's float64 tolerances (each parameter's
  change rtol 5e-3 / atol 5e-4, the running stats rtol 1e-6 / atol 1e-6).
"""

import copy
import functools
import importlib

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train.train_loop import create_train_state as jax_create_train_state
from pytorchvideo_tpu.train.train_loop import make_train_step as jax_make_train_step
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.models.x3d import create_x3d
from pytorchvideo_tpu_torch.ops import token_pool as tp
from pytorchvideo_tpu_torch.train import (
    REMAT_POLICIES,
    OptimizerConfig,
    TrainState,
    construct_optimizer,
    forward_backward,
    make_train_step,
)
from pytorchvideo_tpu_torch.train import train_loop
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import SMALL_MVIT, TOL, build_pair, small_mvit_pair

# The module (the package exports the JAX package's function under its name).
pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

CLASSES = 7
X3D = dict(input_clip_length=4, input_crop_size=32, model_num_class=CLASSES, width_factor=1.0,
           depth_factor=0.25, head_dim_out=32)
MVIT_DROPOUT = dict(droppath_rate_block=0.3, head_dropout_rate=0.4)
F64_STAT_TOL = dict(rtol=1e-6, atol=1e-6)
EQUAL = 1e-12
_aten = torch.ops.aten


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small steps: they run no faster
    on more, and a pool of threads in each of the suite's parallel workers
    oversubscribes the cores, which slows small ops by tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(the port's state_dict of seeded numpy weights, a seeded NCTHW batch)."""
    _, _, model, x = build_pair(**X3D) if name == "x3d" else small_mvit_pair()
    return copy.deepcopy(model.state_dict()), x


def _model(name):
    """The port model of ``name`` in float64, train mode, its stochastic
    layers each on its own seeded CPU generator."""
    state_dict, _ = _weights(name)
    if name == "x3d":
        model = create_x3d(**X3D, dropout_rate=0.5, device="cpu")
        stochastic = [model.blocks[-1].dropout]
    else:
        model = create_multiscale_vision_transformers(**SMALL_MVIT, **MVIT_DROPOUT, device="cpu")
        stochastic = [*model.blocks, model.head.dropout]
    model.load_state_dict(state_dict)
    for i, module in enumerate(stochastic):
        module.generator = torch.Generator().manual_seed(100 + i)
    return model.double().train()


def _batch(name):
    x = _weights(name)[1]
    labels = np.random.default_rng(3).integers(0, CLASSES, size=len(x))
    return {"video": torch.from_numpy(x).double(), "label": torch.from_numpy(labels)}


def _step(name, policy):
    model = _model(name)
    cfg = OptimizerConfig(method="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-3)
    state = TrainState(model, construct_optimizer(model, cfg))
    state, metrics = make_train_step(remat_policy=policy)(state, _batch(name))
    return metrics["loss"].item(), model.state_dict()


@functools.lru_cache(maxsize=None)
def _unchecked(name):
    return _step(name, None)


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
@pytest.mark.parametrize("name", ["x3d", "mvit"])
def test_every_policy_gives_the_unchecked_step(name, policy):
    ref_loss, ref = _unchecked(name)
    loss, got = _step(name, policy)
    assert abs(loss - ref_loss) <= EQUAL
    assert set(got) == set(ref)
    for key, value in ref.items():
        # Parameters, BN running stats and num_batches_tracked alike.
        assert (got[key].double() - value.double()).abs().max().item() <= EQUAL, key
    tracked = [v for k, v in got.items() if k.endswith("num_batches_tracked")]
    assert all(t.item() == 1 for t in tracked) and (name == "mvit" or tracked)


def _recorded(name, policy, monkeypatch):
    """One checkpointed forward and backward of ``name`` under ``policy``:
    ({aten op packet: set of the policy's answers in the forward}, plain
    kernel forwards run with the policy, without it)."""
    answers = {}
    make_policy = train_loop.checkpoint_policy

    def recording(remat_policy):
        policy_fn = make_policy(remat_policy)
        if policy_fn is None:
            return None

        def wrapped(ctx, op, *args, **kwargs):
            answer = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                answers.setdefault(op.overloadpacket, set()).add(answer)
            return answer

        return wrapped

    monkeypatch.setattr(train_loop, "checkpoint_policy", recording)
    calls = []
    for module, fn in ((pa, "pooled_attention_packed_torch"), (tp, "depthwise_token_pool_torch")):
        original = getattr(module, fn)

        def counted(*args, _original=original, **kwargs):
            calls.append(1)
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, fn, counted)
    kernel_calls = {}
    for remat in (policy, None):
        calls.clear()
        batch = _batch(name)
        forward_backward(_model(name), batch["video"], batch["label"], remat_policy=remat)
        kernel_calls[remat] = len(calls)
    return answers, kernel_calls[policy], kernel_calls[None]


SAVE, RECOMPUTE = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("policy, saved, recomputed", [
    ("dots_with_no_batch_dims_saveable", {_aten.mm, _aten.addmm},
     {_aten.bmm, _aten.baddbmm, _aten.convolution}),
    ("dots_saveable", {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}, {_aten.convolution}),
], ids=["no_batch_dims", "dots"])
@pytest.mark.parametrize("name", ["x3d", "mvit"])
def test_policy_saves_its_dots_and_recomputes_the_rest(name, policy, saved, recomputed,
                                                       monkeypatch):
    answers, with_policy, without = _recorded(name, policy, monkeypatch)
    for op in saved:
        assert answers.get(op, {SAVE}) == {SAVE}, op
    for op in recomputed:
        assert answers.get(op, {RECOMPUTE}) == {RECOMPUTE}, op
    # Every random draw is saved; everything else is recomputed.
    assert answers[_aten.rand] == {SAVE}
    assert answers[_aten.convolution] == {RECOMPUTE}
    others = {op: a for op, a in answers.items() if op not in saved and op is not _aten.rand}
    assert all(a == {RECOMPUTE} for a in others.values()), others
    # The linears are addmm in both models; MViT's attention products (the
    # kernel's plain version on the CPU) are bmm; each kernel forward runs
    # again in the recomputation.
    assert _aten.addmm in answers
    if name == "mvit":
        assert _aten.bmm in answers
        assert without > 0 and with_policy == 2 * without
    else:
        assert with_policy == without == 0


@pytest.mark.parametrize("policy", ["bogus", "save_only_these_names", "save_any_names_but_these",
                                    "offload_dot_with_no_batch_dims"])
def test_other_policy_names_are_refused(policy):
    with pytest.raises(ValueError, match="remat_policy"):
        make_train_step(remat_policy=policy)
    batch = _batch("x3d")
    with pytest.raises(ValueError, match="remat_policy"):
        forward_backward(_model("x3d"), batch["video"], batch["label"], remat_policy=policy)


@jax.enable_x64(True)
def test_full_remat_x3d_step_matches_jax():
    # Head dropout 0 here: the two frameworks draw different masks.
    jax_model, variables, model, x = build_pair(**X3D)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    model = model.double().train()
    x = x.astype(np.float64)
    labels = np.random.default_rng(3).integers(0, CLASSES, size=len(x))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = dict(method="sgd", lr=0.02, momentum=0.9, weight_decay=1e-2, nesterov=True,
               zero_weight_decay_1d_param=True)
    tx = jax_optimizer.construct_optimizer(variables["params"],
                                           jax_optimizer.OptimizerConfig(**cfg))
    jax_step = jax.jit(jax_make_train_step(jax_model, tx, remat_policy="full"))
    jax_state, jax_metrics = jax_step(
        jax_create_train_state(variables, tx),
        {"video": jnp.asarray(np.moveaxis(x, 1, -1)), "label": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    state = TrainState(model, construct_optimizer(model, OptimizerConfig(**cfg)))
    state, metrics = make_train_step(remat_policy="full")(
        state, {"video": torch.from_numpy(x), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jax_metrics["loss"]), **TOL)
    ref = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_state.params),
                                      jax.tree_util.tree_map(np.asarray, jax_state.batch_stats))
    for n, p in model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(),
                                   ref[n].numpy() - before[n].numpy(), err_msg=n, **TOL)
    for key, value in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), ref[key].numpy(), err_msg=key,
                                       **F64_STAT_TOL)
