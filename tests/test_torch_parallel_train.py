"""pytorchvideo_tpu_torch's data-parallel training against the JAX package's
step on the global batch, on the CPU: four gloo ranks
(tests/torch_parallel_worker.py, one spawn for the whole file), a tiny BN
X3D (tests/test_train_parallel.py:28-36), a global batch of 8 clips, the
recipes' optimizer (nesterov SGD, zero-wd 1-D params, the BN group) at an
LR that changes every step, and BatchNorm synced over the group.

- One update in f32 (each rank its 2 rows) without a batch transform, and
  with MixUp and the clip by global norm: the loss, each parameter's change
  and the running stats against the JAX step jitted on the whole batch at
  rtol 5e-3 / atol 5e-4 (tests/test_models_parity.py:24; the stats at rtol
  1e-5 / atol 1e-5, as tests/test_torch_train_bn.py).
- Three updates in float64 (the JAX side under ``jax.enable_x64``), each
  two microbatches, with CutMix: the losses and each parameter's change at
  rtol 5e-3 / atol 5e-4, the running stats at rtol 1e-6 / atol 1e-6, as
  tests/test_torch_train_bn.py's three-step check.
- ``VideoClassificationTrainApp`` on the gloo group: it shards a batch of 8
  (2 rows a rank, MixUp on), replicates a batch of 6 (which 4 ranks do not
  split) and gathers its eval logits; its losses, state and predictions
  match the same app run in one process without a group at the f32
  tolerance above. Where 4 ranks divide the batch it is never replicated:
  a batch of 12 takes 3 rows a rank, and raises ValueError naming the
  constraint under MixUp (an odd share has no mirrored layout) or with
  more microbatches than its rows split into (8 rows in 4).

MixUp's lambda and CutMix's box are fixed on both sides (the frameworks
draw different bits), and each rank's rows are the mirrored layout whose
local flip pairs each row with its global partner. The JAX references and
the one-process app runs are computed while the ranks run.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train import presets as jax_presets
from pytorchvideo_tpu.train.train_loop import create_train_state as jax_create_train_state
from pytorchvideo_tpu.train.train_loop import make_train_step as jax_make_train_step
from pytorchvideo_tpu.transforms import mix as jax_mix
from pytorchvideo_tpu.train.transforms import MixVideoBatchWrapper as JaxMixVideoBatchWrapper
from pytorchvideo_tpu.zoo.import_torch import X3D_RENAME_RULES, import_torch_checkpoint
from pytorchvideo_tpu_torch.train import config_to_dict, get_preset
from pytorchvideo_tpu_torch.transforms import mix
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_parallel_worker import app_run, collect, start
from torch_port_helpers import TOL, random_variables

WORLD, BATCH, CLASSES = 4, 8, 5
X3D = dict(input_clip_length=2, input_crop_size=32, model_num_class=CLASSES, stem_dim_in=8,
           depth_factor=0.1, dropout_rate=0.0)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
F64_STAT_TOL = dict(rtol=1e-6, atol=1e-6)
LAM, CENTRE = 0.3, (20, 9)
MIXUP = dict(mixup_alpha=1.0, cutmix_prob=0.0, cutmix_alpha=1.0, label_smoothing=0.1)
CUTMIX = dict(MIXUP, cutmix_prob=1.0)
# name -> (float64, batch transform, microbatches, clip by global norm, updates)
CASES = {"plain": (False, None, 1, None, 1), "mixup": (False, MIXUP, 1, 0.5, 1),
         "float64": (True, CUTMIX, 2, None, 3)}


@functools.lru_cache(maxsize=None)
def _jax_setup():
    model = jax_create_x3d(**X3D)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 2, 32, 32, 3)), False))
    return model, random_variables(shapes, 0)


def _optim():
    # tests/test_torch_train_bn.py's: warmup then cosine, so the LR moves.
    cfg = jax_optimizer.OptimizerConfig(method="sgd", lr=0.02, momentum=0.9, weight_decay=1e-2,
                                        nesterov=True, zero_weight_decay_1d_param=True)
    sched = jax_presets.classification_x3d_xs().lr_scheduler
    sched.lr, sched.max_iters, sched.warmup_iters, sched.warmup_start_lr = 0.02, 6, 2, 0.002
    return cfg, sched


def _batches(n, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, 3, 2, 32, 32)).astype(np.float32),
             rng.integers(0, CLASSES, size=batch)) for _ in range(n)]


def _app_config(mixing: bool, accum: int = 1) -> dict:
    cfg = get_preset("classification_x3d_xs", **{
        "model.num_classes": CLASSES, "trainer.max_epochs": 1, "trainer.log_every_n_steps": 1,
        "trainer.precise_bn_batches": 0, "mix.enabled": mixing, "mix.cutmix_prob": 0.0,
        "optim.lr": 0.02, "lr_scheduler.lr": 0.02, "trainer.grad_accum_steps": accum})
    return config_to_dict(cfg)


# name -> (config, global batch size)
APP_CASES = {"sharded": (True, BATCH), "replicated": (False, 6)}
# name -> (MixUp, microbatches, global batch size, this rank's labels or the error's words)
LAYOUT_CASES = {"plain 12": (False, 1, 12, None),
                "mixup 12": (True, 1, 12, "even share"),
                "accum 4 of 8": (False, 4, 8, "grad_accum_steps must be a multiple of 4")}


def _inputs():
    _, variables = _jax_setup()
    cfg, sched = _optim()
    cases = {}
    for name, (f64, mixing, accum, clip, updates) in CASES.items():
        batches = [(torch.from_numpy(v), torch.from_numpy(y))
                   for v, y in _batches(updates, seed=len(cases))]
        cases[name] = {"float64": f64, "mix": mixing, "accum": accum, "clip": clip,
                       "batches": batches}
    app_cases = {name: {"config": _app_config(mixing),
                        "batches": [(torch.from_numpy(v), torch.from_numpy(y))
                                    for v, y in _batches(2, batch, seed=10 + batch)]}
                 for name, (mixing, batch) in APP_CASES.items()}
    layout_cases = {name: {"config": _app_config(mixing, accum),
                           "batch": {"video": torch.zeros(batch, 3, 2, 32, 32),
                                     "label": torch.arange(batch)}}
                    for name, (mixing, accum, batch, _) in LAYOUT_CASES.items()}
    return {"x3d": X3D, "classes": CLASSES, "lam": LAM, "centre": CENTRE,
            "layout_cases": layout_cases,
            "state_dict": jax_variables_to_state_dict(variables["params"],
                                                      variables["batch_stats"]),
            "optim": vars(cfg), "sched": vars(sched), "cases": cases, "app_cases": app_cases}


def _fix_draws(monkeypatch):
    """MixUp's lambda and CutMix's box centre fixed in both packages."""
    monkeypatch.setattr(mix, "_sample_beta", lambda alpha, generator: LAM)
    monkeypatch.setattr(mix, "_sample_center", lambda h, w, generator: CENTRE)
    monkeypatch.setattr(jax_mix, "_sample_beta", lambda key, alpha: jnp.float32(LAM))
    draws = itertools.cycle(CENTRE)
    monkeypatch.setattr(jax_mix.jax.random, "randint", lambda *a, **k: jnp.int32(next(draws)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, each rank's results, the JAX references by case, the
    one-process app runs by case)."""
    directory = tmp_path_factory.mktemp("parallel_train")
    inputs = _inputs()
    torch.save(inputs, directory / "inputs.pt")
    context = start(str(directory), "training", WORLD)
    with pytest.MonkeyPatch.context() as monkeypatch:
        _fix_draws(monkeypatch)
        refs = {}
        for name, case in CASES.items():
            with jax.enable_x64(case[0]):
                refs[name] = _jax_run(name)
        alone = app_run(inputs)
    return inputs, collect(context, str(directory)), refs, alone


def _jax_run(name):
    """The JAX step jitted on the whole batch, over the case's updates:
    (losses, params, batch stats)."""
    f64, mixing, accum, clip, updates = CASES[name]
    model, variables = _jax_setup()
    dtype = np.float64 if f64 else np.float32
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    cfg, sched = _optim()
    tx = jax_optimizer.construct_optimizer(variables["params"], cfg,
                                           jax_optimizer.lr_schedule_from_config(sched, 1))
    state = jax_create_train_state(variables, tx)
    transform = None
    if mixing:
        transform = JaxMixVideoBatchWrapper(num_classes=CLASSES, **mixing).mix_video_transform
    step = jax.jit(jax_make_train_step(model, tx, batch_transform=transform, clip_grad_norm=clip,
                                       grad_accum_steps=accum))
    losses = []
    for i, (video, labels) in enumerate(_batches(updates, seed=list(CASES).index(name))):
        batch = {"video": jnp.asarray(np.moveaxis(video, 1, -1).astype(dtype)),
                 "label": jnp.asarray(labels)}
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    return losses, state.params, state.batch_stats


def _port_named(tree):
    _, variables = _jax_setup()
    return jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, tree),
                                       variables["batch_stats"])


def _assert_stats(state_dict, ref_stats, tol):
    _, variables = _jax_setup()
    back, _ = import_torch_checkpoint({k: v.float() for k, v in state_dict.items()},
                                      variables, X3D_RENAME_RULES, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(ref_stats)[0]
    assert flat
    for path, ref in flat:
        ours = back["batch_stats"]
        for key in path:
            ours = ours[key.key]
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax_on_the_global_batch(ranks, name):
    inputs, results, refs, _ = ranks
    f64 = CASES[name][0]
    losses, params, stats = refs[name]
    ours = results[0]["steps"][name]
    np.testing.assert_allclose(ours["losses"], losses, **TOL)
    before = inputs["state_dict"]
    ref = _port_named(params)
    for n, p in ours["state_dict"].items():
        if n in ref and not n.endswith(("running_mean", "running_var", "num_batches_tracked")):
            np.testing.assert_allclose((p.double() - before[n].double()).numpy(),
                                       ref[n].double().numpy() - before[n].double().numpy(),
                                       err_msg=n, **TOL)
    _assert_stats(ours["state_dict"], stats, F64_STAT_TOL if f64 else STAT_TOL)
    # Every rank ends with the same state: the averaged update and the
    # group's statistics.
    for other in results[1:]:
        assert other["steps"][name]["losses"] == ours["losses"]
        for n, t in other["steps"][name]["state_dict"].items():
            torch.testing.assert_close(t, ours["state_dict"][n], rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("name", list(APP_CASES))
def test_app_on_a_group_matches_its_single_process_run(ranks, name):
    _, results, _, runs = ranks
    alone = runs[name]
    batch = APP_CASES[name][1]
    assert not alone["mesh"] and alone["rows"] == [batch, batch]
    expected_rows = batch // WORLD if batch % WORLD == 0 else batch
    for res in results:
        ours = res["app"][name]
        assert ours["mesh"] and ours["rows"] == [expected_rows] * 2
        np.testing.assert_allclose(ours["history"], alone["history"], **TOL)
        for n, t in alone["state_dict"].items():
            np.testing.assert_allclose(ours["state_dict"][n].double().numpy(),
                                       t.double().numpy(), err_msg=n, **TOL)
        # The eval pass: each rank's rows, the logits gathered in order.
        for got, ref in zip(ours["predict"], alone["predict"]):
            assert got["logits"].shape == ref["logits"].shape == (batch, CLASSES)
            np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(), **TOL)
            assert torch.equal(got["video_index"], ref["video_index"])


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_app_shards_every_batch_the_ranks_divide(ranks, name):
    _, results, _, _ = ranks
    _, _, batch, words = LAYOUT_CASES[name]
    for rank, res in enumerate(results):
        got = res["layouts"][name]
        if words is None:
            share = batch // WORLD
            assert got == list(range(rank * share, (rank + 1) * share))
        else:
            assert isinstance(got, str) and words in got, got
