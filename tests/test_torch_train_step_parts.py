"""The parts of the port's train step around the captured graph, on the CPU:
the optimizers with the LR on the device against the float-LR ones, the
captured step's refusal of a CPU model, the app's eager steps on the CPU,
the trainer losses and the SSL backbone graft against the JAX package's.

Tolerances: the tensor-LR updates equal the float-LR ones exactly (the same
arithmetic at the same LR); the losses in f32 rtol 1e-5 (one reduction
order apart); the grafted tensors equal the JAX app's exactly.
"""

import copy
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu.train import losses as jax_losses
from pytorchvideo_tpu.train.app import VideoClassificationTrainApp as JaxTrainApp
from pytorchvideo_tpu.train.train_loop import create_train_state as jax_create_train_state
from pytorchvideo_tpu_torch.models.x3d import create_x3d
from pytorchvideo_tpu_torch.train import (
    CompiledTrainStep,
    OptimizerConfig,
    TrainState,
    VideoClassificationTrainApp,
    construct_optimizer,
    contrastive_loss,
    get_preset,
    lr_schedule_from_config,
    make_train_step,
    ntxent_loss,
    similarity_loss,
)
from pytorchvideo_tpu_torch.train import losses
from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_parallel_worker import one_rank_group
from torch_port_helpers import random_variables

CLASSES = 7
X3D = dict(input_clip_length=4, input_crop_size=32, model_num_class=CLASSES, width_factor=1.0,
           depth_factor=0.25, head_dim_out=32, dropout_rate=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


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
def _variables(seed, num_class):
    """Seeded numpy variables of the small JAX X3D (built once per worker)."""
    jax_model = jax_create_x3d(**{**X3D, "model_num_class": num_class})
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3), jnp.float32), False))
    return random_variables(shapes, seed)


def _x3d(seed=0, model_num_class=CLASSES):
    """The port's small X3D with seeded numpy weights (the JAX layout's),
    and those variables."""
    variables = _variables(seed, model_num_class)
    model = create_x3d(**{**X3D, "model_num_class": model_num_class}, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables["params"],
                                                      variables["batch_stats"]), strict=True)
    return model.train(), variables


def _batches(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"video": torch.from_numpy(rng.normal(size=(batch, 3, 4, 32, 32)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, CLASSES, size=batch))} for _ in range(n)]


# --- the LR on the device ---------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(method="sgd", momentum=0.9),
    dict(method="sgd", momentum=0.9, nesterov=True),
    dict(method="adamw", weight_decay=0.05),
], ids=["sgd_momentum", "sgd_nesterov", "adamw"])
def test_tensor_lr_updates_equal_the_float_lr_ones(cfg):
    # Five updates at a warmup-then-cosine LR that changes every step, from
    # the same weights on the same batches; the optimizer's groups (the
    # main, zero-decay and BN ones) as construct_optimizer makes them.
    cfg = OptimizerConfig(lr=0.05, zero_weight_decay_1d_param=True, **cfg)
    schedule = lr_schedule_from_config(
        LRSchedulerConfig(lr=0.05, warmup_iters=2, warmup_start_lr=0.005, max_iters=6), 1)
    model, _ = _x3d()
    states = {}
    for form in ("tensor", "float"):
        ours = copy.deepcopy(model)
        optimizer = construct_optimizer(ours, cfg)
        lr = optimizer.param_groups[0]["lr"]
        assert isinstance(lr, torch.Tensor) and lr.dim() == 0
        assert all(g["lr"] is lr for g in optimizer.param_groups)
        if form == "float":
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
        state = TrainState(ours, optimizer, schedule)
        step = make_train_step(clip_grad_norm=1.0)
        for batch in _batches(5):
            state, _ = step(state, batch)
        if form == "tensor":
            assert lr.item() == schedule(4)
        states[form] = (ours.state_dict(), optimizer.state_dict()["state"])
    (model_t, opt_t), (model_f, opt_f) = states["tensor"], states["float"]
    for key, value in model_f.items():
        torch.testing.assert_close(model_t[key], value, rtol=0, atol=0, msg=key)
    for index, per_param in opt_f.items():
        for key, value in per_param.items():
            torch.testing.assert_close(opt_t[index][key], value, rtol=0, atol=0)


def test_captured_step_refuses_a_cpu_model():
    model, _ = _x3d()
    state = TrainState(model, construct_optimizer(model, OptimizerConfig()))
    with pytest.raises(ValueError, match="CUDA device"):
        CompiledTrainStep(make_train_step(), state)


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self, n):
        return iter(self.batches[:n])


def test_app_on_the_cpu_trains_eagerly():
    # The app's steps on device="cpu" are the eager step's: no graph is
    # captured, and three of its steps equal three eager steps by hand with
    # the same optimizer, schedule and clip.
    model, _ = _x3d()
    by_hand = copy.deepcopy(model)
    batches = _batches(3, seed=4)
    cfg = get_preset("classification_x3d_xs", **{
        "model.num_classes": CLASSES, "trainer.max_epochs": 1, "trainer.log_every_n_steps": 1,
        "mix.enabled": False, "trainer.precise_bn_batches": 0})
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=_Batches(batches),
                                      steps_per_epoch=3, device="cpu")
    history = app.train()
    assert app.state.step == 3 and len(history) == 3
    assert not app._captured_steps and not app._captured_evals
    state = TrainState(by_hand, construct_optimizer(by_hand, cfg.optim),
                       lr_schedule_from_config(cfg.lr_scheduler, 3))
    step = make_train_step(clip_grad_norm=cfg.trainer.clip_grad_norm)
    losses_by_hand = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses_by_hand.append(metrics["loss"].item())
    assert history == losses_by_hand
    for key, value in by_hand.state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0, msg=key)


# --- the trainer losses -----------------------------------------------------

def _embeddings(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("temperature", [0.07, 0.5])
def test_ntxent_loss_matches_jax(temperature, tmp_path):
    z1, z2 = _embeddings((6, 16), (6, 16))
    ours = ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), temperature)
    ref = jax_losses.ntxent_loss(jnp.asarray(z1), jnp.asarray(z2), temperature)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOSS_TOL)
    # Over a group of one rank the gathered negatives are this rank's own
    # (tests/test_torch_parallel.py holds four ranks against JAX's axis_name).
    with one_rank_group(str(tmp_path)) as group:
        grouped = ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), temperature, group=group)
    np.testing.assert_allclose(grouped.numpy(), ours.numpy(), rtol=1e-6)


def test_similarity_and_contrastive_losses_match_jax():
    q, k, keys = _embeddings((5, 12), (5, 12), (5, 9, 12), seed=1)
    np.testing.assert_allclose(similarity_loss(torch.from_numpy(q), torch.from_numpy(k)).numpy(),
                               np.asarray(jax_losses.similarity_loss(jnp.asarray(q),
                                                                     jnp.asarray(k))),
                               **LOSS_TOL)
    for temperature in (0.07, 0.2):
        ours = contrastive_loss(torch.from_numpy(q), torch.from_numpy(keys), temperature)
        ref = jax_losses.contrastive_loss(jnp.asarray(q), jnp.asarray(keys), temperature)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOSS_TOL)
    assert losses.soft_target_cross_entropy is not None


# --- the SSL backbone graft -------------------------------------------------

@pytest.mark.parametrize("feature_dim", [CLASSES, 16], ids=["feature_dim_eq_classes", "wider"])
def test_load_ssl_backbone_matches_the_jax_app(feature_dim):
    # The classification X3D and an SSL backbone of another seed whose head
    # projects to feature_dim: at CLASSES the head's proj has the
    # classifier's shape and must stay untouched all the same.
    model, variables = _x3d(seed=0)
    _, backbone = _x3d(seed=7, model_num_class=feature_dim)
    fake = types.SimpleNamespace(state=jax_create_train_state(variables, optax.sgd(0.1)))
    count = JaxTrainApp.load_ssl_backbone(fake, backbone)
    ref = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, fake.state.params),
                                      jax.tree_util.tree_map(np.asarray, fake.state.batch_stats))
    head_before = {k: v.clone() for k, v in model.state_dict().items()
                   if k.startswith("blocks.5.proj.")}
    cfg = get_preset("classification_x3d_xs", **{"model.num_classes": CLASSES})
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=_Batches([]), device="cpu")
    with pytest.raises(RuntimeError, match="setup"):
        app.load_ssl_backbone({})
    app.setup()
    grafted = app.load_ssl_backbone(
        jax_variables_to_state_dict(backbone["params"], backbone["batch_stats"]))
    assert grafted == count > 0
    ours = model.state_dict()
    assert set(head_before) == {"blocks.5.proj.weight", "blocks.5.proj.bias"}
    for key, value in ref.items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(ours[key], value, rtol=0, atol=0, msg=key)
    for key, value in head_before.items():
        torch.testing.assert_close(ours[key], value, rtol=0, atol=0, msg=key)
