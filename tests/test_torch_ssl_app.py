"""pytorchvideo_tpu_torch's SSL train steps and ``SSLTrainApp`` against the
JAX package's (pytorchvideo_tpu/train/ssl_app.py), on the CPU at a small
size: three steps of BYOL, SimCLR and MoCo v2 from the same seeded numpy
weights (carried across by zoo/from_jax.py ``jax_ssl_state_to_state_dict``)
on the same views, on a Dense + BatchNorm encoder (tests/test_ssl_app.py's
``_BnEncoder``) and on a narrow Slow R50 (one block a stage, 4x32x32
clips); then the app end to end over small videos for each task, its
backbone grafted into the classification app, and the JAX app's faults
that the port follows.

Tolerances: the steps run in float64 on both sides (the port's modules in
f64, the JAX package's under ``jax.enable_x64``), where the small models'
f32 batch statistics are ill conditioned (tests/test_torch_train_bn.py):
each step's loss and, after three steps, every parameter, running stat,
momentum tensor and queue row at rtol 5e-3 / atol 5e-4; the queue pointer
exactly.
"""

import dataclasses
import functools

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.mlp import MultilayerPerceptron as JaxMlp
from pytorchvideo_tpu.layers.norms import BatchNorm as JaxBatchNorm
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu.models.byol import BYOL as JaxBYOL
from pytorchvideo_tpu.models.simclr import SimCLR as JaxSimCLR
from pytorchvideo_tpu.train import SSLConfig as JaxSSLConfig
from pytorchvideo_tpu.train import SSLTrainApp as JaxSSLTrainApp
from pytorchvideo_tpu.train import make_byol_train_step as jax_byol_step
from pytorchvideo_tpu.train import make_moco_train_step as jax_moco_step
from pytorchvideo_tpu.train import make_simclr_train_step as jax_simclr_step
from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train import presets as jax_presets
from pytorchvideo_tpu.train import ssl_app as jax_ssl_app
from pytorchvideo_tpu.train.ssl import MoCoV2 as JaxMoCoV2
from pytorchvideo_tpu_torch.data.utils import export_video_array
from pytorchvideo_tpu_torch.layers import BatchNorm1d, MultilayerPerceptron
from pytorchvideo_tpu_torch.models import BYOL, SimCLR, hub
from pytorchvideo_tpu_torch.train import (
    DataConfig,
    ModelConfig,
    MoCoV2,
    OptimizerConfig,
    SSLConfig,
    SSLTrainApp,
    TwoViewTransform,
    VideoClassificationTrainApp,
    VideoClassificationTrainConfig,
    construct_optimizer,
    get_preset,
    make_byol_train_step,
    make_moco_train_step,
    make_simclr_train_step,
    ssl_train_state,
)
from pytorchvideo_tpu_torch.zoo.from_jax import jax_ssl_state_to_state_dict
from torch_port_helpers import TOL, random_variables

B, D, F = 4, 10, 16
MMTS = (0.9, 0.95, 0.99)
SLOW = dict(stem_dim_out=8, stage_depths=(1, 1, 1, 1), model_num_class=F, dropout_rate=0.0,
            head_pool_kernel_size=(4, 1, 1))
CLIP = (3, 4, 32, 32)
# SGD as MoCo's recipe; LARS as BYOL's and SimCLR's (zero-wd 1-D params).
SGD = dict(method="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4)
LARS = dict(method="sgd", lr=0.3, momentum=0.9, weight_decay=1e-3, lars_on=True,
            zero_weight_decay_1d_param=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (a pool in each of the suite's parallel workers
    oversubscribes the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxBnEncoder(nn.Module):
    """Dense (no bias: a bias before a train-mode BatchNorm gets a zero
    gradient up to rounding, which LARS's trust ratio scales up to a whole
    step in a direction the rounding picks) -> BatchNorm -> ReLU."""

    dim: int = F

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Dense(self.dim, use_bias=False, name="fc")(x)
        return nn.relu(JaxBatchNorm(name="norm")(x, train=train))


class BnEncoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(D, F, bias=False)
        self.norm = BatchNorm1d(F)

    def forward(self, x):
        return torch.relu(self.norm(self.fc(x)))


# encoder -> (JAX backbone, port backbone, one view's port shape)
ENCODERS = {
    "dense_bn": (JaxBnEncoder, BnEncoder, (D,)),
    "slow_r50": (lambda: jax_hub.slow_r50(**SLOW), lambda: hub.slow_r50(**SLOW, device="cpu"),
                 CLIP),
}


def _views(shape, step, batch=B):
    """Two seeded views (port layout, float64)."""
    rng = np.random.default_rng(100 + step)
    return [rng.normal(size=(batch, *shape)) for _ in range(2)]


def _jax_view(x):
    return jnp.asarray(np.moveaxis(x, 1, -1) if x.ndim == 5 else x)


def _jax_task(task, encoder):
    backbone = ENCODERS[encoder][0]()
    if task == "byol":
        # On Slow R50, SGD: the head's bias feeds the predictor's fc1 and
        # BatchNorm, so its gradient is zero up to rounding, and LARS's trust
        # ratio (on the 1-D "zero" group, as the JAX chain scales it) makes
        # that a whole step in a direction the rounding picks, in either
        # package (ROADMAP faults).
        opt = SGD if encoder == "slow_r50" else LARS
        return JaxBYOL(backbone, feature_dim=F, predictor_inner=8, mmt=0.9), jax_byol_step, opt
    if task == "simclr":
        mlp = JaxMlp(fully_connected_dims=[F, 12, 8], final_activation=None)
        return JaxSimCLR(mlp, backbone=backbone, temperature=0.2), jax_simclr_step, LARS
    return (JaxMoCoV2(backbone, queue_size=2 * B, dim=F, temperature=0.2, mmt=0.9),
            jax_moco_step, SGD)


def _port_task(task, encoder):
    backbone = ENCODERS[encoder][1]()
    if task == "byol":
        return BYOL(backbone, feature_dim=F, predictor_inner=8, mmt=0.9, device="cpu"), \
            make_byol_train_step()
    if task == "simclr":
        mlp = MultilayerPerceptron([F, 12, 8], final_activation=None, device="cpu")
        return SimCLR(mlp, backbone=backbone, temperature=0.2), make_simclr_train_step()
    return (MoCoV2(backbone, queue_size=2 * B, dim=F, temperature=0.2, mmt=0.9, device="cpu"),
            make_moco_train_step())


def _initial_state(jax_task, task, shape):
    """Seeded numpy variables for the JAX task's state: BYOL's and MoCo's
    momentum a copy of the online weights; MoCo's queue normalised normal
    draws, its pointer 0."""
    x = _jax_view(np.zeros((1, *shape)))
    shapes = jax.eval_shape(lambda: jax_task.init(jax.random.PRNGKey(0), x))
    state = {}
    for i, (key, value) in enumerate(shapes.items()):
        if key == "queue":
            q = np.random.default_rng(7).normal(size=value.shape)
            state[key] = q / np.sqrt((q * q).sum(-1, keepdims=True))
        elif key == "queue_ptr":
            state[key] = np.zeros((), np.int32)
        elif key != "momentum":
            state[key] = random_variables(value, i)
    if "momentum" in shapes:
        state["momentum"] = jax.tree_util.tree_map(np.copy, state["online"])
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, state)


def _trainable(task, state):
    if task == "byol":
        return {"online": state["online"]["params"], "predictor": state["predictor"]["params"]}
    if task == "simclr":
        return {k: v["params"] for k, v in state.items()}
    return state["online"]["params"]


@functools.lru_cache(maxsize=None)
def _jax_run(task, encoder):
    """Three JAX steps: (losses, the final state as port tensors)."""
    shape = ENCODERS[encoder][2]
    with jax.enable_x64(True):
        jax_task, make_step, opt = _jax_task(task, encoder)
        state = _initial_state(jax_task, task, shape)
        state = jax.tree_util.tree_map(jnp.asarray, state)
        trainable = _trainable(task, state)
        tx = jax_optimizer.construct_optimizer(trainable, jax_optimizer.OptimizerConfig(**opt))
        opt_state = tx.init(trainable)
        step = jax.jit(make_step(jax_task, tx))
        losses = []
        for i, mmt in enumerate(MMTS):
            x1, x2 = (_jax_view(x) for x in _views(shape, i))
            args = (jax.random.PRNGKey(i),) if task == "simclr" else (jax.random.PRNGKey(i), mmt)
            state, opt_state, loss = step(state, opt_state, x1, x2, *args)
            losses.append(float(loss))
        final = jax.tree_util.tree_map(np.asarray, state)
    return losses, jax_ssl_state_to_state_dict(final)


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("task", ["byol", "simclr", "moco_v2"])
def test_three_ssl_steps_match_jax(task, encoder):
    shape = ENCODERS[encoder][2]
    ref_losses, ref_state = _jax_run(task, encoder)
    with jax.enable_x64(True):
        jax_task, _, opt = _jax_task(task, encoder)
        initial = _initial_state(jax_task, task, shape)
    model, step = _port_task(task, encoder)
    model.load_state_dict(jax_ssl_state_to_state_dict(initial), strict=True)
    model.double()
    state = ssl_train_state(model, construct_optimizer(model, OptimizerConfig(**opt)),
                            None if task == "simclr" else model.mmt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    for i, mmt in enumerate(MMTS):
        x1, x2 = (torch.from_numpy(x) for x in _views(shape, i))
        scalars = {} if task == "simclr" else {"mmt": mmt}
        state, metrics = step(state, {"video": torch.stack([x1, x2], 1)}, **scalars)
        losses.append(metrics["loss"].item())
    assert state.step == 3
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    ours = model.state_dict()
    assert set(ours) == set(ref_state)
    for name, ref in ref_state.items():
        got = ours[name]
        if name.endswith("num_batches_tracked"):
            continue
        if name == "queue_ptr":
            assert int(got) == int(ref) == (3 * B) % (2 * B)
            continue
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=name, **TOL)
        # Everything the step updates moved: parameters, running stats, the
        # momentum and the queue (each row written at least once).
        if not name.startswith("momentum.") or task != "simclr":
            assert not torch.equal(got, before[name]), name


def test_moco_step_keys_enter_the_queue_normalised():
    model, step = _port_task("moco_v2", "dense_bn")
    state = ssl_train_state(model, construct_optimizer(model, OptimizerConfig(**SGD)), 0.9)
    x1, x2 = (torch.from_numpy(x).float() for x in _views((D,), 0))
    with torch.no_grad():
        model.eval()
        keys = model.momentum(x2)
    state, _ = step(state, {"video": torch.stack([x1, x2], 1)}, mmt=0.9)
    assert int(model.queue_ptr) == B
    expected = keys / keys.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(model.queue[:B], expected, rtol=1e-5, atol=1e-6)


def test_an_ssl_batch_must_hold_two_views():
    model, step = _port_task("simclr", "dense_bn")
    state = ssl_train_state(model, construct_optimizer(model, OptimizerConfig(**SGD)))
    with pytest.raises(ValueError, match="two views"):
        step(state, {"video": torch.zeros(B, 3, D)})


# --- the app ----------------------------------------------------------------

TINY_X3D = dict(width_factor=1.0, depth_factor=0.5, head_dim_out=32)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Four 2-second videos of 36x44 frames in two class directories."""
    root = tmp_path_factory.mktemp("ssl_clips")
    for i in range(4):
        cls = root / f"class_{i % 2}"
        cls.mkdir(exist_ok=True)
        frames = np.random.default_rng(i).integers(0, 256, size=(16, 36, 44, 3))
        export_video_array(torch.from_numpy(frames.astype(np.uint8)), str(cls / f"v{i}.avi"), 8)
    return str(root)


def _ssl_config(task, video_dir):
    cfg = SSLConfig(task=task)
    cfg.model = ModelConfig(name="x3d_xs", num_classes=2, kwargs=dict(TINY_X3D), clip_length=4,
                            crop_size=32)
    cfg.data = DataConfig(data_path=video_dir, clip_duration=1.0, batch_size=2, num_samples=4,
                          min_size=36, max_size=44, crop_size=32)
    cfg.optim.lr = 0.01
    cfg.feature_dim, cfg.predictor_inner, cfg.queue_size, cfg.max_epochs = 8, 8, 16, 1
    return cfg


@pytest.mark.parametrize("task", ["byol", "simclr", "moco_v2"])
def test_ssl_app_end_to_end_and_its_backbone_grafts(task, video_dir):
    cfg = _ssl_config(task, video_dir)
    app = SSLTrainApp(cfg, steps_per_epoch=2, device="cpu", seed=1)
    app.setup()
    before = {k: v.clone() for k, v in app.backbone_variables().items()}
    history = app.train()
    assert len(history) == 2 and all(np.isfinite(history)) and app.state.step == 2
    variables = app.backbone_variables()
    assert any(not torch.equal(variables[k], before[k]) for k in before)
    if task == "moco_v2":
        assert int(app.state.model.queue_ptr) == 4
    classifier = VideoClassificationTrainApp(
        VideoClassificationTrainConfig(model=dataclasses.replace(cfg.model, kwargs=dict(TINY_X3D))),
        datamodule=object(), device="cpu")
    classifier.setup()
    grafted = classifier.load_ssl_backbone(variables)
    ours = classifier.state.model.state_dict()
    expected = [k for k in variables if not k.endswith("num_batches_tracked")
                and not k.startswith("blocks.5.proj.")]
    assert grafted == len(expected) > 0
    assert all(torch.equal(ours[k], variables[k]) for k in expected)


def test_two_view_datamodule_batches(video_dir):
    app = SSLTrainApp(_ssl_config("simclr", video_dir), device="cpu", seed=2)
    batch = next(iter(app._datamodule().train_dataloader(1)))
    assert tuple(batch["video"].shape) == (2, 2, 3, 4, 32, 32)
    assert not torch.equal(batch["video"][:, 0], batch["video"][:, 1])
    views = TwoViewTransform(lambda v: v * 2)(torch.ones(3, 2))
    assert tuple(views.shape) == (2, 3, 2) and torch.equal(views, torch.full((2, 3, 2), 2.0))


def test_the_app_anneals_the_momentum_as_jax():
    cfg = SSLConfig(task="byol", mmt=0.99, max_epochs=3)
    app = SSLTrainApp(cfg, steps_per_epoch=4, device="cpu")
    for epoch, step_idx in [(0, 0), (0, 3), (1, 4), (2, 10)]:
        # The JAX app's exact epoch counts step_idx over the whole run.
        exact = epoch + step_idx / 4
        assert app._momentum(step_idx, epoch) == pytest.approx(
            jax_ssl_app.momentum_anneal_cosine(0.99, exact, 3), rel=1e-12)
    assert SSLTrainApp(SSLConfig(task="simclr"), device="cpu")._momentum(0, 0) is None
    cfg.anneal_momentum = False
    assert app._momentum(3, 1) == 0.99


# --- the JAX app's faults, which the port follows ---------------------------

def test_an_mvit_backbone_raises_type_error_in_both_apps():
    for app in (JaxSSLTrainApp(JaxSSLConfig()), SSLTrainApp(SSLConfig(), device="cpu")):
        app.cfg.model.name = "mvit_base_16x4"
        with pytest.raises(TypeError, match="model_num_class"):
            app._build_backbone()


def test_the_ssl_presets_keys_are_not_ssl_config_fields_in_both_packages():
    for get, config in ((jax_presets.get_preset, JaxSSLConfig), (get_preset, SSLConfig)):
        fields = {f.name for f in dataclasses.fields(config)}
        for name in ("byol_train_app_conf", "simclr_train_app_conf", "moco_v2_train_app_conf"):
            assert set(get(name)) - fields, name
    assert set(get_preset("moco_v2_train_app_conf")) - {f.name for f in dataclasses.fields(
        SSLConfig)} == {"backbone", "dim", "k", "momentum", "batch_shuffle", "optimizer"}


def test_the_key_encoder_in_eval_mode_makes_the_shuffle_moot():
    # MoCo's key encoder runs BN in eval mode, so the keys are the same
    # under any permutation (in the JAX step too: ssl_app.py:180-181).
    model, _ = _port_task("moco_v2", "dense_bn")
    model.train()
    x1, x2 = (torch.from_numpy(x).float() for x in _views((D,), 1))
    keys, perms = [], []
    for seed in (0, 1):
        model.generator.manual_seed(seed)
        perms.append(torch.argsort(torch.rand(B, generator=model.generator)))
        model.generator.manual_seed(seed)
        keys.append(model.loss(x1, x2)[1])
    assert not torch.equal(perms[0], perms[1])
    torch.testing.assert_close(keys[0], keys[1], rtol=0, atol=1e-7)
    assert not model.momentum.training and not model.momentum.norm.training


def test_the_datamodule_runs_the_base_chain_three_times_a_sample_in_both_apps(monkeypatch):
    calls = []

    def base(sample):
        calls.append(1)
        return {**sample, "video": torch.full((3, 1, 2, 2), float(len(calls)))}

    from pytorchvideo_tpu.train import datamodule as jax_datamodule
    from pytorchvideo_tpu_torch.train import datamodule as port_datamodule

    monkeypatch.setattr(jax_datamodule.VideoClassificationDataModule, "_transform",
                        lambda self, mode: base)
    monkeypatch.setattr(port_datamodule.VideoClassificationDataModule, "_transform",
                        lambda self, mode, seed: base)
    out = JaxSSLTrainApp(JaxSSLConfig())._datamodule()._transform("train")({"label": 0})
    assert len(calls) == 3 and np.asarray(out["video"])[:, 0, 0, 0, 0].tolist() == [2.0, 3.0]
    calls.clear()
    out = SSLTrainApp(SSLConfig(), device="cpu")._datamodule()._transform("train", None)(
        {"label": 0})
    assert len(calls) == 3 and out["video"][:, 0, 0, 0, 0].tolist() == [2.0, 3.0]
