"""pytorchvideo_tpu_torch's self-supervised modules against the JAX
package's, on the CPU at a small size, with the same seeded numpy weights
carried across by zoo/from_jax.py (``jax_ssl_state_to_state_dict``): the
MLP, BYOL's loss and momentum update, SimCLR's loss, the memory bank,
``KnnMemory``, the batch shuffle, the momentum annealing, LARS against the
optax chain, the SSL transforms and collators, and the config helpers.

Tolerances: rtol 5e-3 / atol 5e-4 in float32 (tests/test_models_parity.py:24)
for every module, update and transform; integer state (indices, pointers,
labels) exactly.
"""

import dataclasses
import json

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.mlp import MultilayerPerceptron as JaxMlp
from pytorchvideo_tpu.layers.norms import BatchNorm as JaxBatchNorm
from pytorchvideo_tpu.models.byol import BYOL as JaxBYOL
from pytorchvideo_tpu.models.memory_bank import MemoryBank as JaxMemoryBank
from pytorchvideo_tpu.models.simclr import SimCLR as JaxSimCLR
from pytorchvideo_tpu.train import config as jax_config
from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train import ssl as jax_ssl
from pytorchvideo_tpu.train import transforms as jax_transforms
from pytorchvideo_tpu_torch.layers import BatchNorm1d, MultilayerPerceptron
from pytorchvideo_tpu_torch.models import BYOL, MemoryBank, SimCLR
from pytorchvideo_tpu_torch.train import (
    LARS,
    ColorJitterVideoSSl,
    GaussianBlur,
    KnnMemory,
    OptimizerConfig,
    RandomErasing,
    RepeatandConverttoList,
    VideoClassificationTrainConfig,
    batch_shuffle,
    batch_unshuffle,
    build_collator_from_name,
    config_from_dict,
    config_to_dict,
    construct_optimizer,
    get_preset,
    momentum_anneal_cosine,
    multiple_samples_collate,
    save_config,
)
from pytorchvideo_tpu_torch.train import transforms as port_transforms
from pytorchvideo_tpu_torch.zoo.from_jax import jax_ssl_state_to_state_dict
from torch_parallel_worker import one_rank_group
from torch_port_helpers import TOL, random_variables

B, D, F = 4, 10, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small ops (a thread pool in each
    of the suite's parallel workers oversubscribes the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxBnEncoder(nn.Module):
    """Dense -> the JAX package's BatchNorm -> ReLU (tests/test_ssl_app.py's
    ``_BnEncoder``, its norm under the package's wrapper)."""

    dim: int = F

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Dense(self.dim, name="fc")(x)
        x = JaxBatchNorm(name="norm")(x, train=train)
        return nn.relu(x)


class JaxDenseEncoder(nn.Module):
    dim: int = F

    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.relu(nn.Dense(self.dim, name="fc")(x))


class BnEncoder(torch.nn.Module):
    def __init__(self, d_in: int = D, dim: int = F, norm: bool = True):
        super().__init__()
        self.fc = torch.nn.Linear(d_in, dim, device="cpu")
        self.norm = BatchNorm1d(dim) if norm else None

    def forward(self, x):
        x = self.fc(x)
        if self.norm is not None:
            x = self.norm(x)
        return torch.relu(x)


def _x(seed, b=B, d=D):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _variables(module, *inputs, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    return random_variables(shapes, seed)


def _strip(state_dict, prefix):
    return {k[len(prefix) + 1:]: v for k, v in state_dict.items() if k.startswith(prefix + ".")}


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               **(tol or TOL))


# --- the MLP ----------------------------------------------------------------

@pytest.mark.parametrize("norm", [False, True], ids=["no_norm", "batchnorm"])
def test_multilayer_perceptron_matches_jax(norm):
    dims = [D, 12, 9, 6]
    jax_mlp = JaxMlp(fully_connected_dims=dims, norm=JaxBatchNorm if norm else None)
    x = _x(0)
    variables = _variables(jax_mlp, jnp.asarray(x), False, seed=1)
    mlp = MultilayerPerceptron(dims, norm=BatchNorm1d if norm else None, device="cpu")
    state_dict = _strip(jax_ssl_state_to_state_dict({"mlp": variables}), "mlp")
    assert {k for k in state_dict if k.startswith("fc_")} == {
        f"fc_{i}.{p}" for i in range(3) for p in ("weight", "bias")}
    mlp.load_state_dict(state_dict, strict=True)
    for train in (False, True):
        mlp.train(train)
        out = mlp(torch.from_numpy(x))
        if train and norm:
            ref, mutated = jax_mlp.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
            for i in range(2):
                stats = mutated["batch_stats"][f"BatchNorm_{i}"]["bn"]
                _close(getattr(mlp, f"norm_{i}").running_mean, stats["mean"])
                _close(getattr(mlp, f"norm_{i}").running_var, stats["var"])
        else:
            ref = jax_mlp.apply(variables, jnp.asarray(x), train)
        _close(out.detach(), ref)


# --- BYOL, SimCLR, the memory bank ------------------------------------------

def _byol_pair(seed=0):
    jax_byol = JaxBYOL(JaxBnEncoder(), feature_dim=F, predictor_inner=8, mmt=0.9)
    x = jnp.asarray(_x(0))
    shapes = jax.eval_shape(lambda: jax_byol.init(jax.random.PRNGKey(0), x))
    state = {k: random_variables(v, seed + i) for i, (k, v) in enumerate(shapes.items())}
    byol = BYOL(BnEncoder(), feature_dim=F, predictor_inner=8, mmt=0.9, device="cpu")
    byol.load_state_dict(jax_ssl_state_to_state_dict(state), strict=True)
    return jax_byol, state, byol


def test_byol_loss_and_momentum_update_match_jax():
    jax_byol, state, byol = _byol_pair()
    x1, x2 = _x(1), _x(2)
    ref = jax_byol.loss(state, jnp.asarray(x1), jnp.asarray(x2), train=False)
    byol.eval()
    _close(byol.loss(torch.from_numpy(x1), torch.from_numpy(x2)).detach(), ref)
    # The momentum start off the online weights (another draw), so the EMA
    # moves every parameter and running stat.
    before = {k: v.clone() for k, v in byol.momentum.state_dict().items()}
    byol.momentum_update(0.7)
    moved = jax_ssl_state_to_state_dict(
        {"momentum": jax_byol.momentum_update(state, 0.7)["momentum"]})
    after = byol.momentum.state_dict()
    for name, ref in _strip(moved, "momentum").items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(after[name], before[name])
            continue
        assert not torch.equal(after[name], before[name]), name
        _close(after[name], ref)


def test_byol_refuses_a_projector():
    with pytest.raises(NotImplementedError):
        BYOL(BnEncoder(), projector=torch.nn.Identity(), device="cpu")


def test_simclr_loss_matches_jax_and_refuses_a_group(tmp_path):
    dims = [F, 12, 6]
    jax_simclr = JaxSimCLR(JaxMlp(fully_connected_dims=dims, final_activation=None),
                           backbone=JaxBnEncoder(), temperature=0.1)
    x1, x2 = _x(1), _x(2)
    shapes = jax.eval_shape(lambda: jax_simclr.init(jax.random.PRNGKey(0), jnp.asarray(x1)))
    state = {k: random_variables(v, i) for i, (k, v) in enumerate(shapes.items())}
    simclr = SimCLR(MultilayerPerceptron(dims, final_activation=None, device="cpu"),
                    backbone=BnEncoder(), temperature=0.1)
    simclr.load_state_dict(jax_ssl_state_to_state_dict(state), strict=True)
    ref = jax_simclr.loss(state, jnp.asarray(x1), jnp.asarray(x2), train=False)
    simclr.eval()
    _close(simclr.loss(torch.from_numpy(x1), torch.from_numpy(x2)).detach(), ref)
    # A process group is taken now (tests/test_torch_parallel.py holds four
    # ranks against the JAX axis_name branch): over one rank the negatives
    # are this rank's own.
    with one_rank_group(str(tmp_path)) as group:
        grouped = simclr.loss(torch.from_numpy(x1), torch.from_numpy(x2), group=group)
    _close(grouped.detach(), ref)


def test_memory_bank_loss_and_update_match_jax_at_the_jax_draw():
    jax_bank = JaxMemoryBank(JaxDenseEncoder(), neg_size=16, temperature=0.07, bank_size=100,
                             dim=F, mmt=0.5)
    x = _x(3)
    x_ind = np.array([3, 17, 42, 99])
    shapes = jax.eval_shape(lambda: jax_bank.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    state = {"backbone": random_variables(shapes["backbone"], 0),
             "memory": np.asarray(jax_bank.init_memory(jax.random.PRNGKey(5)))}
    bank = MemoryBank(BnEncoder(norm=False), neg_size=16, temperature=0.07, bank_size=100,
                      dim=F, mmt=0.5, device="cpu")
    bank.load_state_dict(jax_ssl_state_to_state_dict(state), strict=True)
    key = jax.random.PRNGKey(7)
    ref_loss, ref_memory = jax_bank.loss({**state, "memory": jnp.asarray(state["memory"])},
                                         jnp.asarray(x), jnp.asarray(x_ind), key, train=True)
    # The JAX loss's own draw, handed to the port.
    idx = np.asarray(jax.random.randint(key, (B, 17), 0, 100)).copy()
    idx[:, 0] = x_ind
    loss, memory = bank.loss_at(torch.from_numpy(x), torch.from_numpy(x_ind),
                                torch.from_numpy(idx))
    _close(loss.detach(), ref_loss)
    _close(memory, ref_memory)
    changed = np.flatnonzero(np.any(memory.numpy() != state["memory"], axis=1))
    assert changed.tolist() == sorted(x_ind.tolist())
    # The port's own draw: shape, range, the positive in slot 0.
    drawn = bank.draw_indices(torch.from_numpy(x_ind), torch.Generator().manual_seed(0))
    assert drawn.shape == (B, 17) and drawn.dtype == torch.long
    assert int(drawn.min()) >= 0 and int(drawn.max()) < 100
    assert torch.equal(drawn[:, 0], torch.from_numpy(x_ind))


def test_memory_bank_init_is_uniform_in_its_bound():
    bank = MemoryBank(BnEncoder(norm=False), bank_size=500, dim=12,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    stdv = 1.0 / np.sqrt(12 / 3)
    memory = bank.memory.numpy()
    assert memory.shape == (500, 12)
    assert memory.min() >= -stdv and memory.max() < stdv
    assert abs(memory.mean()) < 0.02 and abs(memory.std() - stdv / np.sqrt(3)) < 0.02


# --- the SSL helpers --------------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True], ids=["ring", "indexed"])
def test_knn_memory_update_and_predict_match_jax(indexed):
    knn = jax_ssl.KnnMemory(length=32, dim=8, knn_k=5, temperature=0.5, num_classes=4)
    port = KnnMemory(length=32, dim=8, knn_k=5, temperature=0.5, num_classes=4)
    rng = np.random.default_rng(0)
    features = rng.normal(size=(32, 8)).astype(np.float32) * 0.01
    ref = {"features": jnp.asarray(features), "labels": jnp.zeros(32, jnp.int32),
           "ptr": jnp.zeros((), jnp.int32)}
    ours = {"features": torch.from_numpy(features.copy()),
            "labels": torch.zeros(32, dtype=torch.int32), "ptr": torch.zeros((), dtype=torch.long)}
    for step in range(3):  # 3 x 20 rows: the ring wraps
        f = rng.normal(size=(20, 8)).astype(np.float32)
        y = rng.integers(0, 4, 20)
        idx = rng.choice(32, 20, replace=False) if indexed else None
        ref = knn.update(ref, jnp.asarray(f), jnp.asarray(y),
                         None if idx is None else jnp.asarray(idx))
        ours = port.update(ours, torch.from_numpy(f), torch.from_numpy(y),
                           None if idx is None else torch.from_numpy(idx))
        _close(ours["features"], ref["features"])
        assert np.array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
        if not indexed:
            assert int(ours["ptr"]) == int(ref["ptr"]) == (20 * (step + 1)) % 32
    q = rng.normal(size=(3, 8)).astype(np.float32)
    _close(port.knn_predict(ours, torch.from_numpy(q)), knn.knn_predict(ref, jnp.asarray(q)))


def test_batch_shuffle_and_unshuffle_follow_the_jax_permutation():
    x = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref_x, ref_inv = jax_ssl.batch_shuffle(key, jnp.asarray(x))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, 6)).astype(np.int64))
    shuffled, inverse = batch_shuffle(torch.from_numpy(x), perm=perm)
    assert np.array_equal(shuffled.numpy(), np.asarray(ref_x))
    assert np.array_equal(inverse.numpy(), np.asarray(ref_inv))
    assert np.array_equal(batch_unshuffle(shuffled, inverse).numpy(), x)
    # The port's own draw is a permutation.
    drawn, inverse = batch_shuffle(torch.from_numpy(x), torch.Generator().manual_seed(1))
    assert np.array_equal(batch_unshuffle(drawn, inverse).numpy(), x)
    assert sorted(map(tuple, drawn.numpy().tolist())) == sorted(map(tuple, x.tolist()))


def test_momentum_anneal_cosine_matches_jax():
    for base, epoch, total in [(0.996, 0.0, 10), (0.996, 3.5, 10), (0.99, 10, 10), (0.9, 1, 3)]:
        assert momentum_anneal_cosine(base, epoch, total) == pytest.approx(
            jax_ssl.momentum_anneal_cosine(base, epoch, total), rel=1e-12)


# --- LARS -------------------------------------------------------------------

class _LarsNet(torch.nn.Module):
    """fc1 (its bias zero: a zero-norm tensor of the "zero" group), a
    BatchNorm ("bn" group, no trust ratio), fc2 (its bias gets zero
    gradients: a zero-norm update)."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(6, 4)
        self.norm = BatchNorm1d(4)
        self.fc2 = torch.nn.Linear(4, 3)


def _lars_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"fc1": {"kernel": rng.normal(size=(6, 4)), "bias": np.zeros(4)},
              "norm": {"bn": {"scale": rng.uniform(0.5, 1.5, 4), "bias": rng.normal(size=4) * .1}},
              "fc2": {"kernel": rng.normal(size=(4, 3)), "bias": rng.normal(size=3) * 0.1}}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _to_port(tree):
    return {"fc1.weight": tree["fc1"]["kernel"].T, "fc1.bias": tree["fc1"]["bias"],
            "norm.weight": tree["norm"]["bn"]["scale"], "norm.bias": tree["norm"]["bn"]["bias"],
            "fc2.weight": tree["fc2"]["kernel"].T, "fc2.bias": tree["fc2"]["bias"]}


@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum", "nesterov"])
def test_lars_matches_the_optax_chain_over_five_updates(nesterov):
    cfg = dict(method="sgd", lr=0.5, momentum=0.9, weight_decay=1e-2, nesterov=nesterov,
               zero_weight_decay_1d_param=True, lars_on=True)
    params = _lars_trees(0)
    tx = jax_optimizer.construct_optimizer(params, jax_optimizer.OptimizerConfig(**cfg))
    opt_state = tx.init(params)
    net = _LarsNet()
    with torch.no_grad():
        for name, value in _to_port(params).items():
            net.get_parameter(name).copy_(torch.from_numpy(np.ascontiguousarray(value)))
    optimizer = construct_optimizer(net, OptimizerConfig(**cfg))
    assert isinstance(optimizer, LARS)
    assert {g["label"]: g["trust_ratio"] for g in optimizer.param_groups} == {
        "main": True, "zero": True, "bn": False}
    rng = np.random.default_rng(1)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        grads["fc2"]["bias"] = np.zeros(3, np.float32)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)
        for name, g in _to_port(grads).items():
            net.get_parameter(name).grad = torch.from_numpy(np.ascontiguousarray(g))
        optimizer.step()
    for name, ref in _to_port(params).items():
        _close(net.get_parameter(name).detach(), ref)
    # The zero-norm bias took a whole step (ratio 1); the bias with zero
    # updates stayed.
    assert not torch.equal(net.fc1.bias, start["fc1.bias"])
    assert torch.equal(net.fc2.bias, start["fc2.bias"])


def test_lars_scales_the_zero_group_as_the_jax_chain_does():
    # The JAX docstring says non-BN params "ignore_1d_param=True"; its chain
    # scales the 1-D "zero" group too, and so does the port.
    cfg = OptimizerConfig(method="sgd", lr=0.5, weight_decay=1e-2, lars_on=True,
                          zero_weight_decay_1d_param=True)
    net = _LarsNet()
    optimizer = construct_optimizer(net, cfg)
    zero = [g for g in optimizer.param_groups if g["label"] == "zero"]
    assert zero and zero[0]["trust_ratio"]
    assert {id(p) for p in zero[0]["params"]} == {id(net.fc1.bias), id(net.fc2.bias)}


def test_the_lars_presets_build_their_optimizers():
    for name in ("byol_train_app_conf", "simclr_train_app_conf"):
        optimizer = construct_optimizer(_LarsNet(), get_preset(name)["optimizer"])
        assert isinstance(optimizer, LARS)
        assert optimizer.param_groups[0]["lr"].item() == 4.8
    moco = construct_optimizer(_LarsNet(), get_preset("moco_v2_train_app_conf")["optimizer"])
    assert isinstance(moco, torch.optim.SGD)


# --- the SSL transforms and collators ---------------------------------------

def _clip(seed=0, t=3, h=9, w=11):
    """A THWC float clip in [0, 1] and its CTHW tensor."""
    clip = np.random.default_rng(seed).uniform(size=(t, h, w, 3)).astype(np.float32)
    return clip, torch.from_numpy(np.ascontiguousarray(np.moveaxis(clip, -1, 0)))


def _thwc(video):
    return np.moveaxis(video.numpy(), 0, -1)


class _Draws:
    """A stand-in numpy generator: ``uniform`` returns the queued values in
    turn, ``random`` returns 0 (every coin applies), ``shuffle`` keeps the
    order."""

    def __init__(self, *values):
        self.values = list(values)

    def uniform(self, low=0.0, high=1.0):
        return self.values.pop(0)

    def random(self):
        return 0.0

    def shuffle(self, x):
        pass


def test_gray_and_blur_match_jax():
    clip, video = _clip()
    _close(_thwc(port_transforms.rgb_to_gray(video)), jax_transforms._rgb_to_gray(clip))
    for sigma in (0.3, 1.0, 1.7):
        _close(_thwc(port_transforms.gaussian_blur(video, sigma)),
               jax_transforms._gaussian_blur_frames(clip, sigma))


@pytest.mark.parametrize("op, draws", [
    ("brightness", (1.3, 1.0, 1.0, 0.0)), ("contrast", (1.0, 0.6, 1.0, 0.0)),
    ("saturation", (1.0, 1.0, 1.4, 0.0)), ("hue", (1.0, 1.0, 1.0, 0.17))])
def test_each_jitter_op_at_a_fixed_factor_matches_jax(op, draws):
    clip, video = _clip(1)
    jax_jitter = jax_transforms.ColorJitterVideoSSl([0.4, 0.4, 0.4], 0.2, 1.0, 0.0)
    jax_jitter._rng = _Draws(*draws)
    ref = jax_jitter._jitter(clip)
    factor = {"brightness": draws[0], "contrast": draws[1], "saturation": draws[2],
              "hue": draws[3]}[op]
    _close(_thwc(getattr(port_transforms, f"adjust_{op}")(video, factor)), ref)
    port = ColorJitterVideoSSl([0.4, 0.4, 0.4], 0.2, 1.0, 0.0)
    port._rng = _Draws(*draws)
    _close(_thwc(port._jitter(video)), ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_ssl_jitter_and_blur_match_jax(seed):
    # The same seed gives the JAX package's numpy draws in its order: the
    # coins, the shuffled op order, the factors and sigma.
    clip, video = _clip(seed + 10)
    args = ([0.6, 0.6, 0.6], 0.15, 0.8, 0.3, 0.5, (0.1, 2.0))
    _close(_thwc(ColorJitterVideoSSl(*args, seed=seed)(video)),
           jax_transforms.ColorJitterVideoSSl(*args, seed=seed)(clip))
    _close(_thwc(GaussianBlur(seed=seed)(video)), jax_transforms.GaussianBlur(seed=seed)(clip))


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
@pytest.mark.parametrize("cube", [True, False], ids=["cube", "per_frame"])
def test_random_erasing_matches_jax_at_its_boxes(mode, cube):
    clip, video = _clip(2, t=3, h=16, w=20)
    kwargs = dict(probability=1.0, mode=mode, min_count=1, max_count=3, cube=cube, seed=4)
    ours = RandomErasing(**kwargs)(video)
    ref = jax_transforms.RandomErasing(**kwargs)(clip)
    _close(_thwc(ours), ref)
    assert not np.array_equal(ref, clip)
    # The boxes themselves, at one draw.
    assert RandomErasing(**kwargs).boxes(16, 20) == jax_transforms.RandomErasing(
        **kwargs)._boxes(16, 20)


def test_repeat_and_the_collators_match_jax():
    rng = np.random.default_rng(0)
    samples = [{"video": rng.normal(size=(3, 2, 4)).astype(np.float32), "label": i}
               for i in range(3)]
    ref_lists = [jax_transforms.RepeatandConverttoList(2)(dict(s)) for s in samples]
    ours_lists = [RepeatandConverttoList(2)(dict(s)) for s in samples]
    ref = jax_transforms.build_collator_from_name("multiple_samples_collate")(ref_lists)
    ours = build_collator_from_name("multiple_samples_collate")(ours_lists)
    assert build_collator_from_name("multiple_samples_collate") is multiple_samples_collate
    assert ours["video"].shape == ref["video"].shape == (6, 3, 2, 4)
    _close(ours["video"], ref["video"], rtol=0, atol=0)
    assert ours["label"].tolist() == ref["label"].tolist() == [0, 0, 1, 1, 2, 2]
    with pytest.raises(AssertionError):
        build_collator_from_name("default_collate")


# --- the config helpers -----------------------------------------------------

def test_config_round_trips_and_reads_the_jax_packages_dict(tmp_path):
    cfg = VideoClassificationTrainConfig()
    cfg.model.name, cfg.optim.lr, cfg.data.video_mean = "x3d_s", 0.3, (0.4, 0.5, 0.6)
    cfg.lr_scheduler.steps, cfg.trainer.remat_policy = [1, 5], "full"
    assert config_from_dict(config_to_dict(cfg)) == cfg
    save_config(cfg, str(tmp_path / "config.json"))
    with open(tmp_path / "config.json") as f:
        assert config_from_dict(json.load(f)) == cfg
    # A dict the JAX package wrote: every field the port has reads back.
    jcfg = jax_config.VideoClassificationTrainConfig()
    jcfg.model.name, jcfg.optim.lr, jcfg.data.video_mean = "x3d_s", 0.3, (0.4, 0.5, 0.6)
    jcfg.optim.lars_on, jcfg.mix.enabled, jcfg.lr_scheduler.lr_policy = True, True, "steps_with_relative_lrs"
    data = json.loads(json.dumps(jax_config.config_to_dict(jcfg), default=str))
    ours = config_from_dict(data)
    assert (ours.model.name, ours.optim.lr, ours.data.video_mean) == ("x3d_s", 0.3, (0.4, 0.5, 0.6))
    assert ours.optim.lars_on and ours.mix.enabled
    for section in dataclasses.fields(ours):
        for f in dataclasses.fields(getattr(ours, section.name)):
            if f.name in data[section.name]:
                value = data[section.name][f.name]
                ours_value = getattr(getattr(ours, section.name), f.name)
                assert (list(ours_value) if isinstance(ours_value, tuple) else ours_value) == \
                    value, (section.name, f.name)
