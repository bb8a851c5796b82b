"""pytorchvideo_tpu_torch's training against the JAX package's, on a small
MViT (3 blocks, widths 32-64, 4x32x32 clips, dropout and DropPath 0) with
the same seeded weights: the loss and every parameter's gradient, the
optimizer's groups and updates, the LR schedule, the clip, gradient
accumulation, the soft-target loss, MixUp/CutMix, DropPath, the checkpoint
round trip and the app's defaults. Tolerances: f32 rtol 5e-3 / atol 5e-4 for
a model's loss and gradients (tests/test_models_parity.py:24); rtol 1e-5
where the same numbers go through one optimizer update."""

import inspect
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.losses import soft_target_cross_entropy as jax_soft_target_cross_entropy
from pytorchvideo_tpu.train import optimizer as jax_optimizer
from pytorchvideo_tpu.train import presets as jax_presets
from pytorchvideo_tpu.train.train_loop import create_train_state as jax_create_train_state
from pytorchvideo_tpu.train.train_loop import make_train_step as jax_make_train_step
from pytorchvideo_tpu.transforms import mix as jax_mix
from pytorchvideo_tpu_torch.layers.attention import MultiScaleBlock
from pytorchvideo_tpu_torch.layers.stochastic import DropPath, drop_path, drop_path_pair
from pytorchvideo_tpu_torch.losses import soft_target_cross_entropy
from pytorchvideo_tpu_torch.train import (
    OptimizerConfig,
    VideoClassificationDataModule,
    VideoClassificationTrainApp,
    construct_optimizer,
    forward_backward,
    get_preset,
    lr_schedule_from_config,
    make_eval_step,
    make_train_step,
    param_labels,
)
from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig
from pytorchvideo_tpu_torch.train.train_loop import TrainState, clip_by_global_norm_
from pytorchvideo_tpu_torch.transforms import mix
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, small_mvit_pair

REPO = Path(__file__).resolve().parents[1]
# One optimizer update of the same f32 numbers.
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
NO_DROPOUT = dict(head_dropout_rate=0.0, dropout_rate_block=0.0, droppath_rate_block=0.0)


def _nhwc(x_ncthw):
    return jnp.asarray(np.moveaxis(np.asarray(x_ncthw), 1, -1))


def _labels(batch, seed=3):
    return np.random.default_rng(seed).integers(0, 7, size=batch)


def _to_port(tree):
    """A JAX params-shaped tree (numpy leaves) -> {port name: tensor}."""
    return jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), {})


def _jax_loss_and_grads(jax_model, params, x, labels):
    def loss_of(p):
        logits = jax_model.apply({"params": p}, _nhwc(x), True)
        return jax_soft_target_cross_entropy(logits, jnp.asarray(labels))

    return jax.value_and_grad(loss_of)(params)


@pytest.mark.parametrize(
    "variant", [{}, {"residual_pool": True}, {"pool_first": True}],
    ids=["packed", "residual_pool", "pool_first"],
)
def test_loss_and_every_grad_match_jax(variant, monkeypatch):
    # The JAX pools take their Pallas kernels in interpret mode, backward
    # included (_token_pool_ad); its attention takes the XLA path on the CPU.
    monkeypatch.setenv("PVT_TOKEN_POOL", "interpret")
    jax_model, variables, model, x = small_mvit_pair(**NO_DROPOUT, **variant)
    labels = _labels(len(x))
    loss, _ = forward_backward(model.train(), torch.from_numpy(x), torch.from_numpy(labels))
    ref_loss, ref_grads = _jax_loss_and_grads(jax_model, variables["params"], x, labels)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **TOL)
    ref = _to_port(ref_grads)
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    for name, p in params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), err_msg=name, **TOL)


def test_bf16_compute_keeps_f32_masters():
    # compute_dtype=bfloat16: the forward runs in bf16 on cast copies, the
    # loss in f32, and the gradients land on the f32 masters, near the f32
    # step's (bf16 rounds every activation to 8 bits of mantissa).
    _, _, model, x = small_mvit_pair(**NO_DROPOUT)
    labels = torch.from_numpy(_labels(len(x)))
    ref_loss, _ = forward_backward(model.train(), torch.from_numpy(x), labels)
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    loss, logits = forward_backward(model, torch.from_numpy(x), labels,
                                    compute_dtype=torch.bfloat16)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert abs(loss.item() - ref_loss.item()) < 3e-2 * abs(ref_loss.item())
    # Per tensor within 10% of its own largest gradient, plus 1% of the
    # model's: a shift of the keys (norm_k's bias) has a zero gradient in
    # exact arithmetic, which bf16 rounding noise of the model's scale meets.
    overall = max(g.abs().max().item() for g in ref.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        scale = ref[name].abs().max().item()
        assert (p.grad - ref[name]).abs().max().item() <= 0.1 * scale + 0.01 * overall, name


def test_optimizer_groups_equal_jax_param_labels():
    _, variables, model, _ = small_mvit_pair()
    ids = {"main": 0, "zero": 1, "bn": 2}
    for zero_wd_1d in (True, False):
        jax_labels = jax_optimizer._param_labels(variables["params"], zero_wd_1d)
        coded = jax.tree_util.tree_map(lambda lab, leaf: np.full(leaf.shape, ids[lab], np.float32),
                                       jax_labels, variables["params"])
        ref = {name: int(t.flatten()[0]) for name, t in _to_port(coded).items()}
        ours = param_labels(model, zero_wd_1d)
        assert {name: ids[lab] for name, lab in ours.items()} == ref
    assert ours["cls_positional_encoding.cls_token"] == "main"
    assert param_labels(model, True)["blocks.0.norm1.bias"] == "bn"
    assert param_labels(model, True)["head.proj.bias"] == "zero"
    opt = construct_optimizer(model, get_preset("classification_mvit_16x4").optim)
    assert [(g["label"], g["weight_decay"]) for g in opt.param_groups] == [
        ("main", 0.05), ("zero", 0.0), ("bn", 0.0)]


def _numpy_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)


def _updates_match_jax(cfg, schedule_cfg, steps):
    """``steps`` optimizer updates, each fed the same numpy grads, in both
    packages; the parameters after them must agree."""
    _, variables, model, _ = small_mvit_pair()
    params = variables["params"]
    jax_schedule = jax_optimizer.lr_schedule_from_config(schedule_cfg, 1)
    tx = jax_optimizer.construct_optimizer(params, cfg, jax_schedule)
    opt_state = tx.init(params)
    schedule = lr_schedule_from_config(LRSchedulerConfig(**vars(schedule_cfg)), 1)
    optimizer = construct_optimizer(model, OptimizerConfig(**vars(cfg)))
    named = dict(model.named_parameters())
    for step in range(steps):
        grads = _numpy_grads(params, seed=step)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in _to_port(grads).items():
            named[name].grad = g
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()
    ref = _to_port(params)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name,
                                   **UPDATE_TOL)


def test_one_adamw_update_matches_jax():
    # The MViT recipe's optimizer at a constant LR large enough to show.
    cfg = jax_presets.classification_mvit_16x4().optim
    sched = jax_presets.classification_mvit_16x4().lr_scheduler
    sched.lr, sched.warmup_iters, sched.cosine_end_lr = 0.1, 0, 0.0
    _updates_match_jax(cfg, sched, steps=1)


def test_three_sgd_nesterov_updates_match_jax():
    # Nesterov momentum with zero-wd 1-D params, at an LR that changes every
    # step (warmup then cosine), indexed from 0 in both.
    cfg = jax_optimizer.OptimizerConfig(method="sgd", lr=0.5, momentum=0.9, weight_decay=1e-2,
                                        nesterov=True, zero_weight_decay_1d_param=True)
    sched = jax_presets.classification_x3d_xs().lr_scheduler
    sched.lr, sched.max_iters, sched.warmup_iters, sched.warmup_start_lr = 0.5, 6, 2, 0.05
    _updates_match_jax(cfg, sched, steps=3)


def test_lr_schedule_matches_jax():
    for preset in ("classification_mvit_16x4", "classification_x3d_xs"):
        ref = jax_optimizer.lr_schedule_from_config(getattr(jax_presets, preset)().lr_scheduler, 7)
        ours = lr_schedule_from_config(get_preset(preset).lr_scheduler, 7)
        steps = np.arange(0, 7 * 310, 13)
        # The JAX schedule is evaluated in float32.
        np.testing.assert_allclose([ours(int(s)) for s in steps],
                                   np.asarray(jax.vmap(ref)(jnp.asarray(steps))), rtol=1e-5,
                                   atol=1e-7)


def test_clip_by_global_norm():
    grads = [torch.randn(5, 3), torch.randn(7), torch.randn(2, 2, 2)]
    norm = np.sqrt(sum(float((g**2).sum()) for g in grads))
    ref = [g * min(1.0, 0.5 / (norm + 1e-6)) for g in grads]
    assert abs(clip_by_global_norm_(grads, 0.5).item() - norm) < 1e-5 * norm
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b)
    small = [torch.full((3,), 1e-3)]
    clip_by_global_norm_(small, 0.5)
    torch.testing.assert_close(small[0], torch.full((3,), 1e-3))


def test_train_step_with_clip_matches_jax(monkeypatch):
    # One whole step (soft-target loss on hard labels, clip 0.5, nesterov SGD
    # at LR 1 so that the update is gradient-sized) in both packages.
    monkeypatch.setenv("PVT_TOKEN_POOL", "interpret")
    jax_model, variables, model, x = small_mvit_pair(**NO_DROPOUT)
    labels = _labels(len(x))
    cfg = jax_optimizer.OptimizerConfig(method="sgd", lr=1.0, nesterov=True, weight_decay=1e-3,
                                        zero_weight_decay_1d_param=True)
    tx = jax_optimizer.construct_optimizer(variables["params"], cfg)
    state = jax_create_train_state({"params": variables["params"]}, tx)
    state, jax_metrics = jax_make_train_step(jax_model, tx, clip_grad_norm=0.5)(
        state, {"video": _nhwc(x), "label": jnp.asarray(labels)}, jax.random.PRNGKey(0))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ts = TrainState(model, construct_optimizer(model, OptimizerConfig(**vars(cfg))))
    ts, metrics = make_train_step(clip_grad_norm=0.5)(
        ts, {"video": torch.from_numpy(x), "label": torch.from_numpy(labels)})
    assert ts.step == 1
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jax_metrics["loss"]), **TOL)
    np.testing.assert_allclose(metrics["accuracy"].numpy(), np.asarray(jax_metrics["accuracy"]))
    ref = _to_port(state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[name]).numpy(),
                                   ref[name].numpy() - before[name].numpy(), err_msg=name, **TOL)


def test_grad_accumulation_equals_the_full_batch():
    # Two microbatches of 2 give the gradient of the batch of 4, and one update.
    results = []
    for accum in (1, 2):
        _, _, model, x = small_mvit_pair(batch=4, **NO_DROPOUT)
        ts = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
        ts, metrics = make_train_step(grad_accum_steps=accum, clip_grad_norm=1.0)(
            ts, {"video": torch.from_numpy(x), "label": torch.from_numpy(_labels(4))})
        results.append((metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                        {n: p.detach().clone() for n, p in model.named_parameters()}))
    (m1, g1, p1), (m2, g2, p2) = results
    torch.testing.assert_close(m1["loss"], m2["loss"], **UPDATE_TOL)
    torch.testing.assert_close(m1["accuracy"], m2["accuracy"])
    for name in g1:
        torch.testing.assert_close(g1[name], g2[name], **UPDATE_TOL)
        torch.testing.assert_close(p1[name], p2[name], **UPDATE_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(grad_accum_steps=3)(ts, {"video": torch.from_numpy(x),
                                                 "label": torch.from_numpy(_labels(4))})


@pytest.mark.parametrize("ignore_index, normalize", [(-100, True), (2, True), (-100, False)])
def test_soft_target_cross_entropy_matches_jax(ignore_index, normalize):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    target = rng.uniform(size=(6, 5)).astype(np.float32)
    target[1, 2] = 0.0
    for t in (target, rng.integers(0, 5, size=6)):
        ours = soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t),
                                         ignore_index, "mean", normalize)
        ref = jax_soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(t), ignore_index,
                                            "mean", normalize)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# Each case: the function or class called, MixVideo's cutmix_prob, and the
# audio's (C, T, H, W) a sample (None: no audio). (1, 16, 1, 10) is
# audio-visual SlowFast's (1, T, 1, F) spectrogram, made small; (1, 2, 12, 10)
# gives CutMix a box that is not empty on the audio.
MIX_CASES = {
    "mixup": ("mixup", None, None),
    "cutmix": ("cutmix", None, None),
    "mixup-audio": ("mixup", None, (1, 16, 1, 10)),
    "cutmix-audio": ("cutmix", None, (1, 16, 1, 10)),
    "cutmix-audio-box": ("cutmix", None, (1, 2, 12, 10)),
    "MixUp-audio": ("MixUp", None, (1, 16, 1, 10)),
    "CutMix-audio-box": ("CutMix", None, (1, 2, 12, 10)),
    "MixVideo-mixup-audio": ("MixVideo", 0.0, (1, 16, 1, 10)),
    "MixVideo-cutmix-audio-box": ("MixVideo", 1.0, (1, 2, 12, 10)),
}


@pytest.mark.parametrize("op", list(MIX_CASES))
def test_mix_matches_jax_with_lambda_and_box_fixed(op, monkeypatch):
    # The samplers are fixed in both packages (the two frameworks draw
    # different bits from one seed); the mixing and the labels must agree.
    # The box centres: the video's, then the audio's.
    name, cutmix_prob, audio_shape = MIX_CASES[op]
    lam, centres = 0.3, {(8, 6): (5, 2), (1, 10): (0, 4), (12, 10): (7, 4)}
    monkeypatch.setattr(mix, "_sample_beta", lambda alpha, generator: lam)
    monkeypatch.setattr(mix, "_sample_center", lambda h, w, generator: centres[(h, w)])
    monkeypatch.setattr(jax_mix, "_sample_beta", lambda key, alpha: jnp.float32(lam))
    draws = [*centres[(8, 6)], *(centres[audio_shape[-2:]] if audio_shape else ())]
    # MixVideo's lax.cond traces both branches: the draws repeat.
    draws = itertools.cycle(draws)
    monkeypatch.setattr(jax_mix.jax.random, "randint", lambda *a, **k: jnp.int32(next(draws)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 2, 8, 6)).astype(np.float32)
    audio = rng.normal(size=(4, *audio_shape)).astype(np.float32) if audio_shape else None
    labels = np.array([0, 3, 1, 2])
    kw = dict(alpha=0.8, label_smoothing=0.1, num_classes=5)
    ours_args = (torch.from_numpy(x), torch.from_numpy(labels))
    jax_args = (jax.random.PRNGKey(0), _nhwc(x), jnp.asarray(labels))
    ours_audio = torch.from_numpy(audio) if audio is not None else None
    jax_audio = _nhwc(audio) if audio is not None else None
    if name in ("mixup", "cutmix"):
        out = getattr(mix, name)(*ours_args, **kw, x_audio=ours_audio)
        ref = getattr(jax_mix, name)(*jax_args, **kw, x_audio=jax_audio)
    elif name == "MixVideo":
        kw = dict(cutmix_prob=cutmix_prob, mixup_alpha=0.8, cutmix_alpha=0.8,
                  label_smoothing=0.1, num_classes=5)
        out = mix.MixVideo(**kw)(*ours_args, x_audio=ours_audio)
        ref = jax_mix.MixVideo(**kw)(*jax_args, x_audio=jax_audio)
    else:
        out = getattr(mix, name)(**kw)(*ours_args, x_audio=ours_audio)
        ref = getattr(jax_mix, name)(**kw)(*jax_args, x_audio=jax_audio)
    assert len(out) == len(ref) == (3 if audio_shape else 2)
    video, soft = out[0], out[-1]
    # MixVideo's lax.cond compiles the JAX mix, which rounds lam * x + (1 -
    # lam) * flip(x) in its own order: 2e-8 apart near zero.
    tol = dict(rtol=1e-6, atol=1e-7 if name == "MixVideo" else 0.0)
    np.testing.assert_allclose(np.moveaxis(video.numpy(), 1, -1), np.asarray(ref[0]), **tol)
    np.testing.assert_allclose(soft.numpy(), np.asarray(ref[-1]), rtol=1e-6, atol=1e-7)
    cuts = name in ("cutmix", "CutMix") or cutmix_prob == 1.0
    if cuts:
        # The box (rows 2-7, columns 0-4 of the 8x6 frame) and its lambda.
        assert not np.allclose(video.numpy(), x) and (video.numpy()[..., :2, :] == x[..., :2, :]).all()
    if audio_shape:
        mixed_audio = out[1].numpy()
        np.testing.assert_allclose(np.moveaxis(mixed_audio, 1, -1), np.asarray(ref[1]), **tol)
        if cuts and audio_shape[-2] == 1:
            # A one-row spectrogram's box is empty, as in the JAX package.
            np.testing.assert_array_equal(mixed_audio, audio)
        elif cuts:
            # Its own box: rows 2-11, columns 0-7 of the 12x10 grid.
            assert (mixed_audio[..., :2, :] == audio[..., :2, :]).all()
            assert (mixed_audio[..., 8:] == audio[..., 8:]).all()
            assert not np.allclose(mixed_audio[..., 2:, :8], audio[..., 2:, :8])


def test_beta_sampler_moments():
    gen = torch.Generator().manual_seed(0)
    for alpha in (0.8, 1.0, 2.0):
        draws = np.array([mix._sample_beta(alpha, gen) for _ in range(4000)])
        assert ((draws > 0) & (draws < 1)).all()
        var = 1.0 / (4 * (2 * alpha + 1))
        assert abs(draws.mean() - 0.5) < 4 * np.sqrt(var / len(draws))
        assert abs(draws.var() - var) < 0.15 * var


def test_drop_path_shares_one_mask_and_scales_by_keep():
    gen = torch.Generator().manual_seed(0)
    cls, grid = torch.ones(4000, 1, 3), torch.ones(4000, 5, 3)
    cls_out, grid_out = drop_path_pair((cls, grid), 0.25, gen)
    scale = grid_out[:, 0, 0]
    assert set(torch.unique(scale).tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert (grid_out == scale[:, None, None]).all() and (cls_out == scale[:, None, None]).all()
    assert abs((scale > 0).float().mean().item() - 0.75) < 0.03
    assert drop_path_pair((None, grid), 0.25, gen)[0] is None
    out = drop_path(torch.ones(4000, 2, 2), 0.5, gen)
    assert set(torch.unique(out).tolist()) == {0.0, 2.0}
    assert (out == out[:, :1, :1]).all()
    # The module form: the identity in eval mode, the same draw in training.
    x = torch.ones(4000, 2, 2)
    assert DropPath(0.5, gen).eval()(x) is x
    module = DropPath(0.5, torch.Generator().manual_seed(1)).train()
    torch.testing.assert_close(module(x), drop_path(x, 0.5, torch.Generator().manual_seed(1)))


def test_block_droppath_in_train_mode_only():
    torch.manual_seed(0)
    block = MultiScaleBlock(16, 16, 2, droppath_rate=0.5)
    x = (torch.randn(6, 1, 16), torch.randn(6, 12, 16))
    with torch.no_grad():
        eval_out, _ = block.eval()(x, (1, 3, 4))
        block.droppath_rate = 0.0
        ref, _ = block.train()(x, (1, 3, 4))
        torch.testing.assert_close(eval_out, ref)
        block.droppath_rate = 0.5
        outs = []
        for _ in range(2):
            torch.manual_seed(3)
            outs.append(block(x, (1, 3, 4))[0])
        torch.testing.assert_close(outs[0], outs[1])
        assert not torch.allclose(outs[0][1], ref[1])


class _Batches:
    """A datamodule: ``train_dataloader(n)`` yields n seeded batches."""

    def __init__(self, batch=2, clip=(4, 32, 32), classes=7, fixed=False):
        self.batch, self.clip, self.classes, self.fixed = batch, clip, classes, fixed

    def train_dataloader(self, n):
        rng = np.random.default_rng(0)
        for i in range(n):
            if self.fixed:
                rng = np.random.default_rng(0)
            yield {"video": rng.normal(size=(self.batch, 3, *self.clip)).astype(np.float32),
                   "label": rng.integers(0, self.classes, size=self.batch)}


def _app(model, tmp_path=None, steps=3, **overrides):
    cfg = get_preset("classification_mvit_16x4", **{
        "model.num_classes": 7, "trainer.max_epochs": 1, "trainer.log_every_n_steps": 1,
        "trainer.checkpoint_dir": None if tmp_path is None else str(tmp_path), **overrides})
    return VideoClassificationTrainApp(cfg, model=model, datamodule=_Batches(fixed=True),
                                       steps_per_epoch=steps, device="cpu")


def test_app_trains_in_bf16_and_every_param_gets_a_grad():
    _, _, model, _ = small_mvit_pair()
    app = _app(model, **{"trainer.compute_dtype": "bfloat16"})
    history = app.train()
    assert len(history) == 3 and np.isfinite(history).all() and app.state.step == 3
    assert [g["label"] for g in app.state.optimizer.param_groups] == ["main", "zero", "bn"]
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name


def test_app_loss_falls_on_one_batch():
    _, _, model, _ = small_mvit_pair(**NO_DROPOUT)
    app = _app(model, steps=10, **{"mix.enabled": False, "optim.lr": 1e-3,
                                   "lr_scheduler.warmup_iters": 0,
                                   "lr_scheduler.cosine_end_lr": 0.0, "lr_scheduler.lr": 1e-3})
    history = app.train()
    assert history[-1] < 0.5 * history[0], history


def test_checkpoint_round_trip(tmp_path):
    _, _, model, x = small_mvit_pair()
    app = _app(model, tmp_path, steps=2)
    app.train()
    path = tmp_path / "ckpt_0.pt"
    assert path.is_file() and (tmp_path / "config.json").is_file()
    _, _, other, _ = small_mvit_pair(seed=5)
    restored = _app(other)
    restored.load_checkpoint(str(path))
    assert restored.state.step == 2
    for (name, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    ours, theirs = app.state.optimizer.state_dict(), restored.state.optimizer.state_dict()
    for key in ours["state"]:
        for k in ours["state"][key]:
            torch.testing.assert_close(ours["state"][key][k], theirs["state"][key][k], rtol=0, atol=0)
    batch = {"video": torch.from_numpy(x)}
    torch.testing.assert_close(make_eval_step()(app.state, batch),
                               make_eval_step()(restored.state, batch), rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    assert inspect.signature(VideoClassificationTrainApp).parameters["device"].default == "cuda"
    cfg = get_preset("classification_mvit_16x4")
    if not torch.cuda.is_available():
        # No card: building the configured model there raises.
        with pytest.raises((AssertionError, RuntimeError)):
            VideoClassificationTrainApp(cfg, datamodule=_Batches())
    # Without a datamodule the app builds the config's, on the app's device.
    app = VideoClassificationTrainApp(cfg, model=torch.nn.Linear(1, 1), device="cpu")
    assert isinstance(app.datamodule, VideoClassificationDataModule)
    assert app.datamodule.cfg is cfg.data and app.datamodule.device == torch.device("cpu")
    assert inspect.signature(VideoClassificationDataModule).parameters["device"].default == "cuda"


def test_every_port_module_imports_without_jax():
    # Every module of the package, and chip_smoke.py, with jax and the JAX
    # package unavailable (the card's machine has neither).
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pytorchvideo_tpu'] = None\n"
        "import pytorchvideo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "new = ['train.train_loop', 'train.precise_batchnorm', 'train.metrics', "
        "'train.transforms', 'models.weight_init', 'layers.norms']\n"
        "assert all('pytorchvideo_tpu_torch.' + n in names for n in new), names\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
