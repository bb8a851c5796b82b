"""pytorchvideo_tpu_torch's evaluation metrics, test-time ensembling and
weight initialisation against the JAX package's, on the CPU.

Tolerances: top-k accuracy exact; average precision and mAP rtol 1e-12
(both float64 numpy); the ensembled logits rtol 1e-6 / atol 1e-6 (f32
sums). Weight init: zeros and ones exact, each drawn tensor of at least 4096
values within 10% of the JAX one's standard deviation. The JAX init runs
its own rules with its unit draws (``jax.random.normal`` and
``truncated_normal``) taken from numpy: eager JAX would compile a kernel per
leaf shape, some 15 s for one small X3D."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.models.weight_init import init_net_weights as jax_init_net_weights
from pytorchvideo_tpu.train import metrics as jax_metrics
from pytorchvideo_tpu.train.train_loop import ensemble_video_level as jax_ensemble_video_level
from pytorchvideo_tpu_torch.models import init_net_weights
from pytorchvideo_tpu_torch.train import (
    average_precision,
    ensemble_video_level,
    mean_average_precision,
    top1_top5,
    topk_accuracy,
)
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import build_pair, small_mvit_pair


def _scores(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_accuracy_matches_jax(k):
    logits = _scores(0, (64, 10))
    labels = np.random.default_rng(1).integers(0, 10, size=64)
    ours = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k)
    assert ours.item() == float(jax_metrics.topk_accuracy(logits, labels, k))
    assert top1_top5(torch.from_numpy(logits), labels) == jax_metrics.top1_top5(logits, labels)


def test_average_precision_and_map_match_jax():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(40, 6))
    targets = (rng.uniform(size=(40, 6)) < 0.3).astype(np.int64)
    targets[:, 4] = 0  # a class without a positive: NaN AP, left out of the mean
    for c in range(6):
        ours = average_precision(torch.from_numpy(scores[:, c]), targets[:, c])
        ref = jax_metrics.average_precision(scores[:, c], targets[:, c])
        assert np.isnan(ours) == np.isnan(ref) == (c == 4)
        if c != 4:
            np.testing.assert_allclose(ours, ref, rtol=1e-12)
    np.testing.assert_allclose(mean_average_precision(torch.from_numpy(scores), targets),
                               jax_metrics.mean_average_precision(scores, targets), rtol=1e-12)
    assert mean_average_precision(scores, np.zeros_like(targets)) == 0.0


@pytest.mark.parametrize("method", ["sum", "max"])
def test_ensemble_video_level_matches_jax(method):
    # Three batches of clips of 5 videos, a video's clips in several batches,
    # and video 3 never seen (0 for sum, -inf for max in both).
    logits = [_scores(3 + i, (4, 7)) for i in range(3)]
    index = [np.array([0, 1, 0, 2]), np.array([4, 4, 1, 2]), np.array([0, 1, 4, 2])]
    ours = ensemble_video_level([torch.from_numpy(a) for a in logits],
                                [torch.from_numpy(i) for i in index], 5, method)
    ref = jax_ensemble_video_level([jnp.asarray(a) for a in logits],
                                   [jnp.asarray(i) for i in index], 5, method)
    assert ours.dtype == torch.float32 and ours.shape == (5, 7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        ensemble_video_level([torch.from_numpy(logits[0])], [torch.from_numpy(index[0])], 5,
                             "mean")


# --- weight init ----------------------------------------------------------------

def _x3d():
    jax_model, variables, model, _ = build_pair(input_clip_length=4, input_crop_size=32,
                                                model_num_class=7, width_factor=1.0,
                                                depth_factor=0.5, head_dim_out=64)
    return variables, model


def _mvit():
    _, variables, model, _ = small_mvit_pair()
    return variables, model


def _numpy_draws(monkeypatch):
    rng = np.random.default_rng(0)

    def normal(key, shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    def truncated_normal(key, lower, upper, shape, dtype=np.float32):
        x = rng.standard_normal(shape)
        while ((x < lower) | (x > upper)).any():
            bad = (x < lower) | (x > upper)
            x[bad] = rng.standard_normal(int(bad.sum()))
        return x.astype(dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "truncated_normal", truncated_normal)


@pytest.mark.parametrize("style, build", [("resnet", _x3d), ("resnet", _mvit), ("vit", _mvit)],
                         ids=["resnet-x3d", "resnet-mvit", "vit-mvit"])
def test_weight_init_redraws_what_jax_redraws(style, build, monkeypatch):
    _numpy_draws(monkeypatch)
    variables, model = build()
    stats = variables.get("batch_stats", {})
    original = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    ref = jax_init_net_weights(variables, jax.random.PRNGKey(0), 0.01 if style == "resnet"
                               else 0.02, style)
    ref = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, ref["params"]), stats)
    init_net_weights(model, 0.01 if style == "resnet" else 0.02, style,
                     torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    changed = {n for n, p in params.items() if not torch.equal(p, original[n])}
    assert changed == {n for n in params if not torch.equal(ref[n], original[n])}
    drawn = 0
    for n in changed:
        ours, theirs = params[n].detach(), ref[n]
        if (theirs == 0).all() or (theirs == 1).all():
            torch.testing.assert_close(ours, theirs, rtol=0, atol=0, msg=n)
        elif theirs.numel() >= 4096:
            drawn += 1
            assert abs(ours.std().item() / theirs.std().item() - 1.0) < 0.1, n
            assert abs(ours.mean().item()) < 0.1 * theirs.std().item(), n
    assert drawn >= 3
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, buffers[n], rtol=0, atol=0, msg=n)
    # One seed, one initialisation.
    again = {n: p.detach().clone() for n, p in params.items()}
    init_net_weights(model, 0.01 if style == "resnet" else 0.02, style,
                     torch.Generator().manual_seed(0))
    for n, p in params.items():
        torch.testing.assert_close(p.detach(), again[n], rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError):
        init_net_weights(model, style="xavier")
