"""The checkpoint chain of the eval harness in both packages: a port
model's ``state_dict`` saved as an upstream ``.pyth`` (``{"model_state":
...}``), loaded by examples/eval_kinetics.py through the JAX importer with
the family's rename rules and by examples_torch/eval_kinetics.py with none
(the port keeps upstream's keys), then evaluated by the model-zoo protocol
on the same synthetic videos: the same predictions, top-1 and top-5. The
port's ``--deploy`` (BN folded) gives the unfolded run's.

The JAX script builds every model with ``model_num_class``, which MViT's
factory does not take (it names the count ``head_num_classes``); the test
hands the JAX script a factory that renames it. The port's script passes
``head_num_classes`` itself.
"""

import json
import os

import numpy as np
import pytest
import torch
from jax._src import random as jax_random

from examples_torch import eval_kinetics
from pytorchvideo_tpu.data import encoded_video_native as jax_native
from pytorchvideo_tpu.data import native_pipeline as jax_pipeline
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu_torch.data import native_build
from pytorchvideo_tpu_torch.models import hub
from test_torch_examples_eval import TINY_X3D, jax_eval_kinetics
from torch_port_helpers import SMALL_MVIT, build_mvit_pair, build_pair

# The tiny MViT at the 16 frames of mvit_base_16x4's protocol.
TINY_MVIT = {**{k: v for k, v in SMALL_MVIT.items() if k != "head_num_classes"},
             "temporal_size": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_on_the_same_library(monkeypatch):
    missing = native_build.missing_tools()
    if missing:
        pytest.skip("the native decoder cannot be built here: missing " + ", ".join(missing))
    monkeypatch.setenv("PVT_DECODE_LIB", str(native_build.build_library()))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_LIB_TRIED", False)
    monkeypatch.setattr(jax_pipeline, "_PIPE_BOUND", False)


def _zero_draws(monkeypatch):
    """The JAX script's ``model.init`` draws zeros: the strict import then
    overwrites every variable, so the init gives only the tree, and its
    draws, each compiled eagerly, would cost 15 s a model."""
    def normal(key, shape=(), dtype=None, **kwargs):
        return np.zeros(shape, np.float32)

    def truncated_normal(key, lower, upper, shape=None, dtype=None, **kwargs):
        return np.zeros(shape, np.float32)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0, **kwargs):
        return np.zeros(shape, np.float32)

    for name, fn in (("normal", normal), ("truncated_normal", truncated_normal),
                     ("uniform", uniform)):
        monkeypatch.setattr(jax_random, name, fn)


def _x3d():
    _, _, model, _ = build_pair(seed=6, model_num_class=4, **TINY_X3D)
    args = ["--model", "x3d_xs", "--clips-per-video", "2", "--spatial-crops", "3",
            "--batch-size", "6", "--side-size", "110", "--crop-size", "96",
            "--model-kwargs", json.dumps(TINY_X3D)]
    return model, args, 1.6


def _mvit():
    _, _, model, _ = build_mvit_pair(jax_hub.mvit_base_16x4, hub.mvit_base_16x4, seed=7,
                                     head_num_classes=4, **TINY_MVIT)
    args = ["--model", "mvit_base_16x4", "--clips-per-video", "2", "--batch-size", "4",
            "--side-size", "36", "--crop-size", "32", "--model-kwargs", json.dumps(TINY_MVIT)]
    return model, args, 2.4


@pytest.mark.parametrize("case", [_x3d, _mvit], ids=["x3d_xs", "mvit_base_16x4"])
def test_pyth_chain_matches_jax_importer(case, tmp_path, jax_on_the_same_library, monkeypatch):
    model, args, seconds = case()
    pyth = str(tmp_path / "model.pyth")
    torch.save({"model_state": model.state_dict()}, pyth)
    jax_harness = jax_eval_kinetics()
    csv = jax_harness.make_synthetic_dataset(str(tmp_path), num_videos=3, num_classes=4,
                                             seconds=seconds, fps=10)
    common = args + ["--data", csv, "--num-classes", "4", "--checkpoint", pyth]

    _zero_draws(monkeypatch)
    mvit = jax_hub.mvit_base_16x4
    monkeypatch.setattr(jax_hub, "mvit_base_16x4",
                        lambda model_num_class, **kw: mvit(head_num_classes=model_num_class, **kw))
    theirs = jax_harness.main(common)
    ours = eval_kinetics.main(common + ["--device", "cpu"])
    deployed = eval_kinetics.main(common + ["--device", "cpu", "--deploy"])

    assert ours["num_videos"] == theirs["num_videos"] == 3
    assert ours["views"] == theirs["views"]
    assert ours["predictions"] == theirs["predictions"]
    assert (ours["top1"], ours["top5"]) == (theirs["top1"], theirs["top5"])
    assert deployed["predictions"] == ours["predictions"]
    assert (deployed["top1"], deployed["top5"]) == (ours["top1"], ours["top5"])
