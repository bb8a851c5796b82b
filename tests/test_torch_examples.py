"""The port's walkthroughs (examples_torch/) beside the JAX package's
(examples/) on the CPU: hub inference's top-5 and the detection pipeline's
scores on carried weights (zoo/from_jax.py), the visualizer's frames bit for
bit, classification and SSL pretraining two steps on a tiny csv, the
deployment walkthrough's CPU parts, and ``--device cuda`` refused on a host
without a card.

The JAX scripts build full-size models and read ``sys.argv``; the tests hand
each the narrow model its port counterpart builds (the factory or hook
replaced on both sides alike) and their arguments through ``sys.argv``.
Tolerances: logits and scores the repo's f32 tolerance (rtol 5e-3, atol
5e-4); the deploy forms' bf16 logits 3e-2 of max |logit|, chip_smoke.py's
bf16 logit bound.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from examples_torch import (
    accelerator_deployment,
    hub_inference,
    ssl_pretraining,
    video_classification,
    video_detection,
    visualization,
)
from pytorchvideo_tpu import engine as jax_engine
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu_torch import engine
from pytorchvideo_tpu_torch.data.utils import export_video_array
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from test_torch_examples_chain import _zero_draws
from torch_port_helpers import TOL, build_pair, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_LOGIT_SHARE = 3e-2
# A narrow Slow-R50: one block a stage, an 8-channel stem, 4-frame clips.
SLOW = dict(stem_dim_out=8, stage_depths=(1, 1, 1, 1), dropout_rate=0.0,
            head_pool_kernel_size=(4, 1, 1))


def jax_example(name):
    """examples/<name>.py as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(path, frames, fps):
    export_video_array(torch.from_numpy(frames), str(path), fps)
    return str(path)


def test_hub_inference_top5_matches_jax(tmp_path, monkeypatch, capsys):
    tiny = dict(depth_factor=0.34, dropout_rate=0.0)
    _, _, model, _ = build_pair(seed=8, model_num_class=10, input_clip_length=4,
                                input_crop_size=160, **tiny)
    pyth = str(tmp_path / "x3d_xs.pyth")
    torch.save({"model_state": model.state_dict()}, pyth)
    frames = np.random.default_rng(9).integers(0, 256, (50, 120, 160, 3), np.uint8)
    video = _write_video(tmp_path / "clip.avi", frames, 30)
    argv = ["--video", video, "--model", "x3d_xs", "--checkpoint", pyth, "--classes", "10"]

    _zero_draws(monkeypatch)
    jax_x3d_xs, x3d_xs = jax_hub.x3d_xs, hub.x3d_xs
    monkeypatch.setattr(jax_hub, "x3d_xs", lambda **kw: jax_x3d_xs(**kw, **tiny))
    monkeypatch.setattr(hub, "x3d_xs", lambda **kw: x3d_xs(**kw, **tiny))
    monkeypatch.setattr(sys, "argv", ["hub_inference.py", *argv])
    jax_example("hub_inference").main()
    printed = capsys.readouterr().out
    theirs = re.findall(r"^\d\. (\S+)  p=([0-9.]+)$", printed, re.M)
    ours = hub_inference.main(argv + ["--device", "cpu"])
    assert [label for label, _ in ours] == [label for label, _ in theirs]
    np.testing.assert_allclose([p for _, p in ours], [float(p) for _, p in theirs], atol=1.5e-4)


def test_visualizer_frames_equal_jax():
    rng = np.random.default_rng(10)
    clip = rng.integers(0, 256, (3, 90, 120, 3), np.uint8)
    boxes = np.array([[5.0, 8.0, 60.0, 70.0], [40.5, 20.2, 110.0, 88.0]], np.float32)
    scores = rng.uniform(0, 1, (2, 6)).astype(np.float32)
    names = {1: "jump", 4: "wave"}
    ours = visualization.VideoVisualizer(6, names, top_k=3, thres=0.2)
    theirs = jax_example("visualization").VideoVisualizer(6, names, top_k=3, thres=0.2)
    got = ours.draw_clip(torch.from_numpy(clip), torch.from_numpy(boxes), scores,
                         repeat_frame=2)
    ref = theirs.draw_clip(clip, boxes, scores, repeat_frame=2)
    assert got.shape == (6, 90, 120, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert (got != np.repeat(clip, 2, axis=0)).any()


def test_video_detection_scores_match_jax(tmp_path, monkeypatch, capsys):
    narrow = dict(SLOW, model_num_class=5)
    hook = dict(side_size=64, crop_size=64)
    shapes = jax.eval_shape(lambda: jax_hub.slow_r50_detection(**narrow).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3)), jnp.zeros((1, 5)), False))
    variables = random_variables(shapes, seed=11)
    state_dict = jax_variables_to_state_dict(variables["params"], variables["batch_stats"])
    jax_hook, hook_cls = jax_engine.ActionDetectionHook, engine.ActionDetectionHook
    monkeypatch.setattr(jax_engine, "ActionDetectionHook",
                        lambda **kw: jax_hook(variables=variables, **kw, **hook, **narrow))
    monkeypatch.setattr(engine, "ActionDetectionHook",
                        lambda **kw: hook_cls(state_dict=state_dict, **kw, **hook, **narrow))
    runs = []
    jax_run = jax_engine.NeuralEngine.run
    monkeypatch.setattr(jax_engine.NeuralEngine, "run",
                        lambda self, status: runs.append(jax_run(self, status)) or runs[-1])

    frames = np.random.default_rng(12).integers(0, 256, (6, 48, 80, 3), np.uint8)
    video = _write_video(tmp_path / "clip.avi", frames, 6)
    boxes = tmp_path / "boxes.csv"
    boxes.write_text("2,4,30,40\n50,0,79,47\n")
    argv = ["--video", video, "--boxes", str(boxes), "--thres", "0.1"]
    monkeypatch.setattr(sys, "argv", ["video_detection.py", *argv,
                                      "--out", str(tmp_path / "theirs.avi")])
    jax_example("video_detection").main()
    assert "wrote" in capsys.readouterr().out
    ours = video_detection.main(argv + ["--out", str(tmp_path / "ours.avi"), "--device", "cpu"])

    ref = runs[0]
    np.testing.assert_array_equal(ours["boxes"], np.asarray(ref["bbox_coordinates"]))
    np.testing.assert_allclose(ours["scores"],
                               np.asarray(ref["action_scores"]).reshape(2, -1), **TOL)
    assert ours["annotated"].shape == (6, 48, 80, 3)
    for name in ("ours.avi", "theirs.avi"):
        assert os.path.getsize(tmp_path / name) > 0


@pytest.fixture(scope="module")
def tiny_csv(tmp_path_factory):
    """Four 2.5 s videos of 48x64 frames at 10 fps, labels 0, 1, 0, 1."""
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(13)
    lines = []
    for i in range(4):
        path = _write_video(root / f"v{i}.avi",
                            rng.integers(0, 256, (25, 48, 64, 3), np.uint8), 10)
        lines.append(f"{path} {i % 2}")
    csv = root / "train.csv"
    csv.write_text("\n".join(lines) + "\n")
    return str(csv)


@pytest.fixture
def narrow_slow(monkeypatch):
    """The hub's ``slow_r50`` narrowed to SLOW for the apps the scripts build."""
    slow_r50 = hub.slow_r50
    monkeypatch.setattr(hub, "slow_r50", lambda **kw: slow_r50(**{**kw, **SLOW}))


def test_video_classification_trains_two_steps(tiny_csv, narrow_slow):
    out = video_classification.main([
        "--data", tiny_csv, "--classes", "2", "--batch-size", "2", "--steps-per-epoch", "2",
        "--frames", "4", "--crop", "32", "--device", "cpu"])
    assert out["losses"] and all(np.isfinite(out["losses"]))
    # The keys of the JAX app's test() (pytorchvideo_tpu/train/app.py:233).
    assert set(out["test"]) == {"video_top1"}
    assert 0.0 <= out["test"]["video_top1"] <= 1.0


def test_ssl_pretraining_trains_two_steps(tiny_csv, narrow_slow):
    out = ssl_pretraining.main([
        "--data", tiny_csv, "--task", "byol", "--batch-size", "2", "--steps-per-epoch", "2",
        "--frames", "4", "--crop", "32", "--feature-dim", "16", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    backbone = hub.slow_r50(model_num_class=16, device="cpu")
    assert out["backbone_params"] == sum(p.numel() for p in backbone.parameters())
    assert set(out["backbone"]) == set(backbone.state_dict())


def test_accelerator_deployment_on_the_cpu():
    from pytorchvideo_tpu_torch.accelerate import (
        DepthwiseConv3x3x3BnAct,
        convert_to_deployable_form,
    )

    out = accelerator_deployment.main(["--device", "cpu"])
    for ref_key, keys in (("reference", ("deployable", "transmuted", "exported")),
                          ("efficient_reference", ("efficient",))):
        ref = out[ref_key]
        assert ref.shape == (1, 400) and bool(ref.isfinite().all())
        for key in keys:
            err = (out[key] - ref).abs().max().item()
            assert err <= BF16_LOGIT_SHARE * ref.abs().max().item(), (key, err)
    assert torch.equal(out["exported"], out["deployable"])
    assert "compiled" not in out and out["deploy_forwards"] == 4
    assert sum(isinstance(m, DepthwiseConv3x3x3BnAct) for m in out["deploy"].modules()) == 22
    # Compiled serving needs the card: a CPU model and input raise.
    with pytest.raises(ValueError, match="needs the card"):
        convert_to_deployable_form(out["deploy"], dtype=torch.bfloat16,
                                   example_input=out["input"])


@pytest.mark.parametrize("script, argv", [
    (hub_inference, ["--video", "clip.avi"]),
    (video_detection, ["--video", "clip.avi"]),
    (video_classification, ["--data", "train.csv"]),
    (ssl_pretraining, ["--data", "train.csv"]),
    (accelerator_deployment, []),
], ids=["hub_inference", "video_detection", "video_classification", "ssl_pretraining",
        "accelerator_deployment"])
def test_device_cuda_raises_without_a_card(script, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        script.main(argv)
