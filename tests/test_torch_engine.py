"""The port's NeuralEngine and hooks against the JAX package's: the engine's
order and outputs on a chain and a diamond of hooks and each of its
refusals, the four fail strategies, DecodeHook on a lossless video written
with OpenCV, X3DClsHook's transform and logits (full-width X3D-S, the same
seeded weights), ActionDetectionHook with a narrow ``slow_r50_detection``
and boxes across the crop, and the detection hooks' executors, predictor
factory and image loading.

Tolerances: the engine, the executors and decoding exact; the logits and
scores the repo's f32 tolerance (rtol 5e-3, atol 5e-4); the transformed
clips rtol 1e-5, atol 1e-5 (one f32 resize each).
"""

import os
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu import engine as jax_engine
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu_torch import engine
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, random_variables

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import create_dummy_video_frames, temp_encoded_video  # noqa: E402

CLIP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    of threads in each of the suite's parallel workers oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the engine ----------------------------------------------------------------

# name -> (inputs, outputs, function of the inputs' values)
CHAIN = {
    "scale": (["x"], ["a"], lambda x: x * 2.0),
    "shift": (["a"], ["b"], lambda a: a + 1.0),
    "square": (["b"], ["c"], lambda b: b * b),
}
DIAMOND = {
    "left": (["x"], ["l"], lambda x: x * 3.0),
    "right": (["x"], ["r", "r2"], lambda x: (x - 1.0, x + 2.0)),
    "join": (["l", "r"], ["j"], lambda l, r: l * r),
    "last": (["j", "r2", "x"], ["y"], lambda j, r2, x: j - r2 + x),
}


def _hooks(module, graph, order, log):
    """``module``'s HookBase per entry of ``graph``, in the order ``order``,
    each appending its name to ``log`` when it runs."""

    def make(name):
        inputs, outputs, fn = graph[name]

        def executor(status):
            log.append(name)
            values = fn(*(status[i] for i in inputs))
            values = values if isinstance(values, tuple) else (values,)
            return dict(zip(outputs, values))

        return module.HookBase(executor=executor, inputs=inputs, outputs=outputs)

    return [make(name) for name in order]


def _runs_after_its_producers(graph, log):
    produced_by = {o: n for n, (_, outs, _) in graph.items() for o in outs}
    for name in log:
        for i in graph[name][0]:
            if i in produced_by:
                assert log.index(produced_by[i]) < log.index(name), (name, log)


@pytest.mark.parametrize("graph_name", ["chain", "diamond"])
@pytest.mark.parametrize("order", ["as_listed", "reversed"])
def test_engine_matches_jax(graph_name, order):
    graph = {"chain": CHAIN, "diamond": DIAMOND}[graph_name]
    names = list(graph) if order == "as_listed" else list(graph)[::-1]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    results = {}
    for label, module, engine_cls, value in (
            ("port", engine, engine.NeuralEngine, torch.from_numpy(x)),
            ("jax", jax_engine, jax_engine.NeuralEngine, jnp.asarray(x))):
        log = []
        status = engine_cls(_hooks(module, graph, names, log)).run(OrderedDict(x=value))
        assert sorted(log) == sorted(graph)
        _runs_after_its_producers(graph, log)
        results[label] = {k: np.asarray(v) for k, v in status.items()}
    assert results["port"].keys() == results["jax"].keys()
    for key, ref in results["jax"].items():
        np.testing.assert_array_equal(results["port"][key], ref, err_msg=key)


def _refused(graph_name):
    if graph_name == "duplicate output":
        return {"one": (["x"], ["a"], None), "two": (["x"], ["a"], None)}, {"x": 1.0}
    if graph_name == "missing input":
        return CHAIN, {}
    return {**CHAIN, "orphan": ([], ["z"], None)}, {"x": 1.0}  # no input: never scheduled


@pytest.mark.parametrize("graph_name", ["duplicate output", "missing input", "unproduced output"])
def test_engine_refuses_what_jax_s_refuses(graph_name):
    graph, status = _refused(graph_name)
    with pytest.raises(AssertionError):
        jax_engine.NeuralEngine(_hooks(jax_engine, graph, list(graph), [])).run(dict(status))
    with pytest.raises(ValueError):
        engine.NeuralEngine(_hooks(engine, graph, list(graph), [])).run(dict(status))


def test_engine_takes_a_path_and_a_custom_order():
    log = []
    hooks = _hooks(engine, {"len": (["path"], ["n"], len)}, ["len"], log)
    with engine.NeuralEngine(hooks) as eng:
        assert eng("abc.mp4") == {"path": "abc.mp4", "n": 7}
        eng.set_execution_order_func(lambda status, hooks: iter(()))
        assert eng("abc.mp4") == {"path": "abc.mp4"}
    assert log == ["len"]


@pytest.mark.parametrize("strategy", ["RAISE_ERROR", "RETURN_NONE", "ZERO_FILL", "RANDOM_FILL"])
def test_fail_strategies_match_jax(strategy):
    def boom(status):
        raise RuntimeError("boom")

    gen = torch.Generator().manual_seed(4)
    ours = engine.HookBase(executor=boom, inputs=["path"], outputs=["u", "v"],
                           fail_strategy=strategy, generator=gen)
    theirs = jax_engine.HookBase(executor=boom, inputs=["path"], outputs=["u", "v"],
                                 fail_strategy=strategy)
    if strategy == "RAISE_ERROR":
        for hook in (ours, theirs):
            with pytest.raises(RuntimeError, match="boom"):
                hook.run({"path": "p"})
        assert ours.status == "FAILED"
        return
    out, ref = ours.run({"path": "p"}), theirs.run({"path": "p"})
    assert ours.status == theirs.status == "FAILED"
    assert out.keys() == ref.keys() == {"u", "v"}
    if strategy == "RETURN_NONE":
        assert out == ref == {"u": None, "v": None}
    elif strategy == "ZERO_FILL":
        for k in out:
            np.testing.assert_array_equal(out[k].numpy(), ref[k])
    else:
        replay = torch.Generator().manual_seed(4)
        for k in ("u", "v"):
            assert out[k].shape == ref[k].shape == (1,)
            assert torch.equal(out[k], torch.rand(1, generator=replay))
            assert 0.0 <= float(out[k]) < 1.0


def test_hook_refuses_an_unknown_fail_strategy():
    with pytest.raises(ValueError):
        engine.HookBase(fail_strategy="IGNORE")


# --- DecodeHook ----------------------------------------------------------------------

def test_decode_hook_frames_equal_jax_s():
    with temp_encoded_video(num_frames=10, fps=5, height=24, width=40) as (path, data):
        ours = engine.DecodeHook().run({"path": path})["video"]
        theirs = jax_engine.DecodeHook().run({"path": path})["video"]
        assert ours.dtype == torch.uint8 and ours.shape == (10, 24, 40, 3)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(ours.numpy(), data)

        mean = engine.HookBase(executor=lambda s: {"mean": float(s["video"].float().mean())},
                               inputs=["video"], outputs=["mean"])
        status = engine.NeuralEngine([mean, engine.DecodeHook()])(path)
        assert status["mean"] == pytest.approx(float(data.mean()))


# --- X3DClsHook ------------------------------------------------------------------------

def test_x3d_cls_hook_matches_jax_s():
    jax_model = jax_hub.x3d_s(model_num_class=400)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 13, 160, 160, 3), jnp.float32), False))
    variables = random_variables(shapes, seed=11)
    ours = engine.X3DClsHook(
        state_dict=jax_variables_to_state_dict(variables["params"], variables["batch_stats"]),
        device="cpu")
    theirs = jax_engine.X3DClsHook(variables=variables)
    assert not ours.model.training
    video = create_dummy_video_frames(20, 170, 220)  # uint8, as the port decodes
    clip = ours.transform(torch.from_numpy(video))
    ref_clip = theirs.transform(jnp.asarray(video.astype(np.float32)))
    assert clip.shape == (13, 160, 160, 3)
    np.testing.assert_allclose(clip.numpy(), np.asarray(ref_clip), **CLIP_TOL)
    logits = ours.run({"video": torch.from_numpy(video)})["action_class"]
    ref = theirs.run({"video": video.astype(np.float32)})["action_class"]
    assert logits.shape == (1, 400)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)


def test_hooks_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        engine.X3DClsHook()
    with pytest.raises((RuntimeError, AssertionError)):
        engine.ActionDetectionHook(stage_depths=(1, 1, 1, 1))


# --- ActionDetectionHook -----------------------------------------------------------------

SLOW = dict(stem_dim_out=8, stage_depths=(1, 1, 1, 1), model_num_class=5, dropout_rate=0.0)
HOOK = dict(num_frames=4, side_size=64, crop_size=64)


def _action_hooks():
    model = jax_hub.slow_r50_detection(**SLOW)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3)), jnp.zeros((1, 5)), False))
    variables = random_variables(shapes, seed=12)
    ours = engine.ActionDetectionHook(
        state_dict=jax_variables_to_state_dict(variables["params"], variables["batch_stats"]),
        device="cpu", **HOOK, **SLOW)
    theirs = jax_engine.ActionDetectionHook(variables=variables, **HOOK, **SLOW)
    return ours, theirs


def test_action_detection_hook_matches_jax_s():
    ours, theirs = _action_hooks()
    video = np.random.default_rng(13).integers(0, 256, (6, 48, 80, 3)).astype(np.uint8)
    # 48x80 -> 64x106, centre crop x0 = 21: boxes across the crop's left and
    # right edges, one inside and one left of it.
    boxes = np.array([[2.0, 4.0, 30.0, 40.0], [50.0, 0.0, 79.0, 47.0], [25.0, 10.0, 45.0, 30.0],
                      [0.0, 5.0, 12.0, 20.0]], np.float32)
    scores = ours.run({"video": torch.from_numpy(video), "bbox_coordinates": boxes})
    ref = theirs.run({"video": video.astype(np.float32), "bbox_coordinates": boxes})
    assert scores["action_scores"].shape == (4, 5, 1, 1, 1)
    np.testing.assert_allclose(np.moveaxis(scores["action_scores"].numpy(), 1, -1),
                               np.asarray(ref["action_scores"]), **TOL)

    # Through both engines, the boxes from a person hook.
    status = {"loaded_image": video[0], "video": torch.from_numpy(video)}
    people = engine.PeopleDetectionHook(predictor=lambda image: boxes)
    out = engine.NeuralEngine([ours, people]).run(dict(status))
    ref = jax_engine.NeuralEngine([theirs, jax_engine.PeopleDetectionHook(
        predictor=lambda image: boxes)]).run({**status, "video": video.astype(np.float32)})
    np.testing.assert_array_equal(out["bbox_coordinates"].numpy(), ref["bbox_coordinates"])
    np.testing.assert_allclose(np.moveaxis(out["action_scores"].numpy(), 1, -1),
                               np.asarray(ref["action_scores"]), **TOL)


def test_action_detection_hook_refuses_a_pathway_model_as_jax_s_fails():
    kw = dict(stem_dim_outs=(16, 2), stage_depths=(1, 1, 1, 1), model_num_class=5,
              head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)))
    with pytest.raises(AssertionError, match="pathway"):
        jax_engine.ActionDetectionHook(model_name="slowfast_r50_detection", **HOOK, **kw)
    with pytest.raises(ValueError, match="pathway"):
        engine.ActionDetectionHook(model_name="slowfast_r50_detection", device="cpu",
                                   **HOOK, **kw)


# --- the detection hooks ------------------------------------------------------------------

def _stub_predictor(image):
    return {"boxes": np.asarray([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0], [0, 1, 2, 3]]),
            "labels": np.asarray([1, 17, 1]),
            "scores": np.asarray([0.9, 0.8, 0.75]),
            "keypoints": np.arange(3 * 17 * 3, dtype=np.float32).reshape(3, 17, 3)}


def test_executors_match_jax_s():
    for name in ("people_detection_executor", "people_keypoints_executor"):
        out = getattr(engine, name)(None, _stub_predictor)
        ref = getattr(jax_engine, name)(None, _stub_predictor)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)
    hook = engine.PeopleDetectionHook()
    frame = np.zeros((30, 50, 3), np.uint8)
    np.testing.assert_array_equal(hook.run({"loaded_image": frame})["bbox_coordinates"].numpy(),
                                  jax_engine.PeopleDetectionHook().run(
                                      {"loaded_image": frame})["bbox_coordinates"])


def test_generate_predictor_refusals(monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        engine.generate_predictor({"backend": "detectron2", "model": "x"}, device="cpu")
    monkeypatch.setitem(sys.modules, "torchvision", None)
    config = {"backend": "torchvision", "model": "fasterrcnn_resnet50_fpn"}
    with pytest.raises(ImportError, match="torchvision"):
        engine.generate_predictor(config, device="cpu")
    with pytest.raises(ImportError, match="torchvision"):
        engine.Detectron2PeopleDetectionHook(device="cpu")
    with pytest.raises(ImportError, match="torchvision"):
        engine.PeopleKeypointDetectionHook(device="cpu")


class _StubDetector(torch.nn.Module):
    """A stand-in for a torchvision detector: two detections per frame, the
    first scored by the frame's mean and the second below the threshold."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones(()))

    def forward(self, frames):
        return [{"boxes": torch.tensor([[0.0, 0.0, 4.0, 3.0], [1.0, 1.0, 2.0, 2.0]]),
                 "scores": torch.stack([f.mean() * self.gain, torch.tensor(0.1)]),
                 "labels": torch.tensor([1, 1])} for f in frames]


def _stub_torchvision(monkeypatch, fetch_error=None):
    """A torchvision whose one builder records its arguments and raises
    ``fetch_error`` where it is asked for pretrained weights."""
    import types

    calls = []

    def stub_rcnn(weights=None, weights_backbone="IMAGENET1K_V1"):
        calls.append((weights, weights_backbone))
        if weights is not None and fetch_error is not None:
            raise fetch_error
        return _StubDetector()

    tv = types.ModuleType("torchvision")
    tv.models = types.SimpleNamespace(detection=types.SimpleNamespace(stub_rcnn=stub_rcnn))
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    return calls


def test_generate_predictor_never_falls_back_to_random_weights_unasked(monkeypatch, tmp_path):
    config = {"backend": "torchvision", "model": "stub_rcnn", "threshold": 0.5}
    frame = np.full((3, 4, 3), 255, np.uint8)
    # Pretrained weights that cannot be fetched raise, naming the way out.
    calls = _stub_torchvision(monkeypatch, fetch_error=OSError("no network"))
    with pytest.raises(RuntimeError, match=r"cannot fetch.*state_dict"):
        engine.generate_predictor(config, device="cpu")
    assert calls == [("DEFAULT", "IMAGENET1K_V1")]
    # Any other failure of the builder is not hidden.
    _stub_torchvision(monkeypatch, fetch_error=ValueError("bad config"))
    with pytest.raises(ValueError, match="bad config"):
        engine.generate_predictor(config, device="cpu")
    # A random init only when asked for, with a warning; nothing fetched.
    calls = _stub_torchvision(monkeypatch, fetch_error=OSError("no network"))
    with pytest.warns(UserWarning, match="randomly initialised"):
        predictor = engine.generate_predictor({**config, "weights": None}, device="cpu")
    assert calls == [(None, None)]
    out = predictor(frame)
    assert out["scores"].tolist() == [1.0] and out["boxes"].shape == (1, 4)
    # A local state dict, as a dict or a saved file, loaded strictly.
    weights = {"gain": torch.tensor(0.25)}
    torch.save(weights, tmp_path / "detector.pt")
    for state_dict in (weights, str(tmp_path / "detector.pt")):
        calls = _stub_torchvision(monkeypatch, fetch_error=OSError("no network"))
        predictor = engine.generate_predictor({**config, "state_dict": state_dict,
                                               "threshold": 0.0}, device="cpu")
        assert calls == [(None, None)]
        assert predictor(frame)["scores"].tolist() == pytest.approx([0.25, 0.1])
    with pytest.raises(RuntimeError, match="gain"):
        engine.generate_predictor({**config, "state_dict": {"bias": torch.zeros(())}},
                                  device="cpu")


def test_image_load_hook_reads_a_png_as_jax_s(tmp_path, monkeypatch):
    import cv2

    image = create_dummy_video_frames(1, 21, 34)[0]
    path = str(tmp_path / "frame.png")
    assert cv2.imwrite(path, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    out = engine.ImageLoadHook().run({"image_path": path})["loaded_image"]
    ref = jax_engine.ImageLoadHook().run({"image_path": path})["loaded_image"]
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), image)
    with pytest.raises(IOError):
        engine.image_load_executor(str(tmp_path / "missing.png"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        engine.image_load_executor(path)
