"""The port's model-zoo eval harness (examples_torch/eval_kinetics.py)
against the JAX package's (examples/eval_kinetics.py): the same synthetic
videos, written by the JAX script's writer and decoded by the one native
library in both packages, the same seeded weights (carried over with
zoo/from_jax.py), a tiny X3D-XS and a tiny MViT; then the golden fixture
(sum 100% top-1, max 0%) and the 14 eval configurations.

Tolerances: the ensembled logits rtol 5e-3 / atol 5e-4, the repo's f32
model tolerance (tests/test_models_parity.py:24); predictions, top-1 and
top-5 equal, videos whose top-two margin in the JAX run lies within twice
that bound excluded (the test prints how many).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from examples_torch import eval_kinetics
from pytorchvideo_tpu.data import encoded_video_native as jax_native
from pytorchvideo_tpu.data import native_pipeline as jax_pipeline
from pytorchvideo_tpu.models import create_multiscale_vision_transformers as jax_create_mvit
from pytorchvideo_tpu.train import train_loop as jax_train_loop
from pytorchvideo_tpu_torch.data import native_build
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from torch_port_helpers import SMALL_MVIT, TOL, build_mvit_pair, build_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_import_eval_chain.py:64-69's tiny X3D-XS.
TINY_X3D = dict(input_clip_length=4, input_crop_size=96, depth_factor=0.34, dropout_rate=0.0)


def jax_eval_kinetics():
    """examples/eval_kinetics.py as a module of its own name (its directory
    is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_kinetics", os.path.join(REPO, "examples", "eval_kinetics.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def library():
    missing = native_build.missing_tools()
    if missing:
        pytest.skip("the native decoder cannot be built here: missing " + ", ".join(missing))
    return str(native_build.build_library())


@pytest.fixture
def jax_on_the_same_library(library, monkeypatch):
    """The JAX harness's ``decoder="native"`` loads the port's library (its
    loader caches a miss, emptied here), so both decode the same frames."""
    monkeypatch.setenv("PVT_DECODE_LIB", library)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_LIB_TRIED", False)
    monkeypatch.setattr(jax_pipeline, "_PIPE_BOUND", False)


def test_eval_configs_match_jax():
    from pytorchvideo_tpu_torch.models import hub

    assert eval_kinetics.EVAL_CONFIGS == jax_eval_kinetics().EVAL_CONFIGS
    assert len(eval_kinetics.EVAL_CONFIGS) == 14
    for name in eval_kinetics.EVAL_CONFIGS:
        assert callable(getattr(hub, name)), name


def test_synthetic_videos_match_jax_writer(tmp_path):
    (tmp_path / "ours").mkdir()
    (tmp_path / "theirs").mkdir()
    ours = eval_kinetics.make_synthetic_dataset(str(tmp_path / "ours"), num_videos=2, seconds=0.5)
    theirs = jax_eval_kinetics().make_synthetic_dataset(str(tmp_path / "theirs"), num_videos=2,
                                                        seconds=0.5)
    for a, b in zip(open(ours).read().split(), open(theirs).read().split()):
        if a.endswith(".avi"):
            assert open(a, "rb").read() == open(b, "rb").read()
        else:
            assert a == b


def _x3d_pair():
    jax_model, variables, torch_model, _ = build_pair(seed=3, model_num_class=4, **TINY_X3D)
    geometry = dict(num_frames=4, sampling_rate=4, side_size=110, crop_size=96,
                    clips_per_video=2, spatial_crops=3, alpha=None, batch_size=6, fps=10.0)
    return jax_model, variables, torch_model, geometry


def _mvit_pair():
    jax_model, variables, torch_model, _ = build_mvit_pair(
        jax_create_mvit, create_multiscale_vision_transformers, seed=4, **SMALL_MVIT)
    geometry = dict(num_frames=4, sampling_rate=4, side_size=36, crop_size=32,
                    clips_per_video=2, spatial_crops=1, alpha=None, batch_size=4, fps=10.0)
    return jax_model, variables, torch_model, geometry


@pytest.mark.parametrize("pair", [_x3d_pair, _mvit_pair], ids=["x3d_xs", "mvit"])
def test_eval_matches_jax(pair, tmp_path, jax_on_the_same_library, monkeypatch):
    jax_harness = jax_eval_kinetics()
    csv = jax_harness.make_synthetic_dataset(str(tmp_path), num_videos=3, num_classes=4,
                                             seconds=1.6, fps=10)
    jax_model, variables, torch_model, geometry = pair()

    jax_ensembled = []
    ensemble = jax_train_loop.ensemble_video_level

    def recording_ensemble(*args, **kwargs):
        out = ensemble(*args, **kwargs)
        jax_ensembled.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_train_loop, "ensemble_video_level", recording_ensemble)
    theirs = jax_harness.evaluate(jax_model, variables, csv, **geometry)
    record = {}
    ours = eval_kinetics.evaluate(torch_model, csv, record=record, **geometry)

    ref = jax_ensembled[0]
    got = record["ensembled"].numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert record["batches"] == -(-3 * 2 * geometry["spatial_crops"] // geometry["batch_size"])
    assert sorted(record["video_index"].tolist()) == sorted(
        [v for v in range(3) for _ in range(2 * geometry["spatial_crops"])])

    top2 = -np.sort(-ref, axis=-1)[:, :2]
    bound = TOL["atol"] + TOL["rtol"] * np.abs(ref).max(-1)
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bound
    print(f"{int((~decided).sum())} of {len(ref)} videos excluded: top-two margin within "
          f"twice the bound")
    assert decided.any()
    for key in ("num_videos", "views"):
        assert ours[key] == theirs[key]
    predictions = np.asarray(ours["predictions"])
    np.testing.assert_array_equal(predictions[decided], np.asarray(theirs["predictions"])[decided])
    if decided.all():
        assert (ours["top1"], ours["top5"]) == (theirs["top1"], theirs["top5"])


class BrightnessModel(torch.nn.Module):
    """Scores -(mean brightness - centre_k)^2 per class
    (tests/test_eval_harness.py:71's model)."""

    def __init__(self, centers_b):
        super().__init__()
        self.centers = torch.nn.Parameter(
            torch.tensor((centers_b / 255.0 - 0.45) / 0.225, dtype=torch.float32))

    def forward(self, x):
        m = x.mean(dim=tuple(range(1, x.dim())))
        return -torch.square(m[:, None] - self.centers[None, :])


def test_eval_golden_fixture(tmp_path, library):
    """The port's copy of tests/test_eval_harness.py:38: each video's first
    clip is misclassified on its own, the sum over both clips recovers the
    class and the max picks the wrong one, so sum gives 100% top-1 and max
    0%."""
    import cv2

    centers_b = np.array([40.0, 100.0, 160.0, 220.0])
    b1 = np.where(np.arange(4) == 0, centers_b + 55, centers_b - 55)
    b2 = np.where(np.arange(4) == 0, centers_b - 15, centers_b + 15)
    csv = tmp_path / "val.csv"
    with open(csv, "w") as f:
        for k in range(4):
            p = str(tmp_path / f"v{k}.avi")
            wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"FFV1"), 4, (64, 64))
            for b in [b1[k]] * 4 + [b2[k]] * 4:
                wr.write(np.full((64, 64, 3), int(b), np.uint8))
            wr.release()
            f.write(f"{p} {k}\n")
    model = BrightnessModel(centers_b)
    results = {
        method: eval_kinetics.evaluate(
            model, str(csv), num_frames=4, sampling_rate=1, side_size=64, crop_size=64,
            clips_per_video=2, spatial_crops=1, alpha=None, batch_size=4, fps=4.0,
            ensemble_method=method)
        for method in ("sum", "max")
    }
    assert results["sum"]["num_videos"] == 4
    assert results["sum"]["views"] == "2x1"
    assert results["sum"]["top1"] == 100.0
    assert results["max"]["top1"] == 0.0


def test_array_videos_through_the_seam_match_the_decoder(tmp_path, library):
    """Frames handed over through ``video_path_handler`` give what the
    decoder gives on the same frames written losslessly: the same
    ensembled logits, bit for bit, SlowFast's pathway lists included."""
    from pytorchvideo_tpu_torch.data.utils import export_video_array
    from pytorchvideo_tpu_torch.models import hub

    rng = np.random.default_rng(5)
    videos = {f"v{i}": torch.from_numpy(rng.integers(0, 256, (15, 40, 52, 3), np.uint8))
              for i in range(2)}
    for name, frames in videos.items():
        export_video_array(frames, str(tmp_path / f"{name}.avi"), 10)
    written = eval_kinetics.write_csv(str(tmp_path / "files.csv"),
                                      [(str(tmp_path / f"{n}.avi"), i) for i, n in
                                       enumerate(videos)])
    named = eval_kinetics.write_csv(str(tmp_path / "names.csv"),
                                    [(n, i) for i, n in enumerate(videos)])
    torch.manual_seed(0)
    model = hub.slowfast_r50(stage_depths=(1, 1, 1, 1), head_pool_kernel_sizes=((2, 1, 1), (8, 1, 1)),
                             model_num_class=5, dropout_rate=0.0, device="cpu").eval()
    geometry = dict(num_frames=8, sampling_rate=1, side_size=36, crop_size=32,
                    clips_per_video=2, spatial_crops=3, alpha=4, batch_size=5, fps=10.0)
    decoded, handed = {}, {}
    eval_kinetics.evaluate(model, written, record=decoded, **geometry)
    eval_kinetics.evaluate(model, named, record=handed,
                           video_path_handler=eval_kinetics.ArrayVideoPathHandler(videos, 10),
                           **geometry)
    assert torch.equal(decoded["ensembled"], handed["ensembled"])
    assert sorted(handed["video_index"].tolist()) == [0] * 6 + [1] * 6


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_kinetics.main(["--model", "x3d_xs", "--synthetic"])
