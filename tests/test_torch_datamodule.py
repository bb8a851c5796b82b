"""The port's datamodule (pytorchvideo_tpu_torch/train/datamodule.py) against
the JAX package's on the same tiny videos, and the port's app built without
a datamodule, training from them on the CPU.

Tolerance: the JAX module's host batches are float64 (numpy uint8 / 255.0),
the port's float32: rtol 1e-5, atol 2e-5 after normalize. The chains resize
normalized clips, whose neighbouring values differ by up to 4.4, and
``F.interpolate`` forms its source coordinates in float32: a weight off by
~1e-6 (float32's spacing at a coordinate of 40 is 3.8e-6) moves a value by
up to ~1e-5 against float64's. Labels and indices exact. The JAX module
builds its random draws unseeded; the test gives them the port's seeds
(``dataset_seeds``, ``transform_seeds``) in the order the JAX module draws
them.
"""

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.train import config as jax_config
from pytorchvideo_tpu.train.datamodule import (
    VideoClassificationDataModule as JaxDataModule,
)
from pytorchvideo_tpu_torch.data.utils import export_video_array
from pytorchvideo_tpu_torch.train import (
    DataConfig,
    ModelConfig,
    VideoClassificationDataModule,
    VideoClassificationTrainApp,
    VideoClassificationTrainConfig,
)
from pytorchvideo_tpu_torch.train.datamodule import dataset_seeds
from pytorchvideo_tpu_torch.transforms.transforms_factory import transform_seeds

NORMALIZED = dict(rtol=1e-5, atol=2e-5)
FPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Four 2-second videos of 32x40 frames in two class directories."""
    root = tmp_path_factory.mktemp("clips")
    y, x = np.mgrid[0:32, 0:40]
    for i in range(4):
        cls = root / f"class_{i % 2}"
        cls.mkdir(exist_ok=True)
        base = np.random.default_rng(i).integers(0, 256, size=(1, 32, 40, 3))
        frames = (base + (x + y)[None, :, :, None] * (i + 1)
                  + 7 * np.arange(16)[:, None, None, None]) % 256
        export_video_array(torch.from_numpy(frames.astype(np.uint8)), str(cls / f"v{i}.avi"), FPS)
    return str(root)


def _configs(video_dir, **data):
    fields = dict(data_path=video_dir, clip_duration=1.0, clips_per_video=2, batch_size=2,
                  num_samples=4, min_size=32, max_size=36, crop_size=28)
    fields.update(data)
    return DataConfig(**fields), jax_config.DataConfig(**fields)


def _jax_batches(monkeypatch, jax_module, mode, seeds, steps):
    """The JAX module's batches with its unseeded generators given ``seeds``."""
    original = np.random.default_rng
    queue = list(seeds)

    def default_rng(seed=None):
        return original(queue.pop(0) if seed is None else seed)

    monkeypatch.setattr(np.random, "default_rng", default_rng)
    try:
        loader = getattr(jax_module, f"{mode}_dataloader")(steps)
        batches = list(loader)
    finally:
        monkeypatch.undo()
    assert not queue
    return batches


def _cthw(a):
    return np.moveaxis(np.asarray(a), -1, -4)


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == {"video", "label", "video_index", "clip_index", "aug_index"} == set(b)
        videos_a = a["video"] if isinstance(a["video"], list) else [a["video"]]
        videos_b = b["video"] if isinstance(b["video"], list) else [b["video"]]
        assert len(videos_a) == len(videos_b)
        for va, vb in zip(videos_a, videos_b):
            assert va.dtype == torch.float32 and va.device.type == "cpu"
            np.testing.assert_allclose(va.numpy(), _cthw(vb), **NORMALIZED)
        for k in ("label", "video_index", "clip_index", "aug_index"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("alpha", [None, 2])
def test_train_batches_equal_jax_s(monkeypatch, video_dir, alpha):
    ours_cfg, jax_cfg = _configs(video_dir)
    ours = VideoClassificationDataModule(ours_cfg, ModelConfig(slowfast_alpha=alpha),
                                         device="cpu", seed=17)
    theirs = JaxDataModule(jax_cfg, jax_config.ModelConfig(slowfast_alpha=alpha))
    for call in range(2):  # a new dataset, and new seeds, per call
        clip_seed, transform_seed, sampler_seed = dataset_seeds(17, "train", call)
        seeds = [clip_seed, *transform_seeds(transform_seed, 4)[:3], sampler_seed]
        got = list(ours.train_dataloader(2))
        _same_batches(got, _jax_batches(monkeypatch, theirs, "train", seeds, 2))
    video = got[0]["video"][-1] if alpha else got[0]["video"]
    assert video.shape == (2, 3, 4, 28, 28)
    assert video.is_contiguous(memory_format=torch.channels_last_3d)
    if alpha:
        assert got[0]["video"][0].shape == (2, 3, 2, 28, 28)


@pytest.mark.parametrize("val_3crop,alpha", [(False, None), (True, None), (True, 2)])
def test_val_batches_equal_jax_s(monkeypatch, video_dir, val_3crop, alpha):
    ours_cfg, jax_cfg = _configs(video_dir, val_3crop=val_3crop)
    ours = VideoClassificationDataModule(ours_cfg, ModelConfig(slowfast_alpha=alpha),
                                         device="cpu", num_workers=0)
    theirs = JaxDataModule(jax_cfg, jax_config.ModelConfig(slowfast_alpha=alpha))
    got = list(ours.val_dataloader(None))
    _same_batches(got, _jax_batches(monkeypatch, theirs, "val", [], None))
    # 4 videos x 2 clips (x 3 crops) in batches of 2.
    assert len(got) == 4 * 2 * (3 if val_3crop else 1) // 2


def test_threaded_loader_yields_the_same_clips(video_dir):
    cfg, _ = _configs(video_dir)
    sequential = VideoClassificationDataModule(cfg, device="cpu", num_workers=0)
    threaded = VideoClassificationDataModule(cfg, device="cpu", num_workers=3)

    def clips(module):
        out = {}
        for b in module.val_dataloader(None):
            for i in range(len(b["label"])):
                out[(int(b["video_index"][i]), int(b["clip_index"][i]))] = b["video"][i]
        return out

    a, b = clips(sequential), clips(threaded)
    assert a.keys() == b.keys() and len(a) == 8
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_app_without_a_datamodule_trains_from_the_videos(video_dir):
    cfg = VideoClassificationTrainConfig(
        model=ModelConfig(name="x3d_xs", num_classes=2, clip_length=4, crop_size=32,
                          kwargs=dict(width_factor=1.0, depth_factor=0.5, head_dim_out=32,
                                      dropout_rate=0.0)),
        data=_configs(video_dir, crop_size=32)[0])
    cfg.trainer.log_every_n_steps = 1
    app = VideoClassificationTrainApp(cfg, steps_per_epoch=2, device="cpu", seed=3)
    assert isinstance(app.datamodule, VideoClassificationDataModule)
    assert app.datamodule.device == torch.device("cpu") and app.datamodule.seed == 3
    losses = app.train()
    assert len(losses) == 2 and all(np.isfinite(losses)) and app.state.step == 2
