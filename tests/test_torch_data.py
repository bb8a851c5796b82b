"""The port's data feed (pytorchvideo_tpu_torch/data) against the JAX
package's: clip samplers, video samplers, path lists, OpenCV decoding, the
labeled video dataset (through ``__next__`` and BatchLoader's plan/load
threads), the packed ClipStore read across the two packages, and the
prefetch on the CPU. Tiny lossless videos (FFV1 in AVI, 32x40 frames) are
written with OpenCV, which this machine has (the card's machine has no
decoder: the data tests run here).

Tolerances: everything exact. Decoded clips are uint8 in the port and
float32 [0, 255] in the JAX package: equal values.
"""

import os
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.data import clip_sampling as jax_cs
from pytorchvideo_tpu.data import samplers as jax_samplers
from pytorchvideo_tpu.data.clip_store import ClipStore as JaxClipStore
from pytorchvideo_tpu.data.clip_store import prepare_clip_store as jax_prepare_clip_store
from pytorchvideo_tpu.data.encoded_video import EncodedVideo as JaxEncodedVideo
from pytorchvideo_tpu.data.labeled_video_dataset import (
    labeled_video_dataset as jax_labeled_video_dataset,
)
from pytorchvideo_tpu.data.labeled_video_paths import LabeledVideoPaths as JaxPaths
from pytorchvideo_tpu.data.utils import pts_to_secs as jax_pts_to_secs
from pytorchvideo_tpu.data.utils import secs_to_pts as jax_secs_to_pts
from pytorchvideo_tpu_torch.data import (
    BatchLoader,
    ClipStore,
    DistributedSampler,
    EncodedVideo,
    LabeledVideoPaths,
    RandomSampler,
    SequentialSampler,
    device_prefetch,
    labeled_video_dataset,
    prepare_clip_store,
)
from pytorchvideo_tpu_torch.data import clip_sampling as cs
from pytorchvideo_tpu_torch.data.utils import (
    export_video_array,
    optional_threaded_foreach,
    pts_to_secs,
    secs_to_pts,
    thwc_to_cthw,
)

FPS = 8
FRAMES = (16, 12, 20, 9)  # 2 s, 1.5 s, 2.5 s, 1.125 s


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, seed):
    y, x = np.mgrid[0:32, 0:40]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(1, 32, 40, 3))
    ramp = (x + y)[None, :, :, None] + 9 * np.arange(n)[:, None, None, None]
    return ((base + ramp) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Four videos in two class directories, and a csv of them; returns
    (root, csv path, {path: frames})."""
    root = tmp_path_factory.mktemp("videos")
    frames = {}
    for i, n in enumerate(FRAMES):
        cls = root / f"class_{i % 2}"
        cls.mkdir(exist_ok=True)
        path = str(cls / f"v{i}.avi")
        frames[path] = _frames(n, i)
        export_video_array(torch.from_numpy(frames[path]), path, FPS)
    csv = root / "list.csv"
    csv.write_text("".join(f"{p} {i % 3}\n" for i, p in enumerate(sorted(frames))))
    return root, str(csv), frames


def _infos(sampler, duration, steps=12):
    out, last = [], None
    for _ in range(steps):
        info = sampler(last, duration, {})
        out.append(tuple(info))
        last = info[1]
        is_last = info[4][-1] if isinstance(info[4], list) else info[4]
        if is_last:
            break
    return out


SAMPLERS = [
    ("uniform", lambda m: m.UniformClipSampler(Fraction(1, 2))),
    ("uniform stride", lambda m: m.UniformClipSampler(1.0, stride=0.75)),
    ("uniform backpad", lambda m: m.UniformClipSampler(0.8, stride=0.5, backpad_last=True)),
    ("truncate", lambda m: m.UniformClipSamplerTruncateFromStart(0.5, truncation_duration=1.2)),
    ("constant", lambda m: m.ConstantClipsPerVideoSampler(0.75, 4, 3)),
    ("random", lambda m: m.RandomClipSampler(0.5, np.random.default_rng(3))),
    ("random multi", lambda m: m.RandomMultiClipSampler(0.4, 3, np.random.default_rng(4))),
    ("random multi truncate", lambda m: m.RandomMultiClipSamplerTruncateFromStart(
        0.4, 2, truncation_duration=1.0, rng=np.random.default_rng(5))),
    ("factory", lambda m: m.make_clip_sampler("constant_clips_per_video", 1.0, 2)),
]


@pytest.mark.parametrize("name,make", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_clip_samplers_give_jax_s_clip_infos(name, make):
    ours, theirs = make(cs), make(jax_cs)
    for duration in (2.0, Fraction(3, 2), 0.3, 5.25):
        for _ in range(2):  # the state carries over, and reset() restarts it
            assert _infos(ours, duration) == _infos(theirs, duration)
        ours.reset()
        theirs.reset()
    with pytest.raises(NotImplementedError):
        cs.make_clip_sampler("nope", 1.0)


def test_video_samplers_order_as_jax_s():
    data = list(range(11))
    for seed in range(3):
        ours = RandomSampler(data, generator=np.random.default_rng(seed))
        theirs = jax_samplers.RandomSampler(data, generator=np.random.default_rng(seed))
        assert [list(ours) for _ in range(3)] == [list(theirs) for _ in range(3)]
        ours.manual_seed(seed + 7)
        theirs.manual_seed(seed + 7)
        assert list(ours) == list(theirs)
    assert list(SequentialSampler(data)) == list(jax_samplers.SequentialSampler(data))
    for kw in (dict(shuffle=True, seed=2), dict(shuffle=False), dict(drop_last=True, seed=1)):
        for rank in range(3):
            ours = DistributedSampler(data, 3, rank, **kw)
            theirs = jax_samplers.DistributedSampler(data, 3, rank, **kw)
            for epoch in range(2):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert list(ours) == list(theirs) and len(ours) == len(theirs)
    with pytest.raises(ValueError):
        DistributedSampler(data, 2, 2)


def test_paths_from_csv_and_directory(videos):
    root, csv, _ = videos
    for source in (csv, str(root)):
        if source == str(root):
            (root / "list.csv").rename(root / "list.txt")  # not a video, not a class dir
        try:
            ours, theirs = LabeledVideoPaths.from_path(source), JaxPaths.from_path(source)
            assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
        finally:
            if source == str(root):
                (root / "list.txt").rename(root / "list.csv")
    with pytest.raises(FileNotFoundError):
        LabeledVideoPaths.from_path(str(root / "missing"))


def test_decoded_clips_are_jax_s_frames_as_uint8(videos):
    _, _, frames = videos
    for path, data in frames.items():
        ours, theirs = EncodedVideo.from_path(path), JaxEncodedVideo.from_path(path)
        assert ours.duration == theirs.duration == len(data) / FPS
        for start, end in ((0, 0.5), (0.25, 1.0), (1.0, 0.75), (0.5, float("inf"))):
            a, b = ours.get_clip(start, end), theirs.get_clip(start, end)
            if b["video"] is None:
                assert a["video"] is None
                continue
            assert a["video"].dtype == torch.uint8
            np.testing.assert_array_equal(a["video"].numpy(), b["video"])
        # Lossless: the clip is the written frames.
        np.testing.assert_array_equal(ours.get_clip(0, float("inf"))["video"].numpy(), data)
        ours.close()
        theirs.close()
    # PyAV is not ported; "native" is the native decoder's class (its clips
    # are held against the JAX package's in test_torch_native_decoder.py).
    with pytest.raises(NotImplementedError, match="pyav"):
        EncodedVideo.from_path(path, decoder="pyav")
    from pytorchvideo_tpu_torch.data.encoded_video import select_video_class
    from pytorchvideo_tpu_torch.data.encoded_video_native import EncodedVideoNative

    assert select_video_class("native") is EncodedVideoNative


def _take(dataset, n):
    """Up to ``n`` samples of ``dataset``'s ``__next__``."""
    out = []
    for _ in range(n):
        try:
            out.append(next(dataset))
        except StopIteration:
            break
    return out


def _key(sample):
    return (int(sample["video_index"]), int(sample["clip_index"]), int(sample["aug_index"]))


def _same_samples(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            if k == "video":
                assert a[k].dtype == torch.uint8
                np.testing.assert_array_equal(a[k].numpy(), b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("sampling", ["uniform", "constant", "random"])
def test_dataset_samples_equal_jax_s(videos, sampling):
    root, csv, _ = videos
    make = {"uniform": lambda m: m.UniformClipSampler(0.5),
            "constant": lambda m: m.ConstantClipsPerVideoSampler(0.75, 2, 3),
            "random": lambda m: m.RandomClipSampler(0.5, np.random.default_rng(8))}[sampling]
    ours = labeled_video_dataset(csv, make(cs), video_sampler=SequentialSampler)
    theirs = jax_labeled_video_dataset(csv, make(jax_cs), video_sampler=jax_samplers.SequentialSampler)
    _same_samples(_take(ours, 9), _take(theirs, 9))
    # A seeded random video order: the JAX dataset's unseeded sampler given
    # the same generator.
    ours = labeled_video_dataset(str(root), make(cs), seed=5)
    theirs = jax_labeled_video_dataset(str(root), make(jax_cs))
    theirs._video_sampler.generator = np.random.default_rng(5)
    _same_samples(_take(ours, 6), _take(theirs, 6))


def test_batch_loader_decodes_the_dataset_s_clips_in_threads(videos):
    _, csv, _ = videos
    ours = labeled_video_dataset(csv, cs.ConstantClipsPerVideoSampler(0.5, 2, 2),
                                 video_sampler=SequentialSampler)
    theirs = jax_labeled_video_dataset(csv, jax_cs.ConstantClipsPerVideoSampler(0.5, 2, 2),
                                       video_sampler=jax_samplers.SequentialSampler)
    want = sorted((next(theirs) for _ in range(16)), key=_key)
    batches = list(BatchLoader(ours, batch_size=4, num_workers=3))
    got = sorted((dict(zip(b, values)) for b in batches for values in zip(*b.values())),
                 key=_key)
    assert len(batches) == 4 and batches[0]["video"].shape == (4, 4, 32, 40, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["video"].numpy(), b["video"])
        assert _key(a) == _key(b) and a["video_name"] == b["video_name"]
        assert int(a["label"]) == b["label"]
    # One worker takes the sequential __next__ path, in order.
    loader = BatchLoader(labeled_video_dataset(csv, cs.UniformClipSampler(0.5),
                                               video_sampler=SequentialSampler),
                         batch_size=3, num_workers=1, drop_last=False)
    flat = [int(v) for b in loader for v in b["clip_index"]]
    assert len(flat) == sum(n // (FPS // 2) for n in FRAMES)


def test_batch_loader_stops_its_workers_when_left_early():
    def endless():
        i = 0
        while True:
            yield {"x": i}
            i += 1

    before = threading.active_count()
    it = iter(BatchLoader(endless(), batch_size=2, num_workers=3))
    assert next(it)["x"].shape == (2,)
    it.close()
    assert threading.active_count() <= before


def test_stores_read_across_packages_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, size=(11, 4, 8, 10, 3)).astype(np.uint8)
    samples = [{"video": clips[i], "label": i % 4, "video_index": i // 2} for i in range(11)]
    ours_dir, theirs_dir = str(tmp_path / "ours"), str(tmp_path / "theirs")
    index = prepare_clip_store(
        [dict(s, video=torch.from_numpy(s["video"]).float()) for s in samples], ours_dir,
        clips_per_shard=4, num_workers=1)
    jax_index = jax_prepare_clip_store(samples, theirs_dir, clips_per_shard=4, num_workers=1)
    assert index == jax_index
    for name in sorted(os.listdir(theirs_dir)):
        with open(os.path.join(ours_dir, name), "rb") as a, \
                open(os.path.join(theirs_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    for ours, theirs in ((ClipStore(theirs_dir), JaxClipStore(ours_dir)),
                         (ClipStore(ours_dir), JaxClipStore(theirs_dir))):
        assert len(ours) == len(theirs) == 11 and ours.clip_shape == theirs.clip_shape
        for kw in (dict(batch_size=3, seed=4, epochs=2), dict(batch_size=4, shuffle=False,
                                                              drop_last=False)):
            got, want = list(ours.batches(**kw)), list(theirs.batches(**kw))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for k in a:
                    assert a[k].numpy().dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k].numpy(), b[k])
        idx = np.array([7, 0, 10, 3])
        np.testing.assert_array_equal(ours.gather(idx)["video"].numpy(), clips[idx])
    with pytest.raises(ValueError):
        next(ClipStore(ours_dir).batches(batch_size=12))


def test_store_of_decoded_clips(videos, tmp_path):
    _, csv, frames = videos
    dataset = labeled_video_dataset(csv, cs.UniformClipSampler(0.5),
                                    video_sampler=SequentialSampler)
    index = prepare_clip_store(dataset, str(tmp_path / "s"), clips_per_shard=3, num_workers=2)
    store = ClipStore(str(tmp_path / "s"))
    assert index["num_clips"] == len(store) == sum(n // (FPS // 2) for n in FRAMES)
    assert store.clip_shape == (4, 32, 40)


def test_device_prefetch_on_the_cpu():
    batches = [{"video": np.full((2, 3), i, np.uint8), "label": torch.tensor([i, i]),
                "name": ["a", "b"], "pathways": [np.zeros(2), np.ones(1)]} for i in range(5)]
    with device_prefetch(iter(batches), device="cpu", size=2) as stream:
        got = list(stream)
    assert len(got) == 5 and stream.pinned_allocations == 0
    for i, b in enumerate(got):
        assert isinstance(b["video"], torch.Tensor) and b["video"].device.type == "cpu"
        np.testing.assert_array_equal(b["video"].numpy(), batches[i]["video"])
        assert b["name"] == ["a", "b"] and torch.equal(b["label"], batches[i]["label"])
        assert isinstance(b["pathways"], list) and b["pathways"][1].dtype == torch.float64


def test_store_prefetch_gathers_into_the_prefetch_s_buffers(tmp_path):
    rng = np.random.default_rng(1)
    samples = [{"video": rng.integers(0, 256, size=(3, 6, 8, 3), dtype=np.uint8), "label": i,
                "video_index": i} for i in range(10)]
    prepare_clip_store(samples, str(tmp_path), clips_per_shard=4, num_workers=1)
    store = ClipStore(str(tmp_path))
    handed = []

    def out(name, shape, dtype):
        handed.append(name)
        return torch.full(shape, 7, dtype=dtype)

    idx = np.array([9, 2, 5])
    direct = store.gather(idx, out)
    assert handed == ["video", "label", "video_index"]
    for k, v in store.gather(idx).items():
        assert torch.equal(direct[k], v)
    seen = []

    def transform(batch):
        seen.append(threading.current_thread().name)
        return {**batch, "video": batch["video"].float() / 255}

    with store.prefetch(4, "cpu", transform=transform, seed=3, epochs=2) as stream:
        got = list(stream)
    want = list(store.batches(4, seed=3, epochs=2))
    assert len(got) == len(want) == 4 and set(seen) == {"device_prefetch"}
    for a, b in zip(got, want):
        torch.testing.assert_close(a["video"], b["video"].float() / 255, rtol=0, atol=0)
        assert torch.equal(a["label"], b["label"])
    assert list(store.batch_indices(4, shuffle=False, drop_last=False))[-1].tolist() == [8, 9]


def test_device_prefetch_raises_the_producer_s_error():
    def failing():
        yield {"x": np.zeros(1)}
        raise KeyError("boom")

    stream = device_prefetch(failing(), device="cpu")
    assert next(stream)["x"].shape == (1,)
    with pytest.raises(KeyError, match="boom"):
        next(stream)
    assert not stream.alive


def test_device_prefetch_close_stops_the_producer_mid_epoch():
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield {"x": np.full(4, i)}
                i += 1
        finally:
            closed.append(True)

    stream = device_prefetch(endless(), device="cpu", size=2)
    assert int(next(stream)["x"][0]) == 0
    time.sleep(0.3)  # the producer fills the queue and waits
    stream.close(timeout=10)
    assert not stream.alive and closed == [True]
    with pytest.raises(StopIteration):
        next(stream)


def test_utils_match_jax_s():
    for args in ((1.5, 1 / 30, 0), (2.0, Fraction(1, 25), 7), (float("inf"), 0.1, 0)):
        for mode in ("floor", "ceil"):
            assert secs_to_pts(*args, mode) == jax_secs_to_pts(*args, mode)
    assert pts_to_secs(90, 1 / 30, 3) == jax_pts_to_secs(90, 1 / 30, 3)
    x = torch.arange(24).view(1, 2, 3, 4)
    assert thwc_to_cthw(x).shape == (4, 1, 2, 3)
    seen = []
    lock = threading.Lock()

    def add(a, b):
        with lock:
            seen.append(a + b)

    for threaded in (False, True):
        seen.clear()
        optional_threaded_foreach(add, [(1, 2), (3, 4)], threaded)
        assert sorted(seen) == [3, 7]
