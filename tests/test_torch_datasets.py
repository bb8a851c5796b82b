"""The port's dataset families of labelled videos against the JAX
package's: Kinetics and UCF101, HMDB51 (split files), Charades (per-frame
label lists), SSv2 (segment sampling) and the JSON datasets, with
``UntrimmedClipSampler``. The same files go through both packages: tiny
lossless videos (FFV1 in AVI, 32x40) and PNG frames written with OpenCV,
which this machine has, and annotations written by the tests (the card's
machine has no decoder: the dataset tests run here).

Tolerances: everything exact. Clips are uint8 in the port and float32
[0, 255] in the JAX package: equal values. SSv2's random segment draws come
from a ``torch.Generator`` in the port and a numpy one in the JAX package,
so those are checked for membership (each draw inside its segment).
"""

import json
import os

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.data import clip_sampling as jax_cs
from pytorchvideo_tpu.data import samplers as jax_samplers
from pytorchvideo_tpu.data.charades import Charades as JaxCharades
from pytorchvideo_tpu.data.hmdb51 import Hmdb51 as JaxHmdb51
from pytorchvideo_tpu.data.hmdb51 import Hmdb51LabeledVideoPaths as JaxHmdbPaths
from pytorchvideo_tpu.data.json_dataset import UntrimmedClipSampler as JaxUntrimmed
from pytorchvideo_tpu.data.json_dataset import clip_recognition_dataset as jax_clip_recognition
from pytorchvideo_tpu.data.json_dataset import video_only_dataset as jax_video_only
from pytorchvideo_tpu.data.kinetics import Kinetics as JaxKinetics
from pytorchvideo_tpu.data.ssv2 import SSv2 as JaxSSv2
from pytorchvideo_tpu.data.ucf101 import Ucf101 as JaxUcf101
from pytorchvideo_tpu_torch.data import (
    Charades,
    Hmdb51,
    Hmdb51LabeledVideoPaths,
    Kinetics,
    SequentialSampler,
    SSv2,
    Ucf101,
    UntrimmedClipSampler,
    clip_recognition_dataset,
    labeled_video_dataset,
    video_only_dataset,
)
from pytorchvideo_tpu_torch.data import clip_sampling as cs
from pytorchvideo_tpu_torch.data.utils import export_video_array
from torch_port_helpers import assert_same_sample

FPS = 8
FRAMES = (16, 12, 20)  # 2 s, 1.5 s, 2.5 s


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, seed, h=32, w=40):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(1, h, w, 3))
    ramp = (x + y)[None, :, :, None] + 9 * np.arange(n)[:, None, None, None]
    return ((base + ramp) % 256).astype(np.uint8)


def _write_png_frames(directory, names, seed):
    import cv2

    os.makedirs(directory, exist_ok=True)
    frames = _frames(len(names), seed)
    for frame, name in zip(frames, names):
        assert cv2.imwrite(os.path.join(directory, name), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return [os.path.join(directory, name) for name in names]


def _take(dataset, n):
    out = []
    for _ in range(n):
        try:
            out.append(next(dataset))
        except StopIteration:
            break
    return out


def _same(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a["video"].dtype == torch.uint8
        assert_same_sample(a, b)


@pytest.fixture(scope="module")
def class_videos(tmp_path_factory):
    """Three videos in two class directories, and a csv of them."""
    root = tmp_path_factory.mktemp("class_videos")
    paths = []
    for i, n in enumerate(FRAMES):
        cls = root / f"class_{i % 2}"
        cls.mkdir(exist_ok=True)
        path = str(cls / f"v{i}.avi")
        export_video_array(torch.from_numpy(_frames(n, i)), path, FPS)
        paths.append(path)
    csv = root / "list.csv"
    csv.write_text("".join(f"{p} {i % 3}\n" for i, p in enumerate(paths)))
    return root, str(csv)


@pytest.mark.parametrize("ours,theirs", [(Kinetics, JaxKinetics), (Ucf101, JaxUcf101)],
                         ids=["kinetics", "ucf101"])
def test_kinetics_and_ucf101_give_jax_s_samples(class_videos, ours, theirs):
    assert ours is labeled_video_dataset
    root, csv = class_videos
    for source in (csv, str(root)):
        a = ours(source, cs.UniformClipSampler(0.5), video_sampler=SequentialSampler)
        b = theirs(source, jax_cs.UniformClipSampler(0.5),
                   video_sampler=jax_samplers.SequentialSampler)
        _same(_take(a, 12), _take(b, 12))
    a = ours(csv, cs.RandomClipSampler(0.75, np.random.default_rng(3)), seed=4)
    b = theirs(csv, jax_cs.RandomClipSampler(0.75, np.random.default_rng(3)))
    b._video_sampler.generator = np.random.default_rng(4)
    _same(_take(a, 6), _take(b, 6))


@pytest.fixture(scope="module")
def hmdb(tmp_path_factory):
    """Two actions' videos under ``videos/<action>/`` and fold 1 and 2 split
    files under ``folds/``."""
    root = tmp_path_factory.mktemp("hmdb")
    names = {"brush_hair": ["April_09_brush_hair_u_nm_np1_ba_goo_0.avi",
                            "Blonde_1_brush_hair_f_cm_np2_le_med_1.avi"],
             "wave": ["Hand_wave_h_nm_np1_fr_bad_0.avi",
                      "likebeckam_wave_f_cm_np1_ri_goo_2.avi"]}
    (root / "folds").mkdir()
    for a, (action, files) in enumerate(names.items()):
        (root / "videos" / action).mkdir(parents=True)
        for v, name in enumerate(files):
            export_video_array(torch.from_numpy(_frames(FRAMES[v], 10 * a + v)),
                               str(root / "videos" / action / name), FPS)
        for fold, types in ((1, (1, 2)), (2, (2, 0))):
            lines = "".join(f"{name} {t}\n" for name, t in zip(files, types))
            (root / "folds" / f"{action}_test_split{fold}.txt").write_text(lines)
    return root


def test_hmdb51_split_files_and_samples_match_jax_s(hmdb):
    folds = str(hmdb / "folds")
    for fold in (1, 2):
        for split in ("train", "test", "unused"):
            try:
                theirs = JaxHmdbPaths.from_dir(folds, fold, split)
            except AssertionError:
                with pytest.raises(ValueError):
                    Hmdb51LabeledVideoPaths.from_dir(folds, fold, split)
                continue
            ours = Hmdb51LabeledVideoPaths.from_dir(folds, fold, split)
            ours.path_prefix = theirs.path_prefix = "/data"
            assert len(ours) == len(theirs) > 0
            assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
    assert Hmdb51LabeledVideoPaths.from_dir(folds, 1, "train")[0][1]["meta_tags"] == [
        "u", "nm", "np1", "ba", "goo"]
    with pytest.raises(ValueError):
        Hmdb51LabeledVideoPaths.from_dir(folds, 4)
    with pytest.raises(ValueError):
        Hmdb51LabeledVideoPaths.from_csvs([str(hmdb / "videos" / "wave" /
                                                "Hand_wave_h_nm_np1_fr_bad_0.avi")])
    for split in ("train", "test"):
        ours = Hmdb51(folds, cs.UniformClipSampler(0.75), video_sampler=SequentialSampler,
                      video_path_prefix=str(hmdb / "videos"), split_type=split)
        theirs = JaxHmdb51(folds, jax_cs.UniformClipSampler(0.75),
                           video_sampler=jax_samplers.SequentialSampler,
                           video_path_prefix=str(hmdb / "videos"), split_type=split)
        _same(_take(ours, 10), _take(theirs, 10))


def _write_frame_csv(path, videos):
    """videos: {video_name: [(frame path, labels string), ...]} as the
    space-separated ``original_vido_id video_id frame_id path labels`` CSV."""
    with open(path, "w") as f:
        f.write("original_vido_id video_id frame_id path labels\n")
        for vid, (video_name, frames) in enumerate(videos.items()):
            for fid, (fpath, labels) in enumerate(frames):
                f.write(f'{video_name} {vid} {fid} {fpath} "{labels}"\n')


@pytest.fixture(scope="module")
def frame_videos(tmp_path_factory):
    """Two PNG frame videos (12 and 9 frames) with per-frame labels, as the
    frame CSV lists them (paths relative to the root)."""
    root = tmp_path_factory.mktemp("frame_videos")
    videos = {}
    for v, (name, n) in enumerate((("vidA", 12), ("vidB", 9))):
        paths = _write_png_frames(str(root / name), [f"{i:06d}.png" for i in range(n)], 20 + v)
        labels = ["0,5" if i < 4 else ("7" if i < 8 else "") for i in range(n)]
        videos[name] = [(os.path.relpath(p, root), lab) for p, lab in zip(paths, labels)]
    _write_frame_csv(str(root / "frames.csv"), videos)
    return root


@pytest.mark.parametrize("frames_per_clip", [None, 3])
def test_charades_gives_jax_s_samples(frame_videos, frames_per_clip):
    root = frame_videos
    kwargs = dict(video_path_prefix=str(root), frames_per_clip=frames_per_clip)
    ours = Charades(str(root / "frames.csv"), cs.UniformClipSampler(5 / 30),
                    video_sampler=SequentialSampler, **kwargs)
    theirs = JaxCharades(str(root / "frames.csv"), jax_cs.UniformClipSampler(5 / 30),
                         video_sampler=jax_samplers.SequentialSampler, **kwargs)
    a, b = _take(ours, 10), _take(theirs, 10)
    _same(a, b)
    assert a[0]["video_label"] == [0, 5, 7] and a[0]["label"][0] == [0, 5]
    for n in (1, 2, 7, 30):
        for k in (1, 3, 8):
            indices = list(range(5, 5 + n))
            assert (Charades._sample_clip_frames(indices, k)
                    == JaxCharades._sample_clip_frames(indices, k))


@pytest.fixture(scope="module")
def ssv2_files(frame_videos):
    root = frame_videos
    (root / "labels.json").write_text(json.dumps({"Doing something": "17",
                                                  "Holding something": "3"}))
    (root / "videos.json").write_text(json.dumps([
        {"id": "vidB", "template": "Holding [something]"},
        {"id": "missing", "template": "Doing [something]"},
        {"id": "vidA", "template": "Doing [something]"}]))
    return [str(root / "labels.json"), str(root / "videos.json"), str(root / "frames.csv")]


@pytest.mark.parametrize("frames_per_clip", [None, 4])
def test_ssv2_gives_jax_s_samples(frame_videos, ssv2_files, frames_per_clip):
    kwargs = dict(video_path_prefix=str(frame_videos), frames_per_clip=frames_per_clip)
    ours = SSv2(*ssv2_files, cs.ConstantClipsPerVideoSampler(1.0, 2),
                video_sampler=SequentialSampler, **kwargs)
    theirs = JaxSSv2(*ssv2_files, jax_cs.ConstantClipsPerVideoSampler(1.0, 2),
                     video_sampler=jax_samplers.SequentialSampler, **kwargs)
    a, b = _take(ours, 6), _take(theirs, 6)
    _same(a, b)
    assert [s["label"] for s in a] == [3, 3, 17, 17]
    for n in (2, 9, 12, 40):
        for k in (1, 4, 8):
            indices = list(range(n))
            assert (SSv2._sample_clip_frames(indices, k, False)
                    == JaxSSv2._sample_clip_frames(indices, k, False))


def test_ssv2_random_draws_fall_inside_their_segments(frame_videos, ssv2_files):
    for n, k in ((12, 4), (9, 8), (40, 5)):
        seg = (n - 1) / k
        bounds = [(int(np.round(seg * i)), int(np.round(seg * (i + 1)))) for i in range(k)]
        draws = [SSv2._sample_clip_frames(list(range(n)), k, True,
                                          torch.Generator().manual_seed(s)) for s in range(200)]
        for draw in draws:
            assert all(lo <= d <= hi for d, (lo, hi) in zip(draw, bounds))
        # Every value of each segment is drawn, and one seed repeats its draw.
        assert [sorted({d[i] for d in draws}) for i in range(k)] == [
            list(range(lo, hi + 1)) for lo, hi in bounds]
        assert SSv2._sample_clip_frames(list(range(n)), k, True,
                                        torch.Generator().manual_seed(3)) == draws[3]
    ours = SSv2(*ssv2_files, cs.ConstantClipsPerVideoSampler(1.0, 1),
                video_sampler=SequentialSampler, video_path_prefix=str(frame_videos),
                frames_per_clip=4, rand_sample_frames=True,
                generator=torch.Generator().manual_seed(0))
    theirs = JaxSSv2(*ssv2_files, jax_cs.ConstantClipsPerVideoSampler(1.0, 1),
                     video_sampler=jax_samplers.SequentialSampler,
                     video_path_prefix=str(frame_videos))
    for a, b in zip(_take(ours, 2), _take(theirs, 2)):
        # The drawn frames are frames of the video (all of which the JAX
        # sample holds), one from each segment.
        frames, seg = b["video"], (len(b["video"]) - 1) / 4
        for i, frame in enumerate(a["video"].numpy()):
            lo, hi = int(np.round(seg * i)), int(np.round(seg * (i + 1)))
            assert any(np.array_equal(frame, frames[j]) for j in range(lo, hi + 1))
        assert a["label"] == b["label"]


def _forecasting_json(path):
    def clip(start, end, noun, verb, noun_unsure=False):
        return {"critical_frame_selection_parent_start_sec": start,
                "critical_frame_selection_parent_end_sec": end,
                "taxonomy": {"noun": noun, "verb": verb, "noun_unsure": noun_unsure,
                             "verb_unsure": False}}

    ann = {"v0.avi": {"benchmarks": {"forecasting_hands_objects": [
        clip(0.25, 1.5, "cup", "lift"), clip(0.5, 1.0, None, "lift"),
        clip(1.0, 1.75, "door", "open")]}},
           "v1.avi": {"benchmarks": {"forecasting_hands_objects": [
               clip(0.0, 1.0, "cup", "open"), clip(0.5, 1.0, "pan", "wash", noun_unsure=True)]}}}
    with open(path, "w") as f:
        json.dump(ann, f)


@pytest.fixture(scope="module")
def json_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("json")
    for i, n in enumerate(FRAMES[:2]):
        export_video_array(torch.from_numpy(_frames(n, 30 + i)), str(root / f"v{i}.avi"), FPS)
    _forecasting_json(str(root / "ann.json"))
    return root


def test_json_datasets_give_jax_s_samples(json_files):
    root = json_files
    ann = str(root / "ann.json")
    for ours_fn, theirs_fn in ((video_only_dataset, jax_video_only),
                               (clip_recognition_dataset, jax_clip_recognition)):
        ours = ours_fn(ann, cs.UniformClipSampler(0.5), video_sampler=SequentialSampler,
                       video_path_prefix=str(root))
        theirs = theirs_fn(ann, jax_cs.UniformClipSampler(0.5),
                           video_sampler=jax_samplers.SequentialSampler,
                           video_path_prefix=str(root))
        assert ours.num_videos == theirs.num_videos
        _same(_take(ours, 8), _take(theirs, 8))
    recognition = clip_recognition_dataset(ann, cs.UniformClipSampler(0.5),
                                           video_sampler=SequentialSampler,
                                           video_path_prefix=str(root))
    assert recognition.num_videos == 3  # the None noun and the unsure noun left out
    with pytest.raises(FileNotFoundError):
        video_only_dataset(str(root / "missing.json"), cs.UniformClipSampler(0.5))
    with pytest.raises(FileNotFoundError):
        video_only_dataset(str(root / "v0.avi"), cs.UniformClipSampler(0.5))


@pytest.mark.parametrize("sampler", ["uniform", "random"])
def test_untrimmed_clip_sampler_gives_one_clip_as_jax_s_does(sampler):
    """The JAX formula's negative span duration (start - end): a [2, 6] s
    span under a 1 s sampler gives the one clip (2.0, 3.0), the last, in
    both packages, where the span holds four."""
    def make(m):
        return (m.make_clip_sampler("uniform", 1.0) if sampler == "uniform"
                else m.make_clip_sampler("random", 1.0, np.random.default_rng(0)))

    ours, theirs = UntrimmedClipSampler(make(cs)), JaxUntrimmed(make(jax_cs))
    span = {"clip_start_sec": 2.0, "clip_end_sec": 6.0}
    a, b = ours(None, 10.0, span), theirs(None, 10.0, span)
    assert tuple(a) == tuple(b)
    assert (float(a.clip_start_sec), float(a.clip_end_sec), a.is_last_clip) == (2.0, 3.0, True)
    ours.reset()
