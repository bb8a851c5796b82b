"""The port's native decoder (data/native_build.py, data/encoded_video_native.py,
data/native_pipeline.py) against the JAX package's, both over the one
library the port builds from ``native/``: clips written by OpenCV (FFV1) and
by ``mux_av`` (FFV1 and pcm_s16le), decoded by seeks forward and backward,
from memory, through a registered scheme, through the worker pool, and
through ``LabeledVideoDataset`` and ``Ego4dMomentsDataset`` with their audio.

Tolerances: frames exact (the port's uint8 clips, as floats, equal the JAX
package's float32 ones); audio equal to the JAX package's exactly and within
2e-4 of the written waveform (pcm_s16le's rounding, as in
tests/test_audio_e2e.py); the Ego4d spectrogram, which the port computes in
float32 and the JAX package in float64, within 1e-5 of max |value|.
"""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from fixtures import create_dummy_video_frames
from pytorchvideo_tpu.data import encoded_video_native as jax_native
from pytorchvideo_tpu.data import io as jax_io
from pytorchvideo_tpu.data import native_pipeline as jax_pipeline
from pytorchvideo_tpu.data.clip_sampling import make_clip_sampler as jax_make_clip_sampler
from pytorchvideo_tpu.data.ego4d.ego4d_dataset import Ego4dMomentsDataset as JaxEgo4dMoments
from pytorchvideo_tpu.data.encoded_video import EncodedVideo as JaxEncodedVideo
from pytorchvideo_tpu.data.labeled_video_dataset import (
    labeled_video_dataset as jax_labeled_video_dataset,
)
from pytorchvideo_tpu_torch.data import encoded_video_native, native_build, native_pipeline
from pytorchvideo_tpu_torch.data import io as pvt_io
from pytorchvideo_tpu_torch.data.clip_sampling import make_clip_sampler
from pytorchvideo_tpu_torch.data.ego4d import Ego4dMomentsDataset
from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo
from pytorchvideo_tpu_torch.data.labeled_video_dataset import labeled_video_dataset
from pytorchvideo_tpu_torch.data.utils import export_video_array
from torch_port_helpers import assert_same_sample

AUDIO_TOL = 2e-4  # pcm_s16le against the float32 waveform
F32_SHARE = 1e-5  # float32 spectrograms, of max |value|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def library():
    """The port's decode library, built here (or found built)."""
    missing = native_build.missing_tools()
    if missing:
        pytest.skip("the native decoder cannot be built here: missing " + ", ".join(missing))
    return str(native_build.build_library())


@pytest.fixture(autouse=True)
def jax_on_the_same_library(library, monkeypatch):
    """The JAX package's decoder loads the port's library. Its loader caches
    a miss, which collecting tests/test_native_decoder.py leaves in each
    worker, so the cache is emptied for the test."""
    monkeypatch.setenv("PVT_DECODE_LIB", library)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_LIB_TRIED", False)
    monkeypatch.setattr(jax_pipeline, "_PIPE_BOUND", False)


def _cv2_video(directory, n, fps, height=32, width=32):
    frames = create_dummy_video_frames(n, height, width)
    path = str(directory / "video.avi")
    export_video_array(torch.from_numpy(frames), path, fps)
    return path, frames


def _av_video(directory, n, fps, rate=16000, height=32, width=32, name="video_av.avi"):
    frames = create_dummy_video_frames(n, height, width)
    t = np.arange(int(round(n / fps * rate))) / rate
    audio = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    path = str(directory / name)
    encoded_video_native.mux_av(path, torch.from_numpy(frames), fps, torch.from_numpy(audio),
                                rate)
    return path, frames, audio


def _same_clip(ours, theirs):
    """Both packages' clip dicts: the video uint8 here, float32 there, equal
    as floats; the audio equal."""
    assert (ours["video"] is None) == (theirs["video"] is None)
    if ours["video"] is not None:
        assert ours["video"].dtype == torch.uint8 and not ours["video"].is_cuda
        np.testing.assert_array_equal(ours["video"].float().numpy(), theirs["video"])
    assert (ours["audio"] is None) == (theirs["audio"] is None)
    if ours["audio"] is not None:
        assert ours["audio"].dtype == torch.float32
        np.testing.assert_array_equal(ours["audio"].numpy(), theirs["audio"])


def test_exact_decode_as_jax_s(tmp_path):
    path, frames = _cv2_video(tmp_path, 10, 5)
    ours = EncodedVideo.from_path(path, decoder="native")
    theirs = JaxEncodedVideo.from_path(path, decoder="native")
    assert type(theirs).__name__ == type(ours).__name__ == "EncodedVideoNative"
    assert ours.duration == theirs.duration == pytest.approx(2.0)
    assert ours.rate == theirs.rate and ours.name == theirs.name == "video.avi"
    assert not ours.has_audio and ours.audio_rate == 0
    clip = ours.get_clip(0, 2.0)
    np.testing.assert_array_equal(clip["video"].numpy(), frames)
    _same_clip(clip, theirs.get_clip(0, 2.0))
    ours.close()
    theirs.close()


def test_seeks_forward_and_backward_as_jax_s(tmp_path):
    path, frames = _cv2_video(tmp_path, 30, 10)
    ours = EncodedVideo.from_path(path, decoder="native")
    theirs = JaxEncodedVideo.from_path(path, decoder="native")
    for start, end, want in ((1.0, 2.0, frames[10:20]), (0.0, 0.5, frames[:5]),
                             (2.5, math.inf, frames[25:]), (0.3, 0.3, frames[3:4]),
                             (1.05, 1.25, frames[11:13])):
        clip = ours.get_clip(start, end)
        np.testing.assert_array_equal(clip["video"].numpy(), want)
        _same_clip(clip, theirs.get_clip(start, end))
    ours.close()
    theirs.close()


def test_out_of_range_gives_none(tmp_path):
    path, _ = _cv2_video(tmp_path, 10, 5)
    ours = EncodedVideo.from_path(path, decoder="native")
    theirs = JaxEncodedVideo.from_path(path, decoder="native")
    for start, end in ((5.0, 6.0), (1.0, 0.5)):
        assert ours.get_clip(start, end) == {"video": None, "audio": None}
        assert theirs.get_clip(start, end) == {"video": None, "audio": None}
    ours.close()
    ours.close()  # a second close is a no-op
    theirs.close()


def test_native_matches_opencv_in_the_port(tmp_path):
    path, _ = _cv2_video(tmp_path, 16, 8, height=40, width=56)
    native = EncodedVideo.from_path(path, decoder="native")
    opencv = EncodedVideo.from_path(path, decoder="opencv")
    for start, end in ((0.5, 1.5), (0.0, math.inf), (1.25, 1.5)):
        a, b = native.get_clip(start, end)["video"], opencv.get_clip(start, end)["video"]
        assert a.dtype == b.dtype == torch.uint8
        assert torch.equal(a, b)
    native.close()
    opencv.close()


def test_from_bytes_and_a_registered_scheme_decode_from_memory(tmp_path, monkeypatch):
    path, frames, audio = _av_video(tmp_path, 10, 5)
    with open(path, "rb") as f:
        blob = f.read()
    ours = EncodedVideo.from_bytes(blob, decoder="native", decode_audio=True)
    theirs = JaxEncodedVideo.from_bytes(blob, decoder="native", decode_audio=True)
    assert ours.name == "<memory>" and not hasattr(ours, "_tempfile_ref")
    clip = ours.get_clip(0, ours.duration)
    np.testing.assert_array_equal(clip["video"].numpy(), frames)
    _same_clip(clip, theirs.get_clip(0, theirs.duration))
    ours.close()
    theirs.close()
    # A path under a registered scheme is read through its opener and decoded
    # from memory, audio included.
    monkeypatch.setattr(pvt_io, "_PATH_OPENERS", {})
    monkeypatch.setattr(jax_io, "_PATH_OPENERS", {})
    for registry in (pvt_io, jax_io):
        registry.register_path_opener("testmem", lambda p: blob)
    ours = EncodedVideo.from_path("testmem://bucket/clip.avi", decoder="native", decode_audio=True)
    theirs = JaxEncodedVideo.from_path("testmem://bucket/clip.avi", decoder="native",
                                       decode_audio=True)
    assert type(ours).__name__ == "EncodedVideoNative" and ours.name == "clip.avi"
    clip = ours.get_clip(0, ours.duration)
    np.testing.assert_array_equal(clip["video"].numpy(), frames)
    n = min(len(clip["audio"]), len(audio))
    assert np.abs(clip["audio"].numpy()[:n] - audio[:n]).max() < AUDIO_TOL
    _same_clip(clip, theirs.get_clip(0, theirs.duration))
    ours.close()
    theirs.close()


def test_full_audio_decode_as_jax_s(tmp_path):
    path, frames, audio = _av_video(tmp_path, 20, 10)
    ours = EncodedVideo.from_path(path, decoder="native", decode_audio=True)
    theirs = JaxEncodedVideo.from_path(path, decoder="native", decode_audio=True)
    assert ours.has_audio and ours.audio_rate == theirs.audio_rate == 16000
    clip = ours.get_clip(0, ours.duration)
    np.testing.assert_array_equal(clip["video"].numpy(), frames)
    got = clip["audio"].numpy()
    n = min(len(got), len(audio))
    assert n >= len(audio) - 1024  # the whole window; the tail is frame-granular
    assert np.abs(got[:n] - audio[:n]).max() < AUDIO_TOL
    _same_clip(clip, theirs.get_clip(0, theirs.duration))
    ours.close()
    theirs.close()
    # Audio alone: the video stream is never read.
    ours = EncodedVideo.from_path(path, decoder="native", decode_audio=True, decode_video=False)
    theirs = JaxEncodedVideo.from_path(path, decoder="native", decode_audio=True,
                                       decode_video=False)
    clip = ours.get_clip(0, ours.duration)
    assert clip["video"] is None
    _same_clip(clip, theirs.get_clip(0, theirs.duration))
    ours.close()
    theirs.close()
    with pytest.raises(ValueError):
        EncodedVideo.from_path(path, decoder="native", decode_audio=False, decode_video=False)


def test_audio_window_alignment_as_jax_s(tmp_path):
    """A window starts at the first audio frame (1024 samples here) at or
    after its start and is sample-exact from there."""
    path, _, audio = _av_video(tmp_path, 30, 10)
    ours = EncodedVideo.from_path(path, decoder="native", decode_audio=True)
    theirs = JaxEncodedVideo.from_path(path, decoder="native", decode_audio=True)
    rate = ours.audio_rate
    for start, end in ((0.5, 1.5), (1.0, 2.9), (2.0, math.inf)):
        clip = ours.get_clip(start, end)
        got = clip["audio"].numpy()
        first = ((int(start * rate) + 1023) // 1024) * 1024
        assert np.abs(got - audio[first:first + len(got)]).max() < AUDIO_TOL
        _same_clip(clip, theirs.get_clip(start, end))
    assert abs(len(ours.get_clip(0.5, 1.5)["audio"]) - rate) <= 2048
    ours.close()
    theirs.close()


def test_mux_av_and_export_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, 24, 32, 3), dtype=np.uint8)
    rate = 8000
    audio = (0.25 * np.sin(2 * np.pi * 200 * np.arange(rate * 2) / rate)).astype(np.float32)
    ours_path, theirs_path = str(tmp_path / "ours.avi"), str(tmp_path / "theirs.avi")
    # CTHW tensors in, as export_video_array takes them.
    export_video_array(torch.from_numpy(frames).permute(3, 0, 1, 2), ours_path, 6.0,
                       layout="CTHW", audio=torch.from_numpy(audio), audio_rate=rate)
    jax_native.mux_av(theirs_path, frames, 6.0, audio, rate)
    for path in (ours_path, theirs_path):
        ours = EncodedVideo.from_path(path, decoder="native", decode_audio=True)
        theirs = JaxEncodedVideo.from_path(path, decoder="native", decode_audio=True)
        clip = ours.get_clip(0, ours.duration)
        np.testing.assert_array_equal(clip["video"].numpy(), frames)
        n = min(len(clip["audio"]), len(audio))
        assert np.abs(clip["audio"].numpy()[:n] - audio[:n]).max() < AUDIO_TOL
        _same_clip(clip, theirs.get_clip(0, theirs.duration))
        ours.close()
        theirs.close()
    with pytest.raises(ValueError):
        encoded_video_native.mux_av(str(tmp_path / "bad.avi"), frames, 6.0, audio, 0)
    with pytest.raises(ValueError):
        encoded_video_native.mux_av(str(tmp_path / "bad.avi"), frames[..., :2], 6.0)


@pytest.mark.parametrize("out_hw", [(0, 0), (12, 16)], ids=["native size", "rescaled"])
def test_pipeline_gives_jax_s_clips(tmp_path, out_hw):
    path, frames = _cv2_video(tmp_path, 12, 6, height=24, width=32)
    requests = [(path, 0, 4), (path, 4, 8), (path, 8, 12), (path, 2, 6)]
    ours = dict(native_pipeline.iter_decoded_clips(requests, num_threads=3, capacity=2,
                                                   out_h=out_hw[0], out_w=out_hw[1]))
    theirs = dict(jax_pipeline.iter_decoded_clips(requests, num_threads=3, capacity=2,
                                                  out_h=out_hw[0], out_w=out_hw[1]))
    assert set(ours) == set(theirs) == {0, 1, 2, 3}
    h, w = out_hw if out_hw != (0, 0) else (24, 32)
    for i, (_, s, e) in enumerate(requests):
        assert ours[i].dtype == torch.uint8 and tuple(ours[i].shape) == (e - s, h, w, 3)
        np.testing.assert_array_equal(ours[i].numpy(), theirs[i])
        if out_hw == (0, 0):
            np.testing.assert_array_equal(ours[i].numpy(), frames[s:e])
    # The handle's API: ids round trip, the count of outstanding requests, a
    # file that does not decode gives None.
    bad = tmp_path / "nope.avi"
    bad.write_bytes(b"not a video")
    with native_pipeline.NativeDecodePipeline(num_threads=2) as pipe:
        pipe.submit(7, path, 0, 3, *out_hw)
        pipe.submit(9, str(bad), 0, 2)
        assert pipe.outstanding() == 2
        got = dict(pipe.wait() for _ in range(2))
        assert pipe.outstanding() == 0
    assert got[9] is None and torch.equal(got[7], ours[0][:3])
    assert native_pipeline.is_available()


def test_labeled_video_dataset_gives_jax_s_samples(tmp_path):
    path, _, _ = _av_video(tmp_path, 20, 10)
    video = tmp_path / "a.avi"
    shutil.copy(path, video)
    csv = tmp_path / "data.csv"
    csv.write_text(f"{video} 3\n")
    ours = labeled_video_dataset(str(csv), make_clip_sampler("uniform", 0.75), decode_audio=True,
                                 decoder="native")
    theirs = jax_labeled_video_dataset(str(csv), jax_make_clip_sampler("uniform", 0.75),
                                       decode_audio=True, decoder="native")
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["video"].dtype == torch.uint8 and a["audio"].dtype == torch.float32
        assert_same_sample(a, b)


def test_ego4d_moments_sample_from_a_real_av_file_as_jax_s(tmp_path):
    """The moments dataset with decode_audio=True over a file with sound:
    the decoded signal, its spectrogram and the rest of the sample."""
    path, _, _ = _av_video(tmp_path, 32, 8, rate=Ego4dMomentsDataset.AUDIO_FPS)
    label = {"label": "cooking", "start_time": 0.5, "end_time": 2.0, "video_start_time": 0.5,
             "video_end_time": 2.0}
    (tmp_path / "moments.json").write_text(json.dumps({"videos": [{
        "video_uid": "v1", "split": "train", "clips": [{
            "clip_uid": "c1", "video_start_sec": 0.0, "video_end_sec": 4.0,
            "annotations": [{"labels": [label]}]}]}]}))
    (tmp_path / "meta.json").write_text(json.dumps({"videos": [
        {"video_uid": "v1", "duration_sec": 4.0, "manifold_path": path}]}))
    kwargs = dict(annotation_path=str(tmp_path / "moments.json"),
                  metadata_path=str(tmp_path / "meta.json"), split="train", decode_audio=True,
                  decoder="native", window_sec=2, label_id_map={"cooking": 0, "washing": 1})
    a, b = next(iter(Ego4dMomentsDataset(**kwargs))), next(iter(JaxEgo4dMoments(**kwargs)))
    assert a["video"].dtype == torch.uint8 and a["audio"]["signal"].dtype == torch.float32
    assert a["audio"]["signal"].numel() >= 2 * Ego4dMomentsDataset.AUDIO_FPS - 2048
    spec, ref = a.pop("spectrogram"), b.pop("spectrogram")
    assert a["audio"].pop("spectrogram") is spec
    b["audio"].pop("spectrogram")
    assert_same_sample(a, b)
    assert a["labels_onehot"] == [1, 0]
    assert spec.dtype == torch.float32 and tuple(spec.shape) == ref.shape
    assert bool(spec.isfinite().all())
    assert np.abs(spec.double().numpy() - ref).max() <= F32_SHARE * np.abs(ref).max()


def test_no_toolchain_raises_and_never_falls_back(tmp_path, monkeypatch):
    """Without g++ the native decoder raises RuntimeError (the JAX package
    would decode with OpenCV); nothing else is decoded instead."""
    path, _ = _cv2_video(tmp_path, 4, 4)
    monkeypatch.delenv("PVT_DECODE_LIB")
    monkeypatch.setattr(encoded_video_native, "_LIB", None)
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    assert native_build.missing_tools()[:2] == ["g++", "pkg-config"]
    assert not encoded_video_native.native_available() and not native_pipeline.is_available()
    with pytest.raises(RuntimeError, match=r"missing g\+\+"):
        EncodedVideo.from_path(path, decoder="native")
    with pytest.raises(RuntimeError, match=r"missing g\+\+"):
        EncodedVideo.from_bytes(b"\0" * 16, decoder="native")
    with pytest.raises(RuntimeError, match=r"missing g\+\+"):
        native_pipeline.NativeDecodePipeline()
    with pytest.raises(RuntimeError, match=r"missing g\+\+"):
        export_video_array(np.zeros((2, 8, 8, 3), np.uint8), str(tmp_path / "x.avi"), 4,
                           audio=np.zeros(100, np.float32), audio_rate=8000)
