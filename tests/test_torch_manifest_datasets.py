"""The port's manifest-driven datasets against the JAX package's: the
dataclass and CSV helpers, the manifest utils and builders, EPIC-Kitchens
(base, recognition, forecasting), DoMSEV (frame and video), Ego4d (window
and clip sampler, IMU, the moments dataset) and its audio front end
``signal_transform``, and that front end feeding a narrow audio-visual
SlowFast in both packages. The same files go through both: PNG frames and
FFV1 clips written with OpenCV, CSV and JSON annotations written here.

Tolerances: sample dicts exact (clips uint8 in the port, float32 [0, 255] in
the JAX package; the JAX package's arrays are the port's tensors), except
the spectrograms. ``signal_transform`` in float64 within rtol 1e-9 of the
JAX function; in float32, which the port computes in float32 and the JAX
package in float64, within 1e-5 of max |value|. The front end into the
model: rtol 5e-3 / atol 5e-4 (tests/test_models_parity.py:24).
EPIC-Kitchens recognition's and DoMSEV's random draws come from a
``torch.Generator`` in the port: the JAX dataset is given the port's draws
(recognition) or held as a permutation (DoMSEV's frame order).
"""

import copy
import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.data import dataset_manifest_utils as jax_dmu
from pytorchvideo_tpu.data import domsev as jax_domsev
from pytorchvideo_tpu.data import epic_kitchen as jax_ek
from pytorchvideo_tpu.data import utils as jax_utils
from pytorchvideo_tpu.data.ego4d import ego4d_dataset as jax_ego4d
from pytorchvideo_tpu.data.ego4d import utils as jax_ego4d_utils
from pytorchvideo_tpu.data.epic_kitchen_forecasting import (
    EpicKitchenForecasting as JaxForecasting,
)
from pytorchvideo_tpu.data.epic_kitchen_recognition import (
    EpicKitchenRecognition as JaxRecognition,
)
from pytorchvideo_tpu.transforms import functional as jax_functional
from pytorchvideo_tpu_torch.data import dataset_manifest_utils as dmu
from pytorchvideo_tpu_torch.data import domsev
from pytorchvideo_tpu_torch.data import epic_kitchen as ek
from pytorchvideo_tpu_torch.data import utils
from pytorchvideo_tpu_torch.data.ego4d import ego4d_dataset as ego4d
from pytorchvideo_tpu_torch.data.ego4d import utils as ego4d_utils
from pytorchvideo_tpu_torch.data.epic_kitchen_forecasting import EpicKitchenForecasting
from pytorchvideo_tpu_torch.data.epic_kitchen_recognition import EpicKitchenRecognition
from pytorchvideo_tpu_torch.data.utils import export_video_array
from pytorchvideo_tpu_torch.transforms import functional
from test_torch_audio_visual import _av_pair, _jax, _run
from torch_port_helpers import TOL, assert_same_sample

FPS = 6
N_FRAMES = 12  # 2 s of frames at FPS
AUDIO_RATE = 48000
F32_SHARE = 1e-5  # float32 spectrograms, of max |value|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, seed, h=10, w=12):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(1, h, w, 3))
    ramp = (x + y)[None, :, :, None] + 9 * np.arange(n)[:, None, None, None]
    return ((base + ramp) % 256).astype(np.uint8)


def _both(make_ours, make_theirs):
    """The two packages' results; their exceptions' types side by side."""
    results = []
    for make in (make_ours, make_theirs):
        try:
            results.append(make())
        except Exception as e:  # noqa: BLE001 - the type is compared
            results.append(type(e))
    return results


# --- the dataclass and CSV helpers ------------------------------------------

def test_dataclass_csv_helpers_match_jax_s(tmp_path):
    path = str(tmp_path / "frames.csv")
    rows = [dmu.VideoFrameInfo("v1", "/a", "frame_", "12", "0", "11", "png"),
            dmu.VideoFrameInfo("v2", "/b", "img_", 10, 3, 7, "jpg")]
    assert rows[0].frame_string_length == 12 and rows[0].max_frame_number == 11
    utils.save_dataclass_objs_to_headered_csv(rows, path)
    ours = utils.load_dataclass_dict_from_csv(path, dmu.VideoFrameInfo, "video_id")
    theirs = jax_utils.load_dataclass_dict_from_csv(path, jax_dmu.VideoFrameInfo, "video_id")
    assert_same_sample(ours, theirs)
    assert ours == {r.video_id: r for r in rows}
    listed = utils.load_dataclass_dict_from_csv(path, dmu.VideoFrameInfo, "file_extension",
                                                list_per_key=True)
    assert list(listed) == ["png", "jpg"] and listed["png"] == [rows[0]]
    with open(path, "a") as f:
        f.write("v1,/c,x_,4,0,1,png\n")
    with pytest.raises(ValueError):
        utils.load_dataclass_dict_from_csv(path, dmu.VideoFrameInfo, "video_id")
    with pytest.raises(ValueError):
        utils.load_dataclass_dict_from_csv(path, dmu.VideoInfo, "video_id")
    with pytest.raises(ValueError):
        utils.save_dataclass_objs_to_headered_csv([], path)

    @dataclasses.dataclass
    class Row(utils.DataclassFieldCaster):
        count: int
        name: str
        values: list = utils.complex_initialized_dataclass_field(lambda s: s.split("|"))

    row = Row("7", 12, "a|b")
    assert (row.count, row.name, row.values) == (7, "12", ["a", "b"])
    assert Row("x", "n", "c").count == "x"  # a value the type cannot take stays
    logger = utils.get_logger("pvt-test-datasets")
    handlers = len(logger.handlers)
    assert logger.level == logging.INFO and utils.get_logger("pvt-test-datasets") is logger
    assert len(logger.handlers) == handlers == len(
        jax_utils.get_logger("pvt-test-datasets").handlers)


@pytest.mark.parametrize("text", ["00:01:30", "01:00:00.5", "00:00:01.75", "bogus", "1:2"])
def test_hms_times_match_jax_s(text):
    ours, theirs = _both(lambda: dmu.get_seconds_from_hms_time(text),
                         lambda: jax_dmu.get_seconds_from_hms_time(text))
    assert ours == theirs


# --- manifests ---------------------------------------------------------------

def _write_manifests(directory, n_frames=N_FRAMES, fps=FPS, video_id="vid1", extra=()):
    """A PNG frame video ``frame_000000.png`` ... and its VideoInfo and
    VideoFrameInfo manifests; ``extra`` rows are added to both."""
    import cv2

    for i, frame in enumerate(_frames(n_frames, 1)):
        cv2.imwrite(os.path.join(directory, f"frame_{i:06d}.png"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    video_info_csv = os.path.join(directory, "video_info.csv")
    with open(video_info_csv, "w") as f:
        f.write("video_id,resolution,duration,fps\n")
        f.write(f"{video_id},10x12,{n_frames / fps},{fps}\n")
        for row in extra:
            f.write(f"{row[0]},10x12,{row[1]},{fps}\n")
    frame_manifest_csv = os.path.join(directory, "frames.csv")
    with open(frame_manifest_csv, "w") as f:
        f.write("video_id,location,frame_file_stem,frame_string_length,"
                "min_frame_number,max_frame_number,file_extension\n")
        f.write(f"{video_id},{directory},frame_,12,0,{n_frames - 1},png\n")
        for row in extra:
            f.write(f"{row[0]},{directory},frame_,12,0,{row[2]},png\n")
    return video_info_csv, frame_manifest_csv


def test_manifest_loading_matches_jax_s(tmp_path):
    # "short" lists 12 frames for 5 s at 6 fps (off by more than a second of
    # frames): dropped, as is "orphan", which has no frames.
    info_csv, frames_csv = _write_manifests(str(tmp_path), extra=[("short", 5.0, 11)])
    with open(info_csv, "a") as f:
        f.write("orphan,10x12,1.0,6\n")
    ours = dmu.VideoDataset._load_videos(frames_csv, info_csv, False, dmu.VideoDatasetType.Frame)
    theirs = jax_dmu.VideoDataset._load_videos(frames_csv, info_csv, False,
                                               jax_dmu.VideoDatasetType.Frame)
    assert list(ours) == list(theirs) == ["vid1"]
    assert ours["vid1"].duration == theirs["vid1"].duration == 2.0
    assert_same_sample(ours["vid1"].get_clip(0.5, 1.25), theirs["vid1"].get_clip(0.5, 1.25))
    images = dmu.ImageDataset._load_images(frames_csv, info_csv, False)
    jax_images = jax_dmu.ImageDataset._load_images(frames_csv, info_csv, False)
    assert_same_sample(images, jax_images)
    assert len(images) == N_FRAMES and images["frame_000003"].frame_number == 3


def test_manifest_builders_and_writers_match_jax_s(tmp_path):
    flat = tmp_path / "flat" / "vid1"
    nested = tmp_path / "nested" / "P01"
    enc = tmp_path / "enc" / "P01"
    for d in (flat, nested, enc):
        os.makedirs(d)
    for i in range(1, 4):
        (flat / f"frame_{i:010d}.jpg").touch()
        (nested / f"P01_01_{i:010d}.jpg").touch()
        (nested / f"P01_02_{i + 6:010d}.jpg").touch()
    (enc / "P01_01.MP4").touch()
    (enc / "P01_02.MP4").touch()
    for threads in (False, True):
        assert_same_sample(ek.build_frame_manifest_from_flat_directory(str(tmp_path / "flat"),
                                                                       threads),
                           jax_ek.build_frame_manifest_from_flat_directory(
                               str(tmp_path / "flat"), threads))
        nested_ours = ek.build_frame_manifest_from_nested_directory(str(tmp_path / "nested"),
                                                                    threads)
        assert_same_sample(nested_ours, jax_ek.build_frame_manifest_from_nested_directory(
            str(tmp_path / "nested"), threads))
    assert nested_ours["P01_02"].min_frame_number == 7
    encoded = ek.build_encoded_manifest_from_nested_directory(str(tmp_path / "enc"))
    assert_same_sample(encoded, jax_ek.build_encoded_manifest_from_nested_directory(
        str(tmp_path / "enc")))
    p1 = dmu.save_video_frame_info(nested_ours, str(tmp_path / "vf.csv"))
    p2 = dmu.save_encoded_video_manifest(encoded, str(tmp_path / "ev.csv"))
    assert utils.load_dataclass_dict_from_csv(p1, dmu.VideoFrameInfo, "video_id") == nested_ours
    assert utils.load_dataclass_dict_from_csv(p2, dmu.EncodedVideoInfo, "video_id") == encoded
    with open(p1) as a, open(jax_dmu.save_video_frame_info(
            jax_ek.build_frame_manifest_from_nested_directory(str(tmp_path / "nested"), False),
            str(tmp_path / "vf_jax.csv"))) as b:
        assert a.read() == b.read()
    (nested / f"P01_01_{9:010d}.jpg").touch()  # a gap in P01_01's numbering
    with pytest.raises(ValueError):
        ek.build_frame_manifest_from_nested_directory(str(tmp_path / "nested"), False)


# --- EPIC-Kitchens -------------------------------------------------------------

ACTION_COLUMNS = ("participant_id,video_id,narration,start_timestamp,stop_timestamp,"
                  "start_frame,stop_frame,verb,verb_class,noun,noun_class,all_nouns,"
                  "all_noun_classes\n")


def _actions_csv(directory, rows, video_id="vid1", name="actions.csv"):
    """rows: (start, stop, verb) with HH:MM:SS timestamps."""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(ACTION_COLUMNS)
        for i, (start, stop, verb) in enumerate(rows):
            f.write(f'P1,{video_id},{verb} door,{start},{stop},{i},{i + 5},{verb},{i},door,2,'
                    f'"[\'door\', \'knob\']","[2, {i}]"\n')
    return path


@pytest.fixture(scope="module")
def epic(tmp_path_factory):
    root = tmp_path_factory.mktemp("epic")
    info_csv, frames_csv = _write_manifests(str(root))
    actions = _actions_csv(str(root), [("00:00:00", "00:00:01", "open"),
                                       ("00:00:01", "00:00:01.5", "close"),
                                       ("00:00:01.75", "00:00:02", "push")])
    # The same frames as an FFV1 clip, for the encoded dataset type.
    clip = str(root / "vid1.avi")
    export_video_array(torch.from_numpy(_frames(N_FRAMES, 1)), clip, FPS)
    encoded_csv = str(root / "encoded.csv")
    with open(encoded_csv, "w") as f:
        f.write(f"video_id,file_path\nvid1,{clip}\n")
    return {"info": info_csv, "frames": frames_csv, "encoded": encoded_csv, "actions": actions,
            "root": str(root)}


def _clips(videos, actions):
    return [dmu.VideoClipInfo("vid1", 0.0, 1.0), dmu.VideoClipInfo("vid1", 0.5, 1.75)]


def _jax_clips(videos, actions):
    return [jax_dmu.VideoClipInfo("vid1", 0.0, 1.0), jax_dmu.VideoClipInfo("vid1", 0.5, 1.75)]


@pytest.mark.parametrize("kind", ["Frame", "EncodedVideo"])
def test_epic_kitchen_dataset_gives_jax_s_samples(epic, kind):
    manifest = epic["frames"] if kind == "Frame" else epic["encoded"]
    ours = ek.EpicKitchenDataset(epic["info"], epic["actions"], _clips, manifest,
                                 dataset_type=dmu.VideoDatasetType[kind],
                                 frame_filter=lambda idx: idx[::2], multithreaded_io=False)
    theirs = jax_ek.EpicKitchenDataset(epic["info"], epic["actions"], _jax_clips, manifest,
                                       dataset_type=jax_dmu.VideoDatasetType[kind],
                                       frame_filter=lambda idx: idx[::2], multithreaded_io=False)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["video"].dtype == torch.uint8
        assert_same_sample(a, b)
    assert a["actions"][0].all_nouns == ["door", "knob"] and a["actions"][1].start_time == 1.0
    with pytest.raises(ValueError):
        ek.EpicKitchenDataset(epic["info"], epic["actions"], None, manifest)


class _TorchDraws:
    """A numpy-like ``random()`` that returns a torch generator's float64
    draws: the JAX recognition dataset given the port's offsets."""

    def __init__(self, seed):
        self.generator = torch.Generator().manual_seed(seed)

    def random(self):
        return float(torch.rand((), generator=self.generator, dtype=torch.float64))


@pytest.mark.parametrize("frames_per_clip", [None, 2])
def test_epic_kitchen_recognition_gives_jax_s_samples(epic, frames_per_clip):
    kwargs = dict(seconds_per_clip=0.5, frames_per_clip=frames_per_clip,
                  multithreaded_io=False)
    ours = EpicKitchenRecognition(epic["info"], epic["actions"], epic["frames"],
                                  generator=torch.Generator().manual_seed(5), **kwargs)
    theirs = JaxRecognition(epic["info"], epic["actions"], epic["frames"], rng=_TorchDraws(5),
                            **kwargs)
    assert len(ours) == len(theirs) >= 3
    offset = ours._clips[0].start_time
    assert 0 <= offset < 0.5 and [c.start_time for c in ours._clips] == [
        offset + 0.5 * i for i in range(len(ours))]
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["video"].dtype == torch.uint8
        assert_same_sample(a, b)
        assert all(x.start_time <= a["stop_time"] and x.stop_time >= a["start_time"]
                   for x in a["actions"])
    for n in (4, 7, 12):
        for k in (1, 2, 3):
            assert (EpicKitchenRecognition._frame_filter_generator(k)(list(range(n)))
                    == JaxRecognition._frame_filter_generator(k)(list(range(n))))


def test_epic_kitchen_forecasting_gives_jax_s_samples(epic):
    actions = _actions_csv(epic["root"], [("00:00:01", "00:00:01.5", "open"),
                                          ("00:00:01.75", "00:00:02", "close"),
                                          ("00:00:00.5", "00:00:00.75", "late")],
                           name="forecast.csv")
    kwargs = dict(seconds_per_clip=0.5, clip_time_stride=0.5, num_input_clips=2,
                  frames_per_clip=3, num_forecast_actions=1, multithreaded_io=False)
    ours = EpicKitchenForecasting(epic["info"], actions, epic["frames"], **kwargs)
    theirs = JaxForecasting(epic["info"], actions, epic["frames"], **kwargs)
    assert len(ours) == len(theirs) == 1
    with pytest.raises(ValueError):  # the third action starts before the second
        ours[0]
    with pytest.raises(AssertionError):
        theirs[0]
    actions = _actions_csv(epic["root"], [("00:00:01", "00:00:01.5", "open"),
                                          ("00:00:01.75", "00:00:02", "close")],
                           name="forecast.csv")
    ours = EpicKitchenForecasting(epic["info"], actions, epic["frames"], **kwargs)
    theirs = JaxForecasting(epic["info"], actions, epic["frames"], **kwargs)
    a, b = ours[0], theirs[0]
    assert tuple(a["video"].shape) == (2, 3, 10, 12, 3) and a["video"].dtype == torch.uint8
    assert_same_sample(a, b)
    assert [x.verb for x in a["actions"]] == ["close"]
    for n in (6, 9, 12):
        assert (EpicKitchenForecasting._frame_filter_generator(3, 0.5, 0.5, 2)(list(range(n)))
                == JaxForecasting._frame_filter_generator(3, 0.5, 0.5, 2)(list(range(n))))


# --- DoMSEV --------------------------------------------------------------------

@pytest.fixture(scope="module")
def domsev_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("domsev")
    info_csv, frames_csv = _write_manifests(str(root))
    labels = str(root / "labels.csv")
    with open(labels, "w") as f:
        f.write("video_id,start_time,stop_time,start_frame,stop_frame,label_id,label_name\n")
        f.write("vid1,0.0,1.0,0,5,7,walking\nvid1,1.0,2.0,6,11,8,eating\n")
        f.write("vid1,0.5,0.75,3,4,2,running\n")
    return info_csv, frames_csv, labels


def test_domsev_frame_dataset_gives_jax_s_frames_in_a_seeded_order(domsev_files):
    info_csv, frames_csv, labels = domsev_files
    ours = domsev.DomsevFrameDataset(frames_csv, info_csv, labels,
                                     generator=torch.Generator().manual_seed(0))
    theirs = jax_domsev.DomsevFrameDataset(frames_csv, info_csv, labels,
                                           rng=np.random.default_rng(0))
    assert len(ours) == len(theirs) == N_FRAMES
    by_id = {theirs[i]["frame_id"]: theirs[i] for i in range(len(theirs))}
    got = [ours[i] for i in range(len(ours))]
    assert sorted(s["frame_id"] for s in got) == sorted(by_id)  # a permutation
    for sample in got:
        assert sample["image"].dtype == torch.uint8 and sample["image"].shape == (10, 12, 3)
        assert_same_sample(sample, by_id[sample["frame_id"]])
    again = domsev.DomsevFrameDataset(frames_csv, info_csv, labels,
                                      generator=torch.Generator().manual_seed(0))
    assert [f.frame_id for f in again._frames] == [s["frame_id"] for s in got]
    assert [s["label"] for s in sorted(got, key=lambda s: s["frame_id"])] == [
        7, 7, 7, 2, 2, 7, 8, 8, 8, 8, 8, 8]


def test_domsev_video_dataset_gives_jax_s_clips(domsev_files):
    info_csv, frames_csv, labels = domsev_files
    spans = [(0.0, 2.0), (0.5, 1.5), (1.25, 1.75)]

    def sampler(module):
        return lambda videos, labels: [module.VideoClipInfo("vid1", s, e) for s, e in spans]

    ours = domsev.DomsevVideoDataset(frames_csv, info_csv, labels, sampler(dmu),
                                     frames_per_second=FPS)
    theirs = jax_domsev.DomsevVideoDataset(frames_csv, info_csv, labels, sampler(jax_dmu),
                                           frames_per_second=FPS)
    for i in range(len(spans)):
        a, b = ours[i], theirs[i]
        assert a["video"].dtype == torch.uint8 and a["labels"].dtype == torch.int64
        assert_same_sample(a, b)
    assert ours[0]["labels"].tolist() == [7] * 6 + [8] * 6 + [2]
    for pair in ((0, 1, 1, 2), (0, 1, 2, 3), (1.5, 2, 0, 1.5)):
        assert (domsev._get_overlap_for_time_range_pair(*pair)
                == jax_domsev._get_overlap_for_time_range_pair(*pair))


# --- Ego4d ---------------------------------------------------------------------

@pytest.mark.parametrize("window", [(5.0, 6.0, 4.0, 100.0), (0.2, 0.4, 4.0, 100.0),
                                    (99.0, 99.5, 4.0, 100.0), (3.0, 7.0, 4.0, None),
                                    (1.0, 9.0, 4.0, 10.0), (0.0, 1.0, 4.0, 3.0)])
def test_ego4d_windows_and_moments_sampler_match_jax_s(window):
    ours, theirs = _both(lambda: ego4d_utils.check_window_len(*window),
                         lambda: jax_ego4d_utils.check_window_len(*window))
    if isinstance(theirs, type):
        assert theirs is AssertionError and ours is ValueError
        return
    assert ours == theirs
    start, end, w_len, duration = window
    annotation = {"label_video_start_sec": start, "label_video_end_sec": end}
    for w in (0, w_len):
        a, b = copy.deepcopy(annotation), copy.deepcopy(annotation)
        info = ego4d_utils.MomentsClipSampler(w)(None, duration, a)
        assert tuple(info) == tuple(jax_ego4d_utils.MomentsClipSampler(w)(None, duration, b))
        assert a == b and info.is_last_clip


def test_ego4d_label_map(tmp_path):
    path = tmp_path / "labels.json"
    path.write_text(json.dumps({"cooking": 0, "washing": 1}))
    assert ego4d_utils.get_label_id_map(str(path)) == jax_ego4d_utils.get_label_id_map(str(path))
    with pytest.raises(FileNotFoundError):
        ego4d_utils.get_label_id_map(str(tmp_path / "missing.json"))


def _imu_csv(path, seconds=4.0, rate=200, seed=0, broken_clock=False):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    stamps = 1000.0 * np.arange(n) / rate + rng.uniform(0, 0.4, n)
    if broken_clock:
        stamps = stamps[::-1]
    with open(path, "w") as f:
        f.write("canonical_timestamp_ms,accl_x,accl_y,accl_z,gyro_x,gyro_y,gyro_z\n")
        for t, row in zip(stamps, rng.normal(size=(n, 6)) * [1, 2, 3, 0.1, 0.2, 0.3] + 9.8):
            cells = ["" if rng.random() < 0.01 else repr(float(v)) for v in row]
            f.write(f"{float(t)!r}," + ",".join(cells) + "\n")


def test_ego4d_imu_windows_match_jax_s(tmp_path):
    _imu_csv(str(tmp_path / "u0.csv"))
    _imu_csv(str(tmp_path / "u1.csv"), seed=1, broken_clock=True)
    ours, theirs = ego4d.Ego4dImuData(str(tmp_path)), jax_ego4d.Ego4dImuData(str(tmp_path))
    assert ours.has_imu("u0") and not ours.has_imu("u2")
    for uid in ("u0", "u1", "u0"):
        signal, stamps, rate = ours.get_imu(uid)
        assert_same_sample([signal, stamps, rate], list(theirs.get_imu(uid)))
        for start, end in ((0.0, 2.0), (1.25, 3.5), (3.0, 9.0)):
            a = ours.get_imu_sample(uid, start, end)
            assert a["signal"].dtype == torch.float64
            assert_same_sample(a, theirs.get_imu_sample(uid, start, end))


@pytest.mark.parametrize("kind", ["spectrogram", "melspectrogram", "mfcc"])
def test_signal_transform_matches_jax_s(kind):
    """10 s at 48 kHz: 936 frames of 513 bins, 256 mels (56 rows of the HTK
    filterbank empty, as in the JAX package)."""
    wave = np.random.default_rng(7).normal(size=10 * AUDIO_RATE) * 0.3
    wave += np.sin(np.arange(wave.size) * 2 * np.pi * 440 / AUDIO_RATE)
    ref = jax_ego4d.signal_transform(kind, AUDIO_RATE)(wave)
    ours = ego4d.signal_transform(kind, AUDIO_RATE)
    got = ours(torch.from_numpy(wave))
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape == (
        513 if kind == "spectrogram" else 256, 936)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=0)
    got32 = ours(torch.from_numpy(wave).float())
    assert got32.dtype == torch.float32
    err = np.abs(got32.double().numpy() - ref).max()
    assert err <= F32_SHARE * np.abs(ref).max(), err
    # An array, and any shape, flattened; the odd tail frames left out.
    np.testing.assert_allclose(ours(wave[:40000].reshape(8, 5000)).numpy(),
                               jax_ego4d.signal_transform(kind, AUDIO_RATE)(wave[:40000]),
                               rtol=1e-9, atol=0)
    assert ours(wave[:40000]).shape[1] == 1 + (40000 - 1024) // 512
    if kind == "melspectrogram":
        assert int((ego4d._mel_filterbank(AUDIO_RATE, 1024, 256).sum(1) == 0).sum()) == 56
        np.testing.assert_array_equal(ego4d._mel_filterbank(AUDIO_RATE, 1024, 256).numpy(),
                                      jax_ego4d._mel_filterbank(AUDIO_RATE, 1024, 256))
    with pytest.raises(ValueError):
        ego4d.signal_transform("cqt")


class _WithAudio:
    """A decoded video whose clips also carry the seeded waveform's samples
    over the clip's span, so the sample's audio is known exactly (a real A/V
    file goes through the native decoder in test_torch_native_decoder.py)."""

    def __init__(self, video, waveform, to_tensor):
        self._video, self._waveform, self._to_tensor = video, waveform, to_tensor

    @property
    def duration(self):
        return self._video.duration

    @property
    def name(self):
        return self._video.name

    def get_clip(self, start, end):
        clip = dict(self._video.get_clip(start, end))
        audio = self._waveform[int(round(float(start) * AUDIO_RATE)):
                               int(round(float(end) * AUDIO_RATE))].copy()
        clip["audio"] = torch.from_numpy(audio) if self._to_tensor else audio
        return clip

    def close(self):
        self._video.close()


class _AudioHandler:
    def __init__(self, handler, waveform, to_tensor):
        self._handler, self._waveform, self._to_tensor = handler, waveform, to_tensor

    def video_from_path(self, filepath, decode_video=True, decode_audio=False, decoder="opencv"):
        video = self._handler.video_from_path(filepath, decode_video=decode_video,
                                              decode_audio=False, decoder=decoder)
        return _WithAudio(video, self._waveform, self._to_tensor)


@pytest.fixture(scope="module")
def ego4d_files(tmp_path_factory):
    """A 4 s FFV1 clip at 8 fps, its IMU CSV, and moments annotations: two
    labels in the train split, one of them empty (start == end), one not in
    the label map, a stereo video and a val video."""
    root = tmp_path_factory.mktemp("ego4d")
    clip = str(root / "u0.avi")
    export_video_array(torch.from_numpy(_frames(32, 3, h=32, w=40)), clip, 8)
    (root / "imu").mkdir()
    _imu_csv(str(root / "imu" / "u0.csv"), seed=2)
    _imu_csv(str(root / "imu" / "u2.csv"), seed=3)

    def label(name, start, end):
        return {"label": name, "start_time": start, "end_time": end, "video_start_time": start,
                "video_end_time": end}

    def video(uid, split, labels):
        return {"video_uid": uid, "split": split, "clips": [{
            "clip_uid": f"{uid}_c0", "video_start_sec": 0.0, "video_end_sec": 4.0,
            "annotations": [{"labels": labels}]}]}

    (root / "moments.json").write_text(json.dumps({"videos": [
        video("u0", "train", [label("cooking", 0.5, 1.5), label("washing", 1.0, 3.5),
                              label("cooking", 2.0, 2.0), label("dancing", 1.0, 2.0)]),
        video("u1", "train", [label("cooking", 0.5, 1.5)]),
        video("u2", "val", [label("washing", 0.0, 1.0)])]}))
    (root / "meta.json").write_text(json.dumps({"videos": [
        {"video_uid": "u0", "duration_sec": 4.0, "manifold_path": clip},
        {"video_uid": "u1", "duration_sec": 4.0, "manifold_path": clip, "is_stereo": True},
        {"video_uid": "u2", "duration_sec": 4.0, "manifold_path": clip}]}))
    return root


def test_ego4d_moments_dataset_gives_jax_s_samples(ego4d_files):
    root = ego4d_files
    waveform = (np.random.default_rng(11).normal(size=5 * AUDIO_RATE) * 0.2).astype(np.float32)
    kwargs = dict(annotation_path=str(root / "moments.json"), metadata_path=str(root / "meta.json"),
                  split="train", decode_audio=True, imu=True, imu_path=str(root / "imu"),
                  window_sec=2, label_id_map={"cooking": 0, "washing": 1, "sleeping": 2})
    ours = ego4d.Ego4dMomentsDataset(**kwargs)
    theirs = jax_ego4d.Ego4dMomentsDataset(**kwargs)
    ours.video_path_handler = _AudioHandler(ours.video_path_handler, waveform, True)
    theirs.video_path_handler = _AudioHandler(theirs.video_path_handler, waveform, False)
    assert ours.cnt_samples == theirs.cnt_samples == 2 and ours.num_classes == 3
    got, want = [next(ours) for _ in range(2)], [next(theirs) for _ in range(2)]
    for a, b in zip(got, want):
        assert a["video"].dtype == torch.uint8 and a["audio"]["signal"].dtype == torch.float32
        spec, ref = a.pop("spectrogram"), b.pop("spectrogram")
        assert a["audio"].pop("spectrogram") is spec
        b["audio"].pop("spectrogram")
        assert_same_sample(a, b)
        # float32 audio: the port's float32 front end against the JAX
        # package's float64 one.
        assert spec.dtype == torch.float32 and tuple(spec.shape) == ref.shape == (256, 186)
        assert np.abs(spec.double().numpy() - ref).max() <= F32_SHARE * np.abs(ref).max()
    assert [s["labels_onehot"] for s in got] == [[1, 0, 0], [0, 1, 0]]
    assert [(s["clip_start"], s["clip_end"]) for s in got] == [(0.0, 2.0), (1.25, 3.25)]
    assert all(s["imu"]["signal"].shape[0] >= 200 for s in got)
    # A transform gets the sample; check_IMU's veto skips a short window.
    seen = []
    ours = ego4d.Ego4dMomentsDataset(**dict(kwargs, decode_audio=False,
                                            transform=lambda s: seen.append(s) or s))
    sample = next(ours)
    assert seen == [sample] and "spectrogram" not in sample
    assert ours.check_IMU({"imu": {"signal": torch.zeros(199, 6)}})
    assert not ours.check_IMU({"imu": {"signal": torch.zeros(200, 6)}})
    with pytest.raises(ValueError):
        ego4d.Ego4dMomentsDataset(**dict(kwargs, label_id_map_path=str(root / "x.json")))
    # Without decoded audio the audio transform type is never read: an
    # unknown one constructs in both packages.
    for package in (ego4d, jax_ego4d):
        package.Ego4dMomentsDataset(**dict(kwargs, decode_audio=False,
                                           audio_transform_type="unknown"))


def test_ego4d_front_end_feeds_av_slowfast_as_jax_s_does():
    """A 2 s, 16 kHz waveform through each package's mel spectrogram, then
    transposed and subsampled to 32 frames of 16 mels (the JAX package's own
    composition, tests/test_audio_e2e.py:268-271) as the narrow
    audio-visual SlowFast's audio pathway, with the same weights."""
    rate = 16000
    t = np.arange(2 * rate) / rate
    wave = (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * np.random.default_rng(4).normal(size=t.size)).astype(np.float32)
    jax_spec = np.asarray(jax_ego4d.signal_transform("melspectrogram", rate)(wave), np.float32)
    jax_spec = jax_functional.uniform_temporal_subsample(jax_spec.T, 32, temporal_axis=0)
    jax_spec = np.asarray(jax_functional.uniform_temporal_subsample(jax_spec, 16,
                                                                    temporal_axis=1))
    spec = ego4d.signal_transform("melspectrogram", rate)(torch.from_numpy(wave))
    spec = functional.uniform_temporal_subsample(spec.T, 32, temporal_axis=0)
    spec = functional.uniform_temporal_subsample(spec, 16, temporal_axis=1)
    assert tuple(spec.shape) == jax_spec.shape == (32, 16)
    scale = np.abs(jax_spec).max()
    assert np.abs(spec.numpy() - jax_spec).max() <= F32_SHARE * scale
    audio = spec.numpy()[None, None, :, None, :]
    jax_audio = jax_spec[None, None, :, None, :]
    rng = np.random.default_rng(6)
    slow = rng.normal(size=(1, 3, 2, 32, 32)).astype(np.float32)
    fast = rng.normal(size=(1, 3, 8, 32, 32)).astype(np.float32)
    jax_model, variables, model, forward = _av_pair()
    ref = np.asarray(forward(variables, _jax([slow, fast, jax_audio])))
    out = _run(model, [slow, fast, audio])
    assert out.shape == (1, 7) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
