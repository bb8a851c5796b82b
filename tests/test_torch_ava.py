"""The port's frame-directory video and AVA dataset against the JAX
package's: FrameVideo on directories of PNG frames written with OpenCV
(clip times, natural order, frame filters, threaded reads, the listing
cache, the path handler's dispatch), and Ava on small frame-list, label and
label-map files written in a temporary directory (the parsed labels and
every sample).

Tolerances: everything exact. Clips are uint8 in the port and float32 [0,
255] in the JAX package: equal values.
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.data import ava as jax_ava
from pytorchvideo_tpu.data import clip_sampling as jax_cs
from pytorchvideo_tpu.data import samplers as jax_samplers
from pytorchvideo_tpu.data.frame_video import FrameVideo as JaxFrameVideo
from pytorchvideo_tpu_torch.data import (
    Ava,
    AvaLabeledVideoFramePaths,
    FrameVideo,
    SequentialSampler,
    VideoPathHandler,
)
from pytorchvideo_tpu_torch.data import clip_sampling as cs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    of threads in each of the suite's parallel workers oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_frames(directory, names, seed, height=6, width=8):
    """Seeded RGB frames as lossless PNGs named ``names``; returns them
    (T, H, W, C) uint8 in the order of ``names``."""
    import cv2

    os.makedirs(directory, exist_ok=True)
    frames = np.random.default_rng(seed).integers(0, 256, (len(names), height, width, 3),
                                                  dtype=np.uint8)
    for name, frame in zip(names, frames):
        assert cv2.imwrite(os.path.join(directory, name), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return frames


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    # Natural order: frame_2 before frame_10 (a plain sort puts it after).
    names = [f"frame_{i}.png" for i in range(1, 16)]
    directory = str(tmp_path_factory.mktemp("frames") / "clip_a")
    return directory, _write_frames(directory, names, seed=0)


@pytest.mark.parametrize("start, end", [(0.0, 1.0), (0.25, 0.75), (0.1, 2.0), (1.4, 1.5)])
@pytest.mark.parametrize("multithreaded", [False, True])
def test_frame_video_clips_equal_jax_s(frame_dir, start, end, multithreaded):
    directory, frames = frame_dir
    ours = FrameVideo.from_directory(directory, fps=10, multithreaded_io=multithreaded)
    theirs = JaxFrameVideo.from_directory(directory, fps=10, multithreaded_io=multithreaded)
    assert ours.duration == theirs.duration == 1.5
    assert ours.name == theirs.name == "clip_a"
    a, b = ours.get_clip(start, end), theirs.get_clip(start, end)
    assert a["frame_indices"] == b["frame_indices"] and a["audio"] is None
    assert a["video"].dtype == torch.uint8
    np.testing.assert_array_equal(a["video"].numpy(), b["video"])
    np.testing.assert_array_equal(a["video"].numpy(), frames[a["frame_indices"]])


def test_frame_video_filter_cache_and_refusals(frame_dir):
    directory, frames = frame_dir
    cache = {}
    ours = FrameVideo.from_directory(directory, fps=10, path_order_cache=cache)
    assert [os.path.basename(p) for p in cache[directory]][:3] == [
        "frame_1.png", "frame_2.png", "frame_3.png"]
    again = FrameVideo.from_directory(directory, fps=10, path_order_cache=cache)
    assert again._video_frame_paths is cache[directory]
    theirs = JaxFrameVideo.from_directory(directory, fps=10)

    def every_third(indices):
        return indices[::3]

    a = ours.get_clip(0.0, 1.5, frame_filter=every_third)
    b = theirs.get_clip(0.0, 1.5, frame_filter=every_third)
    assert a["frame_indices"] == b["frame_indices"] == list(range(0, 15, 3))
    np.testing.assert_array_equal(a["video"].numpy(), b["video"])
    assert ours.get_clip(2.0, 3.0) is None and theirs.get_clip(2.0, 3.0) is None
    assert ours.get_clip(-0.5, 1.0) is None
    by_fn = FrameVideo(1.5, 10, video_frame_to_path_fn=lambda i: cache[directory][i])
    np.testing.assert_array_equal(by_fn._video_frame_to_path(4), cache[directory][4])
    with pytest.raises(ValueError):
        FrameVideo.from_frame_paths([])
    with pytest.raises(ValueError):
        FrameVideo.from_directory(os.path.join(directory, "frame_1.png"))


def test_path_handler_dispatches_a_frame_directory(frame_dir):
    directory, frames = frame_dir
    handler = VideoPathHandler()
    video = handler.video_from_path(directory, fps=10)
    assert isinstance(video, FrameVideo) and directory in handler.path_order_cache
    np.testing.assert_array_equal(video.get_clip(0, 1.5)["video"].numpy(), frames)
    with pytest.raises(ValueError, match="audio"):
        handler.video_from_path(directory, decode_audio=True)


def test_unreadable_frame_raises(tmp_path):
    directory = tmp_path / "broken"
    directory.mkdir()
    (directory / "frame_1.png").write_bytes(b"not a png")
    video = FrameVideo.from_directory(str(directory), fps=10)
    with pytest.raises(RuntimeError, match="Failed to load"):
        video.get_clip(0.0, 0.1)


# --- AVA -------------------------------------------------------------------------------

FPS = 30
AVA_FRAMES = 100  # 3.33 s: keyframes at 902 and 903 s (2 and 3 s after the start)
LABEL_MAP = """item {
  name: "bend/bow (at the waist)"
  id: 1
}
item {
  name: "crawl"
  id: 2
}
item {
  name: "dance"
  label_id: 5
}
"""
# video, second, x1, y1, x2, y2, action, person: a box with two labels, an
# empty label, a label off the map, a second before AVA's valid range.
LABELS = """vid_b,0902,0.100,0.200,0.500,0.600,1,0
vid_b,0902,0.100,0.200,0.500,0.600,2,0
vid_b,0902,0.300,0.100,0.900,0.800,5,1
vid_a,0903,0.000,0.000,0.400,0.950,2,0
vid_a,0902,0.250,0.250,0.750,0.750,,2
vid_a,0902,0.200,0.300,0.600,0.700,7,3
vid_a,0899,0.200,0.300,0.600,0.700,1,0
"""


@pytest.fixture(scope="module")
def ava_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ava")
    frames_root = root / "frames"
    rows = ["original_video_id video_id frame_id path labels"]
    for video_id, name in enumerate(("vid_a", "vid_b")):
        names = [f"{name}_{i + 1:06d}.png" for i in range(AVA_FRAMES)]
        _write_frames(str(frames_root / name), names, seed=10 + video_id, height=4, width=6)
        # Listed out of order: the parser sorts by frame id.
        for i in reversed(range(AVA_FRAMES)):
            rows.append(f'{name} {video_id} {i} {name}/{names[i]} ""')
    (root / "frame_list.csv").write_text("\n".join(rows) + "\n")
    (root / "labels.csv").write_text(LABELS)
    (root / "label_map.pbtxt").write_text(LABEL_MAP)
    return {"frame_paths_file": str(root / "frame_list.csv"),
            "frame_labels_file": str(root / "labels.csv"),
            "video_path_prefix": str(frames_root),
            "label_map_file": str(root / "label_map.pbtxt")}


@pytest.mark.parametrize("with_map", [True, False])
def test_ava_labels_parse_as_jax_s(ava_files, with_map):
    files = dict(ava_files, label_map_file=ava_files["label_map_file"] if with_map else None)
    ours = AvaLabeledVideoFramePaths.from_csv(**files)
    theirs = jax_ava.AvaLabeledVideoFramePaths.from_csv(**files)
    assert ours == theirs
    by_key = {(labels["video_index"], labels["clip_index"]): labels for _, labels in ours}
    merged = by_key[(1, 2.0)]  # vid_b at 902 s: one box, two labels
    assert merged["boxes"][0] == [0.1, 0.2, 0.5, 0.6] and merged["labels"][0] == [1, 2]
    assert (0, -1.0) not in by_key  # 899 s lies before the valid range
    assert by_key[(0, 3.0)]["labels"] == [[2]]
    if with_map:  # the empty label and label 7 are off the map: no box is left
        assert (0, 2.0) not in by_key and len(ours) == 2
    else:
        assert by_key[(0, 2.0)]["labels"] == [[-1], [7]] and len(ours) == 3
    label_map, ids = AvaLabeledVideoFramePaths.read_label_map(ava_files["label_map_file"])
    assert (label_map, ids) == jax_ava.AvaLabeledVideoFramePaths.read_label_map(
        ava_files["label_map_file"])
    assert ids == {1, 2, 5} and label_map[5] == "dance"


def _take(dataset, n):
    out = []
    for _ in range(n):
        try:
            out.append(next(dataset))
        except StopIteration:
            break
    return out


def test_ava_samples_equal_jax_s(ava_files):
    duration = Fraction(8, FPS)
    files = dict(ava_files, label_map_file=None)
    ours = _take(Ava(**files, clip_sampler=cs.UniformClipSampler(duration),
                     video_sampler=SequentialSampler), 10)
    theirs = _take(jax_ava.Ava(**files, clip_sampler=jax_cs.UniformClipSampler(duration),
                               video_sampler=jax_samplers.SequentialSampler), 10)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in a:
            if key == "video":
                assert a[key].dtype == torch.uint8 and a[key].shape == (8, 4, 6, 3)
                np.testing.assert_array_equal(a[key].numpy(), b[key])
            else:
                assert a[key] == b[key], key
    # The clip is centred on the keyframe: frames 56-63 around 2 s at 30 fps.
    first = ours[0]
    assert first["clip_index"] == 2.0 and first["video_name"] == "vid_b"
    np.testing.assert_array_equal(
        first["video"].numpy(),
        FrameVideo.from_directory(os.path.join(ava_files["video_path_prefix"], "vid_b"),
                                  fps=FPS).get_clip(56 / FPS, 64 / FPS)["video"].numpy())


def test_ava_seeded_order_is_repeatable(ava_files):
    def order(seed):
        dataset = Ava(**dict(ava_files, label_map_file=None),
                      clip_sampler=cs.UniformClipSampler(Fraction(4, FPS)), seed=seed)
        return [(s["video_index"], s["clip_index"]) for s in _take(dataset, 3)]

    assert order(3) == order(3)
    assert sorted(order(3)) == [(0, 2.0), (0, 3.0), (1, 2.0)]
