"""The port's video transforms (pytorchvideo_tpu_torch/transforms: functional
ops, the classes, ``create_video_transform``) against the JAX package's, on
the same seeded numpy clips.

Tolerances: index ops (subsample, crops, flip) exact; float32 ops rtol 1e-5,
atol 1e-6 on [0, 1] values, atol 1e-5 after normalize (one float32 rounding
or a reduction order apart); ``crop_and_resize`` at upscaling boxes atol
1e-6, border rows included. The JAX package's numpy inputs take its host
path (OpenCV's resize), its jax inputs the jnp path; both are held.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.transforms import functional as JF
from pytorchvideo_tpu.transforms import transforms as JT
from pytorchvideo_tpu.transforms import transforms_factory as jax_factory
from pytorchvideo_tpu_torch.transforms import functional as F
from pytorchvideo_tpu_torch.transforms import transforms as T
from pytorchvideo_tpu_torch.transforms.transforms_factory import (
    create_video_transform,
    transform_seeds,
)

FLOAT = dict(rtol=1e-5, atol=1e-6)
NORMALIZED = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(t=8, h=32, w=40, seed=0, uint8=False):
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 256, size=(t, h, w, 3)).astype(np.uint8)
    return clip if uint8 else clip.astype(np.float32) / np.float32(255.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("t,num", [(8, 4), (8, 8), (8, 3), (4, 10), (30, 13), (1, 5), (16, 7)])
def test_uniform_temporal_subsample_takes_jax_s_frames(t, num):
    x = _clip(t=t)
    ours = F.uniform_temporal_subsample(torch.from_numpy(x), num)
    np.testing.assert_array_equal(_np(ours), np.asarray(JF.uniform_temporal_subsample(x, num)))
    np.testing.assert_array_equal(
        _np(ours), np.asarray(JF.uniform_temporal_subsample(jnp.asarray(x), num)))


def test_linspace_indices_are_numpy_s():
    for t in range(1, 70):
        for n in range(1, 40):
            want = np.clip(np.linspace(0, t - 1, n), 0, t - 1).astype(np.int64)
            np.testing.assert_array_equal(F.linspace_indices(t, n).numpy(), want)


def test_uniform_temporal_subsample_repeated():
    x = _clip(t=16)
    ours = F.uniform_temporal_subsample_repeated(torch.from_numpy(x), (1, 4))
    theirs = JF.uniform_temporal_subsample_repeated(jnp.asarray(x), (1, 4))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("h,w,size", [(32, 40, 24), (40, 32, 24), (32, 32, 48), (31, 45, 17),
                                      (32, 40, 64)])
def test_short_side_scale_matches_jax_and_opencv(h, w, size):
    x = _clip(h=h, w=w)
    ours = _np(F.short_side_scale(torch.from_numpy(x), size))
    device_path = np.asarray(JF.short_side_scale(jnp.asarray(x), size))
    host_path = JF.short_side_scale(x, size)
    assert ours.shape == device_path.shape == host_path.shape
    np.testing.assert_allclose(ours, device_path, **FLOAT)
    np.testing.assert_allclose(ours, host_path, **FLOAT)


def test_resize_of_a_batch_of_clips_and_uint8():
    x = np.stack([_clip(seed=1), _clip(seed=2)])
    ours = _np(F.resize(torch.from_numpy(x), (20, 50)))
    np.testing.assert_allclose(ours, np.asarray(JF.resize(jnp.asarray(x), (20, 50))), **FLOAT)
    u8 = _clip(uint8=True)
    # A uint8 clip is resized as float32: held on the [0, 1] scale.
    np.testing.assert_allclose(_np(F.resize(torch.from_numpy(u8), (20, 50))) / 255,
                               np.asarray(JF.resize(jnp.asarray(u8, jnp.float32), (20, 50))) / 255,
                               **FLOAT)


@pytest.mark.parametrize("h,w", [(32, 48), (48, 32), (33, 47)])
def test_crops_and_flip_equal_jax_s(h, w):
    x = _clip(h=h, w=w)
    tx = torch.from_numpy(x)
    for idx in (0, 1, 2):
        np.testing.assert_array_equal(_np(F.uniform_crop(tx, 24, idx)),
                                      np.asarray(JF.uniform_crop(jnp.asarray(x), 24, idx)))
        np.testing.assert_array_equal(_np(F.uniform_crop(tx, 24, idx)),
                                      JF.uniform_crop(x, 24, idx))
    np.testing.assert_array_equal(_np(F.center_crop(tx, 20)),
                                  np.asarray(JF.center_crop(jnp.asarray(x), 20)))
    for y, xo in ((0, 0), (3, 5), (h - 20, w - 20), (h, w)):  # the last clamped
        np.testing.assert_array_equal(_np(F.crop(tx, y, xo, 20)),
                                      np.asarray(JF.crop(jnp.asarray(x), y, xo, 20)))
    np.testing.assert_array_equal(_np(F.horizontal_flip(tx)),
                                  np.asarray(JF.horizontal_flip(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(F.horizontal_flip(tx)), JF.horizontal_flip(x))


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_random_horizontal_flip_at_prob_0_and_1_as_jax_s(prob):
    x = _clip()
    ours = F.random_horizontal_flip(torch.from_numpy(x), prob, torch.Generator().manual_seed(0))
    theirs = JF.random_horizontal_flip(jnp.asarray(x), prob, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
    np.testing.assert_array_equal(_np(ours), x[:, :, ::-1] if prob else x)


def test_random_horizontal_flip_draws_from_the_generator():
    x = torch.from_numpy(_clip(t=1, h=2, w=3))
    flips = [not torch.equal(F.random_horizontal_flip(x, 0.5, gen), x)
             for gen in [torch.Generator().manual_seed(0)] for _ in range(400)]
    assert 150 < sum(flips) < 250
    gens = (torch.Generator().manual_seed(5), torch.Generator().manual_seed(5))
    assert all(torch.equal(F.random_horizontal_flip(x, 0.5, gens[0]),
                           F.random_horizontal_flip(x, 0.5, gens[1])) for _ in range(20))


def test_thwc_from_numpy_thwc_shares_memory_as_jax_s_values():
    x = _clip(uint8=True)
    ours = F.thwc_from_numpy_thwc(x)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(JF.thwc_from_numpy_thwc(x)))
    assert ours.dtype == torch.uint8 and ours.data_ptr() == x.ctypes.data


def test_random_crop_stays_inside():
    x = torch.from_numpy(_clip(h=32, w=48))
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        out = F.random_crop(x, 24, generator=g)
        assert out.shape == (8, 24, 24, 3)
        seen.add(out.data_ptr())
    assert len(seen) > 1


def test_div_255_normalize_and_layout():
    u8 = _clip(uint8=True)
    ours = F.div_255(torch.from_numpy(u8))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), np.asarray(JF.div_255(jnp.asarray(u8, jnp.float32))),
                               **FLOAT)
    x = _clip()
    mean, std = (0.45, 0.40, 0.35), (0.225, 0.25, 0.3)
    got = _np(F.normalize(torch.from_numpy(x), mean, std))
    np.testing.assert_allclose(got, np.asarray(JF.normalize(jnp.asarray(x), mean, std)),
                               **NORMALIZED)
    np.testing.assert_allclose(got, JF.normalize(x, mean, std), **NORMALIZED)
    cthw = F.thwc_to_cthw(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(cthw), np.asarray(JF.thwc_to_cthw(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(F.cthw_to_thwc(cthw)), x)


@pytest.mark.parametrize("box,out", [
    ((0.0, 0.0, 8.0, 10.0), (16, 20)),    # the issue's upscale, border rows
    ((3.0, 5.0, 12.0, 9.0), (24, 30)),
    ((0.0, 0.0, 32.0, 40.0), (48, 60)),
    ((2.0, 1.0, 20.0, 30.0), (10, 15)),   # downscale
    ((0.5, 1.25, 7.5, 6.5), (13, 17)),    # fractional box
])
def test_crop_and_resize_takes_jax_s_border_formula(box, out):
    x = _clip()
    ours = _np(F.crop_and_resize(torch.from_numpy(x), *box, *out))
    theirs = np.asarray(JF.crop_and_resize(jnp.asarray(x), *box, *out))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_crop_and_resize_border_differs_from_interpolate_as_jax_s_does():
    # Upscaling an 8x10 crop to 16x20: inside, slice-then-interpolate; the
    # first row and column mix pixels 0 and 1 where F.interpolate takes 0.
    x = _clip()
    ours = F.crop_and_resize(torch.from_numpy(x), 0.0, 0.0, 8.0, 10.0, 16, 20)
    crop = torch.from_numpy(x[:, :8, :10]).permute(0, 3, 1, 2)
    ref = TF.interpolate(crop, size=(16, 20), mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(ours[:, 1:-1, 1:-1]), _np(ref[:, 1:-1, 1:-1]), rtol=0,
                               atol=1e-6)
    assert (ours[:, 0] - ref[:, 0]).abs().max() > 0.05
    assert (ours[:, :, 0] - ref[:, :, 0]).abs().max() > 0.05


@pytest.mark.parametrize("scale,ratio,hw,log_uniform", [
    ((0.08, 1.0), (3 / 4, 4 / 3), (32, 40), True),
    ((0.08, 1.0), (3 / 4, 4 / 3), (64, 48), False),
    ((0.5, 0.9), (0.5, 2.0), (40, 40), True),
    ((3.0, 4.0), (3 / 4, 4 / 3), (32, 40), True),   # nothing fits: the central crop
    ((3.0, 4.0), (2.0, 3.0), (32, 40), True),       # central crop, wider than the frame
])
def test_crop_box_math_matches_jax_s_at_its_draws(scale, ratio, hw, log_uniform):
    height, width = hw
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        draws = [np.asarray(jax.random.uniform(k, shape)) for k, shape in
                 ((k1, (10,)), (k2, (10,)), (k3, ()), (k4, ()))]
        ours = F.crop_params_from_draws(*draws, scale, ratio, height, width, log_uniform)
        theirs = JF._sample_crop_params(key, scale, ratio, height, width, log_uniform)
        assert ours == tuple(float(v) for v in theirs), (seed, ours, theirs)


def test_random_resized_crop_draws_within_their_ranges():
    height, width = 48, 64
    g = torch.Generator().manual_seed(3)
    for _ in range(200):
        i, j, h, w = F._sample_crop_params(g, (0.08, 1.0), (3 / 4, 4 / 3), height, width)
        assert 0 < h <= height and 0 < w <= width
        assert 0 <= i <= height - h and 0 <= j <= width - w
        assert 0.08 * height * width * 0.8 <= h * w <= height * width
    x = torch.from_numpy(_clip(h=height, w=width))
    out = F.random_resized_crop(x, 24, 24, (0.08, 1.0), (3 / 4, 4 / 3), generator=g)
    assert out.shape == (8, 24, 24, 3) and out.dtype == torch.float32
    shifted = F.random_resized_crop(x, 24, 20, (0.08, 1.0), (3 / 4, 4 / 3), generator=g,
                                    shift=True)
    assert shifted.shape == (8, 24, 20, 3)


def _fix_boxes(monkeypatch, box):
    """Both packages' box samplers return ``box``."""
    monkeypatch.setattr(JF, "_sample_crop_params",
                        lambda *a, **k: tuple(jnp.float32(v) for v in box))
    monkeypatch.setattr(F, "_sample_crop_params", lambda *a, **k: box)


@pytest.mark.parametrize("shift", [False, True])
def test_random_resized_crop_at_given_boxes(monkeypatch, shift):
    _fix_boxes(monkeypatch, (3.0, 5.0, 20.0, 24.0))
    x = _clip()
    ours = T.RandomResizedCrop(16, 16, (0.08, 1.0), (3 / 4, 4 / 3), shift=shift, seed=1)
    theirs = JT.RandomResizedCrop(16, 16, (0.08, 1.0), (3 / 4, 4 / 3), shift=shift, seed=1)
    for _ in range(2):
        np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), np.asarray(theirs(x)),
                                   rtol=0, atol=1e-6)
    # The seed draw is the JAX transform's, so the generators stay in step.
    assert ours._rng.integers(1 << 30) == theirs._rng.integers(1 << 30)


@pytest.mark.parametrize("data_format", ["THWC", "CTHW"])
def test_seeded_class_transforms_equal_jax_s(data_format):
    x = _clip(h=36, w=44)
    layout = (lambda a: np.moveaxis(a, -1, 0)) if data_format == "CTHW" else (lambda a: a)
    pairs = [
        (T.RandomShortSideScale(20, 30, data_format=data_format, seed=5),
         JT.RandomShortSideScale(20, 30, data_format=data_format, seed=5), FLOAT),
        (T.RandomCropVideo(24, data_format=data_format, seed=6),
         JT.RandomCropVideo(24, data_format=data_format, seed=6), None),
        (T.RandomHorizontalFlipVideo(0.5, data_format=data_format, seed=7),
         JT.RandomHorizontalFlipVideo(0.5, data_format=data_format, seed=7), None),
        (T.ShortSideScale(28, data_format=data_format),
         JT.ShortSideScale(28, data_format=data_format), FLOAT),
        (T.CenterCropVideo(20, data_format=data_format),
         JT.CenterCropVideo(20, data_format=data_format), None),
        (T.UniformTemporalSubsample(5, data_format=data_format),
         JT.UniformTemporalSubsample(5, data_format=data_format), None),
        (T.Normalize((0.45, 0.4, 0.35), (0.225, 0.2, 0.25), data_format=data_format),
         JT.Normalize((0.45, 0.4, 0.35), (0.225, 0.2, 0.25), data_format=data_format),
         NORMALIZED),
    ]
    for ours, theirs, tol in pairs:
        for _ in range(6):
            got = _np(ours(torch.from_numpy(np.ascontiguousarray(layout(x)))))
            want = np.asarray(theirs(jnp.asarray(layout(x))))
            if tol is None:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **tol)


def test_dict_transforms_and_conversions():
    x = _clip(h=36, w=48)
    for idx in (0, 1, 2):
        ours = T.UniformCropVideo(24)({"video": torch.from_numpy(x), "aug_index": idx})
        theirs = JT.UniformCropVideo(24)({"video": jnp.asarray(x), "aug_index": idx})
        np.testing.assert_array_equal(_np(ours["video"]), np.asarray(theirs["video"]))
    sample = T.Compose([T.ApplyTransformToKey("video", T.Div255()), T.RemoveKey("audio"),
                        T.RemoveKey("absent")])({"video": torch.from_numpy(_clip(uint8=True)),
                                                 "audio": 1})
    assert set(sample) == {"video"} and sample["video"].dtype == torch.float32
    u8 = _clip(uint8=True)
    as_float = T.ConvertUint8ToFloat()(torch.from_numpy(u8))
    np.testing.assert_allclose(_np(as_float), JT.ConvertUint8ToFloat()(u8), **FLOAT)
    np.testing.assert_array_equal(_np(T.ConvertFloatToUint8()(as_float)),
                                  JT.ConvertFloatToUint8()(np.asarray(_np(as_float))))
    with pytest.raises(TypeError):
        T.ConvertUint8ToFloat()(as_float)
    np.testing.assert_array_equal(_np(T.Permute((3, 0, 1, 2))(torch.from_numpy(u8))),
                                  JT.Permute((3, 0, 1, 2))(u8))
    np.testing.assert_array_equal(_np(T.MoveChannelFront()(torch.from_numpy(u8))),
                                  np.asarray(JT.MoveChannelFront()(jnp.asarray(u8))))
    np.testing.assert_array_equal(_np(T.MoveChannelRear()(T.MoveChannelFront()(
        torch.from_numpy(u8)))), u8)


def test_op_sampler_draws_jax_s_ops():
    tags = []
    ops = [lambda v, i=i: tags.append(i) or v for i in range(5)]
    jax_tags = []
    jax_ops = [lambda v, i=i: jax_tags.append(i) or v for i in range(5)]
    for kw in (dict(num_sample_op=2), dict(num_sample_op=3, randomly_sample_depth=True),
               dict(num_sample_op=4, replacement=True, transforms_prob=[1, 2, 3, 4, 5])):
        ours, theirs = T.OpSampler(ops, seed=11, **kw), JT.OpSampler(jax_ops, seed=11, **kw)
        for _ in range(8):
            ours(None)
            theirs(None)
        assert tags == jax_tags
        tags.clear()
        jax_tags.clear()


def _substituted_default_rng(monkeypatch, seeds):
    """numpy.random.default_rng(None) returns generators of ``seeds`` in
    turn: the JAX package builds its random transforms unseeded, in the
    order the port gives them its split seeds."""
    original = np.random.default_rng
    queue = list(seeds)

    def default_rng(seed=None):
        if seed is None:
            return original(queue.pop(0))
        return original(seed)

    monkeypatch.setattr(np.random, "default_rng", default_rng)
    return queue


FACTORY_CASES = [
    ("train", "default", None, 3),
    ("train", "randaug", None, 4),
    ("train", "augmix", None, 4),
    ("train", "default", {}, 1),
    ("train", "randaug", {}, 2),
    ("val", "default", None, 0),
]


@pytest.mark.parametrize("mode,aug_type,rrc,n_random", FACTORY_CASES)
def test_create_video_transform_equals_jax_s_for_one_seed(monkeypatch, mode, aug_type, rrc,
                                                          n_random):
    if rrc is not None:
        _fix_boxes(monkeypatch, (4.0, 6.0, 24.0, 28.0))
    kwargs = dict(num_samples=4, min_size=24, max_size=32, crop_size=20, aug_type=aug_type,
                  random_resized_crop_paras=rrc)
    ours = create_video_transform(mode, seed=123, **kwargs)
    queue = _substituted_default_rng(monkeypatch, transform_seeds(123, 4)[:n_random])
    theirs = jax_factory.create_video_transform(mode, **kwargs)
    monkeypatch.undo()
    assert not queue
    if rrc is not None:
        _fix_boxes(monkeypatch, (4.0, 6.0, 24.0, 28.0))
    for seed in range(5):
        clip = _clip(t=6, h=30, w=36, seed=seed, uint8=True)
        np.testing.assert_allclose(_np(ours(torch.from_numpy(clip))), np.asarray(theirs(clip)),
                                   **NORMALIZED)


def test_create_video_transform_with_keys():
    t = create_video_transform("val", video_key="video", remove_key=["audio"], num_samples=4,
                               min_size=24, crop_size=20)
    out = t({"video": torch.from_numpy(_clip(t=6, h=30, w=36, uint8=True)), "audio": 0})
    assert set(out) == {"video"} and out["video"].shape == (4, 20, 20, 3)
    with pytest.raises(ValueError):
        create_video_transform("train", crop_size=300)
    with pytest.raises(ValueError):
        create_video_transform("train", remove_key=["audio"])


def _thwc_ordered(t):
    """Whether ``t``'s memory runs T, H, W, C (outermost to innermost)."""
    strides = t.stride()[-4:]
    return all(a >= b for a, b in zip(strides, strides[1:])) and strides[-1] == 1


def test_every_transform_keeps_thwc_memory():
    # The datamodule and chip_smoke stack CTHW views of the chains' outputs
    # in their memory order: a channels_last_3d batch needs THWC memory.
    from pytorchvideo_tpu_torch.transforms import augmentations as A

    clip = torch.from_numpy(_clip(t=4, h=34, w=46, uint8=True))
    for name, op in A._NAME_TO_TRANSFORM_FUNC.items():
        args = () if name in ("AutoContrast", "Equalize", "Invert") else (0.6,)
        for x in (clip, clip.float() / 255):
            assert _thwc_ordered(op(x, *args, fill=(0.5,) * 3)), name
    odd = clip.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1).float()  # TCHW memory
    assert _thwc_ordered(F.resize(odd, (20, 30))) and _thwc_ordered(F.short_side_scale(odd, 24))
    for aug_type in ("default", "randaug", "augmix"):
        chain = create_video_transform("train", num_samples=4, min_size=24, max_size=30,
                                       crop_size=20, aug_type=aug_type, seed=9)
        for seed in range(4):
            x = torch.from_numpy(_clip(t=6, h=30, w=36, seed=seed, uint8=True))
            assert _thwc_ordered(chain(x)), aug_type
