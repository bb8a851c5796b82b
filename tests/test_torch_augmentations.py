"""The port's augmentation ops, RandAugment and AugMix
(pytorchvideo_tpu_torch/transforms/augmentations.py, rand_augment.py,
augmix.py) against the JAX package's numpy ones, on the same seeded clips.

Tolerances: uint8 clips exact (the port computes numpy's arithmetic, float64
where a numpy float64 scalar makes numpy compute in float64); float clips
in [0, 1] atol 1e-6 (a mean or a blur summed in another order).
"""

import numpy as np
import pytest
import torch

from pytorchvideo_tpu.transforms import augmentations as JA
from pytorchvideo_tpu.transforms.augmix import AugMix as JaxAugMix
from pytorchvideo_tpu.transforms.rand_augment import RandAugment as JaxRandAugment
from pytorchvideo_tpu_torch.transforms import augmentations as A
from pytorchvideo_tpu_torch.transforms.augmix import AugMix
from pytorchvideo_tpu_torch.transforms.rand_augment import RandAugment

FLOAT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    in each of the suite's parallel workers oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(seed=0, t=4, h=32, w=40, uint8=True):
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 256, size=(t, h, w, 3)).astype(np.uint8)
    if seed % 3 == 2:  # a flat channel and a narrow range: autocontrast's and equalize's edges
        clip[..., 1] = 77
        clip[..., 2] = clip[..., 2] // 16 + 100
    return clip if uint8 else clip.astype(np.float32) / np.float32(255.0)


def _same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


# (op, factors): each factor as a Python float and as a numpy float64,
# which numpy computes with in float64.
OPS = [
    ("AutoContrast", [None]),
    ("Equalize", [None]),
    ("Invert", [None]),
    ("AdjustBrightness", [0.3, 1.6, np.float64(1.37)]),
    ("AdjustContrast", [0.2, 1.8, np.float64(0.55)]),
    ("AdjustSaturation", [0.1, 1.9, np.float64(1.21)]),
    ("AdjustSharpness", [0.1, 1.9, np.float64(1.43)]),
    ("Posterize", [0, 2, 4, 8]),
    ("Solarize", [0.1, 0.5, 0.9, np.float64(0.42)]),
    ("Rotate", [-27.0, 13.5, 90.0]),
    ("ShearX", [-0.3, 0.17, np.float64(0.25)]),
    ("ShearY", [0.3, -0.11, np.float64(-0.2)]),
    ("TranslateX", [-0.45, 0.2, np.float64(0.31)]),
    ("TranslateY", [0.45, -0.13, np.float64(-0.37)]),
]


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("name,factors", OPS, ids=[o[0] for o in OPS])
def test_each_op_equals_jax_s(name, factors, uint8):
    ours, theirs = A._NAME_TO_TRANSFORM_FUNC[name], JA._NAME_TO_TRANSFORM_FUNC[name]
    for seed in range(3):
        clip = _clip(seed, uint8=uint8)
        for factor in factors:
            args = () if factor is None else (factor,)
            _same(ours(torch.from_numpy(clip), *args, fill=(0.5, 0.4, 0.3)),
                  theirs(clip, *args, fill=(0.5, 0.4, 0.3)))


@pytest.mark.parametrize("uint8", [True, False])
def test_affine_nearest_and_bilinear(uint8):
    clip = _clip(1, uint8=uint8)
    for matrix in ([1, 0.1, 2.5, -0.2, 1, -3.0],
                   [np.float64(0.9), np.float64(-0.3), 0, np.float64(0.3), np.float64(0.9), 1.5]):
        for interpolation in ("nearest", "bilinear"):
            _same(A.affine(torch.from_numpy(clip), matrix, interpolation=interpolation),
                  JA.affine(clip, matrix, interpolation=interpolation))


@pytest.mark.parametrize("name", list(A._NAME_TO_TRANSFORM_FUNC))
def test_augment_transform_draws_and_applies_as_jax_s(name):
    for kw in (dict(magnitude=9, prob=0.7),
               dict(magnitude=5, prob=1.0, sampling_type="uniform",
                    sampling_hparas={"sampling_data_type": "float", "sampling_min": 0.1})):
        ours = A.AugmentTransform(name, seed=4, **kw)
        theirs = JA.AugmentTransform(name, seed=4, **kw)
        for seed in range(4):
            clip = _clip(seed)
            _same(ours(torch.from_numpy(clip)), theirs(clip))


@pytest.mark.parametrize("uint8", [True, False])
def test_rand_augment_over_ten_clips_equals_jax_s(uint8):
    ours, theirs = RandAugment(seed=2024), JaxRandAugment(seed=2024)
    for seed in range(10):
        clip = _clip(seed, uint8=uint8)
        _same(ours(torch.from_numpy(clip)), theirs(clip))


@pytest.mark.parametrize("kw", [{}, dict(magnitude=7, width=2, depth=2, alpha=0.5)])
def test_aug_mix_over_ten_clips_equals_jax_s(kw):
    ours, theirs = AugMix(seed=99, **kw), JaxAugMix(seed=99, **kw)
    for seed in range(10):
        clip = _clip(seed, uint8=seed % 2 == 0)
        _same(ours(torch.from_numpy(clip)), theirs(clip))


def test_equalize_histograms_per_frame_and_channel():
    # A clip whose frames and channels differ in range: one LUT each.
    clip = _clip(5)
    clip[0] //= 4
    clip[1, ..., 0] = 3
    _same(A._equalize(torch.from_numpy(clip)), JA._equalize(clip))


def test_invalid_arguments_raise():
    with pytest.raises(ValueError):
        A.AugmentTransform("NotAnOp")
    with pytest.raises(ValueError):
        A.AugmentTransform("Rotate", sampling_type="other")
    with pytest.raises(ValueError):
        AugMix(magnitude=11)
