"""The port's AVA detection family against the JAX package's, with the same
seeded weights: RoIAlign (forward and the gradient to the features), the
RoI head, both detectors at narrow widths, the hub factories' trees at full
width, the box transforms, and the hub's checkpoint loader on weights the
test saves itself.

Tolerances: RoIAlign rtol 1e-5, atol 1e-5 (forward and gradient); the head
and the detectors the repo's f32 logits tolerance (rtol 5e-3, atol 5e-4,
tests/test_models_parity.py:24); the box ops exact up to one f32 rounding;
the loader exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.models import detection as jax_detection
from pytorchvideo_tpu.models import hub as jax_hub
from pytorchvideo_tpu.ops.roi_align import roi_align as jax_roi_align
from pytorchvideo_tpu.transforms import functional as jax_F
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.models.detection import (
    create_res_roi_pooling_head,
    create_resnet_with_roi_head,
)
from pytorchvideo_tpu_torch.models.hub import hub_model_builder, load_pretrained_variables
from pytorchvideo_tpu_torch.ops import RoIAlign, roi_align
from pytorchvideo_tpu_torch.transforms import functional as F
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, random_variables

ROI_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small ops run no faster on more, and a pool
    of threads in each of the suite's parallel workers oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax(x):
    """NCTHW numpy (or a list of them) -> the JAX package's channels-last."""
    if isinstance(x, list):
        return [_jax(p) for p in x]
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _torch(x):
    if isinstance(x, list):
        return [_torch(p) for p in x]
    return torch.from_numpy(x)


# --- RoIAlign ----------------------------------------------------------------

FMAP = (3, 6, 9, 11)  # (B, C, H, W)
# Boxes across every border, inside, smaller than a pixel, and on each batch
# row out of order.
BOXES = np.array([
    [0, -3.0, -2.0, 5.0, 4.0],
    [2, 1.3, 2.2, 14.0, 12.0],
    [1, 0.2, 0.4, 0.7, 0.9],
    [1, 8.0, 6.0, 30.0, 40.0],
    [0, 2.5, 1.5, 9.5, 7.25],
    [2, -20.0, -20.0, -5.0, -3.0],
], np.float32)


def _fmap(seed=0):
    return _rng(seed).normal(size=FMAP).astype(np.float32)


def _port_roi(f, boxes, *args):
    x = torch.from_numpy(f).contiguous(memory_format=torch.channels_last)
    return roi_align(x, torch.from_numpy(boxes), *args)


@pytest.mark.parametrize("sampling_ratio", [0, 1, 3])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("spatial_scale", [1.0, 0.5])
def test_roi_align_matches_jax(sampling_ratio, aligned, spatial_scale):
    f = _fmap()
    ref = jax_roi_align(jnp.asarray(f.transpose(0, 2, 3, 1)), jnp.asarray(BOXES), (3, 4),
                        spatial_scale, sampling_ratio, aligned)
    out = _port_roi(f, BOXES, (3, 4), spatial_scale, sampling_ratio, aligned)
    assert out.shape == (len(BOXES), FMAP[1], 3, 4)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref), **ROI_TOL)
    # The box wholly outside the map pools only zeros.
    assert not out[5].any()


@pytest.mark.parametrize("sampling_ratio, aligned", [(0, False), (1, True), (3, False)])
def test_roi_align_feature_gradient_matches_jax_vjp(sampling_ratio, aligned):
    f = _fmap(1)
    g = _rng(2).normal(size=(len(BOXES), 3, 4, FMAP[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_roi_align(a, jnp.asarray(BOXES), (3, 4), 0.5,
                                             sampling_ratio, aligned),
                     jnp.asarray(f.transpose(0, 2, 3, 1)))
    (ref,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(f).requires_grad_(True)
    out = roi_align(x, torch.from_numpy(BOXES), (3, 4), 0.5, sampling_ratio, aligned)
    out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), np.asarray(ref), **ROI_TOL)


def test_roi_align_routes_each_box_to_its_batch_row():
    f = np.stack([np.full((2, 4, 4), v, np.float32) for v in (0.0, 1.0, 2.0)])
    boxes = np.array([[2, 0, 0, 4, 4], [0, 0, 0, 4, 4], [1, 1, 1, 3, 3]], np.float32)
    out = RoIAlign((2, 2))(torch.from_numpy(f), torch.from_numpy(boxes))
    np.testing.assert_array_equal(out.numpy()[:, 0, 0, 0], [2.0, 0.0, 1.0])


def test_roi_align_keeps_bf16_takes_no_box_and_rejects_bad_shapes():
    f = torch.from_numpy(_fmap()).bfloat16()
    out = roi_align(f, torch.from_numpy(BOXES), (2, 2))
    assert out.dtype == torch.bfloat16
    ref = roi_align(f.float(), torch.from_numpy(BOXES), (2, 2))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2 ** -7, atol=1e-2)
    with pytest.raises(ValueError):
        roi_align(f, torch.from_numpy(BOXES[:, 1:]), (2, 2))
    # No box (a frame with no person): an empty result of the right shape.
    assert roi_align(f, torch.zeros(0, 5), (2, 3)).shape == (0, FMAP[1], 2, 3)


# --- the head and the detectors ------------------------------------------------

def _variables(module, *inputs, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, False))
    return random_variables(shapes, seed)


def _load(module, variables):
    module.load_state_dict(
        jax_variables_to_state_dict(variables["params"], variables.get("batch_stats", {})),
        strict=True)
    return module.eval()


def _boxes(n_per_clip, batch, size, seed):
    """(N, 5) boxes over ``batch`` clips of ``size`` pixels, some across the
    border."""
    rng = _rng(seed)
    rows = []
    for b in range(batch):
        xy = rng.uniform(-0.2 * size, 0.8 * size, size=(n_per_clip, 2))
        wh = rng.uniform(0.1 * size, 0.6 * size, size=(n_per_clip, 2))
        rows.append(np.concatenate([np.full((n_per_clip, 1), b), xy, xy + wh], axis=1))
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("activation, pool_spatial", [("sigmoid", "max"), ("softmax", None)])
def test_roi_head_matches_jax(activation, pool_spatial):
    kw = dict(in_features=16, out_features=5, resolution=(4, 4), spatial_scale=0.5,
              dropout_rate=0.0, pool_kernel_size=(2, 1, 1), pool_spatial=pool_spatial,
              output_with_global_average=pool_spatial is None)
    jax_head = jax_detection.create_res_roi_pooling_head(
        **kw, activation={"sigmoid": jax.nn.sigmoid, "softmax": jax.nn.softmax}[activation])
    head = create_res_roi_pooling_head(
        **kw, activation={"sigmoid": torch.nn.Sigmoid, "softmax": torch.nn.Softmax}[activation],
        device="cpu")
    x = _rng(3).normal(size=(2, 16, 2, 8, 8)).astype(np.float32)
    boxes = _boxes(3, 2, 16, seed=4)
    variables = _variables(jax_head, _jax(x), jnp.asarray(boxes), seed=5)
    ref = np.asarray(jax_head.apply(variables, _jax(x), jnp.asarray(boxes), False))
    with torch.no_grad():
        out = _load(head, variables)(_torch(x).contiguous(memory_format=torch.channels_last_3d),
                                     torch.from_numpy(boxes)).numpy()
    if pool_spatial is None:
        assert out.shape == ref.shape == (6, 5)
    else:
        assert out.shape == (6, 5, 1, 1, 1)
        out = np.moveaxis(out, 1, -1)
    np.testing.assert_allclose(out, ref, **TOL)


def test_roi_head_needs_one_frame():
    head = create_res_roi_pooling_head(in_features=4, out_features=2, resolution=(2, 2),
                                       spatial_scale=1.0, pool=None, device="cpu")
    with pytest.raises(ValueError, match="temporal dimension"):
        head(torch.zeros(1, 4, 2, 4, 4), torch.zeros(1, 5))


SLOW = dict(stem_dim_out=8, stage_depths=(1, 1, 1, 1), model_num_class=5, dropout_rate=0.0)
SLOWFAST = dict(stem_dim_outs=(16, 2), stage_depths=(1, 1, 1, 1), model_num_class=5,
                dropout_rate=0.0, head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)))


@functools.lru_cache(maxsize=None)
def _detector_pair(name):
    """(port model with the JAX model's seeded weights, clip, boxes, JAX
    scores) of a narrow detector at 64x64."""
    if name == "slow_r50_detection":
        x, kw = _rng(6).normal(size=(2, 3, 4, 64, 64)).astype(np.float32), SLOW
    else:
        x = [_rng(6).normal(size=(2, 3, 4, 64, 64)).astype(np.float32),
             _rng(7).normal(size=(2, 3, 16, 64, 64)).astype(np.float32)]
        kw = SLOWFAST
    boxes = _boxes(3, 2, 64, seed=8)
    jax_model = getattr(jax_hub, name)(**kw)
    variables = _variables(jax_model, _jax(x), jnp.asarray(boxes), seed=9)
    ref = np.asarray(jax.jit(lambda v, a, b: jax_model.apply(v, a, b, False))(
        variables, _jax(x), jnp.asarray(boxes)))
    model = _load(getattr(hub, name)(**kw, device="cpu"), variables)
    return model, x, boxes, ref


@pytest.mark.parametrize("name", ["slow_r50_detection", "slowfast_r50_detection"])
def test_detector_scores_match_jax(name):
    model, x, boxes, ref = _detector_pair(name)
    with torch.no_grad():
        out = model(_torch(x), torch.from_numpy(boxes)).numpy()
    assert out.shape == (6, 5, 1, 1, 1) and ref.shape == (6, 1, 1, 1, 5)
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, **TOL)
    assert ((out >= 0) & (out <= 1)).all()  # sigmoid scores


def test_detector_scores_do_not_depend_on_the_other_boxes():
    model, x, boxes, _ = _detector_pair("slow_r50_detection")
    with torch.no_grad():
        all_boxes = model(_torch(x), torch.from_numpy(boxes))
        one = model(_torch(x), torch.from_numpy(boxes[4:5]))
    np.testing.assert_allclose(one.numpy(), all_boxes[4:5].numpy(), rtol=1e-5, atol=1e-6)


# (factory, its clip: one (T, S) per pathway) at full width.
DETECTORS = [("slow_r50_detection", [(4, 256)]),
             ("slowfast_r50_detection", [(8, 256), (32, 256)])]


@pytest.mark.parametrize("name, clip", DETECTORS, ids=[d[0] for d in DETECTORS])
def test_hub_detector_tree_matches_jax_at_full_width(name, clip):
    model = getattr(jax_hub, name)()
    xs = [jax.ShapeDtypeStruct((1, T, S, S, 3), jnp.float32) for T, S in clip]
    boxes = jax.ShapeDtypeStruct((1, 5), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: model.init(jax.random.PRNGKey(0), a, b, False),
                            xs if len(xs) > 1 else xs[0], boxes)
    ours = getattr(hub, name)(device="meta")
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in ours.parameters()) == n_jax
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    converted = jax_variables_to_state_dict(zeros["params"], zeros["batch_stats"])
    assert ({k: tuple(v.shape) for k, v in ours.state_dict().items()}
            == {k: tuple(v.shape) for k, v in converted.items()})
    assert ours.detection_head.proj.out_features == 80
    assert ours.detection_head.roi_layer.spatial_scale == 1.0 / 16.0


@pytest.mark.parametrize("name", ["slow_r50_detection", "slowfast_r50_detection"])
def test_hub_detectors_build_on_the_cpu_when_asked_and_on_the_card_by_default(name):
    model = getattr(hub, name)(device="cpu")
    assert {p.device.type for p in model.state_dict().values()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            getattr(hub, name)()


# --- the hub's loader ------------------------------------------------------------

def _small_slow(**kw):
    return create_resnet_with_roi_head(**{**SLOW, **kw}, device="cpu")


def test_load_pretrained_variables_round_trips_a_saved_pyth(tmp_path):
    model, x, boxes, _ = _detector_pair("slow_r50_detection")
    path = str(tmp_path / "SLOW_DETECTION.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    fresh = _small_slow().eval()
    assert load_pretrained_variables(fresh, None, path) is fresh
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(_torch(x), torch.from_numpy(boxes)).numpy(),
                                      model(_torch(x), torch.from_numpy(boxes)).numpy())
    # A loaded dict and a bare state_dict load the same way.
    for checkpoint in ({"model_state": model.state_dict()}, model.state_dict()):
        again = load_pretrained_variables(_small_slow(), None, checkpoint)
        for key, value in model.state_dict().items():
            assert torch.equal(again.state_dict()[key], value), key


def test_load_pretrained_variables_renames_keys_and_is_strict(tmp_path):
    model = _small_slow()
    torch.nn.init.normal_(model.detection_head.proj.weight)
    renamed = {k.replace("detection_head.", "head."): v for k, v in model.state_dict().items()}
    path = str(tmp_path / "renamed.pyth")
    torch.save({"model_state": renamed}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_variables(_small_slow(), None, path)
    loaded = load_pretrained_variables(_small_slow(), None, path,
                                       rename_rules=[(r"^head\.", "detection_head.")])
    assert torch.equal(loaded.detection_head.proj.weight, model.detection_head.proj.weight)
    # Not strict: the keys that match load, the rest stay as built.
    partial = {k: v for k, v in model.state_dict().items() if k.startswith("detection_head.")}
    target = _small_slow()
    stem_before = target.model.blocks[0].conv.weight.clone()
    load_pretrained_variables(target, None, partial, strict=False)
    assert torch.equal(target.detection_head.proj.weight, model.detection_head.proj.weight)
    assert torch.equal(target.model.blocks[0].conv.weight, stem_before)


def test_hub_model_builder(tmp_path):
    model = hub_model_builder(create_resnet_with_roi_head, device="cpu",
                              default_config=dict(SLOW, model_num_class=3),
                              model_num_class=None, stem_dim_out=8)
    assert model.detection_head.proj.out_features == 3
    path = str(tmp_path / "zoo.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    pretrained = hub_model_builder(create_resnet_with_roi_head, pretrained=True,
                                   checkpoint_path=path,
                                   default_config=dict(SLOW, model_num_class=3), device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(pretrained.state_dict()[key], value), key
    with pytest.raises(ValueError):
        hub_model_builder(create_resnet_with_roi_head, pretrained=True, checkpoint_path=path,
                          model_num_class=7, device="cpu")


# --- the box transforms ------------------------------------------------------------

def _box_clip(seed=10):
    clip = _rng(seed).uniform(0, 255, size=(3, 12, 20, 3)).astype(np.float32)
    boxes = np.array([[-3.0, 2.0, 8.5, 30.0], [4.0, 1.0, 18.0, 10.0], [19.5, -1.0, 25.0, 5.0]],
                     np.float32)
    return clip, boxes


def test_crop_and_clip_boxes_match_jax():
    _, boxes = _box_clip()
    np.testing.assert_array_equal(F.crop_boxes(torch.from_numpy(boxes), 3, 2).numpy(),
                                  np.asarray(jax_F.crop_boxes(jnp.asarray(boxes), 3, 2)))
    np.testing.assert_array_equal(
        F.clip_boxes_to_image(torch.from_numpy(boxes), 12, 20).numpy(),
        np.asarray(jax_F.clip_boxes_to_image(jnp.asarray(boxes), 12, 20)))


@pytest.mark.parametrize("size", [6, 16])
def test_short_side_scale_with_boxes_matches_jax(size):
    clip, boxes = _box_clip()
    images, scaled = F.short_side_scale_with_boxes(torch.from_numpy(clip),
                                                   torch.from_numpy(boxes), size)
    ref_images, ref_boxes = jax_F.short_side_scale_with_boxes(jnp.asarray(clip),
                                                              jnp.asarray(boxes), size)
    np.testing.assert_allclose(images.numpy(), np.asarray(ref_images), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(scaled.numpy(), np.asarray(ref_boxes), rtol=1e-6)


def test_random_short_side_scale_with_boxes_draws_from_the_generator():
    clip, boxes = _box_clip()
    gen = torch.Generator().manual_seed(3)
    size = int(torch.randint(8, 14 + 1, (), generator=torch.Generator().manual_seed(3)))
    images, scaled = F.random_short_side_scale_with_boxes(
        torch.from_numpy(clip), torch.from_numpy(boxes), 8, 14, generator=gen)
    ref_images, ref_boxes = jax_F.short_side_scale_with_boxes(jnp.asarray(clip),
                                                              jnp.asarray(boxes), size)
    assert images.shape == ref_images.shape and min(images.shape[1:3]) == size
    np.testing.assert_allclose(scaled.numpy(), np.asarray(ref_boxes), rtol=1e-6)


@pytest.mark.parametrize("spatial_idx", [0, 1, 2])
def test_uniform_crop_with_boxes_matches_jax(spatial_idx):
    clip, boxes = _box_clip()
    images, cropped = F.uniform_crop_with_boxes(torch.from_numpy(clip), 10,
                                                spatial_idx, torch.from_numpy(boxes))
    ref_images, ref_boxes = jax_F.uniform_crop_with_boxes(jnp.asarray(clip), 10, spatial_idx,
                                                          jnp.asarray(boxes))
    np.testing.assert_array_equal(images.numpy(), np.asarray(ref_images))
    np.testing.assert_array_equal(cropped.numpy(), np.asarray(ref_boxes))
    assert cropped.min() >= 0 and cropped.max() <= 9


def test_random_crop_with_boxes_is_the_jax_crop_at_its_draw():
    clip, boxes = _box_clip()
    images, cropped = F.random_crop_with_boxes(torch.from_numpy(clip), 10,
                                               torch.from_numpy(boxes),
                                               generator=torch.Generator().manual_seed(5))
    replay = torch.Generator().manual_seed(5)
    y = int(torch.randint(0, 12 - 10 + 1, (), generator=replay))
    x = int(torch.randint(0, 20 - 10 + 1, (), generator=replay))
    ref_boxes = jax_F.clip_boxes_to_image(jax_F.crop_boxes(jnp.asarray(boxes), x, y), 10, 10)
    np.testing.assert_array_equal(images.numpy(), clip[:, y:y + 10, x:x + 10])
    np.testing.assert_array_equal(cropped.numpy(), np.asarray(ref_boxes))


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_horizontal_flip_with_boxes_matches_jax(prob):
    clip, boxes = _box_clip()
    images, flipped = F.horizontal_flip_with_boxes(prob, torch.from_numpy(clip),
                                                   torch.from_numpy(boxes),
                                                   generator=torch.Generator().manual_seed(0))
    ref_images, ref_boxes = jax_F.horizontal_flip_with_boxes(
        prob, jnp.asarray(clip), jnp.asarray(boxes), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(images.numpy(), np.asarray(ref_images))
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(ref_boxes))
