"""Functional video transforms on ``torch.Tensor`` clips (counterpart of
pytorchvideo_tpu/transforms/functional.py; upstream
pytorchvideo/transforms/functional.py, cited per function).

Clips are channels-last ``(..., T, H, W, C)`` ("THWC"), as in the JAX
package; :func:`thwc_to_cthw` makes the models' (C, T, H, W) view. Every op
runs on whatever device its tensor lies on, with the same arithmetic, and
none reads a device value back to the host: offsets and sizes are Python
ints, random draws are made on the host (a numpy ``Generator`` in the
transform classes, a CPU ``torch.Generator`` here) and index tensors are
computed where the clip is. So a chain of them queues on the card without
waiting for it.

Where the JAX package's arithmetic and upstream's differ, the port computes
the JAX package's: :func:`crop_and_resize` clamps the source index, not the
coordinate, at the border (its first row and column mix pixels 0 and 1
where ``F.interpolate`` takes pixel 0). The box ops take (..., 4) boxes
(x1, y1, x2, y2) in pixels beside the clip they go with.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorchvideo_tpu_torch.utils.profiling import annotate

# Axis convention for the native THWC layout.
TEMPORAL_AXIS = -4
HEIGHT_AXIS = -3
WIDTH_AXIS = -2
CHANNEL_AXIS = -1


def device_constant(values: Sequence[float], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A (len(values),) tensor on ``device`` filled on the device itself: a
    copy from pageable host memory would wait for the card."""
    if torch.device(device).type == "cpu":
        return torch.tensor([float(v) for v in values], dtype=dtype)
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])


# ---------------------------------------------------------------------------
# Layout adapters
# ---------------------------------------------------------------------------


def cthw_to_thwc(x: torch.Tensor) -> torch.Tensor:
    """(..., C, T, H, W) -> (..., T, H, W, C), a view."""
    return x.movedim(-4, -1)


def thwc_to_cthw(x: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., C, T, H, W), a view (a batch of such
    clips stacked from contiguous THWC memory is ``channels_last_3d``)."""
    with annotate("pvt.transform.thwc_to_cthw"):
        return x.movedim(-1, -4)


def thwc_from_numpy_thwc(x: np.ndarray) -> torch.Tensor:
    """A THWC numpy clip as a tensor sharing its memory."""
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Temporal ops
# ---------------------------------------------------------------------------


def linspace_indices(t: int, num_samples: int, device=None) -> torch.Tensor:
    """``np.clip(np.linspace(0, t - 1, num_samples), 0, t - 1).astype(int64)``
    computed on ``device`` with numpy's arithmetic (float64 ``i * step``, the
    last point set to the stop), so the indices equal the JAX package's
    without a copy from the host."""
    if num_samples <= 0 or t <= 0:
        raise ValueError(f"need num_samples > 0 and t > 0, got {num_samples}, {t}")
    stop = float(t - 1)
    if num_samples == 1:
        return torch.zeros(1, dtype=torch.long, device=device)
    step = stop / (num_samples - 1)
    points = torch.arange(num_samples, dtype=torch.float64, device=device)
    points = points * step if step != 0 else points / (num_samples - 1) * stop
    points[-1] = stop
    return points.clamp(0, stop).long()


def uniform_temporal_subsample(
    x: torch.Tensor, num_samples: int, temporal_axis: int = TEMPORAL_AXIS
) -> torch.Tensor:
    """``num_samples`` frames evenly spaced along ``temporal_axis``
    (upstream functional.py:19-41; indices as numpy's ``linspace``, see
    :func:`linspace_indices`)."""
    t = x.shape[temporal_axis]
    return x.index_select(temporal_axis, linspace_indices(t, num_samples, x.device))


def uniform_temporal_subsample_repeated(
    frames: torch.Tensor, frame_ratios: Sequence[int], temporal_axis: int = TEMPORAL_AXIS
) -> Tuple[torch.Tensor, ...]:
    """Per-pathway temporal subsampling (upstream functional.py:134-161)."""
    temporal_length = frames.shape[temporal_axis]
    return tuple(uniform_temporal_subsample(frames, temporal_length // ratio, temporal_axis)
                 for ratio in frame_ratios)


# ---------------------------------------------------------------------------
# Spatial resize / crop
# ---------------------------------------------------------------------------


def resize(x: torch.Tensor, size: Tuple[int, int], interpolation: str = "bilinear") -> torch.Tensor:
    """Resize the (H, W) of a THWC clip to ``size``: ``F.interpolate`` with
    half-pixel centres and no antialias on a (N, C, H, W) view, which is
    what ``jax.image.resize(antialias=False)`` and OpenCV compute (upstream
    functional.py:92-131). A clip that is not floating point is resized
    as float32. The result is contiguous THWC, whatever the input's
    memory order."""
    if interpolation not in ("bilinear", "nearest"):
        raise ValueError(f"interpolation must be 'bilinear' or 'nearest', got {interpolation!r}")
    new_h, new_w = size
    if not x.is_floating_point():
        x = x.float()
    lead = x.shape[:-3]
    frames = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    if interpolation == "bilinear":
        out = F.interpolate(frames, size=(new_h, new_w), mode="bilinear", align_corners=False,
                            antialias=False)
    else:
        out = F.interpolate(frames, size=(new_h, new_w), mode="nearest")
    return out.permute(0, 2, 3, 1).contiguous().reshape(tuple(lead) + (new_h, new_w, x.shape[-1]))


def short_side_scale(x: torch.Tensor, size: int, interpolation: str = "bilinear") -> torch.Tensor:
    """Scale the short side to ``size`` keeping the aspect ratio; the long
    side is floored (upstream functional.py:92-131)."""
    h, w = x.shape[HEIGHT_AXIS], x.shape[WIDTH_AXIS]
    if w < h:
        new_h, new_w = int(math.floor((float(h) / w) * size)), size
    else:
        new_h, new_w = size, int(math.floor((float(w) / h) * size))
    return resize(x, (new_h, new_w), interpolation)


def crop(x: torch.Tensor, y_offset: int, x_offset: int, size: int) -> torch.Tensor:
    """The ``size x size`` window at (y_offset, x_offset), a view. Offsets
    are clamped so the window fits, as ``lax.dynamic_slice`` clamps them in
    the JAX package."""
    h, w = x.shape[HEIGHT_AXIS], x.shape[WIDTH_AXIS]
    y_offset = min(max(int(y_offset), 0), max(h - size, 0))
    x_offset = min(max(int(x_offset), 0), max(w - size, 0))
    return x[..., y_offset:y_offset + size, x_offset:x_offset + size, :]


def random_crop(x: torch.Tensor, size: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A random ``size`` crop, the offsets drawn on the host from
    ``generator`` (upstream functional.py:267-296 without boxes)."""
    h, w = x.shape[HEIGHT_AXIS], x.shape[WIDTH_AXIS]
    if h == size and w == size:
        return x
    y_offset = int(torch.randint(0, max(h - size, 0) + 1, (), generator=generator))
    x_offset = int(torch.randint(0, max(w - size, 0) + 1, (), generator=generator))
    return crop(x, y_offset, x_offset, size)


def _uniform_crop_offsets(h: int, w: int, size: int, spatial_idx: int) -> Tuple[int, int]:
    """Offsets of 3-crop evaluation (upstream functional.py:494-516)."""
    if spatial_idx not in (0, 1, 2):
        raise ValueError(f"spatial_idx must be 0, 1 or 2, got {spatial_idx}")
    y_offset = int(math.ceil((h - size) / 2))
    x_offset = int(math.ceil((w - size) / 2))
    if h > w:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = h - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = w - size
    return y_offset, x_offset


def uniform_crop(x: torch.Tensor, size: int, spatial_idx: int) -> torch.Tensor:
    """Left/centre/right (or top/centre/bottom) crop (upstream
    functional.py:328-347)."""
    h, w = x.shape[HEIGHT_AXIS], x.shape[WIDTH_AXIS]
    return crop(x, *_uniform_crop_offsets(h, w, size, int(spatial_idx)), size)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    return uniform_crop(x, size, 1)


def horizontal_flip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(WIDTH_AXIS)


def random_horizontal_flip(x: torch.Tensor, prob: float,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``x`` mirrored along its width with probability ``prob``, drawn on the
    host from ``generator``."""
    if float(torch.rand((), generator=generator)) < prob:
        return horizontal_flip(x)
    return x


# ---------------------------------------------------------------------------
# Box ops (detection, AVA)
# ---------------------------------------------------------------------------


def crop_boxes(boxes: torch.Tensor, x_offset: int, y_offset: int) -> torch.Tensor:
    """Boxes shifted into a crop at (y_offset, x_offset) (upstream
    functional.py:429-446)."""
    offsets = device_constant([x_offset, y_offset, x_offset, y_offset], boxes.dtype,
                              boxes.device)
    return boxes - offsets


def clip_boxes_to_image(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x in [0, width - 1], y in [0, height - 1] (upstream
    functional.py:407-427)."""
    x = boxes[..., 0::2].clamp(0.0, width - 1.0)
    y = boxes[..., 1::2].clamp(0.0, height - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def short_side_scale_with_boxes(images: torch.Tensor, boxes: torch.Tensor, size: int,
                                interpolation: str = "bilinear"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`short_side_scale`, the boxes scaled by the same factor
    (upstream functional.py:195-236)."""
    h, w = images.shape[HEIGHT_AXIS], images.shape[WIDTH_AXIS]
    images = short_side_scale(images, size, interpolation)
    new_h, new_w = images.shape[HEIGHT_AXIS], images.shape[WIDTH_AXIS]
    scale = float(new_h) / h if w < h else float(new_w) / w
    return images, boxes * scale


def random_short_side_scale_with_boxes(images: torch.Tensor, boxes: torch.Tensor,
                                       min_size: int, max_size: int,
                                       interpolation: str = "bilinear",
                                       generator: Optional[torch.Generator] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`short_side_scale_with_boxes` to a size drawn from [min_size,
    max_size] on the host from ``generator`` (upstream
    functional.py:233-264)."""
    size = int(torch.randint(min_size, max_size + 1, (), generator=generator))
    return short_side_scale_with_boxes(images, boxes, size, interpolation)


def random_crop_with_boxes(images: torch.Tensor, size: int, boxes: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random ``size`` crop (offsets y, then x, drawn on the host from
    ``generator``), the boxes shifted into it and clipped to it (upstream
    functional.py:267-296)."""
    h, w = images.shape[HEIGHT_AXIS], images.shape[WIDTH_AXIS]
    y_offset = int(torch.randint(0, max(h - size, 0) + 1, (), generator=generator))
    x_offset = int(torch.randint(0, max(w - size, 0) + 1, (), generator=generator))
    cropped = crop(images, y_offset, x_offset, size)
    return cropped, clip_boxes_to_image(crop_boxes(boxes, x_offset, y_offset), size, size)


def uniform_crop_with_boxes(images: torch.Tensor, size: int, spatial_idx: int,
                            boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`uniform_crop`, the boxes shifted into it and clipped to it
    (upstream functional.py:350-378)."""
    h, w = images.shape[HEIGHT_AXIS], images.shape[WIDTH_AXIS]
    y_offset, x_offset = _uniform_crop_offsets(h, w, size, int(spatial_idx))
    cropped = crop(images, y_offset, x_offset, size)
    return cropped, clip_boxes_to_image(crop_boxes(boxes, x_offset, y_offset), size, size)


def horizontal_flip_with_boxes(prob: float, images: torch.Tensor, boxes: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """With probability ``prob`` (drawn on the host from ``generator``), the
    clip and its boxes mirrored: x becomes width - 1 - x (upstream
    functional.py:380-405)."""
    if not float(torch.rand((), generator=generator)) < prob:
        return images, boxes
    width = images.shape[WIDTH_AXIS]
    flipped = torch.stack([width - boxes[..., 2] - 1, boxes[..., 1],
                           width - boxes[..., 0] - 1, boxes[..., 3]], dim=-1)
    return horizontal_flip(images), flipped


# ---------------------------------------------------------------------------
# Value transforms
# ---------------------------------------------------------------------------


def div_255(x: torch.Tensor) -> torch.Tensor:
    """x / 255 as float32 for integer clips (upstream functional.py:604-615)."""
    return (x if x.is_floating_point() else x.float()) / 255.0


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel ``(x - mean) / std`` over the last axis; ``mean`` and
    ``std`` are sequences, or tensors on ``x``'s device."""
    if not isinstance(mean, torch.Tensor):
        mean = device_constant(mean, x.dtype, x.device)
    if not isinstance(std, torch.Tensor):
        std = device_constant(std, x.dtype, x.device)
    return (x - mean) / std


def convert_to_one_hot(
    targets: torch.Tensor, num_class: int, label_smooth: float = 0.0
) -> torch.Tensor:
    """Index labels (N,) -> (smoothed) one-hot (N, num_class) float32
    (upstream functional.py:163-192)."""
    if not 0.0 <= label_smooth < 1.0:
        raise ValueError(f"label_smooth must be in [0, 1), got {label_smooth}")
    non_target_value = label_smooth / num_class
    target_value = 1.0 - label_smooth + non_target_value
    one_hot = F.one_hot(targets.long(), num_class).float()
    return one_hot * (target_value - non_target_value) + non_target_value


# ---------------------------------------------------------------------------
# Crop-and-resize (the random resized crop)
# ---------------------------------------------------------------------------


def _source_coords(start: float, extent: float, out: int, device) -> torch.Tensor:
    """``start + (arange(out) + 0.5) * (extent / out) - 0.5`` in float32,
    the JAX package's half-pixel source coordinates; the scale is the
    float32 quotient, formed on the host."""
    scale = float(np.float32(extent) / np.float32(out))
    coords = (torch.arange(out, dtype=torch.float32, device=device) + 0.5) * scale
    return (coords + float(np.float32(start))) - 0.5


def crop_and_resize(frames: torch.Tensor, i: float, j: float, h: float, w: float,
                    target_height: int, target_width: int) -> torch.Tensor:
    """Bilinearly sample the box with top-left (i, j) and size (h, w) of a
    THWC clip to (target_height, target_width), in float32.

    The JAX package's formula (its functional.py:393-447): half-pixel
    source coordinates, floor, then the source INDEX clamped to the frame
    (``y1 = clip(y0 + 1)``), not the coordinate. Inside the frame that is
    slice-then-``F.interpolate``; at the border of an upscaled crop the
    first row and column mix pixels 0 and 1 where ``F.interpolate``
    (upstream functional.py:518-601) takes pixel 0.
    """
    H, W = frames.shape[HEIGHT_AXIS], frames.shape[WIDTH_AXIS]
    ys = _source_coords(i, h, target_height, frames.device)
    xs = _source_coords(j, w, target_width, frames.device)
    y0, x0 = ys.floor(), xs.floor()
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    frames = frames if frames.is_floating_point() else frames.float()
    rows0 = frames.index_select(HEIGHT_AXIS, y0i)
    rows1 = frames.index_select(HEIGHT_AXIS, y1i)
    top = rows0.index_select(WIDTH_AXIS, x0i) * (1.0 - wx) + rows0.index_select(WIDTH_AXIS, x1i) * wx
    bot = rows1.index_select(WIDTH_AXIS, x0i) * (1.0 - wx) + rows1.index_select(WIDTH_AXIS, x1i) * wx
    return top * (1.0 - wy) + bot * wy


def crop_params_from_draws(
    area_draws: np.ndarray,
    ratio_draws: np.ndarray,
    i_draw: float,
    j_draw: float,
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
    height: int,
    width: int,
    log_uniform_ratio: bool = True,
) -> Tuple[float, float, float, float]:
    """The Inception-style box (i, j, h, w) from unit uniform draws, in
    float32 as the JAX package's ``_sample_crop_params`` (its
    functional.py:450-520; upstream ``_get_param_spatial_crop``,
    functional.py:448-516): the first of the tries whose (h, w) fits, else
    the aspect-preserving central crop. ``area_draws`` and ``ratio_draws``
    hold one unit draw per try; ``i_draw`` and ``j_draw`` the offsets'."""
    f32 = np.float32
    scale = (min(scale), max(scale))
    ratio = (min(ratio), max(ratio))
    u_area = np.asarray(area_draws, f32)
    u_ratio = np.asarray(ratio_draws, f32)
    target_area = f32(height * width) * (u_area * (f32(scale[1]) - f32(scale[0])) + f32(scale[0]))
    if log_uniform_ratio:
        lo, hi = f32(math.log(ratio[0])), f32(math.log(ratio[1]))
        aspect = np.exp(u_ratio * (hi - lo) + lo)
    else:
        aspect = u_ratio * (f32(ratio[1]) - f32(ratio[0])) + f32(ratio[0])
    w = np.round(np.sqrt(target_area * aspect))
    h = np.round(np.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    if valid.any():
        first = int(np.argmax(valid))
        h_sel, w_sel = h[first], w[first]
        i_sel = np.floor(f32(i_draw) * (f32(height) - h_sel + f32(1.0)))
        j_sel = np.floor(f32(j_draw) * (f32(width) - w_sel + f32(1.0)))
        return float(i_sel), float(j_sel), float(h_sel), float(w_sel)
    in_ratio = float(width) / float(height)
    if in_ratio < ratio[0]:
        fw = float(width)
        fh = float(round(fw / ratio[0]))
    elif in_ratio > ratio[1]:
        fh = float(height)
        fw = float(round(fh * ratio[1]))
    else:
        fw, fh = float(width), float(height)
    return float((height - fh) // 2), float((width - fw) // 2), fh, fw


def _sample_crop_params(
    generator: Optional[torch.Generator],
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
    height: int,
    width: int,
    log_uniform_ratio: bool = True,
    num_tries: int = 10,
) -> Tuple[float, float, float, float]:
    """:func:`crop_params_from_draws` of unit draws from ``generator`` (a
    CPU ``torch.Generator``) in place of the JAX package's key."""
    draws = torch.rand(2 * num_tries + 2, generator=generator).numpy()
    return crop_params_from_draws(draws[:num_tries], draws[num_tries:2 * num_tries],
                                  draws[-2], draws[-1], scale, ratio, height, width,
                                  log_uniform_ratio)


def random_resized_crop(
    frames: torch.Tensor,
    target_height: int,
    target_width: int,
    scale: Tuple[float, float],
    aspect_ratio: Tuple[float, float],
    generator: Optional[torch.Generator] = None,
    shift: bool = False,
    log_uniform_ratio: bool = True,
    interpolation: str = "bilinear",
    num_tries: int = 10,
) -> torch.Tensor:
    """Inception-style random resized crop of a (T, H, W, C) clip (upstream
    functional.py:518-601): a box from :func:`_sample_crop_params`, then
    :func:`crop_and_resize`. ``shift=True`` draws a second box for the last
    frame and moves the box linearly between them frame by frame (float32
    on the host, floored, as the JAX package's vmap over frames)."""
    if not (scale[0] > 0 and scale[1] > 0 and aspect_ratio[0] > 0 and aspect_ratio[1] > 0):
        raise ValueError(f"scale and aspect_ratio must be positive, got {scale}, {aspect_ratio}")
    del interpolation  # bilinear sampling, as the JAX package
    t = frames.shape[TEMPORAL_AXIS]
    height, width = frames.shape[HEIGHT_AXIS], frames.shape[WIDTH_AXIS]
    box = _sample_crop_params(generator, scale, aspect_ratio, height, width,
                              log_uniform_ratio, num_tries)
    if not shift:
        return crop_and_resize(frames, *box, target_height, target_width)
    box2 = _sample_crop_params(generator, scale, aspect_ratio, height, width,
                               log_uniform_ratio, num_tries)
    ts = np.linspace(0.0, 1.0, t, dtype=np.float32)
    a, b = np.asarray(box, np.float32), np.asarray(box2, np.float32)
    boxes = np.floor(a[None] + ts[:, None] * (b - a)[None])
    return torch.stack([
        crop_and_resize(frames[..., k:k + 1, :, :, :], *map(float, boxes[k]),
                        target_height, target_width)[..., 0, :, :, :]
        for k in range(t)], dim=TEMPORAL_AXIS)
