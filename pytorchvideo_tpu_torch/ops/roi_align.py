"""RoIAlign in plain PyTorch (counterpart of pytorchvideo_tpu/ops/roi_align.py,
which the JAX package keeps in XLA gathers; upstream delegates to
torchvision, pytorchvideo/models/head.py:8, :320).

The semantics are the JAX package's, not torchvision's: ``sampling_ratio``
0 means 2 samples per bin and each axis (torchvision's per-box ``ceil``
count depends on the data), a sample outside [-1, size] adds zero, one
inside is clamped to the map and interpolated bilinearly, and ``aligned``
shifts the box by half a pixel (else a box is at least one pixel wide).

A bin's value is the mean of its s x s bilinear samples, and both the
bilinear weights and the validity test factor into a row part and a column
part. So the bins of a box are ``Wy @ f @ Wx^T``, with ``Wy`` (out_h, H)
the mean of the rows' bilinear weights and ``Wx`` (out_w, W) the
columns': two batched products over every box at once, no loop per box,
and autograd gives the backward (to the features and to the boxes). A
sample at c (clamped to the map) weighs max(0, 1 - |c - p|) on position p,
the bilinear pair, with no index op that reads the device back, so the op
queues on the card without waiting for it.
Each box's map is gathered from the (B, H, W, C) view of a channels-last
(B, C, H, W) input, one contiguous row per position, and contracted over
its rows, then its columns, with no copy between. The products run in
float32 for any input dtype, as the port's pools do; the result has the
input's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, out: int, s: int,
                  size: int) -> torch.Tensor:
    """(N, out, size) float32: row ``i`` of box ``n`` holds the mean over its
    ``s`` samples at ``start + (i + (k + 0.5) / s) * bin_size`` of each
    sample's bilinear weights on the ``size`` positions of the axis (zero
    for a sample outside [-1, size])."""
    device = start.device
    offsets = (torch.arange(out, dtype=torch.float32, device=device)[:, None]
               + (torch.arange(s, dtype=torch.float32, device=device)[None, :] + 0.5) / s)
    coords = start[:, None, None] + offsets[None] * bin_size[:, None, None]  # (N, out, s)
    valid = (coords > -1.0) & (coords < size)
    c = coords.clamp(0.0, size - 1)[..., None]
    positions = torch.arange(size, dtype=torch.float32, device=device)
    weights = (1.0 - (c - positions).abs()).clamp(min=0.0) * valid[..., None]
    return weights.mean(dim=2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: Tuple[int, int],
              spatial_scale: float = 1.0, sampling_ratio: int = 0,
              aligned: bool = False) -> torch.Tensor:
    """features (B, C, H, W); boxes (N, 5) = (batch index, x1, y1, x2, y2) in
    input coordinates. Returns (N, C, out_h, out_w) in features' dtype, in
    channels-last memory."""
    if features.dim() != 4 or boxes.dim() != 2 or boxes.shape[1] != 5:
        raise ValueError(f"expected (B, C, H, W) features and (N, 5) boxes, got "
                         f"{tuple(features.shape)} and {tuple(boxes.shape)}")
    out_h, out_w = output_size
    _, _, H, W = features.shape
    s = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    boxes = boxes.to(device=features.device, dtype=torch.float32)
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale - offset for i in range(1, 5))
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    wy = _axis_weights(y1, roi_h / out_h, out_h, s, H)
    wx = _axis_weights(x1, roi_w / out_w, out_w, s, W)
    n, c = boxes.shape[0], features.shape[1]
    maps = features.permute(0, 2, 3, 1).index_select(0, boxes[:, 0].long()).float()
    rows = torch.bmm(wy, maps.reshape(n, H, W * c))  # (N, out_h, W * C)
    wx = wx[:, None].expand(n, out_h, out_w, W).reshape(n * out_h, out_w, W)
    out = torch.bmm(wx, rows.reshape(n * out_h, W, c))  # (N * out_h, out_w, C)
    return out.reshape(n, out_h, out_w, c).to(features.dtype).permute(0, 3, 1, 2)


class RoIAlign(nn.Module):
    """Module form with torchvision's constructor signature, which upstream's
    head builder uses (head.py:320-327); the JAX package's ``RoIAlign``."""

    def __init__(self, output_size, spatial_scale: float = 1.0, sampling_ratio: int = 0,
                 aligned: bool = False):
        super().__init__()
        self.output_size = tuple(output_size)
        self.spatial_scale = spatial_scale
        self.sampling_ratio = sampling_ratio
        self.aligned = aligned

    def forward(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return roi_align(features, boxes, self.output_size, self.spatial_scale,
                         self.sampling_ratio, self.aligned)

    def extra_repr(self) -> str:
        return (f"output_size={self.output_size}, spatial_scale={self.spatial_scale}, "
                f"sampling_ratio={self.sampling_ratio}, aligned={self.aligned}")
