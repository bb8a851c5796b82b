"""What the plain references share: float32 with TF32 off, the published
X3D / MViT width rounding, the lower-precision control's rounding, and the
FLOP count of a forward (``FlopCounterMode``: 2 a multiply-add).

Nothing here imports the program (``pytorchvideo_tpu_torch``), JAX or the
JAX package."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

# The control's precision: the nearest below the bfloat16 that the
# configurations serve and train in.
CONTROL_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convs inside, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _RoundTrip(torch.autograd.Function):
    """x rounded to ``dtype`` with one per-tensor scale (amax to the
    format's largest value), back in x's dtype; the gradient is rounded
    the same way, so a backward also runs at that precision."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return round_to(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.dtype), None


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def lowp(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` as the control sees it: rounded to ``dtype`` (None: as it is)."""
    return x if dtype is None else _RoundTrip.apply(x, dtype)


def round_width(width, multiplier, min_width=8, divisor=8):
    """X3D's and MViT's channel rounding: ``width * multiplier`` to a
    multiple of ``divisor``, at least ``min_width``, bumped by ``divisor``
    where it fell below 90% of the target."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def round_repeats(repeats, multiplier):
    return repeats if not multiplier else int(math.ceil(multiplier * repeats))


def forward_flops(forward, specs, x_shape) -> float:
    """FLOPs of ``forward(weights, x)`` by ``FlopCounterMode`` (2 a
    multiply-add of its convs and products; nothing for elementwise work),
    on meta tensors of the leaves' ``specs`` and of ``x_shape``, so nothing
    is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = {name: torch.empty(tuple(shape), device="meta") for name, shape, _ in specs}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        forward(meta, torch.empty(tuple(x_shape), device="meta"))
    return float(counter.get_total_flops())
