"""Fused depthwise 3x3x3 conv (+ per-channel scale/bias, + optional swish).

Counterpart of pytorchvideo_tpu/ops/depthwise_conv.py. X3D's ``conv_b`` is a
depthwise 3x3x3 conv followed by BN and swish; in the deploy form the BN is a
per-channel scale/bias, and the whole chain is one kernel.

- :func:`depthwise3x3x3_bn_swish_cuda` launches the hand-written CUDA kernel
  (``csrc/depthwise_conv.cu``, the port of the TPU kernel
  ``depthwise3x3x3_bn_swish_pallas``). It counts its launches in
  ``depthwise3x3x3_bn_swish_cuda.launches``, and per route in
  ``launches_by_route``.
- :func:`depthwise3x3x3_bn_swish_torch` is the plain version
  (``F.conv3d(groups=C)`` + epilogue), the counterpart of
  ``depthwise3x3x3_bn_swish_xla``.
- :func:`depthwise3x3x3_bn_swish` dispatches on the device of ``x``: a CPU
  tensor takes the plain version, a CUDA tensor the kernel (or the kernel's
  checks raise). Under tracing (``torch.export``, ``torch.compile``) it
  calls the custom op ``torch.ops.pvt.depthwise3x3x3_bn_swish`` instead,
  one graph node whose CUDA implementation is the kernel's wrapper and whose
  CPU implementation is the plain version (contiguous, as the kernel's
  output is).

Every kernel call takes one of two routes, chosen before the launch by
:func:`depthwise_route`; no route is tried after another fails:

- ``tiled``: float32 and bfloat16 with C even and x aligned to the copy
  width (:func:`depthwise_copy_bytes`). The token pool's tiled machinery
  (``csrc/pool_tiles.cuh``, :func:`~pytorchvideo_tpu_torch.ops.token_pool.pool_tile_plan`
  at kernel (3, 3, 3) and stride 1): a block walks T over a tile of H x W
  and a 64-channel slice through a ring of planes in shared memory, then
  applies the epilogue. :func:`depthwise3x3x3_tiled_torch` replays that
  walk in float32, for the tests.
- ``scalar``: the first version's kernel, for every other call.

Every function takes the JAX package's layout: x (B, T, H, W, C), w
(3, 3, 3, C), stride 1, padding 1; the output has the shape and dtype of x.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pytorchvideo_tpu_torch.ops import token_pool as tp

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
DEPTHWISE_ROUTES = ("tiled", "scalar")
KERNEL_SIZE = (3, 3, 3)
STRIDE = (1, 1, 1)


def depthwise3x3x3_bn_swish_torch(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    apply_swish: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: depthwise conv in x's dtype, then the epilogue."""
    C = x.shape[-1]
    out = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        w.permute(3, 0, 1, 2).unsqueeze(1).to(x.dtype),
        padding=1,
        groups=C,
    )
    if scale is not None:
        out = out * scale.to(out.dtype).view(C, 1, 1, 1)
    if bias is not None:
        out = out + bias.to(out.dtype).view(C, 1, 1, 1)
    if apply_swish:
        out = F.silu(out)
    return out.permute(0, 2, 3, 4, 1)


def depthwise_copy_bytes(dtype: torch.dtype, C: int) -> int:
    """The tiled route's copy width: the largest of 16, 8 and 4 bytes that
    divides a position's row of C channels (bf16: 4 at C = 54, 8 at 108, 16
    at 216 and 432); 0 where none does or the dtype is not the kernel's."""
    row = C * _ITEMSIZE.get(dtype, 0)
    return next((n for n in (16, 8, 4) if row and row % n == 0), 0)


def depthwise_route(dtype: torch.dtype, C: int, aligned: bool) -> str:
    """The route a CUDA call takes: ``tiled`` for float32 and bfloat16 when C
    is even and every tensor the kernel copies is aligned to the copy width
    (``aligned``); ``scalar`` for every other call."""
    return "tiled" if dtype in _KERNEL_DTYPES and C % 2 == 0 and aligned else "scalar"


def _aligned(x: torch.Tensor) -> bool:
    width = depthwise_copy_bytes(x.dtype, x.shape[-1])
    return bool(width) and x.data_ptr() % width == 0


def depthwise3x3x3_tiled_torch(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    apply_swish: bool = False,
    plan: Optional[tp.PoolTilePlan] = None,
) -> torch.Tensor:
    """Plain replay of the tiled kernel (tests only): the token pool's tiled
    walk (:func:`~pytorchvideo_tpu_torch.ops.token_pool.token_pool_tiled_torch`)
    at kernel (3, 3, 3) and stride 1, with ``plan`` (default: x's) and the
    copies' chunks of x's copy width, then the epilogue, in float32;
    returned in x's dtype."""
    B, T, H, W, C = x.shape
    plan = plan or tp.pool_tile_plan(B, T, H, W, C, KERNEL_SIZE, STRIDE, x.dtype)
    width = depthwise_copy_bytes(x.dtype, C)
    if not width:
        raise ValueError(f"the tiled route takes no {x.dtype} rows of {C} channels")
    weight = w.permute(3, 0, 1, 2).unsqueeze(1)  # (C, 1, 3, 3, 3), the pool's layout
    y = tp.token_pool_tiled_torch(x.float(), weight, KERNEL_SIZE, STRIDE, "conv", plan=plan,
                                  copy_vec=width // _ITEMSIZE[x.dtype])
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if apply_swish:
        y = F.silu(y)
    return y.to(x.dtype)


def _choose(dtype, C: int, aligned: bool, route: Optional[str]) -> str:
    """``route`` if given (``scalar`` takes any call; ``tiled`` only what
    :func:`depthwise_route` sends there, else ValueError), else its choice."""
    chosen = depthwise_route(dtype, C, aligned)
    if route not in (None, *DEPTHWISE_ROUTES):
        raise ValueError(f"route must be one of {DEPTHWISE_ROUTES}, got {route!r}")
    if route == "tiled" and chosen != "tiled":
        raise ValueError(
            f"the tiled route takes float32 or bfloat16 with C even and x aligned to the copy "
            f"width; got {dtype}, C {C}, aligned {aligned}")
    return route or chosen


def depthwise3x3x3_bn_swish_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    apply_swish: bool = False,
    route: Optional[str] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel of ``route`` (default: :func:`depthwise_route`'s)
    on the current stream.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device: x (B, T, H, W, C), w (3, 3, 3, C), scale and bias (C,) or None.
    Raises ValueError on anything else (and on ``tiled`` for a call that
    route does not take) and RuntimeError if the launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    expected = {"w": (3, 3, 3, C), "scale": (C,), "bias": (C,)}
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if name != "x" and tuple(t.shape) != expected[name]:
            raise ValueError(
                f"{name} must have shape {expected[name]}, got {tuple(t.shape)}"
            )
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    route = _choose(x.dtype, C, _aligned(x), route)
    lib = load_library()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    B, T, H, W, _ = x.shape
    pointers = (x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr())
    stream, guard = tp._stream_and_guard(x)
    with guard:
        if route == "tiled":
            _, args = tp._tiled_args("forward", x.shape, KERNEL_SIZE, STRIDE, C, 0, x.dtype)
            err = lib.pvt_depthwise3x3x3_tiled(*pointers, args, int(apply_swish), stream)
        else:
            err = lib.pvt_depthwise3x3x3_bn_swish(
                *pointers, B, T, H, W, C, _KERNEL_DTYPES[x.dtype], int(apply_swish), stream)
    if err != 0:
        raise RuntimeError(f"depthwise3x3x3 ({route}) kernel launch failed: cudaError {err}")
    depthwise3x3x3_bn_swish_cuda.launches += 1
    depthwise3x3x3_bn_swish_cuda.launches_by_route[route] += 1
    return out


depthwise3x3x3_bn_swish_cuda.launches = 0
depthwise3x3x3_bn_swish_cuda.launches_by_route = dict.fromkeys(DEPTHWISE_ROUTES, 0)


def depthwise3x3x3_bn_swish(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    apply_swish: bool = False,
) -> torch.Tensor:
    """x: (B, T, H, W, C); w: (3, 3, 3, C) depthwise taps; optional
    per-channel scale/bias epilogue (BN eval affine) and swish. Stride 1,
    'same' (pad 1): the output has x's shape. CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    if torch.compiler.is_compiling():
        return torch.ops.pvt.depthwise3x3x3_bn_swish(x, w, scale, bias, apply_swish)
    if x.device.type == "cpu":
        return depthwise3x3x3_bn_swish_torch(x, w, scale, bias, apply_swish)
    return depthwise3x3x3_bn_swish_cuda(x, w, scale, bias, apply_swish)


@torch.library.custom_op(
    "pvt::depthwise3x3x3_bn_swish", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor? scale, Tensor? bias, bool apply_swish) -> Tensor")
def _depthwise_op(x, w, scale, bias, apply_swish):
    return depthwise3x3x3_bn_swish_torch(x, w, scale, bias, apply_swish).contiguous()


@_depthwise_op.register_kernel("cuda")
def _(x, w, scale, bias, apply_swish):
    return depthwise3x3x3_bn_swish_cuda(x, w, scale, bias, apply_swish)


@_depthwise_op.register_fake
def _(x, w, scale, bias, apply_swish):
    return x.new_empty(x.shape)
