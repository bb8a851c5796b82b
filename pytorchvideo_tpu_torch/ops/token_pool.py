"""Token pooling of a channels-last (B, T, H, W, C) grid: depthwise conv,
max or average.

Counterpart of pytorchvideo_tpu/ops/token_pool.py. MViT pools its q/k/v
tokens through their (T, H, W) geometry, and its residual path through a max
pool; all of them go through one kernel with a mode argument.

- :func:`depthwise_token_pool_cuda`, :func:`max_token_pool_cuda` and
  :func:`avg_token_pool_cuda` launch the hand-written CUDA kernel
  (``csrc/token_pool.cu``, the port of the TPU kernel ``_pool_pallas_call``
  behind ``depthwise_token_pool_pallas``, ``max_token_pool_pallas`` and
  ``_avg_pool_ad``). Each counts its launches in its ``launches`` attribute.
- The ``*_torch`` functions are the plain versions: ``F.conv3d(groups=C)``,
  ``F.max_pool3d`` and ``F.avg_pool3d(count_include_pad=True)``, computed in
  float32 and returned in x's dtype, as the kernel does.
- :func:`depthwise_token_pool`, :func:`max_token_pool` and
  :func:`avg_token_pool` dispatch on the device of ``x``: a CPU tensor takes
  the plain version, a CUDA tensor the kernel (or the kernel's checks raise).

The conv pool's backward: :func:`depthwise_token_pool_dx_cuda` and
:func:`depthwise_token_pool_dw_cuda` launch the hand-written kernels of
``csrc/token_pool_bwd.cu`` (the port of ``_input_grad_pallas`` and of the
TPU kernel ``_dw_kernel``); ``*_dx_torch`` and ``*_dw_torch`` are their plain
versions, explicit tap-by-tap sums in float32. Where autograd needs a
gradient, the dispatchers go through a ``torch.autograd.Function`` whose
forward and backward follow the device rule above. The max and avg pools'
backward is PyTorch's own (``F.max_pool3d`` / ``F.avg_pool3d`` under
autograd), as the JAX package leaves it to XLA.

x is (B, T, H, W, C); the padding is k // 2 on each axis (odd k <= 5, kt <= 3,
as the TPU kernel); any stride. The conv weight keeps PyTorch's depthwise
layout (Cw, 1, kt, kh, kw) with C a multiple of Cw: channel c uses row
c % Cw, so head-packed tokens (C = heads * head_dim) share one per-head
weight without a tiled copy.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Size3 = Tuple[int, int, int]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"conv": 0, "max": 1, "avg": 2}
# The dw kernel's blocks (csrc/token_pool_bwd.cu): 32 channels each; it cuts
# the output positions into at most this many blocks' worth of chunks.
_DW_CHANNELS = 32
_DW_TARGET_BLOCKS = 1056


def _triple(v) -> Size3:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def pool_out_size(d: int, k: int, s: int) -> int:
    """Output length of one axis at padding k // 2."""
    return (d + 2 * (k // 2) - k) // s + 1


def check_geometry(x_shape, kernel_size: Size3, stride: Size3) -> Size3:
    """Validates a pool of a (B, T, H, W, C) grid; returns the output (T2, H2, W2)."""
    if len(x_shape) != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got shape {tuple(x_shape)}")
    kt, kh, kw = kernel_size
    if not (kt in (1, 3) and kh in (1, 3, 5) and kw in (1, 3, 5)):
        raise ValueError(f"kernel must be odd with kt <= 3 and kh, kw <= 5, got {kernel_size}")
    if min(stride) < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    return tuple(pool_out_size(d, k, s) for d, k, s in zip(x_shape[1:4], kernel_size, stride))


def _ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).float()


def depthwise_token_pool_torch(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """Plain version of the conv pool: ``F.conv3d(groups=C)`` in float32."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    check_geometry(x.shape, kernel_size, stride)
    C = x.shape[-1]
    w = weight.float().repeat(C // weight.shape[0], 1, 1, 1, 1)
    out = F.conv3d(_ncthw(x), w, stride=stride, padding=[k // 2 for k in kernel_size], groups=C)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def max_token_pool_torch(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Plain version of the max pool: ``F.max_pool3d`` (-inf padding)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    check_geometry(x.shape, kernel_size, stride)
    out = F.max_pool3d(_ncthw(x), kernel_size, stride, [k // 2 for k in kernel_size])
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def avg_token_pool_torch(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Plain version of the average pool: ``F.avg_pool3d`` with
    count_include_pad. The zero padding is explicit, because ``F.avg_pool3d``
    refuses an input axis shorter than the kernel even where the padding
    covers it (T = 2 under a 3-tap kernel)."""
    kernel_size, stride = _triple(kernel_size), _triple(stride)
    check_geometry(x.shape, kernel_size, stride)
    pads = [k // 2 for k in reversed(kernel_size) for _ in range(2)]
    out = F.avg_pool3d(F.pad(_ncthw(x), pads), kernel_size, stride)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def _tap_windows(kernel_size: Size3, stride: Size3, out_size: Size3):
    """For each tap (dt, dy, dx), the slices of the zero-padded input grid
    that the tap reads across the output grid."""
    for taps in itertools.product(*(range(k) for k in kernel_size)):
        yield taps, tuple(slice(d, d + s * (n - 1) + 1, s)
                          for d, s, n in zip(taps, stride, out_size))


def depthwise_token_pool_dx_torch(g: torch.Tensor, weight: torch.Tensor, x_shape, stride):
    """Plain input gradient of the conv pool: each tap scatters g times its
    weight back onto the padded input grid; float32, returned in g's dtype."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    B, T, H, W, C = x_shape
    pads = [k // 2 for k in kernel_size]
    w = weight.float()[:, 0].repeat(C // weight.shape[0], 1, 1, 1)  # (C, kt, kh, kw)
    gf = g.float()
    dx = gf.new_zeros((B, T + 2 * pads[0], H + 2 * pads[1], W + 2 * pads[2], C))
    for (dt, dy, dx_), window in _tap_windows(kernel_size, stride, tuple(g.shape[1:4])):
        dx[(slice(None), *window)] += gf * w[:, dt, dy, dx_]
    return dx[:, pads[0]:pads[0] + T, pads[1]:pads[1] + H, pads[2]:pads[2] + W].to(g.dtype)


def depthwise_token_pool_dw_torch(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride):
    """Plain weight gradient of the conv pool: per tap, the sum over the batch
    and the output grid of the tap's input window times g, then over the heads
    that share each weight row (c % Cw); float32, returned shaped and typed
    like ``weight``."""
    stride = _triple(stride)
    kernel_size = tuple(weight.shape[2:])
    C, Cw = x.shape[-1], weight.shape[0]
    pads = [0, 0] + [k // 2 for k in reversed(kernel_size) for _ in range(2)]
    xp = F.pad(x.float(), pads)
    gf = g.float()
    rows = [(xp[(slice(None), *window)] * gf).sum((0, 1, 2, 3))
            for _, window in _tap_windows(kernel_size, stride, tuple(g.shape[1:4]))]
    dw = torch.stack(rows, dim=1).reshape(C // Cw, Cw, -1).sum(0)
    return dw.reshape(weight.shape).to(weight.dtype)


def _launch(
    x: torch.Tensor, weight: Optional[torch.Tensor], kernel_size: Size3, stride: Size3, mode: str
) -> torch.Tensor:
    """Checks the inputs and launches the kernel on the current stream.

    Takes a contiguous CUDA x of float32 or bfloat16 and, for the conv mode,
    a contiguous weight (Cw, 1, kt, kh, kw) of x's dtype and device with C a
    multiple of Cw. Raises ValueError on anything else and RuntimeError if
    the launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    T2, H2, W2 = check_geometry(x.shape, kernel_size, stride)
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, T, H, W, C = x.shape
    Cw = 1
    if weight is not None:
        Cw = weight.shape[0]
        if weight.dim() != 5 or tuple(weight.shape[1:]) != (1, *kernel_size) or C % Cw:
            raise ValueError(
                f"weight must be (Cw, 1, kt, kh, kw) with {C} % Cw == 0, got {tuple(weight.shape)}"
            )
        if weight.device != x.device or weight.dtype != x.dtype:
            raise ValueError(
                f"weight must be {x.dtype} on {x.device}, got {weight.dtype} on {weight.device}"
            )
        if not weight.is_contiguous():
            raise ValueError("weight must be contiguous")
    lib = load_library()
    out = torch.empty((B, T2, H2, W2, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pvt_token_pool(
            x.data_ptr(),
            None if weight is None else weight.data_ptr(),
            out.data_ptr(),
            B, T, H, W, C, T2, H2, W2,
            *kernel_size,
            *stride,
            Cw,
            _MODES[mode],
            _KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"token_pool ({mode}) kernel launch failed: cudaError {err}")
    return out


def depthwise_token_pool_cuda(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """Conv pool through the CUDA kernel; see :func:`_launch` for the checks."""
    if weight is None:
        raise ValueError("the conv pool needs a weight")
    out = _launch(x, weight, tuple(weight.shape[2:]), _triple(stride), "conv")
    depthwise_token_pool_cuda.launches += 1
    return out


def max_token_pool_cuda(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Max pool through the CUDA kernel; see :func:`_launch` for the checks."""
    out = _launch(x, None, _triple(kernel_size), _triple(stride), "max")
    max_token_pool_cuda.launches += 1
    return out


def avg_token_pool_cuda(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Average pool through the CUDA kernel; see :func:`_launch` for the checks."""
    out = _launch(x, None, _triple(kernel_size), _triple(stride), "avg")
    avg_token_pool_cuda.launches += 1
    return out


def _check_bwd(named, weight: torch.Tensor, x_shape, g_shape, stride: Size3) -> None:
    """The backward kernels take contiguous CUDA tensors of one dtype
    (float32 or bfloat16), a weight (Cw, 1, kt, kh, kw) with C % Cw == 0 and
    g shaped as the pool of x; raises ValueError on anything else."""
    kernel_size = tuple(weight.shape[2:])
    out_size = check_geometry(x_shape, kernel_size, stride)
    ref_name, ref = named[0]
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{ref_name} dtype must be float32 or bfloat16, got {ref.dtype}")
    if not ref.is_cuda:
        raise ValueError(f"{ref_name} must be a CUDA tensor, got device {ref.device}")
    for name, t in named + (("weight", weight),):
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                f"{name} must be {ref.dtype} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.dim() != 5 or weight.shape[1] != 1 or x_shape[-1] % weight.shape[0]:
        raise ValueError(f"weight must be (Cw, 1, kt, kh, kw) with {x_shape[-1]} % Cw == 0, "
                         f"got {tuple(weight.shape)}")
    if tuple(g_shape) != (x_shape[0], *out_size, x_shape[-1]):
        raise ValueError(f"g must be {(x_shape[0], *out_size, x_shape[-1])}, got {tuple(g_shape)}")


def _geometry_args(x_shape, g_shape, weight, stride: Size3):
    return (*x_shape, *g_shape[1:4], *weight.shape[2:], *stride, weight.shape[0])


def depthwise_token_pool_dx_cuda(g: torch.Tensor, weight: torch.Tensor, x_shape, stride):
    """Input gradient of the conv pool through the CUDA kernel: dx shaped
    ``x_shape``, in g's dtype. Raises ValueError on inputs the kernel does
    not take, RuntimeError if the launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    stride, x_shape = _triple(stride), tuple(x_shape)
    _check_bwd((("g", g),), weight, x_shape, g.shape, stride)
    dx = torch.empty(x_shape, dtype=g.dtype, device=g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.pvt_token_pool_dx(
            g.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            *_geometry_args(x_shape, g.shape, weight, stride),
            _KERNEL_DTYPES[g.dtype],
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"token_pool dx kernel launch failed: cudaError {err}")
    depthwise_token_pool_dx_cuda.launches += 1
    return dx


def dw_chunks(positions: int, channels: int) -> Tuple[int, int]:
    """(chunks, positions per chunk) of the dw kernel's output positions."""
    channel_blocks = -(-channels // _DW_CHANNELS)
    chunks = max(1, min(-(-positions // 8), -(-_DW_TARGET_BLOCKS // channel_blocks)))
    per_chunk = max(1, -(-positions // chunks))
    return max(1, -(-positions // per_chunk)), per_chunk


def depthwise_token_pool_dw_cuda(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride):
    """Weight gradient of the conv pool through the CUDA kernels (per-chunk
    partials, then a reduction over chunks and heads): dw shaped and typed
    like ``weight``. Raises as :func:`depthwise_token_pool_dx_cuda`."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    stride = _triple(stride)
    _check_bwd((("x", x), ("g", g)), weight, tuple(x.shape), g.shape, stride)
    B, T2, H2, W2, C = g.shape
    chunks, per_chunk = dw_chunks(B * T2 * H2 * W2, C)
    taps = weight[0].numel()
    part = torch.empty((chunks, taps, C), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.pvt_token_pool_dw(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
            *_geometry_args(tuple(x.shape), g.shape, weight, stride),
            chunks, per_chunk,
            _KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"token_pool dw kernel launch failed: cudaError {err}")
    depthwise_token_pool_dw_cuda.launches += 1
    return dw


depthwise_token_pool_cuda.launches = 0
max_token_pool_cuda.launches = 0
avg_token_pool_cuda.launches = 0
depthwise_token_pool_dx_cuda.launches = 0
depthwise_token_pool_dw_cuda.launches = 0


def depthwise_token_pool_dx(g: torch.Tensor, weight: torch.Tensor, x_shape, stride):
    """Input gradient of the conv pool. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if g.device.type == "cpu":
        return depthwise_token_pool_dx_torch(g, weight, x_shape, stride)
    return depthwise_token_pool_dx_cuda(g, weight, x_shape, stride)


def depthwise_token_pool_dw(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, stride):
    """Weight gradient of the conv pool. CPU tensors take the plain version;
    CUDA tensors the kernels."""
    if x.device.type == "cpu":
        return depthwise_token_pool_dw_torch(x, g, weight, stride)
    return depthwise_token_pool_dw_cuda(x, g, weight, stride)


class _ConvPool(torch.autograd.Function):
    """The conv pool with its backward (dx and dw): the kernels on the card,
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        if x.device.type == "cpu":
            return depthwise_token_pool_torch(x, weight, stride)
        return depthwise_token_pool_cuda(x, weight, stride)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_token_pool_dx(g, weight, x.shape, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = depthwise_token_pool_dw(x, g, weight, ctx.stride)
        return dx, dw, None


class _KernelPool(torch.autograd.Function):
    """The max or avg pool's kernel with PyTorch's own backward: the plain
    version under autograd, recomputed in x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel_size, stride, mode: str):
        ctx.save_for_backward(x)
        ctx.args = (kernel_size, stride, mode)
        if mode == "max":
            return max_token_pool_cuda(x, kernel_size, stride)
        return avg_token_pool_cuda(x, kernel_size, stride)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        kernel_size, stride, mode = ctx.args
        pad = [k // 2 for k in kernel_size]
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            ncthw = xr.permute(0, 4, 1, 2, 3)
            if mode == "max":
                out = F.max_pool3d(ncthw, kernel_size, stride, pad)
            else:
                pads = [p for p in reversed(pad) for _ in range(2)]
                out = F.avg_pool3d(F.pad(ncthw, pads), kernel_size, stride)
            (dx,) = torch.autograd.grad(out, xr, g.permute(0, 4, 1, 2, 3))
        return dx.contiguous(), None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def depthwise_token_pool(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """Depthwise conv pool of x (B, T, H, W, C) by weight (Cw, 1, kt, kh, kw),
    padding k // 2. CPU tensors take the plain versions; CUDA tensors the
    kernels, the backward included where autograd needs it."""
    if _needs_grad(x, weight):
        return _ConvPool.apply(x, weight, _triple(stride))
    if x.device.type == "cpu":
        return depthwise_token_pool_torch(x, weight, stride)
    return depthwise_token_pool_cuda(x, weight, stride)


def max_token_pool(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Max pool of x (B, T, H, W, C), padding k // 2 with -inf (MaxPool3d).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return max_token_pool_torch(x, kernel_size, stride)
    if _needs_grad(x):
        return _KernelPool.apply(x, _triple(kernel_size), _triple(stride), "max")
    return max_token_pool_cuda(x, kernel_size, stride)


def avg_token_pool(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """Average pool of x (B, T, H, W, C), padding k // 2, count_include_pad.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return avg_token_pool_torch(x, kernel_size, stride)
    if _needs_grad(x):
        return _KernelPool.apply(x, _triple(kernel_size), _triple(stride), "avg")
    return avg_token_pool_cuda(x, kernel_size, stride)
