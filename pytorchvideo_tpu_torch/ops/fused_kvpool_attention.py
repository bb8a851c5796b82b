"""Fused kv-pool + per-head LayerNorm + pooled attention.

Counterpart of pytorchvideo_tpu/ops/fused_kvpool_attention.py, with its
public names and argument order (``pool_out``, ``fusable``,
``fused_kvpool_attention`` and its plain version). MViT's keys and values
arrive UNPOOLED, as the (B, T*H*W, H*c) outputs of their projections; the op
pools each with a depthwise stride-(st, sh, sw) conv at padding k // 2, applies
the per-head LayerNorm (f32 from the pool to the norm), puts the already-normed
cls row in front and runs head-packed attention of q over the result. Returns
(out, pooled k, pooled v); with ``cls_q`` (a port argument, keyword only) also
the cls query's output, which the JAX package computes outside the op.

- :func:`fused_kvpool_attention_cuda` makes two launches on one stream: the
  hand-written pool-LN kernel (``csrc/fused_kvpool_attention.cu``, the port of
  the pool phase of the TPU kernel ``_fused_local``) writes k and v into
  (B, 1 + Lk, H*c) buffers with the cls row at row 0, and the attention kernel
  (``pooled_attention_packed_cuda``, the port of the attention phase) runs over
  those buffers for q and, as an Lq = 1 launch, for ``cls_q``. The pooled
  grids it returns are views of the buffers: no concatenation. It counts its
  pool-LN launches in ``launches``; the attention launches are counted by
  ``pooled_attention_packed_cuda.launches``. Why two launches and not the TPU
  kernel's one is in the CUDA source.
- :func:`fused_kvpool_attention_torch` is the plain version (the counterpart
  of ``fused_kvpool_attention_xla`` and ``_pool_ln_xla``): ``F.conv3d(groups=C)``,
  a per-head LayerNorm in f32, a concatenation of the cls row and
  ``pooled_attention_packed_torch``.
- :func:`fused_kvpool_attention` dispatches: a CPU tensor takes the plain
  version, a CUDA tensor the kernels (or the kernels' checks raise). Where
  autograd needs a gradient it goes through a ``torch.autograd.Function``
  whose backward recomputes through the unfused composition, as the JAX
  package's ``_fused_bwd`` does: the conv pool (``depthwise_token_pool``), the
  LayerNorm, the cls concatenation and ``pooled_attention_packed`` under
  autograd. On the card that backward runs the token-pool kernel and its dx
  and dw kernels, the attention kernel and its backward, and PyTorch's own
  LayerNorm backward.

Taps ``wk``/``wv`` are (kt*kh*kw, Cw) and LayerNorm parameters ``lnk``/``lnv``
(2, Cw) (scale, then shift), with H*c a multiple of Cw: channel j uses column
j % Cw. Cw = H*c is the JAX package's head-tiled layout; Cw = c the per-head
parameters that MViT shares across heads, which the port's layer passes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pytorchvideo_tpu_torch.ops.pooled_attention import (
    MAX_HEAD_DIM,
    pooled_attention_packed,
    pooled_attention_packed_cuda,
    pooled_attention_packed_torch,
)
from pytorchvideo_tpu_torch.ops.token_pool import depthwise_token_pool, depthwise_token_pool_torch

Size3 = Tuple[int, int, int]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pool_out(d: int, k: int, s: int, p: int) -> int:
    """Output length of one axis of a pool: input d, kernel k, stride s, padding p."""
    return (d + 2 * p - k) // s + 1


def fusable(thw: Size3, hc: int, kernel: Optional[Size3], stride: Size3, head_dim: int) -> bool:
    """Whether the fused op takes a block's kv pool on the card.

    The conditions on what the op computes are the JAX gate's: a (3, 3, 3)
    pool kernel (padding k // 2), temporal stride 1 and a pooled grid that is
    not empty. The JAX gate's other two conditions came from the TPU (strides
    sh, sw >= 4, from a v5e Mosaic compile crash, and a 12 MB VMEM budget,
    for which it took the activations' itemsize) and are replaced by the
    card's own limits: head_dim <= 128, for the attention kernel and for the
    pool-LN kernel, whose lanes hold at most four channels of a head. The
    pool-LN kernel keeps nothing in shared memory, so no grid size bounds it.
    """
    if kernel is None or tuple(kernel) != (3, 3, 3) or stride[0] != 1 or min(stride) < 1:
        return False
    if not 1 <= head_dim <= MAX_HEAD_DIM or hc % head_dim:
        return False
    return min(pool_out(d, k, s, k // 2) for d, k, s in zip(thw, kernel, stride)) > 0


def _compose(pool, attend, q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads,
             scale, residual, kernel, stride, eps, cls_q):
    """The op as the unfused path computes it, through ``pool`` (a depthwise
    token pool) and ``attend`` (head-packed attention)."""
    B, _, HC = q.shape
    c = HC // num_heads

    def pool_ln(grid, w, ln):
        Cw = w.shape[1]
        weight = w.t().contiguous().reshape(Cw, 1, *kernel)
        pooled = pool(grid.reshape(B, *thw, HC), weight, stride)
        x = F.layer_norm(pooled.reshape(B, -1, num_heads, c).float(), (c,), eps=eps)
        x = x.reshape(B, -1, HC // Cw, Cw) * ln[0].float() + ln[1].float()
        return x.reshape(B, -1, HC).to(grid.dtype)

    kp, vp = pool_ln(k_grid, wk, lnk), pool_ln(v_grid, wv, lnv)
    k_full = kp if cls_k is None else torch.cat([cls_k, kp], dim=1)
    v_full = vp if cls_v is None else torch.cat([cls_v, vp], dim=1)
    outs = (attend(q, k_full, v_full, num_heads, scale, residual), kp, vp)
    if cls_q is not None:
        outs += (attend(cls_q, k_full, v_full, num_heads, scale, residual),)
    return outs


def fused_kvpool_attention_torch(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None,
):
    """Plain version: ``F.conv3d(groups=C)`` pools in f32, the per-head
    LayerNorm in f32, the cls rows in front, ``pooled_attention_packed_torch``.
    Returns (out, pooled k, pooled v[, cls out]) in q's dtype."""
    return _compose(depthwise_token_pool_torch, pooled_attention_packed_torch, q, k_grid, v_grid,
                    wk, wv, lnk, lnv, cls_k, cls_v, tuple(thw), num_heads, scale, residual,
                    tuple(kernel), tuple(stride), eps, cls_q)


def _check_cuda(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel,
                stride, cls_q) -> Size3:
    """The kernels take contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device, in the shapes of the module docstring, with
    head_dim <= 128 and odd kernel sizes; raises ValueError on anything else.
    Returns the pooled grid (T2, H2, W2)."""
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"q dtype must be float32 or bfloat16, got {q.dtype}")
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Lq, H*c), got {tuple(q.shape)}")
    B, _, HC = q.shape
    if HC % num_heads or not 1 <= HC // num_heads <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim = {HC} / {num_heads} heads must be a whole number in "
                         f"[1, {MAX_HEAD_DIM}]")
    if len(kernel) != 3 or any(k % 2 == 0 for k in kernel) or len(stride) != 3 or min(stride) < 1:
        raise ValueError(f"kernel must be three odd sizes and stride three positive steps, got "
                         f"{kernel}, {stride}")
    if (cls_k is None) != (cls_v is None):
        raise ValueError("give both cls_k and cls_v, or neither")
    Cw, L, taps = wk.shape[-1], math.prod(thw), math.prod(kernel)
    for name, t, shape in (
        ("q", q, tuple(q.shape)), ("k_grid", k_grid, (B, L, HC)), ("v_grid", v_grid, (B, L, HC)),
        ("wk", wk, (taps, Cw)), ("wv", wv, (taps, Cw)), ("lnk", lnk, (2, Cw)),
        ("lnv", lnv, (2, Cw)), ("cls_k", cls_k, (B, 1, HC)), ("cls_v", cls_v, (B, 1, HC)),
        ("cls_q", cls_q, (B, 1, HC)),
    ):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if HC % Cw:
        raise ValueError(f"H*c = {HC} is not a multiple of the taps' {Cw} columns")
    pooled = tuple(pool_out(d, k, s, k // 2) for d, k, s in zip(thw, kernel, stride))
    if min(pooled) < 1:
        raise ValueError(f"the pool of {tuple(thw)} by {kernel}, {stride} is empty")
    return pooled


def _pool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel, stride,
                  eps, pooled):
    """Launches the pool-LN kernel; returns the (B, cls + Lk, H*c) k and v buffers."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    B, _, HC = k_grid.shape
    rows = (cls_k is not None) + math.prod(pooled)
    k_full = torch.empty((B, rows, HC), dtype=k_grid.dtype, device=k_grid.device)
    v_full = torch.empty_like(k_full)
    lib = load_library()
    with torch.cuda.device(k_grid.device):
        err = lib.pvt_fused_kvpool_ln(
            k_grid.data_ptr(), v_grid.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            lnk.data_ptr(), lnv.data_ptr(),
            None if cls_k is None else cls_k.data_ptr(),
            None if cls_v is None else cls_v.data_ptr(),
            k_full.data_ptr(), v_full.data_ptr(),
            B, *thw, HC, *pooled, *kernel, *stride, wk.shape[1], num_heads, float(eps),
            _KERNEL_DTYPES[k_grid.dtype],
            torch.cuda.current_stream(k_grid.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused kv-pool LayerNorm kernel launch failed: cudaError {err}")
    return k_full, v_full


def fused_kvpool_attention_cuda(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None,
):
    """The pool-LN kernel, then the attention kernel over its buffers (for q,
    and for ``cls_q`` where given). Returns (out, pooled k, pooled v[, cls
    out]); the pooled grids are views of the buffers. Raises ValueError on
    inputs the kernels do not take and RuntimeError if a launch fails."""
    thw, kernel, stride = tuple(thw), tuple(kernel), tuple(stride)
    pooled = _check_cuda(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, kernel,
                         stride, cls_q)
    k_full, v_full = _pool_ln_cuda(k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads,
                                   kernel, stride, eps, pooled)
    fused_kvpool_attention_cuda.launches += 1
    off = 0 if cls_k is None else 1
    outs = (pooled_attention_packed_cuda(q, k_full, v_full, num_heads, scale, residual),
            k_full[:, off:], v_full[:, off:])
    if cls_q is not None:
        outs += (pooled_attention_packed_cuda(cls_q, k_full, v_full, num_heads, scale, residual),)
    return outs


fused_kvpool_attention_cuda.launches = 0


class _FusedKVPoolAttention(torch.autograd.Function):
    """The op with its backward: forward through the kernels on the card (the
    plain version on the CPU); backward by recomputing the unfused composition
    under autograd (JAX ``_fused_bwd``), whose ops take their kernels on the
    card and their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q, args):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q)
        ctx.args = args
        fn = fused_kvpool_attention_torch if q.device.type == "cpu" else fused_kvpool_attention_cuda
        return fn(q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, *args, cls_q=cls_q)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:10]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = _compose(depthwise_token_pool, pooled_attention_packed, *leaves[:9], *ctx.args,
                            leaves[9])
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t, need in zip(leaves, needs) if need]
        if not pairs or not wanted:
            return (None,) * (len(needs) + 1)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
        return (*(next(got) if need else None for need in needs), None)


def fused_kvpool_attention(
    q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, thw, num_heads, scale, residual, kernel,
    stride, eps=1e-6, *, cls_q=None,
):
    """Fused kv-pool + LayerNorm + attention. q: (B, Lq, H*c) pooled queries;
    k_grid, v_grid: (B, T*H*W, H*c) UNPOOLED grids; wk, wv: (kt*kh*kw, Cw)
    taps; lnk, lnv: (2, Cw) LayerNorm scale and shift; cls_k, cls_v: (B, 1,
    H*c) ALREADY-NORMED cls rows or None; cls_q: (B, 1, H*c) cls query or
    None. Returns (out (B, Lq, H*c), pooled k (B, Lk, H*c), pooled v[, cls
    out (B, 1, H*c)]). CPU tensors take the plain version; CUDA tensors the
    kernels, the backward included where autograd needs it."""
    inputs = (q, k_grid, v_grid, wk, wv, lnk, lnv, cls_k, cls_v, cls_q)
    args = (tuple(thw), num_heads, scale, residual, tuple(kernel), tuple(stride), eps)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _FusedKVPoolAttention.apply(*inputs, args)
    fn = fused_kvpool_attention_torch if q.device.type == "cpu" else fused_kvpool_attention_cuda
    return fn(*inputs[:9], *args, cls_q=cls_q)
