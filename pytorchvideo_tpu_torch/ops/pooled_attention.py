"""Pooled multi-head attention: softmax(q k^T * scale) v (+ q).

Counterpart of pytorchvideo_tpu/ops/pooled_attention.py, in its two layouts:

- head-packed (B, L, H*c), the layout of the q/k/v projections, on MViT's
  default path: :func:`pooled_attention_packed`;
- per-head (B, H, L, c), on the ``pool_first`` path: :func:`pooled_attention`.

One CUDA source serves both forwards (``csrc/pooled_attention.cu``, the port
of the TPU kernels ``_packed_pallas_local`` and
``_pooled_attention_pallas_local``) and one both backwards
(``csrc/pooled_attention_bwd.cu``, the port of ``_packed_pallas_bwd_local``
and ``_pooled_attention_pallas_bwd_local``); the layouts differ only in the
strides they are given.

The forward and the backward each take one of three routes
(:func:`forward_route`, :func:`backward_route`, one rule): bf16 with c a
multiple of 8 and 16-byte aligned tensors runs on the tensor cores
(``tensor_core``) or, at most ``SPLIT_MAX_LQ`` query rows, over the key axis
cut into splits (``split_key``, :func:`split_plan`); float32 and any other
bf16 call run on the CUDA cores (``cuda_core``). The route is chosen before
the launch; no route is tried after another fails.

- ``*_cuda`` launch a kernel and count their launches in ``launches``, and
  per route in ``launches_by_route``; the forward writes each row's
  log-sum-exp for the backward when asked to (``return_lse``), and the
  deploy path does not ask.
- ``*_torch`` are the plain versions, all in float32 and returned in the
  inputs' dtype, as the kernels compute: the forward is reshape + einsum +
  softmax (the counterparts of ``pooled_attention_packed_xla`` and
  ``pooled_attention_xla``); :func:`pooled_attention_split_torch` is the
  split-key route's arithmetic (per-split partials and their combine), used
  by the tests only; the backward is the explicit formulas of
  (q, k, v, o, lse, g) -> (dq, dk, dv) that the kernels evaluate, and
  :func:`pooled_attention_bwd_split_torch` the backward split-key route's
  arithmetic (tests only).
- The dispatchers take the plain versions for CPU tensors and the kernels
  for CUDA tensors (or the kernels' checks raise). Where autograd needs the
  gradient they go through a ``torch.autograd.Function`` whose forward and
  backward follow the same rule, so on the card the backward is the kernel.
  Under tracing (``torch.export``, ``torch.compile``) without autograd, the
  forward dispatchers call the custom ops ``torch.ops.pvt.pooled_attention_packed``
  and ``torch.ops.pvt.pooled_attention`` instead: one graph node each, the
  kernel's wrapper on CUDA tensors and the plain version (contiguous, as
  the kernel's output is) on CPU tensors.

Any Lq is taken, Lq = 1 included (MViT's cls query); the kernels take
head_dim c <= 128.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
FORWARD_ROUTES = ("tensor_core", "split_key", "cuda_core")
BACKWARD_ROUTES = FORWARD_ROUTES
# At most this many query rows, a bf16 call takes the split-key route: a
# tensor-core block computes 192 query rows (three 64-row wgmma tiles), so at
# Lq <= 8 it would waste >= 23/24 of its products and give each (batch, head)
# one block walking all keys alone (64 blocks for 132 SMs at B32 with two
# heads); the split route reads each key once per split for all its rows,
# holding 8 rows x 8 columns a lane in registers (the kernel's kMaxRows).
SPLIT_MAX_LQ = 8
# The split plan: enough 16-lane groups (one per split) to keep ~2 KB of key
# and value loads in flight on each of them across the card's 132 SMs, and
# no fewer than 16 keys a split so the partials stay small beside K and V.
_SPLIT_TARGET_PARTS = 4096
_SPLIT_MIN_KEYS = 16
# The backward kernels' tile (csrc/pooled_attention_bwd.cu): q rows and keys
# of the CUDA-core kernels, q rows of a tensor-core dk/dv tile; the keys of
# a tensor-core dk/dv block (two warpgroups of 64); and the blocks the dk/dv
# kernel aims for (two waves of the H100's 132 SMs) when it splits the q axis.
_BWD_TILE = 64
_BWD_TC_KEYS = 128
_BWD_TARGET_BLOCKS = 264


def pooled_attention_packed_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    residual_pool: bool = False,
) -> torch.Tensor:
    """Plain version over head-packed q (B, Lq, H*c), k and v (B, Lk, H*c)."""
    B, Lq, HC = q.shape
    Lk = k.shape[1]
    c = HC // num_heads
    qf = q.float()
    attn = torch.einsum(
        "bqhc,bkhc->bhqk", qf.reshape(B, Lq, num_heads, c) * scale,
        k.float().reshape(B, Lk, num_heads, c),
    ).softmax(dim=-1)
    out = torch.einsum("bhqk,bkhc->bqhc", attn, v.float().reshape(B, Lk, num_heads, c))
    out = out.reshape(B, Lq, HC)
    if residual_pool:
        out = out + qf
    return out.to(q.dtype)


def pooled_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, residual_pool: bool = False
) -> torch.Tensor:
    """Plain version over per-head q (B, H, Lq, c), k and v (B, H, Lk, c)."""
    qf = q.float()
    attn = torch.einsum("bhqc,bhkc->bhqk", qf * scale, k.float()).softmax(dim=-1)
    out = torch.einsum("bhqk,bhkc->bhqc", attn, v.float())
    if residual_pool:
        out = out + qf
    return out.to(q.dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Head-packed (B, L, H*c) -> a per-head (B, H, L, c) view."""
    B, L, HC = t.shape
    return t.view(B, L, num_heads, HC // num_heads).transpose(1, 2)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """Per-head (B, H, L, c) -> head-packed (B, L, H*c)."""
    B, H, L, c = t.shape
    return t.transpose(1, 2).reshape(B, L, H * c)


def forward_route(dtype: torch.dtype, Lq: int, c: int, aligned: bool = True) -> str:
    """The forward route a CUDA call takes: bf16 with c % 8 == 0 and
    16-byte aligned q, k and v (``aligned``) takes ``split_key`` at Lq <=
    SPLIT_MAX_LQ and ``tensor_core`` above; float32, and bf16 with c % 8 != 0
    or a misaligned tensor, take ``cuda_core``."""
    if dtype != torch.bfloat16 or c % 8 or not aligned:
        return "cuda_core"
    return "split_key" if Lq <= SPLIT_MAX_LQ else "tensor_core"


def backward_route(dtype: torch.dtype, Lq: int, c: int, aligned: bool = True) -> str:
    """The backward route a CUDA call takes, by the forward's rule
    (:func:`forward_route`), with ``aligned`` over q, k, v, o and g."""
    return forward_route(dtype, Lq, c, aligned)


def split_plan(B: int, H: int, Lk: int) -> Tuple[int, int]:
    """(splits, keys per split) of the split-key route: split s takes keys
    [s * per, min((s + 1) * per, Lk)), so the splits cover the key axis once
    and none is empty. About _SPLIT_TARGET_PARTS splits over the B * H
    (batch, head) pairs, at least _SPLIT_MIN_KEYS keys each."""
    per = max(_SPLIT_MIN_KEYS, -(-Lk * B * H // _SPLIT_TARGET_PARTS))
    return -(-Lk // per), per


def pooled_attention_split_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    residual_pool: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split-key route over per-head q (B, H, Lq, c), k
    and v (B, H, Lk, c), in float32: per split of the key axis
    (:func:`split_plan`) the row max, row sum and unnormalised output, then
    their combine in split order. Returns (output in q's dtype, row
    log-sum-exp (B, H, Lq) float32)."""
    B, H = q.shape[:2]
    splits, per = split_plan(B, H, k.shape[2])
    qf = q.float()
    parts = []
    for s in range(splits):
        ks, vs = (t[:, :, s * per:(s + 1) * per].float() for t in (k, v))
        scores = torch.einsum("bhqc,bhkc->bhqk", qf * scale, ks)
        row_max = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - row_max)
        parts.append((row_max, p.sum(dim=-1, keepdim=True), torch.einsum("bhqk,bhkc->bhqc", p, vs)))
    row_max = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    row_sum, acc = 0.0, 0.0
    for m, l, o in parts:
        w = torch.exp(m - row_max)
        row_sum = row_sum + l * w
        acc = acc + o * w
    out = acc / row_sum
    if residual_pool:
        out = out + qf
    return out.to(q.dtype), (row_max + torch.log(row_sum)).squeeze(-1)


def attention_lse_torch(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain row log-sum-exp of the scaled scores over per-head q (B, H, Lq, c)
    and k (B, H, Lk, c): (B, H, Lq) float32, what the forward kernel saves."""
    return torch.logsumexp(torch.einsum("bhqc,bhkc->bhqk", q.float() * scale, k.float()), dim=-1)


def pooled_attention_bwd_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float, residual_pool: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward over per-head (B, H, L, c) tensors: the explicit formulas
    of the kernel, in float32, each result in its input's dtype.

    p = exp(q k^T * scale - lse); D = rowsum(g * o_attn), with o_attn the
    saved output o less q where the residual is on; ds = p * (g v^T - D);
    dq = ds k * scale (+ g), dk = ds^T q * scale, dv = p^T g."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(torch.einsum("bhqc,bhkc->bhqk", qf * scale, kf) - lse[..., None])
    o_attn = o.float() - qf if residual_pool else o.float()
    delta = (gf * o_attn).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqc,bhkc->bhqk", gf, vf) - delta)
    dq = torch.einsum("bhqk,bhkc->bhqc", ds, kf) * scale
    if residual_pool:
        dq = dq + gf
    dk = torch.einsum("bhqk,bhqc->bhkc", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqc->bhkc", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def pooled_attention_bwd_split_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float, residual_pool: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward's split-key route over per-head
    (B, H, L, c) tensors, in float32: per split of the key axis
    (:func:`split_plan`) p and ds of its keys, their dk and dv (each key in
    one split) and the split's dq partial; the partials summed in split
    order, then scaled (+ g). Each result in its input's dtype."""
    splits, per = split_plan(q.shape[0], q.shape[1], k.shape[2])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    o_attn = o.float() - qf if residual_pool else o.float()
    delta = (gf * o_attn).sum(-1, keepdim=True)
    dks, dvs, dq = [], [], 0.0
    for s in range(splits):
        ks, vs = kf[:, :, s * per:(s + 1) * per], vf[:, :, s * per:(s + 1) * per]
        p = torch.exp(torch.einsum("bhqc,bhkc->bhqk", qf * scale, ks) - lse[..., None])
        ds = p * (torch.einsum("bhqc,bhkc->bhqk", gf, vs) - delta)
        dks.append(torch.einsum("bhqk,bhqc->bhkc", ds, qf) * scale)
        dvs.append(torch.einsum("bhqk,bhqc->bhkc", p, gf))
        dq = dq + torch.einsum("bhqk,bhkc->bhqc", ds, ks)
    dq = dq * scale
    if residual_pool:
        dq = dq + gf
    return dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


def pooled_attention_packed_bwd_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, num_heads: int, scale: float, residual_pool: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward over head-packed (B, L, H*c) tensors; lse is (B, H, Lq)."""
    grads = pooled_attention_bwd_torch(
        *(_heads(t, num_heads) for t in (q, k, v, o)), lse, _heads(g, num_heads), scale,
        residual_pool,
    )
    return tuple(_packed(t) for t in grads)


def _check_cuda(c: int, named) -> None:
    """The kernels take contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device and c <= 128; raises ValueError on anything else."""
    ref_name, ref = named[0]
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{ref_name} dtype must be float32 or bfloat16, got {ref.dtype}")
    if not ref.is_cuda:
        raise ValueError(f"{ref_name} must be a CUDA tensor, got device {ref.device}")
    for name, t in named:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                f"{name} must be {ref.dtype} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= c <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}], got {c}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(q, k, v, heads: int, c: int, strides, scale: float, residual_pool: bool,
            return_lse: bool, route: str = None):
    """Checks q, k, v and launches the forward kernel of ``route`` (default:
    :func:`forward_route`'s) on the current stream.

    Raises ValueError on inputs the kernel does not take (see
    :func:`_check_cuda`; at least one key; for the bf16 routes, what
    :func:`forward_route` sends to the CUDA cores) and RuntimeError if the
    launch fails. Returns the output, shaped and laid out like q, the
    (B, H, Lq) float32 row log-sum-exp if ``return_lse`` (else None) and the
    route taken."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    _check_cuda(c, (("q", q), ("k", k), ("v", v)))
    B, Lq, Lk = q.shape[0], q.shape[-2], k.shape[-2]
    if Lk < 1:
        raise ValueError("k and v need at least one key")
    chosen = forward_route(q.dtype, Lq, c, _aligned(q, k, v))
    route = route or chosen
    if route != "cuda_core" and chosen == "cuda_core":
        raise ValueError(f"the {route} route takes bfloat16 with head_dim % 8 == 0 and 16-byte "
                         f"aligned q, k and v; got {q.dtype}, head_dim {c}")
    if route == "split_key" and Lq > SPLIT_MAX_LQ:
        raise ValueError(f"the split_key route takes at most {SPLIT_MAX_LQ} query rows, got {Lq}")
    lib = load_library()
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((B, heads, Lq), **f32) if return_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    shape = (B, heads, Lq, Lk, c, (ctypes.c_int64 * 12)(*strides), float(scale),
             int(residual_pool))
    # The current stream's raw handle, and a device guard only where q is not
    # on the current device: MViT makes 32 of these calls a forward and waits
    # on the host at B1, so no Stream object or guard is built per call.
    index = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    same_device = index == torch.cuda.current_device()
    with contextlib.nullcontext() if same_device else torch.cuda.device(index):
        if route == "tensor_core":
            err = lib.pvt_pooled_attention_tc(*args, *shape, stream)
        elif route == "split_key":
            splits, per = split_plan(B, heads, Lk)
            # One buffer for the partials: outputs, row maxima, row sums.
            parts = torch.empty(B * heads * splits * Lq * (c + 2), **f32)
            err = lib.pvt_pooled_attention_split(*args, parts.data_ptr(), *shape, splits, per,
                                                 stream)
        else:
            err = lib.pvt_pooled_attention(*args, *shape, _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"pooled attention {route} kernel launch failed: cudaError {err}")
    return out, lse, route


def _check_packed(q, k, v, num_heads: int):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[::2] != q.shape[::2]:
        raise ValueError(
            f"expected q (B, Lq, H*c) and k, v (B, Lk, H*c), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] % num_heads:
        raise ValueError(f"H*c = {q.shape[2]} is not a multiple of {num_heads} heads")


def _check_per_head(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
        k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
    ):
        raise ValueError(
            f"expected q (B, H, Lq, c) and k, v (B, H, Lk, c), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def _packed_strides(q, k, num_heads: int):
    """(batch, head, row) strides of head-packed q-shaped and k-shaped tensors."""
    B, Lq, HC = q.shape
    c = HC // num_heads
    return (Lq * HC, c, HC), (k.shape[1] * HC, c, HC)


def _per_head_strides(q, k):
    B, H, Lq, c = q.shape
    return (H * Lq * c, Lq * c, c), (H * k.shape[2] * c, k.shape[2] * c, c)


def pooled_attention_packed_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    residual_pool: bool = False, return_lse: bool = False,
):
    """The forward kernel over head-packed q (B, Lq, H*c), k and v (B, Lk, H*c).
    Returns the output, or (output, lse) with ``return_lse``."""
    _check_packed(q, k, v, num_heads)
    sq, sk = _packed_strides(q, k, num_heads)
    out, lse, route = _launch(q, k, v, num_heads, q.shape[2] // num_heads, sq + sk + sk + sq,
                              scale, residual_pool, return_lse)
    pooled_attention_packed_cuda.launches += 1
    pooled_attention_packed_cuda.launches_by_route[route] += 1
    return (out, lse) if return_lse else out


def pooled_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, residual_pool: bool = False,
    return_lse: bool = False,
):
    """The forward kernel over per-head q (B, H, Lq, c), k and v (B, H, Lk, c).
    Returns the output, or (output, lse) with ``return_lse``."""
    _check_per_head(q, k, v)
    sq, sk = _per_head_strides(q, k)
    out, lse, route = _launch(q, k, v, q.shape[1], q.shape[3], sq + sk + sk + sq, scale,
                              residual_pool, return_lse)
    pooled_attention_cuda.launches += 1
    pooled_attention_cuda.launches_by_route[route] += 1
    return (out, lse) if return_lse else out


def bwd_splits(B: int, H: int, Lq: int, Lk: int, keys: int = _BWD_TILE) -> Tuple[int, int]:
    """(splits, q tiles per split) of a dk/dv kernel whose blocks take
    ``keys`` keys each: the q axis is cut so that key blocks x batch x heads
    x splits reach _BWD_TARGET_BLOCKS blocks."""
    q_tiles = -(-Lq // _BWD_TILE)
    base = -(-Lk // keys) * B * H
    splits = max(1, min(q_tiles, -(-_BWD_TARGET_BLOCKS // base)))
    per_split = -(-q_tiles // splits)
    return -(-q_tiles // per_split), per_split


def _scratch(device, *sizes):
    """One float32 buffer cut into pieces of ``sizes`` floats, each starting
    on a 16-byte boundary: the backward's scratch in one allocation."""
    starts, total = [], 0
    for n in sizes:
        starts.append(total)
        total += -(-n // 4) * 4
    buf = torch.empty(total, dtype=torch.float32, device=device)
    return [buf[start:start + n] for start, n in zip(starts, sizes)]


def _launch_bwd(q, k, v, o, lse, g, heads: int, c: int, sq, sk, scale: float,
                residual_pool: bool, route: str = None):
    """Checks the inputs and launches the backward kernels of ``route``
    (default: :func:`backward_route`'s) on the current stream; returns
    ((dq, dk, dv), the route taken), each gradient shaped, laid out and typed
    like its input. Raises ValueError on inputs the kernels do not take (for
    the bf16 routes, what :func:`backward_route` sends to the CUDA cores)
    and RuntimeError if a launch fails."""
    from pytorchvideo_tpu_torch.ops._build import load_library

    _check_cuda(c, (("q", q), ("k", k), ("v", v), ("o", o), ("g", g)))
    B, Lq, Lk = q.shape[0], q.shape[-2], k.shape[-2]
    if o.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"o and g must be shaped like q {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(g.shape)}")
    if lse.shape != (B, heads, Lq) or lse.dtype != torch.float32 or lse.device != q.device or (
        not lse.is_contiguous()
    ):
        raise ValueError(f"lse must be contiguous float32 ({B}, {heads}, {Lq}) on {q.device}")
    if Lk < 1:
        raise ValueError("k and v need at least one key")
    chosen = backward_route(q.dtype, Lq, c, _aligned(q, k, v, o, g))
    route = route or chosen
    if route != "cuda_core" and chosen == "cuda_core":
        raise ValueError(f"the {route} route takes bfloat16 with head_dim % 8 == 0 and 16-byte "
                         f"aligned q, k, v, o and g; got {q.dtype}, head_dim {c}")
    if route == "split_key" and Lq > SPLIT_MAX_LQ:
        raise ValueError(f"the split_key route takes at most {SPLIT_MAX_LQ} query rows, got {Lq}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Lq == 0:
        return (dq, dk.zero_(), dv.zero_()), route
    lib = load_library()
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
              lse.data_ptr())
    outputs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (B, heads, Lq, Lk, c, (ctypes.c_int64 * 6)(*sq, *sk), float(scale),
             int(residual_pool))
    # As in _launch: the raw stream handle, a device guard only off the
    # current device, and the scratch in one buffer.
    index = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    same_device = index == torch.cuda.current_device()
    with contextlib.nullcontext() if same_device else torch.cuda.device(index):
        if route == "split_key":
            splits, per = split_plan(B, heads, Lk)
            (dq_part,) = _scratch(q.device, B * heads * splits * Lq * c)
            err = lib.pvt_pooled_attention_bwd_split(*inputs, dq_part.data_ptr(), *outputs,
                                                     *shape, splits, per, stream)
        else:
            tensor_core = route == "tensor_core"
            splits, per_split = bwd_splits(B, heads, Lq, Lk,
                                           _BWD_TC_KEYS if tensor_core else _BWD_TILE)
            # One q split: the tensor-core dk/dv kernel writes dk and dv itself.
            n_part = 0 if tensor_core and splits == 1 else splits * B * heads * Lk * c
            delta, dk_part, dv_part = _scratch(q.device, B * heads * Lq, n_part, n_part)
            args = (*inputs, delta.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), *outputs,
                    *shape, splits, per_split)
            if tensor_core:
                err = lib.pvt_pooled_attention_bwd_tc(*args, stream)
            else:
                err = lib.pvt_pooled_attention_bwd(*args, _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"pooled attention backward {route} kernel launch failed: "
                           f"cudaError {err}")
    return (dq, dk, dv), route


def pooled_attention_packed_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, num_heads: int, scale: float, residual_pool: bool = False,
):
    """The backward kernels over head-packed tensors: (dq, dk, dv). Counts
    its launches in ``launches`` and per route in ``launches_by_route``."""
    _check_packed(q, k, v, num_heads)
    sq, sk = _packed_strides(q, k, num_heads)
    grads, route = _launch_bwd(q, k, v, o, lse, g, num_heads, q.shape[2] // num_heads, sq, sk,
                               scale, residual_pool)
    pooled_attention_packed_bwd_cuda.launches += 1
    pooled_attention_packed_bwd_cuda.launches_by_route[route] += 1
    return grads


def pooled_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float, residual_pool: bool = False,
):
    """The backward kernels over per-head tensors: (dq, dk, dv); counted as
    :func:`pooled_attention_packed_bwd_cuda`."""
    _check_per_head(q, k, v)
    sq, sk = _per_head_strides(q, k)
    grads, route = _launch_bwd(q, k, v, o, lse, g, q.shape[1], q.shape[3], sq, sk, scale,
                               residual_pool)
    pooled_attention_bwd_cuda.launches += 1
    pooled_attention_bwd_cuda.launches_by_route[route] += 1
    return grads


pooled_attention_packed_cuda.launches = 0
pooled_attention_cuda.launches = 0
pooled_attention_packed_cuda.launches_by_route = dict.fromkeys(FORWARD_ROUTES, 0)
pooled_attention_cuda.launches_by_route = dict.fromkeys(FORWARD_ROUTES, 0)
pooled_attention_packed_bwd_cuda.launches = 0
pooled_attention_bwd_cuda.launches = 0
pooled_attention_packed_bwd_cuda.launches_by_route = dict.fromkeys(BACKWARD_ROUTES, 0)
pooled_attention_bwd_cuda.launches_by_route = dict.fromkeys(BACKWARD_ROUTES, 0)


class _PackedAttention(torch.autograd.Function):
    """Head-packed attention with its backward: the kernels on the card, the
    plain versions on the CPU. Saves q, k, v, the output and the row lse."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float, residual_pool: bool):
        if q.device.type == "cpu":
            out = pooled_attention_packed_torch(q, k, v, num_heads, scale, residual_pool)
            lse = attention_lse_torch(_heads(q, num_heads), _heads(k, num_heads), scale)
        else:
            out, lse = pooled_attention_packed_cuda(q, k, v, num_heads, scale, residual_pool,
                                                    return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (num_heads, scale, residual_pool)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = pooled_attention_packed_bwd(q, k, v, out, lse, g.contiguous(), *ctx.args)
        return (*grads, None, None, None)


class _PerHeadAttention(torch.autograd.Function):
    """Per-head attention with its backward; as :class:`_PackedAttention`."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, residual_pool: bool):
        if q.device.type == "cpu":
            out = pooled_attention_torch(q, k, v, scale, residual_pool)
            lse = attention_lse_torch(q, k, scale)
        else:
            out, lse = pooled_attention_cuda(q, k, v, scale, residual_pool, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, residual_pool)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*pooled_attention_bwd(q, k, v, out, lse, g.contiguous(), *ctx.args), None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def pooled_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    residual_pool: bool = False,
) -> torch.Tensor:
    """Attention over head-packed tokens (B, L, H*c); returns (B, Lq, H*c).
    CPU tensors take the plain versions; CUDA tensors the kernels, the
    backward included where autograd needs it. The JAX package's function
    also takes ``use_pallas``; here the tensors' device picks the path."""
    if _needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, num_heads, scale, residual_pool)
    if torch.compiler.is_compiling():
        return torch.ops.pvt.pooled_attention_packed(q, k, v, num_heads, float(scale),
                                                     residual_pool)
    if q.device.type == "cpu":
        return pooled_attention_packed_torch(q, k, v, num_heads, scale, residual_pool)
    return pooled_attention_packed_cuda(q, k, v, num_heads, scale, residual_pool)


def pooled_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, residual_pool: bool = False
) -> torch.Tensor:
    """Attention over per-head tokens (B, H, L, c); returns (B, H, Lq, c).
    CPU tensors take the plain versions; CUDA tensors the kernels, the
    backward included where autograd needs it. The JAX package's function
    also takes ``use_pallas``; here the tensors' device picks the path."""
    if _needs_grad(q, k, v):
        return _PerHeadAttention.apply(q, k, v, scale, residual_pool)
    if torch.compiler.is_compiling():
        return torch.ops.pvt.pooled_attention(q, k, v, float(scale), residual_pool)
    if q.device.type == "cpu":
        return pooled_attention_torch(q, k, v, scale, residual_pool)
    return pooled_attention_cuda(q, k, v, scale, residual_pool)


@torch.library.custom_op(
    "pvt::pooled_attention_packed", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, int num_heads, float scale, bool residual_pool) "
           "-> Tensor")
def _packed_op(q, k, v, num_heads, scale, residual_pool):
    return pooled_attention_packed_torch(q, k, v, num_heads, scale, residual_pool).contiguous()


@_packed_op.register_kernel("cuda")
def _(q, k, v, num_heads, scale, residual_pool):
    return pooled_attention_packed_cuda(q, k, v, num_heads, scale, residual_pool)


@_packed_op.register_fake
def _(q, k, v, num_heads, scale, residual_pool):
    return q.new_empty(q.shape)


@torch.library.custom_op(
    "pvt::pooled_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool residual_pool) -> Tensor")
def _per_head_op(q, k, v, scale, residual_pool):
    return pooled_attention_torch(q, k, v, scale, residual_pool).contiguous()


@_per_head_op.register_kernel("cuda")
def _(q, k, v, scale, residual_pool):
    return pooled_attention_cuda(q, k, v, scale, residual_pool)


@_per_head_op.register_fake
def _(q, k, v, scale, residual_pool):
    return q.new_empty(q.shape)


def pooled_attention_packed_bwd(q, k, v, o, lse, g, num_heads: int, scale: float,
                                residual_pool: bool = False):
    """Head-packed backward: CPU tensors take the plain version, CUDA tensors
    the kernels."""
    if q.device.type == "cpu":
        return pooled_attention_packed_bwd_torch(q, k, v, o, lse, g, num_heads, scale,
                                                 residual_pool)
    return pooled_attention_packed_bwd_cuda(q, k, v, o, lse, g, num_heads, scale, residual_pool)


def pooled_attention_bwd(q, k, v, o, lse, g, scale: float, residual_pool: bool = False):
    """Per-head backward: CPU tensors take the plain version, CUDA tensors the
    kernels."""
    if q.device.type == "cpu":
        return pooled_attention_bwd_torch(q, k, v, o, lse, g, scale, residual_pool)
    return pooled_attention_bwd_cuda(q, k, v, o, lse, g, scale, residual_pool)
