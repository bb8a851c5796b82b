"""Plain float32 MViT (Fan et al., "Multiscale Vision Transformers",
arXiv:2104.11227; pytorchvideo's ``create_multiscale_vision_transformers``),
written from the published description with ``torch.nn.functional`` alone.

The configuration's ``model`` holds the builder's keywords (the program's
factory takes the same): the 3x7x7 patch embedding of stride 2x4x4, a cls
token and separate space and time position tables, 16 blocks whose width
and heads double at blocks 1, 3 and 14, where the queries pool 1x2x2; keys
and values pool adaptively from 1x8x8; every pool a depthwise 3x3x3 conv
(one per head width, shared by the heads) followed by a LayerNorm over the
head width; the residual max-pooled where the queries are. Each block is
``x + attn(norm1(x))`` then ``x' + mlp(norm2(x'))``, where ``x'`` is
projected to the new width where it changes; the classifier reads the cls
token after the final norm. LayerNorm eps is 1e-6.

Departure, shared with the program: GELU is the tanh approximation (the
port follows the JAX package it was checked against; upstream's torch
model uses the exact erf form).

Leaves carry the program's ``state_dict`` names (upstream pytorchvideo's),
so one seeded dict is handed to both sides. Weights of 2-D and larger
leaves are normal with std 1/sqrt(fan-in), so q and k are of unit scale and
the softmax is neither flat nor one-hot; biases, LN shifts, the cls token
and the position tables normal with std 0.02; LN gains in [0.9, 1.1].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.harness.weights import draw
from perfbench.reference.common import forward_flops, lowp, round_width

LN_EPS = 1e-6


def _triple(v) -> Tuple[int, int, int]:
    return tuple(int(x) for x in v) if len(v) else (1, 1, 1)


def architecture(model: dict) -> dict:
    """The per-block geometry the builder derives from ``model``."""
    depth = model.get("depth", 16)
    dim_mul, head_mul = np.ones(depth + 1), np.ones(depth + 1)
    for i, mul in model.get("embed_dim_mul", []):
        dim_mul[i] = mul
    for i, mul in model.get("atten_head_mul", []):
        head_mul[i] = mul
    kernel = model.get("pool_kvq_kernel")
    stride_q = [[] for _ in range(depth)]
    for entry in model.get("pool_q_stride_size", []):
        stride_q[entry[0]] = list(entry[1:])
    stride_kv, running = [], list(model["pool_kv_stride_adaptive"])
    for i in range(depth):
        if stride_q[i]:
            running = [max(running[d] // stride_q[i][d], 1) for d in range(3)]
        stride_kv.append(list(running))
    t, s = model["temporal_size"], model["spatial_size"]
    patch_stride = tuple(model.get("conv_patch_embed_stride", (2, 4, 4)))
    thw = (t // patch_stride[0], s // patch_stride[1], s // patch_stride[2])
    blocks, dim, heads = [], model.get("patch_embed_dim", 96), model.get("num_heads", 1)
    for i in range(depth):
        heads = round_width(heads, head_mul[i], min_width=1, divisor=1)
        dim_out = round_width(dim, dim_mul[i + 1], divisor=round_width(heads, head_mul[i + 1]))
        kq = tuple(kernel) if stride_q[i] else (1, 1, 1)
        sq = _triple(stride_q[i])
        blocks.append({
            "dim": dim, "dim_out": dim_out, "heads": heads,
            "kernel_q": None if np.prod(kq) == 1 and np.prod(sq) == 1 else kq, "stride_q": sq,
            "kernel_kv": tuple(kernel), "stride_kv": tuple(stride_kv[i]),
            "skip": tuple(x + 1 if x > 1 else x for x in sq) if np.prod(sq) > 1 else None,
        })
        dim = dim_out
    return {"blocks": blocks, "thw": thw, "dim": dim, "clip": (t, s, s),
            "patch_stride": patch_stride,
            "patch_padding": tuple(model.get("conv_patch_embed_padding", (1, 3, 3))),
            "embed_dim": model.get("patch_embed_dim", 96),
            "num_classes": model.get("head_num_classes", 400),
            "mlp_ratio": model.get("mlp_ratio", 4.0)}


def pooled_thw(thw, kernel, stride):
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, k, s in zip(thw, kernel, stride))


def _linear(specs, name, out_f, in_f):
    specs += [(f"{name}.weight", (out_f, in_f), ("normal", in_f ** -0.5)),
              (f"{name}.bias", (out_f,), ("normal", 0.02))]


def _ln(specs, name, c):
    specs += [(f"{name}.weight", (c,), ("uniform", 0.9, 1.1)),
              (f"{name}.bias", (c,), ("normal", 0.02))]


def weight_specs(model: dict) -> List[tuple]:
    arch = architecture(model)
    e, (t, h, w) = arch["embed_dim"], arch["thw"]
    kt, kh, kw = model.get("conv_patch_embed_kernel", (3, 7, 7))
    specs = [("patch_embed.patch_model.weight", (e, 3, kt, kh, kw),
              ("normal", (3 * kt * kh * kw) ** -0.5)),
             ("patch_embed.patch_model.bias", (e,), ("normal", 0.02)),
             ("cls_positional_encoding.cls_token", (1, 1, e), ("normal", 0.02)),
             ("cls_positional_encoding.pos_embed_spatial", (1, h * w, e), ("normal", 0.02)),
             ("cls_positional_encoding.pos_embed_temporal", (1, t, e), ("normal", 0.02)),
             ("cls_positional_encoding.pos_embed_class", (1, 1, e), ("normal", 0.02))]
    for i, b in enumerate(arch["blocks"]):
        p, d, c = f"blocks.{i}", b["dim"], b["dim"] // b["heads"]
        _ln(specs, f"{p}.norm1", d)
        for n in ("q", "k", "v", "proj"):
            _linear(specs, f"{p}.attn.{n}", d, d)
        for n, k in (("q", b["kernel_q"]), ("k", b["kernel_kv"]), ("v", b["kernel_kv"])):
            if k is not None:
                specs.append((f"{p}.attn.pool_{n}.weight", (c, 1) + tuple(k),
                              ("normal", float(np.prod(k)) ** -0.5)))
                _ln(specs, f"{p}.attn.norm_{n}", c)
        _ln(specs, f"{p}.norm2", d)
        hidden = int(d * arch["mlp_ratio"])
        _linear(specs, f"{p}.mlp.fc1", hidden, d)
        _linear(specs, f"{p}.mlp.fc2", b["dim_out"], hidden)
        if b["dim_out"] != d:
            _linear(specs, f"{p}.proj", b["dim_out"], d)
    _ln(specs, "norm_embed", arch["dim"])
    _linear(specs, "head.proj", arch["num_classes"], arch["dim"])
    return specs


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(weight_specs(model), seed, device)


class _Forward:
    def __init__(self, w, model, control=None, dropout=None):
        self.w, self.arch, self.control = w, architecture(model), control
        self.dropout = dropout
        self.dropout_rate = model.get("head_dropout_rate", 0.5)

    def q(self, x):
        return lowp(x, self.control)

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[f"{name}.weight"]), self.w[f"{name}.bias"])

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            LN_EPS)

    def pool(self, x, thw, name, heads, kernel, stride):
        """cls + grid tokens (B, 1 + L, heads * c) -> pooled grid with the
        per-head conv, both normed per head."""
        B, _, C = x.shape
        c = C // heads
        cls, grid = x[:, :1], x[:, 1:]
        grid = grid.reshape(B, *thw, C).permute(0, 4, 1, 2, 3)
        weight = self.w[f"{name.replace('norm', 'pool')}.weight"].repeat(heads, 1, 1, 1, 1)
        grid = F.conv3d(self.q(grid), self.q(weight), None, stride,
                        tuple(k // 2 for k in kernel), 1, C)
        thw_out = tuple(grid.shape[2:])
        x = torch.cat([cls, grid.flatten(2).transpose(1, 2)], dim=1)
        x = self.ln(x.reshape(B, x.shape[1], heads, c), name).reshape(B, -1, C)
        return x, thw_out

    def attention(self, x, thw, i, b):
        p, heads = f"blocks.{i}.attn", b["heads"]
        q, k, v = (self.linear(x, f"{p}.{n}") for n in ("q", "k", "v"))
        q_thw = thw
        if b["kernel_q"] is not None:
            q, q_thw = self.pool(q, thw, f"{p}.norm_q", heads, b["kernel_q"], b["stride_q"])
        k, _ = self.pool(k, thw, f"{p}.norm_k", heads, b["kernel_kv"], b["stride_kv"])
        v, _ = self.pool(v, thw, f"{p}.norm_v", heads, b["kernel_kv"], b["stride_kv"])
        B, Lq, C = q.shape
        c = C // heads
        split = lambda t: t.reshape(B, t.shape[1], heads, c).transpose(1, 2)
        scores = torch.matmul(self.q(split(q) * c ** -0.5), self.q(split(k)).transpose(-1, -2))
        out = torch.matmul(self.q(scores.softmax(dim=-1)), self.q(split(v)))
        out = out.transpose(1, 2).reshape(B, Lq, C)
        return self.linear(out, f"{p}.proj"), q_thw

    def __call__(self, x):
        arch, w = self.arch, self.w
        x = F.conv3d(self.q(x), self.q(w["patch_embed.patch_model.weight"]),
                     w["patch_embed.patch_model.bias"], arch["patch_stride"], arch["patch_padding"])
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        t = arch["thw"][0]
        pe = "cls_positional_encoding"
        pos = (w[f"{pe}.pos_embed_spatial"].repeat(1, t, 1)
               + w[f"{pe}.pos_embed_temporal"].repeat_interleave(arch["thw"][1] * arch["thw"][2], 1))
        x = torch.cat([w[f"{pe}.cls_token"].expand(B, -1, -1), x], dim=1)
        x = x + torch.cat([w[f"{pe}.pos_embed_class"], pos], dim=1)
        thw = arch["thw"]
        for i, b in enumerate(arch["blocks"]):
            p = f"blocks.{i}"
            a, thw_new = self.attention(self.ln(x, f"{p}.norm1"), thw, i, b)
            if b["skip"] is not None:
                grid = x[:, 1:].reshape(B, *thw, -1).permute(0, 4, 1, 2, 3)
                grid = F.max_pool3d(grid, b["skip"], b["stride_q"],
                                    tuple(k // 2 for k in b["skip"]))
                x = torch.cat([x[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)
            x = x + a
            xn = self.ln(x, f"{p}.norm2")
            mlp = self.linear(F.gelu(self.linear(xn, f"{p}.mlp.fc1"), approximate="tanh"),
                              f"{p}.mlp.fc2")
            if b["dim_out"] != b["dim"]:
                x = self.linear(xn, f"{p}.proj")
            x = x + mlp
            thw = thw_new
        x = self.ln(x, "norm_embed")[:, 0]
        if self.dropout is not None and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(x.shape, device=x.device, generator=self.dropout) < keep
            x = torch.where(mask, x / keep, 0.0)
        return self.linear(x, "head.proj")


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
            control: Optional[torch.dtype] = None,
            dropout: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits (B, classes) of NCTHW clips ``x`` (normalised), in x's dtype;
    with ``control`` the operands of every conv and product (the
    attention's too) are rounded to that precision first. With ``dropout``,
    the forward in training: the head's dropout (``head_dropout_rate``)
    keeps each feature of the cls token where a uniform draw from that
    generator, one a feature in row-major order, lies below 1 - rate."""
    return _Forward(w, model, control=control, dropout=dropout)(x)


def flops_per_clip(model: dict) -> float:
    """The forward's FLOPs for one clip (2 a multiply-add)."""
    return forward_flops(lambda w, x: forward(w, x, model), weight_specs(model),
                         (1, 3) + tuple(architecture(model)["clip"]))


def attention_work(model: dict, block: int, batch: int, thw: Tuple[int, int, int],
                   itemsize: int):
    """(FLOPs, bytes, output thw) of block ``block``'s attention unit on
    ``batch`` clips whose grid is ``thw``: the q, k, v projections, the
    pools, the two products of every head and the output projection, 2 a
    multiply-add; the input tokens read once, the output tokens written
    once, every weight of the unit (projections, pool taps, the pools'
    norms) once. Elementwise work (softmax, norms) adds no operations."""
    b = architecture(model)["blocks"][block]
    d, heads = b["dim"], b["heads"]
    c = d // heads
    L = int(np.prod(thw))
    q_thw = pooled_thw(thw, b["kernel_q"], b["stride_q"]) if b["kernel_q"] else tuple(thw)
    kv_thw = pooled_thw(thw, b["kernel_kv"], b["stride_kv"])
    Lq, Lk = int(np.prod(q_thw)), int(np.prod(kv_thw))
    flops = 3 * 2.0 * batch * (L + 1) * d * d
    weights = 4 * (d * d + d)
    if b["kernel_q"]:
        flops += 2.0 * np.prod(b["kernel_q"]) * batch * Lq * d
        weights += c * int(np.prod(b["kernel_q"])) + 2 * c
    flops += 2 * 2.0 * np.prod(b["kernel_kv"]) * batch * Lk * d
    weights += 2 * (c * int(np.prod(b["kernel_kv"])) + 2 * c)
    flops += 2 * 2.0 * batch * (Lq + 1) * (Lk + 1) * d
    flops += 2.0 * batch * (Lq + 1) * d * d
    nbytes = itemsize * (batch * (L + 1) * d + batch * (Lq + 1) * d + weights)
    return float(flops), float(nbytes), q_thw
