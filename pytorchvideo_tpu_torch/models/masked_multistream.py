"""Masked multi-stream building blocks for variable-length multimodal input.

Counterpart of pytorchvideo_tpu/models/masked_multistream.py (upstream
models/masked_multistream.py: MaskedTemporalPooling :35, TransposeMultiheadAttention
:96, LearnMaskedDefault :154, LSTM :208, TransposeTransformerEncoder :275,
MaskedSequential :322, MaskedMultiPathWay :347).

Every module takes ``(x, mask)``: x (B, L, C) and mask a (B, L) bool of the
valid positions, a valid prefix of each row (what upstream's
``pack_padded_sequence`` assumes). The attention is the JAX package's, flax's
``MultiHeadDotProductAttention``: per-head q, k and v projections with
biases (``query``, ``key``, ``value``), softmax(q k^T / sqrt(head_dim)) over
the valid keys, and an ``out`` projection, written around
``F.scaled_dot_product_attention`` with a boolean mask (True: attend). Both
attention modules take position 0 as valid in every row, on a copy of the
mask: the caller's mask, which :class:`MaskedSequential` hands on to the
modules after them, is left as it is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence

Device = Union[str, torch.device]


def _attend_to_first(mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``mask`` with position 0 valid in every row."""
    mask = mask.clone()
    mask[:, 0] = True
    return mask


class MaskedTemporalPooling(nn.Module):
    """(B, L, C) -> (B, C): the max, mean or sum over each row's valid
    positions. A row with no valid position pools to 0 under "max"; under
    "avg" the count is taken as at least 1."""

    def __init__(self, method: str):
        super().__init__()
        if method not in ("max", "avg", "sum"):
            raise ValueError(f"method must be 'max', 'avg' or 'sum', got {method!r}")
        self.method = method

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        if self.method == "max":
            masked = x.masked_fill(~mask[..., None], float("-inf"))
            masked = masked.masked_fill(~mask.any(dim=-1)[:, None, None], 0.0)
            return masked.max(dim=1).values
        masked = (x * mask[..., None].to(x.dtype)).sum(dim=1)
        if self.method == "sum":
            return masked
        return masked / mask.sum(dim=-1).clamp(min=1).to(x.dtype)[:, None]


class FlaxMultiHeadAttention(nn.Module):
    """Self-attention with flax's ``MultiHeadDotProductAttention`` layout:
    ``query``, ``key``, ``value`` map C to heads x head_dim (with biases),
    ``out`` maps them back to C; the scale is 1/sqrt(head_dim).
    ``mask`` (B, L) bool marks the keys each query may attend to."""

    def __init__(self, in_features: int, num_heads: int, device: Device = "cuda"):
        super().__init__()
        if in_features % num_heads:
            raise ValueError(f"{in_features} features do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(in_features, in_features, device=device)
        self.key = nn.Linear(in_features, in_features, device=device)
        self.value = nn.Linear(in_features, in_features, device=device)
        self.out = nn.Linear(in_features, in_features, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        return x.view(B, L, self.num_heads, -1).transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self._heads(self.query(x)), self._heads(self.key(x)), self._heads(self.value(x))
        attn_mask = None if mask is None else mask[:, None, None, :]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        return self.out(o.transpose(1, 2).flatten(2))


class TransposeMultiheadAttention(nn.Module):
    """Self-attention over (B, L, C), keys limited to each row's valid
    positions (position 0 always among them) -> (B, L, C)."""

    def __init__(self, feature_dim: int, num_heads: int = 1, device: Device = "cuda"):
        super().__init__()
        self.attention = FlaxMultiHeadAttention(feature_dim, num_heads, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"expected (B, L, C), got shape {tuple(x.shape)}")
        return self.attention(x, None if mask is None else _attend_to_first(mask))


class LearnMaskedDefault(nn.Module):
    """Rows with no valid position take a learned (feature_dim,) vector
    ``_learned_defaults`` (N(0, 1) from ``generator``, or zeros); the others
    pass unchanged. ``freeze`` keeps the vector out of the gradient."""

    def __init__(self, feature_dim: int, init_method: str = "gaussian", freeze: bool = False,
                 generator: Optional[torch.Generator] = None, device: Device = "cuda"):
        super().__init__()
        if init_method not in ("gaussian", "zeros"):
            raise ValueError(f"init_method must be 'gaussian' or 'zeros', got {init_method!r}")
        defaults = torch.zeros(feature_dim)
        if init_method == "gaussian":
            defaults = torch.randn(feature_dim, generator=generator)
        self._learned_defaults = nn.Parameter(defaults.to(device))
        self.freeze = freeze

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        defaults = self._learned_defaults.detach() if self.freeze else self._learned_defaults
        any_valid = mask.reshape(mask.shape[0], -1).any(dim=-1)
        m = any_valid.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return x * m + defaults * (1 - m)


class LSTM(nn.Module):
    """A one-layer LSTM over each row's valid prefix (at least position 0)
    -> (B, hidden_dim): the state after the last valid position; with
    ``bidirectional``, concatenated with the reverse pass's state after
    position 0. ``nn.LSTM`` (``lstm``) over a ``pack_padded_sequence``; the
    lengths go to the host for the pack. ``dropout`` is accepted and unused,
    as in the JAX package (one layer has no inter-layer dropout)."""

    def __init__(self, dim_in: int, hidden_dim: int, dropout: float = 0.0,
                 bidirectional: bool = False, device: Device = "cuda"):
        super().__init__()
        self.bidirectional = bidirectional
        self.hidden_dim = hidden_dim
        self.lstm = nn.LSTM(dim_in, hidden_dim, batch_first=True, bidirectional=bidirectional,
                            device=device)

    @property
    def output_dim(self) -> int:
        return 2 * self.hidden_dim if self.bidirectional else self.hidden_dim

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if data.dim() != 3:
            raise ValueError(f"expected (B, L, C), got shape {tuple(data.shape)}")
        B, L = data.shape[:2]
        if mask is None:
            lengths = torch.full((B,), L, dtype=torch.int64)
        else:
            lengths = mask.sum(dim=1).clamp(1, L).cpu()
        packed = pack_padded_sequence(data, lengths, batch_first=True, enforce_sorted=False)
        _, (h_n, _) = self.lstm(packed)
        if self.bidirectional:
            return torch.cat([h_n[0], h_n[1]], dim=-1)
        return h_n[0]


class TransposeTransformerEncoder(nn.Module):
    """``num_layers`` post-norm encoder layers over (B, L, C) -> the output
    at position 0, (B, C). A layer: x = norm1(x + attn(x)), then x =
    norm2(x + ff2(relu(ff1(x)))), with a feed-forward width of 2048, no
    dropout and LayerNorm eps 1e-6 (flax's), as the JAX package builds it.
    Keys are limited to each row's valid positions (position 0 always)."""

    FF_DIM = 2048

    def __init__(self, dim_in: int, num_heads: int = 1, num_layers: int = 1,
                 device: Device = "cuda"):
        super().__init__()
        self.attn = nn.ModuleList(FlaxMultiHeadAttention(dim_in, num_heads, device=device)
                                  for _ in range(num_layers))
        self.norm1 = nn.ModuleList(nn.LayerNorm(dim_in, eps=1e-6, device=device)
                                   for _ in range(num_layers))
        self.ff1 = nn.ModuleList(nn.Linear(dim_in, self.FF_DIM, device=device)
                                 for _ in range(num_layers))
        self.ff2 = nn.ModuleList(nn.Linear(self.FF_DIM, dim_in, device=device)
                                 for _ in range(num_layers))
        self.norm2 = nn.ModuleList(nn.LayerNorm(dim_in, eps=1e-6, device=device)
                                   for _ in range(num_layers))

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = data
        mask = None if mask is None else _attend_to_first(mask)
        for attn, norm1, ff1, ff2, norm2 in zip(self.attn, self.norm1, self.ff1, self.ff2,
                                                self.norm2):
            x = norm1(x + attn(x, mask))
            x = norm2(x + ff2(torch.relu(ff1(x))))
        return x[:, 0]


_MASK_MODULES = (
    MaskedTemporalPooling,
    LearnMaskedDefault,
    TransposeMultiheadAttention,
    LSTM,
    TransposeTransformerEncoder,
)


class MaskedSequential(nn.Module):
    """``layers`` in order; the five mask-aware modules get the mask, any
    other module only x."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask=mask) if isinstance(layer, _MASK_MODULES) else layer(x)
        return x


class MaskedMultiPathWay(nn.Module):
    """One block per stream of a list of ``(x, mask)`` pairs, then an
    optional fusion of their outputs (``layers.fusion.make_fusion_layer``)."""

    def __init__(self, multipathway_blocks: Sequence[nn.Module],
                 multipathway_fusion: Optional[nn.Module] = None):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList(multipathway_blocks)
        self.multipathway_fusion = multipathway_fusion

    def forward(self, x_and_mask: List[Tuple[torch.Tensor, torch.Tensor]]):
        if len(x_and_mask) != len(self.multipathway_blocks):
            raise ValueError(f"expected {len(self.multipathway_blocks)} (x, mask) pairs, got "
                             f"{len(x_and_mask)}")
        out = [block(*pair) for block, pair in zip(self.multipathway_blocks, x_and_mask)]
        if self.multipathway_fusion is not None:
            out = self.multipathway_fusion(out)
        return out
