"""Positional encodings: the fixed sinusoidal one, MViT's learned one with
a cls token, and the numpy sincos tables.

Counterpart of pytorchvideo_tpu/layers/positional_encoding.py
(``PositionalEncoding``, ``SpatioTemporalClsPositionalEncoding``, the sincos
builders; upstream positional_encoding.py:11-44, :47-136, :139-244). The
builders are the JAX package's numpy arithmetic, copied: they return the
same arrays, bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn as nn

Device = Union[str, torch.device]


def _sinusoidal_table(seq_len: int, embed_dim: int) -> np.ndarray:
    """(seq_len, embed_dim) float32: sin on the even columns, cos on the odd."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, embed_dim, 2, dtype=np.float32) * (-math.log(10000.0) / embed_dim)
    )
    pe = np.zeros((seq_len, embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Adds the fixed sinusoidal table to (B, L, C) sequences of L <=
    ``seq_len``. The table is a float32 buffer on ``device``, computed and
    not stored in the ``state_dict`` (the JAX module has no variables);
    ``.to(dtype)`` casts it with the weights."""

    def __init__(self, embed_dim: int, seq_len: int = 1024, device: Device = "cuda"):
        super().__init__()
        self.seq_len = seq_len
        pe = torch.tensor(_sinusoidal_table(seq_len, embed_dim), device=device)[None]
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] > self.seq_len:
            raise ValueError(f"a sequence of {x.shape[1]} is longer than the table's "
                             f"{self.seq_len}")
        return x + self.pe[:, : x.shape[1]]


class SpatioTemporalClsPositionalEncoding(nn.Module):
    """Prepends the cls token to (B, L, C) tokens and adds learned position
    embeddings: one joint (1, L [+1], C) table, or with ``sep_pos_embed`` a
    spatial table tiled over T plus a temporal one repeated over H*W (and a
    separate one for the cls row). Parameters start at zero, as in the JAX
    package; ``state_dict`` keys are upstream's (``cls_token``,
    ``pos_embed_spatial``, ``pos_embed_temporal``, ``pos_embed_class`` or
    ``pos_embed``)."""

    def __init__(
        self,
        embed_dim: int,
        patch_embed_shape: Tuple[int, int, int],
        sep_pos_embed: bool = False,
        has_cls: bool = True,
    ):
        super().__init__()
        t, h, w = patch_embed_shape
        self.num_spatial = h * w
        self.num_temporal = t
        self.sep_pos_embed = sep_pos_embed
        self.has_cls = has_cls
        if has_cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, self.num_spatial, embed_dim))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, t, embed_dim))
            if has_cls:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, embed_dim))
        else:
            num_patches = self.num_spatial * t + (1 if has_cls else 0)
            self.pos_embed = nn.Parameter(torch.zeros(1, num_patches, embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if self.has_cls:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        if not self.sep_pos_embed:
            return x + self.pos_embed
        pos = self.pos_embed_spatial.repeat(1, self.num_temporal, 1) + torch.repeat_interleave(
            self.pos_embed_temporal, self.num_spatial, dim=1
        )
        if self.has_cls:
            pos = torch.cat([self.pos_embed_class, pos], dim=1)
        return x + pos


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M, embed_dim) sin then cos of the positions ``pos`` (any shape, M
    values) at embed_dim / 2 frequencies (upstream positional_encoding.py:219-244)."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    """Half the width for grid[0] (h), half for grid[1] (w)."""
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """(grid_size**2 [+1], embed_dim) over a square grid, a zero cls row first
    with ``cls_token`` (upstream positional_encoding.py:192-216)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, t_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """(t_size * grid_size**2 [+1], embed_dim): a quarter of the width
    temporal, three quarters spatial, in (T, H, W) order (upstream
    positional_encoding.py:139-190)."""
    assert embed_dim % 4 == 0
    embed_dim_spatial = embed_dim // 4 * 3
    embed_dim_temporal = embed_dim // 4

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed_spatial = get_2d_sincos_pos_embed_from_grid(embed_dim_spatial, grid)

    grid_t = np.arange(t_size, dtype=np.float32)
    pos_embed_temporal = get_1d_sincos_pos_embed_from_grid(embed_dim_temporal, grid_t)

    pos_embed_temporal = np.repeat(pos_embed_temporal[:, None, :], grid_size**2, axis=1)
    pos_embed_spatial = np.repeat(pos_embed_spatial[None, :, :], t_size, axis=0)
    pos_embed = np.concatenate([pos_embed_temporal, pos_embed_spatial], axis=-1)
    pos_embed = pos_embed.reshape([-1, embed_dim])
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed
