"""Multi-layer perceptron factory (counterpart of
pytorchvideo_tpu/layers/mlp.py; upstream pytorchvideo/layers/mlp.py:8-62).

The Linear layers keep the JAX package's names ``fc_0``, ``fc_1``, ... so
that its Dense kernels map one to one (zoo/from_jax.py). The JAX module
calls ``norm()`` and lets flax infer the width; here ``norm`` is a factory
called with the width, ``norm(dim)`` (e.g. ``BatchNorm1d``), and its
modules are ``norm_0``, ``norm_1``, ...
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.layers.stochastic import Dropout


class MultilayerPerceptron(nn.Module):
    """Linear (+ norm + mid activation) stack, then dropout and the final
    activation (JAX mlp.py:12). ``fully_connected_dims`` = [in, hidden...,
    out]; the activations are functions of a tensor."""

    def __init__(self, fully_connected_dims: List[int], norm: Optional[Callable] = None,
                 mid_activation: Callable = F.relu,
                 final_activation: Optional[Callable] = F.relu, dropout_rate: float = 0.0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dims = list(fully_connected_dims)
        assert len(dims) > 1
        self.depth = len(dims) - 1
        for i in range(self.depth):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], dims[i + 1], device=device))
            if norm is not None and i < self.depth - 1:
                self.add_module(f"norm_{i}", norm(dims[i + 1]).to(device))
        self.has_norm = norm is not None
        self.mid_activation, self.final_activation = mid_activation, final_activation
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth - 1):
            x = getattr(self, f"fc_{i}")(x)
            if self.has_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = self.mid_activation(x)
        x = getattr(self, f"fc_{self.depth - 1}")(x)
        if self.dropout is not None:
            x = self.dropout(x)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x


def make_multilayer_perceptron(
    fully_connected_dims: List[int],
    norm: Optional[Callable] = None,
    mid_activation: Callable = F.relu,
    final_activation: Optional[Callable] = F.relu,
    dropout_rate: float = 0.0,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[nn.Module, int]:
    """The reference's factory: returns (module, output width)."""
    assert all(isinstance(x, int) and x >= 0 for x in fully_connected_dims)
    mlp = MultilayerPerceptron(fully_connected_dims, norm=norm, mid_activation=mid_activation,
                               final_activation=final_activation, dropout_rate=dropout_rate,
                               device=device)
    return mlp, fully_connected_dims[-1]
