"""int8 serving: dynamic-quantized linear layers.

Counterpart of pytorchvideo_tpu/accelerate/int8.py. The JAX package swaps
each large ``nn.Dense`` call for an int8 GEMM through a flax method
interceptor; here :func:`int8_serving_fn` returns a copy of the model in
which each such ``nn.Linear`` is an :class:`Int8Linear`:

- per-output-channel symmetric int8 weights (quantized once by
  :func:`prepare_int8_weights`, or in every call with ``prepare=False``);
- per-row (per-token) dynamic symmetric int8 activations: the row's
  max |x| / 127 in float32, its reciprocal in float32 cast to the
  activation's dtype, the product rounded in that dtype, then rounded half
  to even and clipped to [-127, 127] (JAX int8.py:106-120, in that order);
- an int8 x int8 -> int32 product: ``torch._int_mm`` on the card (cuBLASLt's
  int8 GEMM, as the JAX package's ``lax.dot`` is XLA's; no kernel of this
  repo), the same int32 product on the CPU; never a float GEMM;
- y = float32(product) * (x_scale * w_scale), plus the bias in float32,
  cast back to the input's dtype.

Which layers: the JAX interceptor sees the ``nn.Dense`` calls whose
in x out is at least ``min_weight_size`` (16384: MViT-B's first-stage
96 x 96 attention ``proj`` stays in float). The head-packed MViT attention's
q, k and v (``separate_qkv``, MViT-B's default) are ``_ProjParams`` there, not
``nn.Dense``, so the JAX package never quantizes them; their port
counterparts are ``nn.Linear``, and :func:`make_int8_interceptor`'s rule
leaves them in float. The fused ``qkv`` and ``pool_first``'s q, k and v are
``nn.Dense`` in JAX and are quantized.

Apply it to a deploy form (``convert_to_deployable_form``) for bf16
activations; the int8 forward holds no host read, so ``CompiledForward``
captures it.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.accelerate.quantize import _quantize_weight

# Quantize only where the weight's GEMM is large enough for the int8 rate to
# pay for the activation's quantization (JAX int8.py:43).
DEFAULT_MIN_WEIGHT_SIZE = 16384
# torch._int_mm on CUDA takes more than 16 rows and k, n multiples of 8.
INT_MM_MIN_ROWS = 17
INT_MM_PAD_ROWS = 32
INT_MM_MULTIPLE = 8

Prepared = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, x_q @ w_q.T. On the card
    ``torch._int_mm`` with w_q's transpose as B; fewer than 17 rows are
    padded with zero rows (exact) and dropped after; K or N not a multiple
    of 8 raises. On the CPU the same int32 product in plain PyTorch."""
    if x_q.device.type == "cpu":
        return torch.mm(x_q.to(torch.int32), w_q.to(torch.int32).t())
    M, K = x_q.shape
    N = w_q.shape[0]
    if K % INT_MM_MULTIPLE or N % INT_MM_MULTIPLE:
        raise ValueError(f"torch._int_mm takes K and N multiples of {INT_MM_MULTIPLE}, got "
                         f"K {K}, N {N}")
    if M < INT_MM_MIN_ROWS:
        x_q = torch.cat([x_q, x_q.new_zeros(INT_MM_PAD_ROWS - M, K)])
    return torch._int_mm(x_q, w_q.t())[:M]


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 rows, float32 scale (M, 1)) of a (M, K) activation, in the JAX
    package's order: max |x| / 127 per row (1 for a zero row), its
    reciprocal cast to x's dtype, the product rounded in x's dtype, then
    rounded half to even and clipped."""
    absmax = x2.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x2 * (1.0 / scale).to(x2.dtype)), -127, 127)
    return q.to(torch.int8), scale


class Int8Linear(nn.Module):
    """An ``nn.Linear`` served in int8 (see the module docstring). With
    ``prepared`` (int8 weight (out, in), float32 scale (out,)) the weight is
    held in int8; without, the float weight is quantized in every call."""

    def __init__(self, linear: nn.Linear, prepared: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        if prepared is None:
            self.weight = linear.weight
        else:
            self.weight = None
            self.register_buffer("weight_q", prepared[0].to(linear.weight.device))
            self.register_buffer("weight_scale", prepared[1].to(linear.weight.device))
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            w_q, w_scale = self.weight_q, self.weight_scale
            if w_scale.dtype != torch.float32:
                raise ValueError(f"the int8 weight's scale is {w_scale.dtype}: cast the model "
                                 f"before int8_serving_fn, not after")
        else:
            w_q, w_scale = _quantize_weight(self.weight)
        x2 = x.reshape(-1, self.in_features)
        x_q, x_scale = quantize_rows(x2)
        y = int8_matmul(x_q, w_q).float() * (x_scale * w_scale[None, :])
        if self.bias is not None:
            y = y + self.bias.float()
        return y.reshape(*x.shape[:-1], self.out_features).to(x.dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"prepared={self.weight is None}")


def prepare_int8_weights(model: nn.Module, min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE
                         ) -> Prepared:
    """Each ``nn.Linear`` weight of at least ``min_weight_size`` elements,
    quantized once, by the module's name (the JAX package's walk over every
    2-D kernel, keyed by its path)."""
    return {name: _quantize_weight(m.weight) for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and m.weight.numel() >= min_weight_size}


def _jax_proj_params(parent: Optional[nn.Module], attr: str) -> bool:
    """q, k or v of a head-packed MViT attention: ``_ProjParams`` in the JAX
    package, which its interceptor never sees."""
    from pytorchvideo_tpu_torch.layers.attention import MultiScaleAttention

    return (isinstance(parent, MultiScaleAttention) and attr in ("q", "k", "v")
            and not parent.pool_first)


def make_int8_interceptor(min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE,
                          prepared: Optional[Prepared] = None) -> Callable:
    """The swap rule ``rule(module, name="", parent=None)``: an
    :class:`Int8Linear` for an ``nn.Linear`` that the JAX interceptor
    quantizes (in x out at least ``min_weight_size``, and not a head-packed
    attention's q, k or v), None for any other module. ``name`` is the
    module's name in the model (the key of ``prepared``), ``parent`` the
    module that holds it."""

    def rule(module: nn.Module, name: str = "", parent: Optional[nn.Module] = None):
        if (not isinstance(module, nn.Linear)
                or module.in_features * module.out_features < min_weight_size
                or _jax_proj_params(parent, name.rsplit(".", 1)[-1])):
            return None
        return Int8Linear(module, None if prepared is None else prepared[name])

    return rule


def int8_serving_fn(model: nn.Module, min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE,
                    prepare: bool = True) -> nn.Module:
    """An eval-mode copy of ``model`` (left unchanged) in which each
    ``nn.Linear`` the JAX package quantizes is an :class:`Int8Linear`: the
    module-swap counterpart of the JAX interceptor. ``prepare`` quantizes
    the weights once (:func:`prepare_int8_weights`); without it every call
    quantizes them."""
    model = copy.deepcopy(model).eval()
    rule = make_int8_interceptor(
        min_weight_size, prepare_int8_weights(model, min_weight_size) if prepare else None)
    for parent_name, parent in list(model.named_modules()):
        for attr, child in list(parent.named_children()):
            swapped = rule(child, f"{parent_name}.{attr}" if parent_name else attr, parent)
            if swapped is not None:
                setattr(parent, attr, swapped)
    return model
