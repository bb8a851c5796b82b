"""Weight-only int8 quantization of a port ``state_dict``.

Counterpart of pytorchvideo_tpu/accelerate/quantize.py: symmetric int8 per
output channel, a float32 scale per channel; ``dequantize_variables``
restores dense weights (int8 x scale) for execution.

The JAX package quantizes every ``kernel`` leaf of at least ``min_size``
elements and two dimensions, per its last axis, a flax kernel's output
channel. Those leaves are, in a port ``state_dict``, the ``weight`` entries of
two or more dimensions: ``nn.Linear`` (out, in), ``nn.Conv3d``
(out, in / groups, kt, kh, kw) and the MViT token pool's bare
``TokenPool.weight`` (c, 1, kt, kh, kw), whose output channel is axis 0. So
the set and the int8 values are the JAX package's, through
zoo/from_jax.py's layout transpose.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import torch


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale (out,)): symmetric per output channel
    (axis 0), the scale max |w| / 127 (1 for an all-zero channel), values
    rounded half to even and clipped to [-127, 127], all in float32."""
    w = w.detach().float()
    absmax = w.abs().flatten(1).amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale.view(-1, *(1,) * (w.dim() - 1))), -127, 127)
    return q.to(torch.int8), scale


def _is_kernel(name: str, t) -> bool:
    return isinstance(t, torch.Tensor) and name.rsplit(".", 1)[-1] == "weight" and t.dim() >= 2


def quantize_variables(state_dict: Mapping[str, torch.Tensor], min_size: int = 1024
                       ) -> Dict[str, object]:
    """A copy of ``state_dict`` in which each weight of at least two
    dimensions and ``min_size`` elements is ``{"q": int8, "scale": float32}``;
    every other entry is as it was."""
    out: Dict[str, object] = OrderedDict()
    for name, t in state_dict.items():
        if _is_kernel(name, t) and t.numel() >= min_size:
            q, scale = _quantize_weight(t)
            out[name] = {"q": q, "scale": scale}
        else:
            out[name] = t
    return out


def dequantize_variables(variables: Mapping[str, object], dtype: torch.dtype = torch.bfloat16
                         ) -> Dict[str, torch.Tensor]:
    """Dense weights (int8 x scale, both in ``dtype``) in place of each
    quantized entry: a ``state_dict`` to load."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, v in variables.items():
        if isinstance(v, Mapping) and set(v) == {"q", "scale"}:
            q, scale = v["q"], v["scale"]
            out[name] = q.to(dtype) * scale.to(dtype).view(-1, *(1,) * (q.dim() - 1))
        else:
            out[name] = v
    return out


def quantization_error(state_dict: Mapping[str, torch.Tensor]) -> float:
    """The largest relative error of the int8 round trip over the floating
    entries: max |w - dequant(quant(w))| / max |w| per entry (diagnostic)."""
    restored = dequantize_variables(quantize_variables(state_dict), torch.float32)
    errs = [0.0]
    for name, t in state_dict.items():
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
            t = t.detach().float()
            denom = t.abs().max().item() or 1.0
            errs.append((t - restored[name].to(t.device)).abs().max().item() / denom)
    return max(errs)
