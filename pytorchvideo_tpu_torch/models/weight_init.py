"""Weight initialisation in ResNet and ViT styles, in place on a module
(counterpart of pytorchvideo_tpu/models/weight_init.py; upstream
models/weight_init.py:8-92).

The rules are the JAX package's, read through the port's names (a JAX
``kernel`` is a conv's or a ``Linear``'s ``weight``, a norm's ``scale`` its
``weight``):

- resnet: a conv ``weight`` ~ N(0, 2 / fan_out) with fan_out = out channels
  x the kernel's volume (upstream's ``c2_msra_fill``); a ``Linear`` weight ~
  N(0, ``fc_init_std``), and so are the squeeze-excitation 1x1x1 convs,
  which the JAX package holds as Dense layers; every bias 0; every norm
  weight 1, except each bottleneck's last BN (``norm_c``, upstream's
  ``block_final_bn``), which is 0.
- vit: every conv and ``Linear`` weight, the cls token and the position
  tables ~ N(0, std) truncated at 2 std; every bias 0, every norm weight 1.

Anything else keeps its value (the BN running buffers included). The JAX
functions fold ``hash(path)`` into their key, which Python salts per
process; here the draws come in module order from ``generator`` (on the
generator's device, then copied), so one seed gives one initialisation.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.layers.squeeze_excitation import SqueezeExcitation

_NORMS = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
_VIT_TABLES = ("cls_token", "pos_embed", "pos_embed_spatial", "pos_embed_temporal",
               "pos_embed_class")


def _fill_(p: torch.Tensor, generator: Optional[torch.Generator], fill) -> None:
    device = p.device if generator is None else generator.device
    value = torch.empty(p.shape, dtype=torch.float32, device=device)
    fill(value)
    p.copy_(value)


def _normal_(p, std: float, generator) -> None:
    _fill_(p, generator, lambda v: v.normal_(0.0, std, generator=generator))


def _trunc_normal_(p, std: float, generator) -> None:
    _fill_(p, generator, lambda v: nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                                          generator=generator))


@torch.no_grad()
def init_resnet_weights(model: nn.Module, fc_init_std: float = 0.01,
                        generator: Optional[torch.Generator] = None) -> nn.Module:
    """ResNet-style re-initialisation of ``model``'s parameters, in place."""
    dense = {id(m) for se in model.modules() if isinstance(se, SqueezeExcitation)
             for m in se.modules() if isinstance(m, nn.Conv3d)}
    for module_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif isinstance(module, _NORMS):
                p.fill_(0.0 if module_name.endswith("norm_c") else 1.0)
            elif name == "weight" and (p.dim() == 2 or id(module) in dense):
                _normal_(p, fc_init_std, generator)
            elif name == "weight":
                fan_out = p.shape[0] * math.prod(p.shape[2:])
                _normal_(p, math.sqrt(2.0 / fan_out), generator)
    return model


@torch.no_grad()
def init_vit_weights(model: nn.Module, trunc_normal_std: float = 0.02,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """ViT-style re-initialisation of ``model``'s parameters, in place."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif isinstance(module, _NORMS):
                p.fill_(1.0)
            elif name == "weight" or name in _VIT_TABLES:
                _trunc_normal_(p, trunc_normal_std, generator)
    return model


def init_net_weights(model: nn.Module, init_std: float = 0.01, style: str = "resnet",
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """The dispatcher (upstream weight_init.py:72-92)."""
    if style == "resnet":
        return init_resnet_weights(model, init_std, generator)
    if style == "vit":
        return init_vit_weights(model, init_std, generator)
    raise ValueError(f"style must be 'resnet' or 'vit', got {style!r}")
