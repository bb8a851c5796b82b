"""Inference-time BatchNorm folding over a module tree.

Counterpart of pytorchvideo_tpu/accelerate/fuse.py ``fold_conv_bn`` and
``fuse_bn_mvit``, which rewrite a JAX variables tree. Here the rewrite is on
modules: each eval BN that follows a conv (the same sibling pairs as the JAX
package, 3D or 2D) folds into the conv, scale into the weight and shift into
the conv's bias (created where the conv had none), and the BN leaves the
model. A pair of ``nn.ModuleList``s (the separable bottleneck's ``conv_b``
and ``norm_b``, the JAX package's ``conv_b_0``/``norm_b_0`` ...) folds branch
by branch. A conv that is not one ``nn.Conv3d`` or ``nn.Conv2d`` (the
acoustic stem's ``ConvReduce3D``) keeps its BN, as in the JAX package.
:func:`fuse_bn_mvit` folds the BatchNorm MViT's norms into its linear
layers. Exact up to rounding.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm

from pytorchvideo_tpu_torch.layers.convolutions import Conv2plus1d

# (conv attribute, norm attribute) sibling pairs used across the model
# families. The JAX package's separable branches ("conv_b_0", "norm_b_0"),
# which it lists too, are entries of the ("conv_b", "norm_b") lists here.
CONV_BN_PAIRS = [
    ("conv_a", "norm_a"),
    ("conv_b", "norm_b"),
    ("conv_c", "norm_c"),
    ("branch1_conv", "branch1_norm"),
    ("conv", "norm"),
    ("pre_conv", "pre_norm"),
    ("post_conv", "post_norm"),
    ("conv_fast_to_slow", "norm"),
]
_CONVS = (nn.Conv3d, nn.Conv2d)


def bn_scale_shift(bn: _BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as y = x * scale + shift, in float64."""
    var = bn.running_var.double()
    mean = bn.running_mean.double()
    gamma = bn.weight.double() if bn.weight is not None else torch.ones_like(var)
    beta = bn.bias.double() if bn.bias is not None else torch.zeros_like(var)
    scale = gamma / torch.sqrt(var + bn.eps)
    return scale, beta - mean * scale


@torch.no_grad()
def fold_bn_into_conv(conv: nn.Module, bn: _BatchNorm) -> None:
    """conv <- bn(conv(.)) in place, for an ``nn.Conv3d`` or ``nn.Conv2d``.
    Where the conv had no bias, the BN's shift becomes its new bias."""
    scale, shift = bn_scale_shift(bn)
    weight = conv.weight.double() * scale.view(-1, *(1,) * (conv.weight.dim() - 1))
    bias = shift if conv.bias is None else conv.bias.double() * scale + shift
    conv.weight.copy_(weight.to(conv.weight.dtype))
    if conv.bias is None:
        conv.bias = nn.Parameter(bias.to(conv.weight.dtype), requires_grad=False)
    else:
        conv.bias.copy_(bias.to(conv.bias.dtype))


def _final_conv(conv: nn.Module) -> Optional[nn.Module]:
    """The conv whose output the sibling norm sees (of a Conv2plus1d, the
    one that runs last: conv_xy, or conv_t when ``conv_xy_first``)."""
    if isinstance(conv, Conv2plus1d):
        conv = conv.conv_t if conv.conv_xy_first else conv.conv_xy
    return conv if isinstance(conv, _CONVS) else None


def _fold_inner(module: Conv2plus1d) -> None:
    """A Conv2plus1d's own BN, between its convs, into the one that runs first."""
    first = module.conv_xy if module.conv_xy_first else module.conv_t
    bn = module.norm
    if (isinstance(bn, _BatchNorm) and isinstance(first, nn.Conv3d)
            and bn.num_features == first.out_channels):
        fold_bn_into_conv(first, bn)
        module.norm = None


def _fold_pair(owner: nn.Module, key: str, conv: Optional[nn.Module],
               norm: Optional[nn.Module]) -> None:
    """Folds ``norm`` (``owner``'s attribute ``key``: a name, or the index of
    a ``nn.ModuleList``'s entry) into ``conv`` where it is a BN of the conv's
    width: the entry becomes None, or, at the head of upstream's ``norm_b =
    Sequential(BN, SE)``, ``nn.Identity``."""
    conv = _final_conv(conv)
    if conv is None or norm is None:
        return
    head_of_sequential = isinstance(norm, nn.Sequential) and len(norm) > 0
    bn = norm[0] if head_of_sequential else norm
    if not isinstance(bn, _BatchNorm) or bn.num_features != conv.out_channels:
        return
    fold_bn_into_conv(conv, bn)
    if head_of_sequential:
        norm[0] = nn.Identity()
    else:
        setattr(owner, key, None)


def fold_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every known conv+BN sibling pair in ``model`` (in place; returns
    it), branch by branch where the pair is two ``nn.ModuleList``s, and the
    BN inside each Conv2plus1d (R(2+1)D's conv_b), which the JAX package's
    fold leaves in place. A folded BN attribute or list entry becomes None;
    the BN at the head of upstream's ``norm_b = Sequential(BN, SE)`` becomes
    ``nn.Identity``."""
    if model.training:
        raise ValueError("fold_conv_bn needs an eval-mode model (running stats)")
    for module in list(model.modules()):
        if isinstance(module, Conv2plus1d):
            _fold_inner(module)
        for conv_key, norm_key in CONV_BN_PAIRS:
            conv, norm = getattr(module, conv_key, None), getattr(module, norm_key, None)
            if isinstance(conv, nn.ModuleList) and isinstance(norm, nn.ModuleList):
                for i, (branch_conv, branch_norm) in enumerate(zip(conv, norm)):
                    _fold_pair(norm, str(i), branch_conv, branch_norm)
            else:
                _fold_pair(module, norm_key, conv, norm)
    return model


@torch.no_grad()
def _fold_before(bn: _BatchNorm, linear: nn.Linear) -> None:
    """linear <- linear(bn(.)) in place: the BN's scale into the weight's
    input columns, its shift through the weight into the bias."""
    if linear.bias is None:
        # upstream's fused linear always has a bias (vision_transformers.py:85)
        raise ValueError("fuse_bn_mvit needs bias slots (qkv_bias=True, bias_on=True): the BN "
                         "shift has nowhere to go")
    scale, shift = bn_scale_shift(bn)
    weight = linear.weight.double()
    linear.bias.copy_((weight @ shift + linear.bias.double()).to(linear.bias.dtype))
    linear.weight.copy_((weight * scale).to(linear.weight.dtype))


@torch.no_grad()
def _fold_after(linear: nn.Linear, bn: _BatchNorm, third: Optional[int]) -> None:
    """linear <- bn(linear(.)) in place for a per-head BN of the head width
    c: its scale and shift tiled head-major over the outputs (JAX
    fuse.py:159-160), of the whole layer or of ``third`` of a fused qkv."""
    scale, shift = bn_scale_shift(bn)
    rows = linear.out_features if third is None else linear.out_features // 3
    start = 0 if third is None else third * rows
    scale, shift = scale.repeat(rows // len(scale)), shift.repeat(rows // len(shift))
    if linear.bias is None:
        linear.bias = nn.Parameter(torch.zeros_like(linear.weight[:, 0]), requires_grad=False)
    weight, bias = linear.weight[start:start + rows], linear.bias[start:start + rows]
    bias.copy_((bias.double() * scale + shift).to(bias.dtype))
    weight.copy_((weight.double() * scale[:, None]).to(weight.dtype))


def fuse_bn_mvit(model: nn.Module) -> nn.Module:
    """The BatchNorm MViT with its norms folded (JAX fuse.py:121-218; upstream
    vision_transformers.py:96-170): an eval-mode copy (``model`` is left
    unchanged) in which each block's ``norm1`` folds into q, k and v (or the
    fused qkv, whole) and ``norm2`` into ``mlp.fc1`` (and the block's ``proj``
    where the width changes), each becoming ``nn.Identity``. Without a cls
    token the per-head pool norms fold after the projections (into the
    matching third of a fused qkv), their GELU kept; with one they stay, as
    in the JAX package, since the pool norm skips the cls token that the
    projection does not. ``dim_mul_in_att``'s ``proj`` reads ``norm1``'s output,
    so ``norm1`` folds into it. ``pool_first`` raises: its pools' BN and GELU
    sit between ``norm1`` and the projections, so no fold is exact. A
    LayerNorm MViT comes back as an unchanged copy."""
    model = copy.deepcopy(model).eval()
    has_cls = model.cls_positional_encoding.has_cls
    for block in model.blocks:
        attn = block.attn
        has_bn = isinstance(block.norm1, _BatchNorm) or isinstance(block.norm2, _BatchNorm)
        if has_bn and attn.pool_first:
            raise ValueError("fuse_bn_mvit: under pool_first norm1 reaches q, k and v through "
                             "the pools' BN and GELU, so it does not fold")
        if isinstance(block.norm1, _BatchNorm):
            targets = [attn.q, attn.k, attn.v] if attn.separate_qkv else [attn.qkv]
            if block.dim_mul_in_att and block.proj is not None:
                targets.append(block.proj)
            for linear in targets:
                _fold_before(block.norm1, linear)
            block.norm1 = nn.Identity()
        for i, name in enumerate(() if has_cls else ("q", "k", "v")):
            norm = getattr(attn, f"norm_{name}")
            if isinstance(norm, _BatchNorm):
                if attn.separate_qkv:
                    _fold_after(getattr(attn, name), norm, None)
                else:
                    _fold_after(attn.qkv, norm, i)
                setattr(attn, f"norm_{name}", nn.Identity())
        if isinstance(block.norm2, _BatchNorm):
            targets = [block.mlp.fc1]
            if not block.dim_mul_in_att and block.proj is not None:
                targets.append(block.proj)
            for linear in targets:
                _fold_before(block.norm2, linear)
            block.norm2 = nn.Identity()
    return model
