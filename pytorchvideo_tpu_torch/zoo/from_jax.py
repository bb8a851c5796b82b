"""JAX variables tree -> port ``state_dict``.

Counterpart (the inverse direction) of pytorchvideo_tpu/zoo/import_torch.py.
Takes numpy ``params`` and ``batch_stats`` trees in the JAX package's layout
and returns a ``state_dict`` for the port's modules, which keep upstream
pytorchvideo's key layout:

- path ``blocks_1/res_blocks_0/...`` -> key ``blocks.1.res_blocks.0...``
  (a detector's ``model/blocks_0/...`` and ``detection_head/proj`` map by
  the same rule to upstream's ``model.blocks.0...`` and
  ``detection_head.proj``);
- the JAX package's renames (``X3D_RENAME_RULES`` and ``MVIT_RENAME_RULES``
  of the importer) are undone: ``norm_b/norm`` -> ``norm_b.0``,
  ``norm_b/se/fc1|fc2`` -> ``norm_b.1.block.0|2``, ``projected_pool`` ->
  ``pool``; ``attn/pool_q/pool`` -> ``attn.pool_q`` and ``attn/pool_q/norm``
  -> ``attn.norm_q`` (likewise k and v). The two families' rules touch
  disjoint names, so both apply to every tree;
- conv kernel (kt, kh, kw, Cin/g, Cout) -> weight (Cout, Cin/g, kt, kh, kw)
  (MViT's pool kernel (kt, kh, kw, 1, c) -> (c, 1, kt, kh, kw));
  Dense kernel (in, out) -> Linear weight (out, in), or a 1x1x1 Conv3d
  weight (out, in, 1, 1, 1) for the SE layers; BN {scale, bias} and
  {mean, var} -> weight, bias, running_mean, running_var and a zero
  num_batches_tracked; LayerNorm ``ln/{scale, bias}`` -> weight, bias;
- bare parameters (MViT's ``cls_token``, ``pos_embed_spatial``,
  ``pos_embed_temporal``, ``pos_embed_class``, ``pos_embed``) keep their
  names.

The same rules carry the efficient blocks' trees (accelerate/conv_blocks.py:
``conv``/``norm``, ``conv_a``..``conv_c``/``norm_a``..``norm_c``, ``se/fc1`` and
``se/fc2`` as 5-D conv kernels, ``fc``) into their ``.model``, and the
BatchNorm MViT's ``norm1``, ``norm2`` and pool norms (``attn/pool_q/norm`` ->
``attn.norm_q``) with their running statistics.

:func:`jax_ssl_state_to_state_dict` turns a JAX SSL state (the dict of
pytorchvideo_tpu/models/byol.py, simclr.py, memory_bank.py or
train/ssl.py's MoCoV2) into the port task's ``state_dict``: each variables
tree (``online``, ``momentum``, ``predictor``, ``backbone``, ``mlp``) by
the rules above under its key, where a ``MultilayerPerceptron``'s Dense
``fc_0``, ``fc_1``... keep their names and its flax-named norms
(``BatchNorm_0``...) become ``norm_0``...; the arrays ``queue``,
``queue_ptr`` (int64) and ``memory`` as they are.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

X3D_INVERSE_RENAME_RULES = [
    (r"norm_b\.norm(?=$|\.)", "norm_b.0"),
    (r"norm_b\.se\.fc1(?=$|\.)", "norm_b.1.block.0"),
    (r"norm_b\.se\.fc2(?=$|\.)", "norm_b.1.block.2"),
    (r"\.projected_pool\.", ".pool."),
]
MVIT_INVERSE_RENAME_RULES = [
    (r"attn\.pool_(q|k|v)\.pool$", r"attn.pool_\1"),
    (r"attn\.pool_(q|k|v)\.norm$", r"attn.norm_\1"),
]

# Dense layers (JAX path, before renaming) that the port holds as 1x1x1 convs.
_DENSE_AS_CONV = re.compile(r"\.se\.fc[12]$")


def _dotted(path: Sequence[str]) -> str:
    """('blocks_1', 'res_blocks_0', 'conv_a') -> 'blocks.1.res_blocks.0.conv_a'."""
    return ".".join(re.sub(r"_(\d+)$", r".\1", token) for token in path)


def _modules(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """Yield (path, node) for every leaf module: a node holding "kernel",
    "bn" or "ln". A bare array elsewhere is a parameter of its own, yielded
    as (path + (name,), array)."""
    if "kernel" in tree or "bn" in tree or "ln" in tree:
        yield path, tree
        return
    for key, child in tree.items():
        if isinstance(child, Mapping):
            yield from _modules(child, path + (key,))
        else:
            yield path + (key,), child


def _lookup(tree: Mapping, path: Sequence[str]) -> Mapping:
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def jax_variables_to_state_dict(
    params: Mapping, batch_stats: Mapping
) -> Dict[str, torch.Tensor]:
    """Convert JAX ``params``/``batch_stats`` trees (numpy leaves) into a
    port ``state_dict``, undoing the X3D and MViT renames on each dotted
    module path."""
    state_dict: Dict[str, torch.Tensor] = OrderedDict()
    for path, node in _modules(params):
        jax_name = _dotted(path)
        if not isinstance(node, Mapping):
            state_dict[jax_name] = _tensor(node)
            continue
        name = jax_name
        for pattern, replacement in X3D_INVERSE_RENAME_RULES + MVIT_INVERSE_RENAME_RULES:
            name = re.sub(pattern, replacement, name)
        if "ln" in node:
            state_dict[f"{name}.weight"] = _tensor(node["ln"]["scale"])
            state_dict[f"{name}.bias"] = _tensor(node["ln"]["bias"])
            continue
        if "bn" in node:
            stats = _lookup(batch_stats, path + ("bn",))
            state_dict[f"{name}.weight"] = _tensor(node["bn"]["scale"])
            state_dict[f"{name}.bias"] = _tensor(node["bn"]["bias"])
            state_dict[f"{name}.running_mean"] = _tensor(stats["mean"])
            state_dict[f"{name}.running_var"] = _tensor(stats["var"])
            state_dict[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            continue
        kernel = np.asarray(node["kernel"])
        if kernel.ndim == 5:
            weight = np.transpose(kernel, (4, 3, 0, 1, 2))
        elif kernel.ndim == 2 and _DENSE_AS_CONV.search(jax_name):
            weight = np.transpose(kernel)[:, :, None, None, None]
        elif kernel.ndim == 2:
            weight = np.transpose(kernel)
        else:
            raise ValueError(f"unhandled kernel rank at {jax_name}: {kernel.shape}")
        state_dict[f"{name}.weight"] = _tensor(weight)
        if "bias" in node:
            state_dict[f"{name}.bias"] = _tensor(node["bias"])
    return state_dict


MLP_INVERSE_RENAME_RULES = [
    (r"(^|\.)fc\.(\d+)\.", r"\1fc_\2."),
    (r"(^|\.)(?:BatchNorm|LayerNorm)\.(\d+)\.", r"\1norm_\2."),
]
SSL_VARIABLES = ("online", "momentum", "predictor", "backbone", "mlp")
SSL_ARRAYS = ("queue", "queue_ptr", "memory")


def jax_ssl_state_to_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX SSL state (numpy leaves) -> the port task's ``state_dict``."""
    state_dict: Dict[str, torch.Tensor] = OrderedDict()
    for key, value in state.items():
        if key in SSL_VARIABLES:
            converted = jax_variables_to_state_dict(value["params"], value.get("batch_stats", {}))
            for name, tensor in converted.items():
                for pattern, replacement in MLP_INVERSE_RENAME_RULES:
                    name = re.sub(pattern, replacement, name)
                state_dict[f"{key}.{name}"] = tensor
        elif key in SSL_ARRAYS:
            tensor = _tensor(value)
            state_dict[key] = tensor.long() if key == "queue_ptr" else tensor
        else:
            raise ValueError(f"unknown SSL state entry {key!r}")
    return state_dict
