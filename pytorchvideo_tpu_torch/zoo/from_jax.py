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
  ``pos_embed_temporal``, ``pos_embed_class``, ``pos_embed``, the masked
  multistream's ``_learned_defaults``) keep their names.

The audio models and the masked multistream add these rules:

- a 2D conv kernel (kh, kw, Cin, Cout) -> weight (Cout, Cin, kh, kw);
- the 2D SE layers' Dense kernels (``se/fc1``, ``se/fc2`` anywhere but under
  X3D's ``norm_b``: ``SqueezeAndExcitationLayer2D``'s and the 2D SE
  block's, at the root of a tree too) -> 1x1 ``Conv2d`` weights (out, in,
  1, 1);
- flax attention's DenseGeneral kernels: ``query``/``key``/``value`` (C,
  heads, head_dim) -> ``nn.Linear`` weight (heads * head_dim, C) and their
  (heads, head_dim) biases flattened; ``out`` (heads, head_dim, C) -> (C,
  heads * head_dim);
- a flax ``LayerNorm`` node ``{scale, bias}`` without an ``ln`` wrapper (the
  encoder's ``norm1_{i}``, ``norm2_{i}``) -> weight, bias;
- flax's LSTM cells ``OptimizedLSTMCell_0`` (the forward pass) and
  ``OptimizedLSTMCell_1`` (the reverse one) of a module at path P -> P's
  ``nn.LSTM`` ``P.lstm``: ``weight_ih_l0`` stacks the input kernels ``ii``,
  ``if``, ``ig``, ``io`` transposed (torch's gate order i, f, g, o),
  ``weight_hh_l0`` the hidden kernels ``hi``..``ho``, ``bias_hh_l0`` their
  biases, and ``bias_ih_l0`` is zero (flax's input kernels have none); the
  reverse cell fills the ``*_reverse`` entries;
- ``ConvReduce3D``'s ``convs_{i}``, the separable bottleneck's ``conv_b_{i}``
  and ``norm_b_{i}``, the encoder's ``attn_{i}``, ``ff1_{i}``, ``ff2_{i}`` and
  the audio fusion's ``block_audio_to_fastslow/stages_{i}`` map by the
  dotted-path rule (``convs.0``, ``conv_b.0`` ...).

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

# Dense layers (JAX path, before renaming) that the port holds as convs:
# X3D's SE (under norm_b) as 1x1x1 convs, the 2D SE's as 1x1 convs.
_DENSE_AS_CONV3D = re.compile(r"\.norm_b\.se\.fc[12]$")
_DENSE_AS_CONV2D = re.compile(r"(^|\.)se\.fc[12]$")
_LSTM_CELL = re.compile(r"^OptimizedLSTMCell_([01])$")
_LSTM_GATES = ("i", "f", "g", "o")


def _dotted(path: Sequence[str]) -> str:
    """('blocks_1', 'res_blocks_0', 'conv_a') -> 'blocks.1.res_blocks.0.conv_a'."""
    return ".".join(re.sub(r"_(\d+)$", r".\1", token) for token in path)


def _is_layer_norm(tree: Mapping) -> bool:
    """A flax LayerNorm's own node: a scale and a bias, nothing else."""
    return set(tree) == {"scale", "bias"}


def _modules(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """Yield (path, node) for every leaf module: a node holding "kernel",
    "bn" or "ln", a flax LayerNorm node or an LSTM cell. A bare array
    elsewhere is a parameter of its own, yielded as (path + (name,), array)."""
    if ("kernel" in tree or "bn" in tree or "ln" in tree or _is_layer_norm(tree)
            or (path and _LSTM_CELL.match(path[-1]))):
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


def _lstm_cell(state_dict: Dict[str, torch.Tensor], path: Tuple[str, ...], cell: Mapping) -> None:
    """One flax ``OptimizedLSTMCell`` into its ``nn.LSTM``'s layer-0 entries."""
    prefix = ".".join(filter(None, (_dotted(path[:-1]), "lstm")))
    suffix = "_reverse" if _LSTM_CELL.match(path[-1]).group(1) == "1" else ""
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in _LSTM_GATES])
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in _LSTM_GATES])
    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _LSTM_GATES])
    state_dict[f"{prefix}.weight_ih_l0{suffix}"] = _tensor(w_ih)
    state_dict[f"{prefix}.weight_hh_l0{suffix}"] = _tensor(w_hh)
    state_dict[f"{prefix}.bias_ih_l0{suffix}"] = _tensor(np.zeros_like(b_hh))
    state_dict[f"{prefix}.bias_hh_l0{suffix}"] = _tensor(b_hh)


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
        if _LSTM_CELL.match(path[-1]):
            _lstm_cell(state_dict, path, node)
            continue
        name = jax_name
        for pattern, replacement in X3D_INVERSE_RENAME_RULES + MVIT_INVERSE_RENAME_RULES:
            name = re.sub(pattern, replacement, name)
        if "ln" in node or _is_layer_norm(node):
            ln = node.get("ln", node)
            state_dict[f"{name}.weight"] = _tensor(ln["scale"])
            state_dict[f"{name}.bias"] = _tensor(ln["bias"])
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
        elif kernel.ndim == 4:
            weight = np.transpose(kernel, (3, 2, 0, 1))
        elif kernel.ndim == 3 and path[-1] == "out":
            weight = kernel.reshape(-1, kernel.shape[-1]).T
        elif kernel.ndim == 3:
            weight = kernel.reshape(kernel.shape[0], -1).T
        elif kernel.ndim == 2 and _DENSE_AS_CONV3D.search(jax_name):
            weight = np.transpose(kernel)[:, :, None, None, None]
        elif kernel.ndim == 2 and _DENSE_AS_CONV2D.search(jax_name):
            weight = np.transpose(kernel)[:, :, None, None]
        elif kernel.ndim == 2:
            weight = np.transpose(kernel)
        else:
            raise ValueError(f"unhandled kernel rank at {jax_name}: {kernel.shape}")
        state_dict[f"{name}.weight"] = _tensor(weight)
        if "bias" in node:
            state_dict[f"{name}.bias"] = _tensor(np.asarray(node["bias"]).reshape(-1))
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
