"""Parameter sharding rules: tensor parallelism and FSDP (counterpart of
pytorchvideo_tpu/parallel/sharding.py).

The JAX package maps a params tree to ``NamedSharding``s by path rules and
lets GSPMD partition the step. Here a sharding is what parallel/mesh.py
calls one: a tuple of ``DTensor`` placements, one per mesh axis; a rule is
(a regex over the port's parameter names, a spec) where the spec names,
for each dim of the *torch* tensor, the mesh axis it is split over, or
None (``()`` replicates). parallel/tensor.py puts a model on such
placements.

Layouts differ from the JAX package's: a JAX Dense kernel is (in, out) and
a torch ``nn.Linear`` weight (out, in), so the JAX rule ``P(None,
"model")`` is ``("model", None)`` here; a JAX conv kernel is (kt, kh, kw,
in, out) and a torch conv weight (out, in, kt, kh, kw). The FSDP rule
("the largest evenly divisible dim, ties -> last") is computed on the JAX
layout and mapped to the torch dim, so that both packages shard the same
axis of the same parameter (:func:`jax_dims`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Optional[str], ...]

# (name regex, spec over the torch layout), first match wins: q, k, v (or
# the fused qkv) and fc1 column-parallel (their out rows over "model"),
# proj and fc2 row-parallel (their in columns).
MEGATRON_ATTENTION_RULES: List[Tuple[str, Spec]] = [
    (r"(.*\.)?attn\.(q|k|v|qkv)\.weight$", ("model", None)),
    (r"(.*\.)?attn\.proj\.weight$", (None, "model")),
    (r"(.*\.)?mlp\.fc1\.weight$", ("model", None)),
    (r"(.*\.)?mlp\.fc2\.weight$", (None, "model")),
]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping of axis name
    to size (in mesh order), which the rules need alone."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def jax_dims(name: str, ndim: int) -> List[int]:
    """For each dim of the JAX package's layout of the parameter ``name``
    (of ``ndim`` dims in the port), the torch dim that holds it: a Linear
    weight (out, in) is the JAX (in, out); a conv weight (out, in, *k) the
    JAX (*k, in, out); everything else keeps its layout (zoo/from_jax.py
    makes the same transposes)."""
    if name.endswith("weight") and ndim == 2:
        return [1, 0]
    if name.endswith("weight") and ndim >= 3:
        return [*range(2, ndim), 1, 0]
    return list(range(ndim))


def _placements(spec: Spec, sizes: Dict[str, int]) -> Tuple:
    return tuple(Shard(spec.index(axis)) if axis in spec else Replicate() for axis in sizes)


def _fsdp_spec(name: str, shape: torch.Size, axis: str, n: int, min_size: int
               ) -> Optional[Spec]:
    """The JAX package's FSDP choice (sharding.py:48-62) on the JAX layout,
    as a spec over the torch layout; None where nothing divides."""
    if len(shape) == 0 or math.prod(shape) < min_size:
        return None
    best_dim, best = None, 0
    for torch_dim in jax_dims(name, len(shape)):
        s = shape[torch_dim]
        if s % n == 0 and s >= best:
            best_dim, best = torch_dim, s
    if best_dim is None:
        return None
    spec: List[Optional[str]] = [None] * len(shape)
    spec[best_dim] = axis
    return tuple(spec)


def infer_param_shardings(
    model_or_named_params: Union[nn.Module, Mapping[str, torch.Tensor]],
    mesh,
    rules: Sequence[Tuple[str, Spec]] = (),
    fsdp_axis: Optional[str] = None,
    fsdp_min_size: int = 2**16,
) -> Dict[str, Tuple]:
    """{parameter name: placements, one per mesh axis} by the first rule
    whose regex matches the name (``re.match``) and whose split dims
    divide by their axes' sizes; a rule that matches but does not divide
    falls through to the next. Unmatched parameters replicate, unless
    ``fsdp_axis`` is given: then every unmatched parameter of at least
    ``fsdp_min_size`` elements is split over that axis along its largest
    evenly divisible dim of the JAX layout (ties -> the last, the output
    features of a kernel), FSDP / ZeRO-3; its optimizer state follows it
    (:func:`optimizer_state_shardings`).

    ``mesh``: a ``DeviceMesh`` or a mapping {axis name: size} (the rules
    read only the sizes, so no process group is needed)."""
    sizes = axis_sizes(mesh)
    named = (dict(model_or_named_params.named_parameters())
             if isinstance(model_or_named_params, nn.Module) else dict(model_or_named_params))
    compiled = [(re.compile(pattern), tuple(spec)) for pattern, spec in rules]

    def spec_for(name: str, shape: torch.Size) -> Spec:
        for pattern, spec in compiled:
            if pattern.match(name) and all(
                    axis is None or (dim < len(shape) and shape[dim] % sizes[axis] == 0)
                    for dim, axis in enumerate(spec)):
                return spec
        if fsdp_axis is not None:
            spec = _fsdp_spec(name, shape, fsdp_axis, sizes[fsdp_axis], fsdp_min_size)
            if spec is not None:
                return spec
        return ()

    return {name: _placements(spec_for(name, p.shape), sizes) for name, p in named.items()}


def optimizer_state_shardings(state, param_shardings: Mapping[str, Tuple], mesh
                              ) -> Dict[str, Dict[str, Tuple]]:
    """{parameter name: {state key: placements}} of the per-parameter state
    of a train/train_loop.py ``TrainState``'s optimizer (its model names the
    parameters): every buffer shaped like its parameter (SGD's
    ``momentum_buffer``, Adam's ``exp_avg`` and ``exp_avg_sq``) takes the
    parameter's placements, so a sharded parameter has a sharded state (the
    ZeRO memory effect); anything else (step counts, scalars) replicates."""
    optimizer = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    replicated = (Replicate(),) * len(axis_sizes(mesh))
    out: Dict[str, Dict[str, Tuple]] = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            out[name] = {
                key: param_shardings[name]
                if isinstance(value, torch.Tensor) and value.shape == p.shape and value.dim()
                else replicated
                for key, value in optimizer.state.get(p, {}).items()}
    return out
