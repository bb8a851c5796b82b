"""A model on its placements: tensor parallelism and FSDP (the part of
pytorchvideo_tpu/parallel/sharding.py that GSPMD does for the JAX package:
there the jitted step partitions itself; here each rank holds its shards
and the layers and the step call the collectives).

:func:`shard_model_` keeps each parameter's local shard of the placements
of parallel/sharding.py ``infer_param_shardings``, and returns the
:class:`ShardPlan` that the train step (train/train_loop.py ``sharding=``)
and :func:`ShardPlan.forward` use:

- **Tensor parallelism** (a split over the ``model`` axis): only the
  Megatron layers take it, ``MultiScaleAttention`` (q, k, v or the fused qkv
  column-parallel, ``proj`` row-parallel) and ``Mlp`` (``fc1`` column,
  ``fc2`` row); layers/attention.py runs this rank's heads and rows. The
  layer's other parameters stay replicated but are used inside the region
  on the local heads (the column-parallel biases at this rank's rows, the
  pool convs, the pool norms, the fused path's LayerNorm rows): each rank's
  gradient of them is partial and is summed over the model group, the
  ``psum`` the JAX package's pool kernel makes of its weight gradient
  (ops/token_pool.py:432-436).
- **FSDP** (a split over any other axis): the parameter and its optimizer
  state live as a shard of ``numel / axis size`` elements; the forward
  gathers it over the axis with grad (parallel/collectives.py
  ``all_gather_with_grad``), so its gradient arrives reduce-scattered: the
  ZeRO-3 layout GSPMD gives ``P("data")`` in the JAX package.
- **BatchNorm**: a BatchNorm inside a model region
  (the BatchNorm MViT's pool norms, per head-channel and shared across
  heads) takes the whole world as its group, since its statistics cover
  every head of the global batch; every other one takes the data axis's
  group (layers/batch_norm.py ``set_sync_group``).

The mesh's axes are named as parallel/mesh.py's users name them: ``model``
for the Megatron split, ``data`` for the batch (any other axis may carry
FSDP shards).

Nothing here needs a process group to choose: :class:`MeshAxes` also takes
axis sizes and coordinates alone, which is how the checks that raise (a
split head) run on one process.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.tensor import Shard

from pytorchvideo_tpu_torch.parallel.collectives import all_gather_with_grad
from pytorchvideo_tpu_torch.parallel.sharding import axis_sizes

MODEL_AXIS, DATA_AXIS = "model", "data"


class MeshAxes:
    """The sizes of a mesh's axes, this rank's coordinate on each and each
    axis's process group (the group of the ranks that differ from this one
    on that axis alone). ``groups`` None: no collective can run (the
    placement checks alone)."""

    def __init__(self, sizes: Mapping[str, int], coords: Optional[Mapping[str, int]] = None,
                 groups: Optional[Mapping[str, dist.ProcessGroup]] = None):
        self.sizes = dict(sizes)
        self.coords = dict(coords or {name: 0 for name in self.sizes})
        self.groups = None if groups is None else dict(groups)

    @classmethod
    def of(cls, mesh) -> "MeshAxes":
        """From a ``DeviceMesh`` (or a ``MeshAxes``, as it is)."""
        if isinstance(mesh, MeshAxes):
            return mesh
        names = mesh.mesh_dim_names
        return cls(axis_sizes(mesh), {n: mesh.get_local_rank(n) for n in names},
                   {n: mesh.get_group(n) for n in names})

    def group(self, axis: str):
        if self.groups is None:
            raise ValueError("these mesh axes carry no process groups; build them from a "
                             "DeviceMesh (parallel.make_mesh)")
        return self.groups[axis]


def _shard(placements: Tuple, names: Sequence[str], param_name: str):
    """(axis, dim) of the one split in ``placements``, or None."""
    splits = [(axis, p.dim) for axis, p in zip(names, placements) if isinstance(p, Shard)]
    if len(splits) > 1:
        raise ValueError(f"{param_name}: split over several mesh axes {splits}; a parameter "
                         f"is tensor-parallel or FSDP-sharded, not both")
    return splits[0] if splits else None


def _tp_layers(model: nn.Module) -> Dict[str, Tuple[nn.Module, Dict[str, int]]]:
    """{module prefix: (the attention or Mlp, {its parameter name: the dim a
    tensor-parallel split takes})} of every Megatron layer of ``model``."""
    from pytorchvideo_tpu_torch.layers.attention import Mlp, MultiScaleAttention

    layers = {}
    for prefix, m in model.named_modules():
        if isinstance(m, MultiScaleAttention):
            cols = ("q", "k", "v") if m.separate_qkv else ("qkv",)
            dims = {**{f"{c}.weight": 0 for c in cols}, "proj.weight": 1}
        elif isinstance(m, Mlp):
            dims = {"fc1.weight": 0, "fc2.weight": 1}
        else:
            continue
        layers[prefix] = (m, {f"{prefix}.{n}" if prefix else n: d for n, d in dims.items()})
    return layers


def _full_slices(full_shape, dim: int, parts: int, index: int, qkv: bool):
    """(view shape, index) that takes shard ``index`` of ``parts`` along
    ``dim`` of a tensor of ``full_shape``; a fused qkv weight's shard is its
    q, k and v rows of this rank's heads (layers/attention.py)."""
    if qkv:
        return (3, parts, full_shape[0] // (3 * parts), *full_shape[1:]), (slice(None), index)
    shape = (*full_shape[:dim], parts, full_shape[dim] // parts, *full_shape[dim + 1:])
    return shape, (slice(None),) * dim + (index,)


class ShardPlan:
    """How a model built by :func:`shard_model_` holds its parameters:
    ``placements`` by name, ``tensor_parallel`` {name: dim} of the local
    shards of the Megatron layers, ``fsdp`` {name: (axis, dim)} of the
    gathered ones, ``region`` the replicated parameters used on the local
    heads (their gradients summed over the model group), ``full_shapes``
    the unsharded shapes, and the axes."""

    def __init__(self, axes: MeshAxes, placements, model_axis: Optional[str],
                 data_axis: Optional[str], tensor_parallel: Dict[str, int],
                 fsdp: Dict[str, Tuple[str, int]], region: Set[str], qkv: Set[str],
                 full_shapes: Dict[str, torch.Size]):
        self.axes, self.placements = axes, dict(placements)
        self.model_axis, self.data_axis = model_axis, data_axis
        self.tensor_parallel, self.fsdp, self.region = tensor_parallel, fsdp, region
        self.qkv, self.full_shapes = qkv, full_shapes

    def compute_parameters(self, model: nn.Module, dtype: Optional[torch.dtype] = None
                           ) -> Dict[str, torch.Tensor]:
        """{name: the parameter as the forward takes it}: an FSDP shard
        gathered over its axis with grad, each floating one cast to
        ``dtype`` (differentiable, as train_loop.py ``cast_parameters``)."""
        out = {}
        for name, p in model.named_parameters():
            t = p
            if name in self.fsdp:
                axis, dim = self.fsdp[name]
                t = all_gather_with_grad(p, self.axes.group(axis)).movedim(0, dim).flatten(
                    dim, dim + 1)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[name] = t
        return out

    def forward(self, model: nn.Module, *inputs):
        """``model(*inputs)`` on :meth:`compute_parameters`."""
        return torch.func.functional_call(model, self.compute_parameters(model), inputs)

    def reduce_gradients_(self, model: nn.Module, scalars: Optional[torch.Tensor] = None) -> None:
        """The gradients as the global batch's step has them, in place. Over
        the model group, one all-reduce of every gradient but the
        tensor-parallel shards': the region's summed (each rank's is
        partial), the others averaged (equal up to the replicated part's
        non-deterministic kernels, PyTorch's max-pool backward among them),
        so the replicas stay equal. Then every one averaged over the data
        axis: an FSDP shard's (already the sum of the reduce-scatter) by a
        division, the rest and ``scalars`` (the step's metrics) by one
        all-reduce."""
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        if self.model_axis is not None:
            size = self.axes.sizes[self.model_axis]
            replicated = [(n, p.grad) for n, p in named if n not in self.tensor_parallel]
            _div_([g for n, g in replicated if n not in self.region], size)
            _all_reduce_([g for _, g in replicated], self.axes.group(self.model_axis))
        if self.data_axis is None:
            return
        size = self.axes.sizes[self.data_axis]
        rest = [p.grad for n, p in named if n not in self.fsdp]
        if scalars is not None:
            rest.append(scalars)
        _all_reduce_(rest, self.axes.group(self.data_axis), size)
        _div_([p.grad for n, p in named if n in self.fsdp], size)

    def global_norm(self, model: nn.Module) -> torch.Tensor:
        """The f32 L2 norm of every gradient of the unsharded model, as GSPMD
        computes it: a split parameter's squares summed over the ranks that
        hold its shards (one all-reduce over the world, each sum divided by
        the ranks that hold the same shard), a replicated one's counted
        once."""
        local = torch.zeros(3, device=next(model.parameters()).device)
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            kind = 1 if name in self.tensor_parallel else 2 if name in self.fsdp else 0
            local[kind] += p.grad.float().square().sum()
        split = local[1:].clone()
        dist.all_reduce(split, op=dist.ReduceOp.SUM)
        world = dist.get_world_size()
        holders = torch.tensor([world // self.axes.sizes[self.model_axis] if self.model_axis
                                else world, 1.0], device=local.device)
        if self.fsdp:
            axis = next(iter(self.fsdp.values()))[0]
            holders[1] = world // self.axes.sizes[axis]
        return torch.sqrt(local[0] + (split / holders).sum())

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The unsharded ``state_dict`` (every rank gets it): each shard
        placed in a zero tensor of the full shape and summed over its axis's
        group (an all-reduce, which every backend carries on every device),
        a fused qkv's rows back in their order."""
        out = dict(model.state_dict())
        for name, p in model.named_parameters():
            if name in self.fsdp:
                axis, dim = self.fsdp[name]
            elif name in self.tensor_parallel:
                axis, dim = self.model_axis, self.tensor_parallel[name]
            else:
                continue
            full_shape = self.full_shapes[name]
            view, index = _full_slices(full_shape, dim, self.axes.sizes[axis],
                                       self.axes.coords[axis], name in self.qkv)
            full = p.detach().new_zeros(view)
            full[index] = p.detach().view(full[index].shape)
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=self.axes.group(axis))
            out[name] = full.view(full_shape)
        return out


def _div_(tensors, d: int) -> None:
    if tensors:
        torch._foreach_div_(tensors, float(d))


def _all_reduce_(tensors, group, mean_over: int = 1) -> None:
    """Each of ``tensors`` (one dtype) replaced in place by its sum over
    ``group`` divided by ``mean_over``: one all-reduce of them flattened."""
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean_over != 1:
        flat.div_(mean_over)
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


def shard_model_(model: nn.Module, placements: Mapping[str, Tuple], mesh) -> ShardPlan:
    """Puts ``model`` (the same full weights on every rank) on
    ``placements`` (parallel/sharding.py ``infer_param_shardings``) over
    ``mesh`` (a ``DeviceMesh``, or :class:`MeshAxes`), in place: each
    parameter keeps this rank's shard (build the optimizer afterwards, so
    its state is shard-sized), the Megatron layers split over ``model``
    get their model group, and the BatchNorms their groups (see the module
    docstring). Returns the :class:`ShardPlan`.

    Raises ValueError where the placements split over ``model`` a
    parameter that is not a Megatron weight, or split one along another
    dim; where a layer's weights are split only in part; and where an
    attention's heads do not divide over the model axis (a rank would hold
    part of a head, which no kernel computes): MViT-B's block 0 has one
    head, so tensor parallelism over it takes a rule that replicates
    ``blocks.0.attn`` ahead of ``MEGATRON_ATTENTION_RULES`` (first match
    wins)."""
    from pytorchvideo_tpu_torch.layers.norms import BatchNorm

    axes = MeshAxes.of(mesh)
    names = list(axes.sizes)
    model_axis = MODEL_AXIS if MODEL_AXIS in names else None
    data_axis = DATA_AXIS if DATA_AXIS in names else None
    layers = _tp_layers(model)
    tp_dims = {n: d for _, (_, dims) in layers.items() for n, d in dims.items()}
    tensor_parallel: Dict[str, int] = {}
    fsdp: Dict[str, Tuple[str, int]] = {}
    params = dict(model.named_parameters())
    for name, p in params.items():
        split = _shard(placements[name], names, name)
        if split is None:
            continue
        axis, dim = split
        if axis == model_axis:
            if tp_dims.get(name) != dim:
                raise ValueError(f"{name}: placements split it along dim {dim} over the "
                                 f"'{model_axis}' axis; tensor parallelism splits only the "
                                 f"Megatron weights (attention q, k, v, qkv along dim 0, proj "
                                 f"along dim 1; mlp fc1 along 0, fc2 along 1)")
            tensor_parallel[name] = dim
        else:
            fsdp[name] = (axis, dim)

    region: Set[str] = set()
    region_norms = []
    qkv: Set[str] = set()
    for prefix, (layer, dims) in layers.items():
        split = [n for n in dims if n in tensor_parallel]
        if not split:
            continue
        if len(split) != len(dims):
            raise ValueError(f"{prefix}: placements split {sorted(split)} over '{model_axis}' "
                             f"but not {sorted(set(dims) - set(split))}; a layer's column- and "
                             f"row-parallel weights are split together")
        size = axes.sizes[model_axis]
        heads = getattr(layer, "num_heads", None)
        if heads is not None and heads % size:
            raise ValueError(f"{prefix}: {heads} head(s) of {layer.head_dim} channels do not "
                             f"split over the {size} ranks of the '{model_axis}' axis (a rank "
                             f"would hold part of a head); replicate {prefix} with a rule ahead "
                             f"of MEGATRON_ATTENTION_RULES")
        qkv.update(n for n in dims if n.endswith("qkv.weight"))
        own = f"{prefix}." if prefix else ""
        bias_out = f"{own}proj.bias" if heads is not None else f"{own}fc2.bias"
        region.update(n for n in params if n.startswith(own) and n not in dims
                      and n != bias_out and (heads is not None or n == f"{own}fc1.bias"))
        if heads is not None:
            region_norms += [m for m in layer.modules() if isinstance(m, BatchNorm)]
        if axes.groups is not None:
            layer.model_group = axes.group(model_axis)
        layer.model_index, layer.model_size = axes.coords[model_axis], size

    full_shapes = {n: params[n].shape for n in (*tensor_parallel, *fsdp)}
    with torch.no_grad():
        for name, dim in {**tensor_parallel, **{n: d for n, (_, d) in fsdp.items()}}.items():
            axis = model_axis if name in tensor_parallel else fsdp[name][0]
            view, index = _full_slices(params[name].shape, dim, axes.sizes[axis],
                                       axes.coords[axis], name in qkv)
            local = params[name].view(view)[index]
            params[name].data = local.reshape(
                (-1, *params[name].shape[1:]) if name in qkv else local.shape).clone(
                memory_format=torch.contiguous_format)

    if axes.groups is not None:
        inside = {id(m) for m in region_norms}
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = (dist.group.WORLD if id(m) in inside else
                                   axes.group(data_axis) if data_axis else None)
    return ShardPlan(axes, placements, model_axis if tensor_parallel else None, data_axis,
                     tensor_parallel, fsdp, region, qkv, full_shapes)
