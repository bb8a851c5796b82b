"""pytorchvideo_tpu_torch/parallel/sharding.py and the placement checks of
parallel/tensor.py, on one process (no process group).

- ``infer_param_shardings`` of the MViT of tests/test_train_parallel.py:196-209
  (separate and fused qkv; the Megatron rules, alone and with FSDP over
  ``data`` from 256 elements) and of its X3D-tiny (FSDP alone) against the
  JAX function's specs on a (2, 2) mesh of four of the conftest's virtual
  devices, each JAX spec carried through the layout transposes of
  zoo/from_jax.py: every JAX leaf is filled with the indices of its elements
  (distinct across leaves), so each port tensor's values say which leaf and
  which of its dims every torch dim is.
- ``optimizer_state_shardings``: SGD's momentum takes its parameter's
  placements, and an FSDP shard and its momentum hold numel / 2 elements.
- ``shard_model_``: a fused qkv's local rows are this rank's q, k and v rows
  in that order; an attention whose heads do not split over the model axis
  raises ValueError naming the block, and a rule that replicates it ahead of
  the Megatron rules lets the rest split.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pytorchvideo_tpu import models as jax_models
from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu.parallel import MEGATRON_ATTENTION_RULES as JAX_RULES
from pytorchvideo_tpu.parallel import infer_param_shardings as jax_infer_param_shardings
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.models.x3d import create_x3d
from pytorchvideo_tpu_torch.parallel import (
    MEGATRON_ATTENTION_RULES,
    MeshAxes,
    infer_param_shardings,
    optimizer_state_shardings,
    shard_model_,
)
from pytorchvideo_tpu_torch.train import OptimizerConfig, construct_optimizer, create_train_state
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch.distributed.tensor import Replicate, Shard

SIZES = {"data": 2, "model": 2}
# tests/test_train_parallel.py:196-209 and :28-36.
MVIT = dict(spatial_size=32, temporal_size=2, depth=2, num_heads=2, patch_embed_dim=32,
            head_num_classes=4)
X3D_TINY = dict(input_clip_length=2, input_crop_size=32, model_num_class=5, stem_dim_in=8,
                depth_factor=0.1, dropout_rate=0.0)
# name -> (model, its variant, Megatron rules, FSDP axis)
CASES = {
    "mvit": ("mvit", {}, True, None),
    "mvit fused qkv": ("mvit", {"separate_qkv": False}, True, None),
    "mvit + fsdp": ("mvit", {}, True, "data"),
    "mvit fused qkv + fsdp": ("mvit", {"separate_qkv": False}, True, "data"),
    "x3d fsdp": ("x3d", {}, False, "data"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(kind, variant):
    if kind == "mvit":
        return (jax_models.create_multiscale_vision_transformers(**MVIT, **variant),
                create_multiscale_vision_transformers(**MVIT, **variant, device="cpu"),
                jnp.zeros((1, 2, 32, 32, 3)))
    return jax_create_x3d(**X3D_TINY), create_x3d(**X3D_TINY, device="cpu"), \
        jnp.zeros((1, 2, 32, 32, 3))


def _expected(jax_model, x, rules, fsdp_axis):
    """{port parameter name: placements} from the JAX function's specs."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), x, False))
    offsets, leaves = [0], jax.tree_util.tree_leaves(shapes["params"])
    for leaf in leaves:
        offsets.append(offsets[-1] + int(np.prod(leaf.shape)))
    numbered = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes["params"]),
        [np.arange(o, o + int(np.prod(a.shape)), dtype=np.float64).reshape(a.shape)
         for o, a in zip(offsets, leaves)])
    stats = jax.tree_util.tree_map(lambda a: np.zeros(a.shape), shapes.get("batch_stats", {}))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = jax.tree_util.tree_leaves(jax_infer_param_shardings(
        numbered, mesh, rules, fsdp_axis=fsdp_axis, fsdp_min_size=256))
    expected = {}
    for name, t in jax_variables_to_state_dict(numbered, stats).items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        first = int(t.min())
        leaf = int(np.searchsorted(offsets, first, side="right")) - 1
        strides = np.cumprod((1,) + leaves[leaf].shape[::-1])[:-1][::-1]
        spec = tuple(specs[leaf].spec) + (None,) * (len(leaves[leaf].shape)
                                                     - len(specs[leaf].spec))
        placements = []
        for axis in SIZES:
            torch_dim = None
            for jax_dim, a in enumerate(spec):
                if a == axis:
                    # The torch dim along which one step moves by this JAX
                    # dim's stride.
                    torch_dim = next(d for d in range(t.dim()) if t.shape[d] > 1 and int(
                        t.narrow(d, 1, 1).flatten()[0] - t.narrow(d, 0, 1).flatten()[0])
                        == strides[jax_dim])
            placements.append(Replicate() if torch_dim is None else Shard(torch_dim))
        expected[name] = tuple(placements)
    return expected


@pytest.mark.parametrize("case", list(CASES))
def test_placements_match_jax_through_the_layouts(case):
    kind, variant, megatron, fsdp_axis = CASES[case]
    jax_model, model, x = _models(kind, variant)
    expected = _expected(jax_model, x, JAX_RULES if megatron else (), fsdp_axis)
    got = infer_param_shardings(model, SIZES, MEGATRON_ATTENTION_RULES if megatron else (),
                                fsdp_axis=fsdp_axis, fsdp_min_size=256)
    assert set(got) == set(expected) == {n for n, _ in model.named_parameters()}
    for name, placements in expected.items():
        assert got[name] == placements, (name, got[name], placements)
    split = [n for n, p in got.items() if any(isinstance(q, Shard) for q in p)]
    if megatron:
        assert any(n.endswith("attn.proj.weight") and got[n] == (Replicate(), Shard(1))
                   for n in split)
    if fsdp_axis:
        assert any(isinstance(got[n][0], Shard) for n in split)


def test_optimizer_state_follows_the_fsdp_shards():
    model = create_x3d(**X3D_TINY, device="cpu")
    full = {n: p.numel() for n, p in model.named_parameters()}
    placements = infer_param_shardings(model, SIZES, fsdp_axis="data", fsdp_min_size=256)
    plan = shard_model_(model, placements, MeshAxes(SIZES, {"data": 1, "model": 0}))
    state = create_train_state(model, construct_optimizer(model, OptimizerConfig(lr=0.05)))
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    shardings = optimizer_state_shardings(state, placements, SIZES)
    assert plan.fsdp
    for name, p in model.named_parameters():
        momentum = state.optimizer.state[p]["momentum_buffer"]
        assert shardings[name]["momentum_buffer"] == placements[name]
        expect = full[name] // 2 if name in plan.fsdp else full[name]
        assert p.numel() == momentum.numel() == expect, name


def test_fused_qkv_shard_holds_its_heads_q_k_v_rows():
    model = create_multiscale_vision_transformers(**MVIT, separate_qkv=False, device="cpu")
    full = model.blocks[1].attn.qkv.weight.detach().clone()
    placements = infer_param_shardings(model, SIZES, MEGATRON_ATTENTION_RULES)
    assert placements["blocks.1.attn.qkv.weight"] == (Replicate(), Shard(0))
    plan = shard_model_(model, placements, MeshAxes(SIZES, {"data": 0, "model": 1}))
    local = model.blocks[1].attn.qkv.weight
    d = full.shape[0] // 3  # 2 heads of 16: rank 1 holds head 1 of q, k and v
    assert torch.equal(local, torch.cat([full[i * d + d // 2:(i + 1) * d] for i in range(3)]))
    attn = model.blocks[1].attn
    assert (attn.model_index, attn.model_size, attn._local_heads()) == (1, 2, 1)
    assert "blocks.1.attn.qkv.bias" in plan.region and "blocks.1.attn.proj.bias" not in plan.region


def test_a_split_head_raises_and_a_replicating_rule_avoids_it():
    # One head in block 0, then two (MViT-B's head schedule in small).
    config = dict(MVIT, num_heads=1, atten_head_mul=[[1, 2.0]])
    model = create_multiscale_vision_transformers(**config, device="cpu")
    placements = infer_param_shardings(model, SIZES, MEGATRON_ATTENTION_RULES)
    with pytest.raises(ValueError, match=r"blocks\.0\.attn: 1 head\(s\) of 32 channels"):
        shard_model_(model, placements, MeshAxes(SIZES))
    rules = [(r"blocks\.0\.attn\..*", ()), *MEGATRON_ATTENTION_RULES]
    placements = infer_param_shardings(model, SIZES, rules)
    plan = shard_model_(model, placements, MeshAxes(SIZES))
    assert "blocks.0.attn.q.weight" not in plan.tensor_parallel
    assert plan.tensor_parallel["blocks.1.attn.q.weight"] == 0
    assert plan.tensor_parallel["blocks.0.mlp.fc2.weight"] == 1
