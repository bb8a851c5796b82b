"""pytorchvideo_tpu_torch's data-parallel primitives against the JAX
package's on the CPU: four gloo ranks (tests/torch_parallel_worker.py, one
spawn for the whole file) against the conftest's virtual devices.

- ``all_gather_with_grad`` and ``cat_all_gather`` against ``lax.all_gather``
  under ``shard_map`` on 4 devices: values and gradients, rtol 1e-6;
- ``make_mesh`` (shapes, rank layout, placements, refusals), the world
  queries and ``local_sync_groups`` against the JAX package's;
- the synced ``BatchNorm`` against flax's ``BatchNorm(axis_name=...)``
  under ``pmap`` (the JAX package's wrapper), with the global group and
  the local groups [[0, 1], [2, 3]], on random inputs and on the
  constant-per-rank case of tests/test_train_parallel.py:94 (group means
  0.5 and 2.5, running means 0.05 and 0.25): outputs, input gradients and
  running stats in f32 at rtol 5e-3 / atol 5e-4
  (tests/test_models_parity.py:24);
- ``ntxent_loss`` and ``SimCLR.loss`` over a 4-rank group against the JAX
  ``axis_name`` branch under ``shard_map``: the loss and the gradients of
  the ranks' summed losses (inputs, and SimCLR's parameters summed over
  the ranks) at the same tolerance;
- ``sequence_parallel_attention`` against the JAX function on a 4-device
  mesh and ``pooled_attention_packed_xla``: kv replicated and sharded,
  residual pooling off and on, values and q/k/v gradients at rtol/atol
  1e-5 (tests/test_parallel_sequence.py:41), and the refusal of a token
  count the group does not divide.

Tolerances as listed; the spawn takes ~10 s here.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pytorchvideo_tpu.layers.mlp import MultilayerPerceptron as JaxMlp
from pytorchvideo_tpu.layers.norms import BatchNorm as JaxBatchNorm
from pytorchvideo_tpu.models.simclr import SimCLR as JaxSimCLR
from pytorchvideo_tpu.ops.pooled_attention import pooled_attention_packed_xla
from pytorchvideo_tpu.parallel import distributed as jax_distributed
from pytorchvideo_tpu.parallel import make_mesh as jax_make_mesh
from pytorchvideo_tpu.parallel import sequence_parallel_attention as jax_sequence_attention
from pytorchvideo_tpu.train import losses as jax_losses
from pytorchvideo_tpu_torch.layers import MultilayerPerceptron
from pytorchvideo_tpu_torch.models import SimCLR
from pytorchvideo_tpu_torch.parallel import batch_rows
from pytorchvideo_tpu_torch.train import ntxent_loss
from pytorchvideo_tpu_torch.zoo.from_jax import jax_ssl_state_to_state_dict
from torch_parallel_worker import spawn
from torch_port_helpers import TOL, random_variables

WORLD = 4
GATHER_TOL = dict(rtol=1e-6, atol=1e-6)
ATTENTION_TOL = dict(rtol=1e-5, atol=1e-5)
C, TEMPERATURE, MLP_DIMS = 5, 0.1, [6, 12, 4]
LOCAL_GROUPS = [[0, 1], [2, 3]]


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, *shape):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _devices():
    return np.array(jax.devices()[:WORLD])


@functools.lru_cache(maxsize=None)
def _simclr():
    jax_simclr = JaxSimCLR(JaxMlp(fully_connected_dims=MLP_DIMS, final_activation=None),
                           temperature=TEMPERATURE)
    shapes = jax.eval_shape(lambda: jax_simclr.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((2, MLP_DIMS[0]))))
    state = {k: random_variables(v, i) for i, (k, v) in enumerate(shapes.items())}
    return jax_simclr, state


def _inputs():
    bn_x = _normal(3, WORLD, 2, C, 2, 3, 3) * 2.0 + 0.5
    const = np.arange(WORLD, dtype=np.float32)[:, None, None, None, None, None] * np.ones(
        (WORLD, 2, C, 2, 3, 3), np.float32)
    rng = _rng(4)
    bn_params = (rng.uniform(0.5, 1.5, C), rng.normal(size=C) * 0.1, rng.normal(size=C) * 0.1,
                 rng.uniform(0.5, 1.5, C))
    return {
        "gather_x": _normal(0, WORLD, 3, 5),
        "all_gather_with_grad_w": _normal(1, WORLD, WORLD, 3, 5),
        "cat_all_gather_w": _normal(2, WORLD, WORLD * 3, 5),
        "bn_x": bn_x, "bn_const": const, "bn_w": _normal(5, WORLD, 2, C, 2, 3, 3),
        "bn_params": tuple(p.astype(np.float32) for p in bn_params),
        "z1": _normal(6, WORLD, 3, 8), "z2": _normal(7, WORLD, 3, 8),
        "temperature": TEMPERATURE, "mlp_dims": MLP_DIMS,
        "simclr_state": jax_ssl_state_to_state_dict(_simclr()[1]),
        "x1": _normal(8, WORLD, 3, MLP_DIMS[0]), "x2": _normal(9, WORLD, 3, MLP_DIMS[0]),
        "attention": (*(torch.from_numpy(_normal(10 + i, 2, n, 32))
                        for i, n in enumerate((64, 24, 24))), 2, 16 ** -0.5),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results: one spawn of four gloo processes."""
    directory = tmp_path_factory.mktemp("parallel")
    inputs = _inputs()
    torch.save(_as_torch(inputs), directory / "inputs.pt")
    return inputs, spawn(str(directory), "primitives", WORLD)


def _np(t):
    return t.detach().numpy()


# --- collectives --------------------------------------------------------------

@pytest.mark.parametrize("name", ["all_gather_with_grad", "cat_all_gather"])
def test_collective_values_and_gradients_match_lax_all_gather(ranks, name):
    inputs, results = ranks
    tiled = name == "cat_all_gather"
    mesh = Mesh(_devices(), ("d",))

    def local(x, w):
        y = jax.lax.all_gather(x, "d", axis=0, tiled=tiled)
        return y[None], jnp.sum(w[0] * y)[None]

    f = shard_map(local, mesh=mesh, in_specs=(P("d"), P("d")), out_specs=(P("d"), P("d")))
    x = jnp.asarray(inputs["gather_x"].reshape(WORLD * 3, 5))
    w = jnp.asarray(inputs[f"{name}_w"][:, None])
    values, _ = jax.jit(f)(x, w)
    grad = jax.jit(jax.grad(lambda x: jnp.sum(f(x, w)[1])))(x)
    for r, out in enumerate(results):
        y, dx = out["collectives"][name]
        assert y.shape == ((WORLD * 3, 5) if tiled else (WORLD, 3, 5))
        np.testing.assert_allclose(_np(y), np.asarray(values[r]), **GATHER_TOL)
        np.testing.assert_allclose(_np(dx), np.asarray(grad[r * 3:(r + 1) * 3]), **GATHER_TOL)


# --- the mesh and the world ---------------------------------------------------

@pytest.mark.parametrize("shapes,names", [((-1,), ("data",)), ((2, -1), ("data", "model")),
                                          ((-1, 2), ("data", "model"))])
def test_make_mesh_matches_jax(ranks, shapes, names):
    _, results = ranks
    ref = jax_make_mesh(shapes, names, devices=list(_devices()))
    ids = np.vectorize(lambda d: d.id)(ref.devices).tolist()
    for r, out in enumerate(results):
        shape, dim_names, layout, sharded, repl = out["mesh"][f"mesh {shapes}"]
        assert dict(zip(dim_names, shape)) == dict(ref.shape)
        assert dim_names == tuple(ref.axis_names) and layout == ids
        assert sharded == ["S(0)" if n == "data" else "R" for n in names]
        assert repl == ["R"] * len(names)


def test_make_mesh_refuses_what_jax_refuses(ranks):
    _, results = ranks
    for shapes, message in results[0]["mesh"]["mesh_errors"].items():
        names = ("data",) if len(eval(shapes)) == 1 else ("data", "model")
        with pytest.raises(ValueError):
            jax_make_mesh(eval(shapes), names, devices=list(_devices()))
        assert message is not None and "do not tile" in message, shapes


def test_world_queries_and_local_sync_groups_match_jax(ranks, monkeypatch):
    _, results = ranks
    monkeypatch.setattr(jax_distributed.jax, "device_count", lambda: WORLD)
    ref = jax_distributed.local_sync_groups(2)
    assert ref == LOCAL_GROUPS
    for r, out in enumerate(results):
        mesh = out["mesh"]
        assert (mesh["world"], mesh["local"], mesh["rank"]) == (WORLD, WORLD, r)
        assert mesh["local_sync_groups"] == ref


# --- the synced BatchNorm -----------------------------------------------------

def _flax_bn(inputs, case: str, groups):
    """flax's BatchNorm under pmap over 4 devices: (outputs, input gradients
    of the devices' summed losses, running mean, running var), NCTHW."""
    weight, bias, mean, var = inputs["bn_params"]
    if case == "constant":
        mean = np.zeros_like(mean)
    xs = inputs["bn_x"] if case == "random" else inputs["bn_const"]
    bn = JaxBatchNorm(momentum=0.9, epsilon=1e-5, axis_name="d", axis_index_groups=groups)
    variables = {"params": {"bn": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}
    x = jnp.asarray(np.moveaxis(xs, 2, -1))
    w = jnp.asarray(np.moveaxis(inputs["bn_w"], 2, -1))

    def device(x, w):
        out, mutated = bn.apply(variables, x, True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated["batch_stats"]["bn"])

    pmapped = jax.pmap(device, axis_name="d")
    _, (out, stats) = pmapped(x, w)
    grad = jax.grad(lambda x: jnp.sum(pmapped(x, w)[0]))(x)
    return (np.moveaxis(np.asarray(out), -1, 2), np.moveaxis(np.asarray(grad), -1, 2),
            np.asarray(stats["mean"]), np.asarray(stats["var"]))


@pytest.mark.parametrize("case", ["random", "constant"])
@pytest.mark.parametrize("sync", ["global", "local"])
def test_synced_batchnorm_matches_flax_axis_name(ranks, sync, case):
    inputs, results = ranks
    out, grad, mean, var = _flax_bn(inputs, case, LOCAL_GROUPS if sync == "local" else None)
    for r, res in enumerate(results):
        y, dx, running_mean, running_var = res["batch_norm"][(sync, case)]
        np.testing.assert_allclose(_np(y), out[r], err_msg=f"rank {r} output", **TOL)
        np.testing.assert_allclose(_np(dx), grad[r], err_msg=f"rank {r} dx", **TOL)
        np.testing.assert_allclose(_np(running_mean), mean[r], **TOL)
        np.testing.assert_allclose(_np(running_var), var[r], **TOL)
    if case == "constant":
        # Rank r's input is r: the group means and the running means 0.1 x them.
        expected = [1.5 / 10] * 4 if sync == "global" else [0.05, 0.05, 0.25, 0.25]
        got = [float(res["batch_norm"][(sync, case)][2][0]) for res in results]
        np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_set_sync_group_reaches_every_batchnorm_and_survives_a_copy():
    import copy

    from pytorchvideo_tpu_torch.layers import BatchNorm, set_sync_group
    from pytorchvideo_tpu_torch.models.x3d import create_x3d

    model = create_x3d(input_clip_length=2, input_crop_size=32, model_num_class=5,
                       stem_dim_in=8, depth_factor=0.1, device="cpu")
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    group = object()  # stands for a ProcessGroup, which cannot be copied
    assert set_sync_group(model, group) == len(norms) > 0
    copied = copy.deepcopy(model)
    assert all(m.process_group is group for m in copied.modules() if isinstance(m, BatchNorm))
    assert set_sync_group(copied, None) == len(norms)
    assert all(m.process_group is group for m in norms)
    assert "process_group" not in str(list(model.state_dict()))


# --- NT-Xent and SimCLR -------------------------------------------------------

def _summed_loss_grads(f, *args):
    """Each device's loss, and the gradients of their sum (one jit)."""
    summed = jax.value_and_grad(lambda *a: (lambda l: (jnp.sum(l), l))(f(*a)),
                                argnums=tuple(range(len(args))), has_aux=True)
    (_, values), grads = jax.jit(summed)(*args)
    return np.asarray(values), grads


def test_ntxent_over_a_group_matches_jax_axis_name(ranks):
    inputs, results = ranks
    mesh = Mesh(_devices(), ("d",))
    f = shard_map(lambda a, b: jax_losses.ntxent_loss(a, b, TEMPERATURE, axis_name="d")[None],
                  mesh=mesh, in_specs=(P("d"), P("d")), out_specs=P("d"))
    z1, z2 = (jnp.asarray(inputs[k].reshape(WORLD * 3, 8)) for k in ("z1", "z2"))
    losses, (g1, g2) = _summed_loss_grads(f, z1, z2)
    for r, res in enumerate(results):
        loss, d1, d2 = res["ntxent"]["ntxent"]
        np.testing.assert_allclose(_np(loss), losses[r], **TOL)
        rows = slice(r * 3, (r + 1) * 3)
        np.testing.assert_allclose(_np(d1), np.asarray(g1[rows]), **TOL)
        np.testing.assert_allclose(_np(d2), np.asarray(g2[rows]), **TOL)
    # The gathered negatives matter: rank 0's loss differs from its local one.
    local = ntxent_loss(torch.from_numpy(inputs["z1"][0]), torch.from_numpy(inputs["z2"][0]),
                        TEMPERATURE)
    assert abs(local.item() - losses[0]) > 1e-3


def test_simclr_loss_over_a_group_matches_jax_axis_name(ranks):
    inputs, results = ranks
    jax_simclr, state = _simclr()
    mesh = Mesh(_devices(), ("d",))
    f = shard_map(lambda s, a, b: jax_simclr.loss(s, a, b, train=False, axis_name="d")[None],
                  mesh=mesh, in_specs=(P(), P("d"), P("d")), out_specs=P("d"))
    x1, x2 = (jnp.asarray(inputs[k].reshape(WORLD * 3, MLP_DIMS[0])) for k in ("x1", "x2"))
    losses, (gs, g1, g2) = _summed_loss_grads(f, state, x1, x2)
    ref_params = jax_ssl_state_to_state_dict(jax.tree_util.tree_map(np.asarray, gs))
    for r, res in enumerate(results):
        loss, d1, d2, _ = res["ntxent"]["simclr"]
        np.testing.assert_allclose(_np(loss), losses[r], **TOL)
        rows = slice(r * 3, (r + 1) * 3)
        np.testing.assert_allclose(_np(d1), np.asarray(g1[rows]), **TOL)
        np.testing.assert_allclose(_np(d2), np.asarray(g2[rows]), **TOL)
    summed = {n: sum(res["ntxent"]["simclr"][3][n] for res in results)
              for n in results[0]["ntxent"]["simclr"][3]}
    assert summed
    for n, g in summed.items():
        np.testing.assert_allclose(_np(g), ref_params[n].numpy(), err_msg=n, **TOL)
    # Without a group the module's loss is the JAX one's over a device's batch.
    simclr = SimCLR(MultilayerPerceptron(MLP_DIMS, final_activation=None, device="cpu"),
                    temperature=TEMPERATURE)
    simclr.load_state_dict(inputs["simclr_state"], strict=True)
    one = simclr.loss(torch.from_numpy(inputs["x1"][0]), torch.from_numpy(inputs["x2"][0]))
    ref = jax_simclr.loss(state, jnp.asarray(inputs["x1"][0]), jnp.asarray(inputs["x2"][0]),
                          train=False)
    np.testing.assert_allclose(_np(one), np.asarray(ref), **TOL)


# --- sequence parallelism -----------------------------------------------------

@pytest.mark.parametrize("residual_pool", [False, True])
@pytest.mark.parametrize("kv_sharded", [False, True])
def test_sequence_parallel_attention_matches_jax(ranks, kv_sharded, residual_pool):
    inputs, results = ranks
    q, k, v, heads, scale = (jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t
                             for t in inputs["attention"])
    mesh = Mesh(_devices(), ("model",))

    def attend(q, k, v):
        return jax_sequence_attention(q, k, v, heads, scale, residual_pool, mesh=mesh,
                                      kv_sharded=kv_sharded)

    out = jax.jit(attend)(q, k, v)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(pooled_attention_packed_xla(q, k, v, heads, scale,
                                                                residual_pool)), **ATTENTION_TOL)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(attend(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
    rows = q.shape[1] // WORLD
    for r, res in enumerate(results):
        y, *_ = res["sequence"][(kv_sharded, residual_pool)]
        np.testing.assert_allclose(_np(y), np.asarray(out[:, r * rows:(r + 1) * rows]),
                                   **ATTENTION_TOL)
    # Each rank's gradients are those of its own loss; summed over the ranks
    # they are the gradients of the whole output's.
    for i, ref in enumerate(grads):
        got = sum(res["sequence"][(kv_sharded, residual_pool)][1 + i] for res in results)
        np.testing.assert_allclose(_np(got), np.asarray(ref), **ATTENTION_TOL)
    if kv_sharded:
        # k's and v's gradients land on each rank's own rows.
        lk = k.shape[1] // WORLD
        for r, res in enumerate(results):
            for t in res["sequence"][(kv_sharded, residual_pool)][2:]:
                outside = torch.cat([t[:, :r * lk], t[:, (r + 1) * lk:]], dim=1)
                assert torch.count_nonzero(outside) == 0


def test_sequence_parallel_attention_refuses_an_indivisible_sequence(ranks):
    inputs, results = ranks
    q, k, v, heads, scale = (jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t
                             for t in inputs["attention"])
    mesh = Mesh(_devices(), ("model",))
    for kv_sharded, (lq, lk) in ((False, (q.shape[1] - 2, k.shape[1])),
                                 (True, (q.shape[1], k.shape[1] - 2))):
        with pytest.raises(ValueError):
            jax_sequence_attention(q[:, :lq], k[:, :lk], v[:, :lk], heads, scale, mesh=mesh,
                                   kv_sharded=kv_sharded)
    for res in results:
        assert all(e is not None and "must divide" in e for e in res["sequence"]["errors"])


# --- the batch layout (no process group) --------------------------------------

@pytest.mark.parametrize("batch,parts,micro", [(8, 4, 1), (16, 4, 2), (24, 2, 3), (12, 3, 1)])
def test_mirrored_rows_pair_each_row_with_its_global_flip(batch, parts, micro):
    shares = [batch_rows(batch, parts, r, micro, mirrored=True) for r in range(parts)]
    assert sorted(torch.cat(shares).tolist()) == list(range(batch))
    per_micro = batch // micro
    for rows in shares:
        # The local flip pairs row i with row batch - 1 - i ...
        assert (rows.flip(0) == batch - 1 - rows).all()
        # ... and the local chunks are the rank's rows of each microbatch.
        for k, chunk in enumerate(rows.chunk(micro)):
            assert ((chunk >= k * per_micro) & (chunk < (k + 1) * per_micro)).all()
    plain = [batch_rows(batch, parts, r, micro) for r in range(parts)]
    assert sorted(torch.cat(plain).tolist()) == list(range(batch))
    with pytest.raises(ValueError):
        batch_rows(batch + 1, parts, 0, micro)
