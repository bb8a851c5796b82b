"""Shared helpers for the tests that hold pytorchvideo_tpu_torch against the
JAX package: seeded numpy weights in the JAX layout, the JAX forward, and the
port model (X3D or MViT) loaded with the same weights."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.models import create_multiscale_vision_transformers as jax_create_mvit
from pytorchvideo_tpu.models.x3d import create_x3d as jax_create_x3d
from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
from pytorchvideo_tpu_torch.models.x3d import create_x3d as torch_create_x3d
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict

# f32 logits tolerance of the JAX package's model parity tests
# (tests/test_models_parity.py:24).
TOL = dict(rtol=5e-3, atol=5e-4)


def random_variables(shapes, seed):
    """Numpy variables for an abstract JAX variables tree: He-normal kernels,
    small biases, BN affine and running stats drawn away from the identity
    (gamma in [0.5, 1.5], so no residual branch is zeroed)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, size=shape)
        else:  # bias, mean
            v = rng.normal(size=shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def build_pair(seed=0, batch=2, **kwargs):
    """The JAX and port X3D of ``kwargs`` with the same random weights.

    Returns (jax_model, variables, torch_model, x) where x is a seeded NCTHW
    numpy batch of the model's clip size."""
    kwargs.setdefault("dropout_rate", 0.0)
    T, S = kwargs["input_clip_length"], kwargs["input_crop_size"]
    jax_model = jax_create_x3d(**kwargs)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, T, S, S, 3), jnp.float32), False
        )
    )
    variables = random_variables(shapes, seed)
    torch_model = torch_create_x3d(**kwargs, device="cpu")
    torch_model.load_state_dict(
        jax_variables_to_state_dict(variables["params"], variables["batch_stats"]),
        strict=True,
    )
    x = np.random.default_rng(seed + 1).normal(size=(batch, 3, T, S, S)).astype(np.float32)
    return jax_model, variables, torch_model.eval(), x


def jax_logits(jax_model, variables, x_ncthw):
    fwd = jax.jit(lambda v, x: jax_model.apply(v, x, False))
    return np.asarray(fwd(variables, jnp.asarray(np.moveaxis(x_ncthw, 1, -1))))


def torch_logits(model, x_ncthw, dtype=torch.float32):
    with torch.no_grad():
        return model(torch.from_numpy(x_ncthw).to(dtype)).float().numpy()


# A small MViT: 3 blocks, 2 heads (4 from block 1), a q pool and a width
# change at block 1, adaptive kv pools, 4x32x32 clips (tokens (2, 8, 8)).
SMALL_MVIT = dict(
    spatial_size=32,
    temporal_size=4,
    depth=3,
    num_heads=2,
    patch_embed_dim=32,
    embed_dim_mul=[[2, 2.0]],
    atten_head_mul=[[1, 2.0]],
    pool_q_stride_size=[[1, 1, 2, 2]],
    pool_kv_stride_adaptive=[1, 2, 2],
    pool_kvq_kernel=[3, 3, 3],
    head_num_classes=7,
)


def init_variables(module, *inputs, seed):
    """Seeded numpy variables for ``module`` (a flax module) at ``inputs``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    return random_variables(shapes, seed)


def load_jax_variables(module, variables):
    """Loads JAX ``variables`` (no batch stats) into a port module, in eval mode."""
    module.load_state_dict(jax_variables_to_state_dict(variables["params"], {}), strict=True)
    return module.eval()


def build_mvit_pair(jax_builder, torch_builder, seed=0, batch=2, **kwargs):
    """The JAX and port MViT of ``kwargs`` with the same random weights
    (nonzero cls and position embeddings, LN gammas in [0.5, 1.5]).

    Returns (jax_model, variables, torch_model, x) with x a seeded NCTHW
    numpy batch of the model's clip size."""
    T, S = kwargs["temporal_size"], kwargs["spatial_size"]
    jax_model = jax_builder(**kwargs)
    variables = init_variables(jax_model, jnp.zeros((1, T, S, S, 3), jnp.float32), False, seed=seed)
    torch_model = load_jax_variables(torch_builder(**kwargs, device="cpu"), variables)
    x = np.random.default_rng(seed + 1).normal(size=(batch, 3, T, S, S)).astype(np.float32)
    return jax_model, variables, torch_model, x


def small_mvit_pair(seed=0, batch=2, **variant):
    return build_mvit_pair(jax_create_mvit, create_multiscale_vision_transformers, seed, batch,
                           **{**SMALL_MVIT, **variant})


def assert_same_sample(ours, theirs, where="sample"):
    """A port sample (tensors) equal to a JAX package sample (numpy) exactly:
    dict keys in the same order, a tensor's values and shape those of the
    array (a uint8 clip against the JAX package's float32 [0, 255] one),
    lists element by element, dataclass rows field by field, anything else
    by ``==``."""
    import dataclasses

    if isinstance(ours, dict):
        assert isinstance(theirs, dict) and list(ours) == list(theirs), (where, list(ours),
                                                                         list(theirs))
        for key in ours:
            assert_same_sample(ours[key], theirs[key], f"{where}[{key!r}]")
    elif isinstance(ours, torch.Tensor):
        assert isinstance(theirs, np.ndarray), (where, type(theirs))
        assert tuple(ours.shape) == theirs.shape, (where, tuple(ours.shape), theirs.shape)
        np.testing.assert_array_equal(ours.cpu().numpy(), theirs, err_msg=where)
    elif isinstance(ours, (list, tuple)):
        assert len(ours) == len(theirs), (where, len(ours), len(theirs))
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_sample(a, b, f"{where}[{i}]")
    elif dataclasses.is_dataclass(ours):
        assert type(ours).__name__ == type(theirs).__name__, where
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), where
    else:
        assert ours == theirs, (where, ours, theirs)
