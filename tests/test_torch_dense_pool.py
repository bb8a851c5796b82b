"""The non-depthwise pool conv (``depthwise_conv=False``) of
pytorchvideo_tpu_torch/layers/attention.py against the JAX package's, in
f32: the ``TokenPool`` alone, a (c, c, 3, 3, 3) conv shared across heads, on
head-packed tokens (the JAX package's grouped conv, one group per head) and
on per-head grids (``pool_first``'s, one group), its output and input
gradient at rtol 1e-4 / atol 1e-5, its weight's gradient (a sum over every
output position) at the model parity tolerance; and a ``MultiScaleBlock`` with such q and kv pools, with and without a cls
token, at the model parity tolerance (rtol 5e-3 / atol 5e-4,
tests/test_models_parity.py:24; the block sums hundreds of products more
than the pool, in another order than XLA's): the output, the input's
gradient and every parameter's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.layers.attention import MultiScaleBlock as JaxMultiScaleBlock
from pytorchvideo_tpu.layers.attention import TokenPool as JaxTokenPool
from pytorchvideo_tpu_torch.layers.attention import MultiScaleBlock, TokenPool
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, init_variables

DENSE_TOL = dict(rtol=1e-4, atol=1e-5)
# (pool_first, has_cls)
CASES = [(False, True), (False, False), (True, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per_head"])
def test_dense_token_pool_matches_jax(packed):
    heads, c, thw = 2, 16, (2, 8, 8)
    rng = np.random.default_rng(9)
    if packed:  # (cls, grid (B, L, H*c))
        x = (rng.normal(size=(2, 1, heads * c)).astype(np.float32),
             rng.normal(size=(2, 2 * 8 * 8, heads * c)).astype(np.float32))
        jax_x = tuple(jnp.asarray(t) for t in x)
    else:  # (B, H, 1 + L, c)
        x = rng.normal(size=(2, heads, 1 + 2 * 8 * 8, c)).astype(np.float32)
        jax_x = jnp.asarray(x)
    jax_pool = JaxTokenPool(pool_mode="conv", kernel=(3, 3, 3), stride=(1, 2, 2),
                            depthwise_conv=False, head_groups=heads if packed else 1)
    variables = init_variables(jax_pool, jax_x, thw, False, seed=10)

    def jax_loss(params, xx):
        out, _ = jax_pool.apply({"params": params}, xx, thw, False)
        out = jnp.concatenate(out, axis=1) if packed else out
        return jnp.sum(out * jnp.cos(out)), out

    (_, ref), (ref_grads, ref_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jax_x)
    pool = TokenPool("conv", (3, 3, 3), (1, 2, 2), c, depthwise=False)
    pool.weight.data.copy_(jax_variables_to_state_dict(variables["params"], {})["pool.weight"])
    xt = (tuple(torch.from_numpy(t).requires_grad_() for t in x) if packed
          else torch.from_numpy(x).requires_grad_())
    out, thw_out = pool(xt, thw)
    assert thw_out == (2, 4, 4)
    out = torch.cat(out, dim=1) if packed else out
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **DENSE_TOL)
    (out * torch.cos(out)).sum().backward()
    for got, want in zip(xt if packed else (xt,), ref_dx if packed else (ref_dx,)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **DENSE_TOL)
    # The weight's gradient sums every output position of every head and
    # row: at the model parity tolerance.
    weight_grad = np.transpose(np.asarray(ref_grads["pool"]["kernel"]), (4, 3, 0, 1, 2))
    np.testing.assert_allclose(pool.weight.grad.numpy(), weight_grad, **TOL)


@pytest.mark.parametrize("pool_first, has_cls", CASES, ids=["packed_cls", "packed", "pool_first"])
def test_dense_pool_block_matches_jax(pool_first, has_cls):
    kw = dict(dim=32, dim_out=32, num_heads=2, stride_q=(1, 2, 2), stride_kv=(1, 2, 2),
              kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), residual_pool=True, depthwise_conv=False,
              pool_first=pool_first, has_cls_embed=has_cls)
    thw = (2, 8, 8)
    x = np.random.default_rng(7).normal(size=(2, has_cls + 2 * 8 * 8, 32)).astype(np.float32)
    jax_block = JaxMultiScaleBlock(**kw)
    variables = init_variables(jax_block, jnp.asarray(x), thw, False, seed=8)
    assert variables["params"]["attn"]["pool_k"]["pool"]["kernel"].shape == (3, 3, 3, 16, 16)

    def jax_loss(params, xx):
        out, _ = jax_block.apply({"params": params}, xx, thw, False)
        return jnp.sum(out * jnp.cos(out)), out

    (_, ref), (ref_grads, ref_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    block = MultiScaleBlock(**kw)
    block.load_state_dict(jax_variables_to_state_dict(variables["params"], {}), strict=True)
    assert block.attn.pool_k.weight.shape == (16, 16, 3, 3, 3)
    xt = torch.from_numpy(x).requires_grad_()
    (cls_out, grid_out), thw_out = block.eval()((xt[:, :1] if has_cls else None,
                                                 xt[:, has_cls:]), thw)
    assert thw_out == (2, 4, 4)
    out = grid_out if cls_out is None else torch.cat([cls_out, grid_out], dim=1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out * torch.cos(out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **TOL)
    ref_named = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), {})
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_named[name].numpy(), err_msg=name, **TOL)
