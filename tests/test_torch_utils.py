"""The port's utils/flops.py and utils/profiling.py against the JAX
package's: parameter counts equal to JAX's ``count_params`` (exact), FLOPs of
a product, a conv and a small X3D beside XLA's cost model; ``time_jitted``
and ``time_stateful`` on the host clock, their noise floor raising;
``trace`` writing a Chrome trace that holds an ``annotate`` range."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.utils.flops import count_params as jax_count_params
from pytorchvideo_tpu.utils.flops import flops_of as jax_flops_of
from pytorchvideo_tpu_torch import utils
from pytorchvideo_tpu_torch.utils import flops, profiling
from torch_port_helpers import build_pair, small_mvit_pair

SMALL_X3D = dict(input_clip_length=4, input_crop_size=32, width_factor=1.0, depth_factor=0.5,
                 model_num_class=10)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_matmul_flops_equal_xla_s():
    a, b = np.ones((64, 32), np.float32), np.ones((32, 16), np.float32)
    ours = flops.flops_of(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    assert ours == jax_flops_of(lambda a, b: a @ b, a, b) == 2 * 64 * 32 * 16


def test_conv_flops_count_every_tap_where_xla_skips_the_padding():
    x, w = torch.ones(2, 6, 4, 8, 8), torch.ones(10, 6, 3, 3, 3)
    ours = flops.flops_of(lambda x, w: F.conv3d(x, w, padding=1), x, w)
    assert ours == 2 * (2 * 10 * 4 * 8 * 8) * (6 * 27)  # 2 per MAC, every output, every tap

    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1, 1), [(1, 1)] * 3,
                                            dimension_numbers=("NTHWC", "THWIO", "NTHWC"))

    xla = jax_flops_of(conv, np.ones((2, 4, 8, 8, 6), np.float32),
                       np.ones((3, 3, 3, 6, 10), np.float32))
    # XLA counts only the taps that land inside the clip (1161600 here).
    assert xla == 2 * 2 * 10 * 6 * (10 * 22 * 22)  # valid taps per axis: T 10, H and W 22
    assert xla < ours


def test_small_x3d_params_equal_jax_s_and_flops_near_xla_s():
    jax_model, variables, model, _ = build_pair(**SMALL_X3D)
    assert flops.count_params(model) == jax_count_params(variables)
    assert flops.count_params(model.state_dict()) == jax_count_params(variables)
    ours = flops.model_complexity(model, (3, 4, 32, 32))
    assert ours["params_m"] == jax_count_params(variables) / 1e6
    # JAX's model_complexity without its eager init (the forward's cost on
    # the same variables): XLA's count takes elementwise ops in and the conv
    # padding's taps out; port / JAX GFLOPs is 0.9475 on this model.
    xla = jax_flops_of(lambda v, x: jax_model.apply(v, x, False), variables,
                       jnp.zeros((1, 4, 32, 32, 3)))
    assert 0.9 < ours["gflops"] * 1e9 / xla < 1.0
    assert not model.training  # the count runs on a copy


def test_model_complexity_of_an_mvit_and_a_pathway_list():
    _, variables, model, _ = small_mvit_pair()
    out = flops.model_complexity(model, (3, 4, 32, 32))
    assert out["params_m"] * 1e6 == pytest.approx(jax_count_params(variables))
    assert out["gflops"] > 0

    class TwoPaths(nn.Module):
        def forward(self, x):
            return torch.cat([p.flatten(1) @ torch.ones(p[0].numel(), 2) for p in x], 1)

    two = flops.model_complexity(TwoPaths(), [(3, 2, 4, 4), (3, 4, 4, 4)])
    assert two["gflops"] * 1e9 == 2 * 2 * (96 + 192)


def test_time_jitted_and_time_stateful_on_the_host_clock():
    a = torch.randn(96, 96)
    seconds = utils.time_jitted(torch.mm, a, a, iters=20, trials=2)
    assert 0 < seconds < 1

    def step(state, x):
        return state + x, state.sum()

    assert 0 < profiling.time_stateful(step, torch.zeros(64, 64), torch.ones(64, 64),
                                       iters=10, trials=2) < 1


def test_time_jitted_raises_below_the_noise_floor(monkeypatch):
    monkeypatch.setattr(profiling, "_run_seconds", lambda run, n, on_card: 1.0)
    with pytest.raises(RuntimeError, match="noise"):
        utils.time_jitted(lambda: None)


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    a = torch.randn(32, 32)
    with utils.trace(str(tmp_path / "log")):
        with utils.annotate("port_matmul"):
            torch.mm(a, a)
    path = tmp_path / "log" / profiling.TRACE_FILE
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "port_matmul" in names and "aten::mm" in names
