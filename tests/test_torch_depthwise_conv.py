"""pytorchvideo_tpu_torch.ops.depthwise_conv against the JAX package's
depthwise3x3x3_bn_swish (Pallas kernel in interpret mode, and its XLA form),
plus the CUDA wrapper's checks and build plumbing that run without a card.
The kernel itself is tested on the card by tests/test_torch_kernels_cuda.py."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchvideo_tpu.ops.depthwise_conv import (
    depthwise3x3x3_bn_swish_pallas,
    depthwise3x3x3_bn_swish_xla,
)
from pytorchvideo_tpu_torch.ops import _build
from pytorchvideo_tpu_torch.ops.depthwise_conv import (
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
)

def _inputs(C, affine, seed=0, B=2, T=4, S=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, S, S, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, C)) * 0.2).astype(np.float32)
    s = rng.uniform(0.5, 1.5, C).astype(np.float32) if affine else None
    b = (rng.normal(size=C) * 0.1).astype(np.float32) if affine else None
    return x, w, s, b


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("C", [5, 54])
@pytest.mark.parametrize("apply_swish", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_depthwise_matches_jax(C, apply_swish, affine):
    # Same atol as tests/test_ops_depthwise_conv.py (f32, 27-tap sums of O(1)).
    x, w, s, b = _inputs(C, affine)
    out = depthwise3x3x3_bn_swish(_torch(x), _torch(w), _torch(s), _torch(b), apply_swish)
    assert out.shape == x.shape and out.dtype == torch.float32
    args = (jnp.asarray(x), jnp.asarray(w), _jnp(s), _jnp(b), apply_swish)
    pallas = depthwise3x3x3_bn_swish_pallas(*args, interpret=True)
    xla = depthwise3x3x3_bn_swish_xla(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=2e-5)


def test_depthwise_borders_are_zero_padded():
    # A single 1 at a corner: the output is the tap pattern cut at the border.
    x = torch.zeros(1, 2, 3, 3, 1)
    x[0, 0, 0, 0, 0] = 1.0
    w = torch.arange(27, dtype=torch.float32).reshape(3, 3, 3, 1)
    out = depthwise3x3x3_bn_swish(x, w)
    # out[t, h, w] = x[0,0,0] * w[1 - t, 1 - h, 1 - w] where that tap exists.
    expect = torch.zeros(2, 3, 3)
    for t in range(2):
        for h in range(2):
            for ww in range(2):
                expect[t, h, ww] = w[1 - t, 1 - h, 1 - ww, 0]
    torch.testing.assert_close(out[0, ..., 0], expect)


@pytest.mark.parametrize(
    "kwargs, message",
    [
        (dict(), "CUDA tensor"),
        (dict(x_shape=(2, 3, 4, 4)), r"\(B, T, H, W, C\)"),
        (dict(dtype=torch.float64), "float32 or bfloat16"),
    ],
)
def test_cuda_wrapper_rejects_bad_inputs(kwargs, message):
    x = torch.zeros(kwargs.get("x_shape", (1, 2, 3, 3, 4)), dtype=kwargs.get("dtype", torch.float32))
    with pytest.raises(ValueError, match=message):
        depthwise3x3x3_bn_swish_cuda(x, torch.zeros(3, 3, 3, 4))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc stand-in: writes its -o file, or fails on one source."""
    nvcc = tmp_path / "nvcc"
    fail = ""
    if fail_on:
        fail = f'case "$*" in *{fail_on}*) echo "error in {fail_on}"; exit 2;; esac\n'
    nvcc.write_text(
        "#!/bin/sh\n" + fail
        + 'args="$*"\n'
        + 'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then echo "$args" > "$2"; fi; shift; done\n'
    )
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    # The sources get a directory of their own: the library's hash covers
    # every file there, and the nvcc stand-in lives beside it.
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    so = _build.build_library()
    assert so == _build.library_path() and so.is_file()
    # The link step takes one object per source.
    link_args = so.read_text()
    assert "-shared" in link_args and "a.o" in link_args and "b.o" in link_args
    assert [p.name for p in (tmp_path / "build").iterdir()] == [so.name]

    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path, fail_on="b.cu"))
    (csrc / "b.cu").write_text("// b, edited\n")
    with pytest.raises(RuntimeError, match="error in b.cu"):
        _build.build_library()
    assert not _build.library_path().exists()


def test_library_path_follows_source_hash(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_path_follows_header_hash(monkeypatch, tmp_path):
    # A header the sources include is hashed too: an edited one is rebuilt.
    (tmp_path / "k.cu").write_text('#include "tiles.cuh"\n')
    header = tmp_path / "tiles.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    header.write_text("// two\n")
    assert _build.library_path() != first
