"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper), one
process per source, all at once, and linked into one shared library with a
plain C interface, bound with ``ctypes``. The build
runs at first use and lands in ``build/pytorchvideo_tpu_torch/`` at the root of
the checkout; the library's file name carries a hash of the flags and of
every file under ``csrc/`` (the sources and the headers they include, such
as ``hopper_tiles.cuh``), so an edited source or header is rebuilt. A missing ``nvcc`` or a failed build raises:
there is no fallback.

The program's counters (utils/profiling.py) count ``kernels.builds`` (nvcc
ran) and ``kernels.loads``; the span ``pvt.setup.kernels`` covers the
build and the load.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from pytorchvideo_tpu_torch.utils.profiling import annotate, count

DEFAULT_CUDA_HOME = "/usr/local/cuda"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pytorchvideo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``DEFAULT_CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME/bin, {DEFAULT_CUDA_HOME}/bin): the "
        "CUDA kernels of pytorchvideo_tpu_torch cannot be built"
    )


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources, headers and flags is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(p for p in CSRC_DIR.iterdir() if p.is_file()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpvt_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _check(proc: subprocess.Popen, cmd) -> None:
    output = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}")


def build_library() -> Path:
    """Compile the sources unless a library for them already exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    so_path = library_path()
    if so_path.is_file():
        return so_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects, compiles = [], []
        for src in _sources():
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objects.append(obj)
            compiles.append((_run(cmd), cmd))
        try:
            for proc, cmd in compiles:
                _check(proc, cmd)
        finally:
            for proc, _ in compiles:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_so = os.path.join(tmp_dir, so_path.name)
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp_so, *objects]
        _check(_run(cmd), cmd)
        os.replace(tmp_so, so_path)
    count("kernels.builds")
    return so_path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point typed.

    Pointers and the stream are ``c_void_p``: without ``argtypes`` ctypes
    would pass them as 32-bit ints and cut them."""
    with annotate("pvt.setup.kernels"):
        lib = ctypes.CDLL(str(build_library()))
    count("kernels.loads")
    fn = lib.pvt_depthwise3x3x3_bn_swish
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_token_pool
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention_tc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention_split
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention_bwd_tc
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_pooled_attention_bwd_split
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_token_pool_dx
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.pvt_token_pool_dw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    # The tiled token-pool routes: one int array (the geometry, then the
    # plan) that the caller caches per call signature.
    ints = ctypes.POINTER(ctypes.c_int32)
    for name, pointers in (("pvt_token_pool_tiled", 3), ("pvt_token_pool_dx_tiled", 3),
                           ("pvt_token_pool_dw_tiled", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ints, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # The tiled depthwise conv takes the token pool's int array too.
    fn = lib.pvt_depthwise3x3x3_tiled
    fn.argtypes = [ctypes.c_void_p] * 5 + [ints, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.pvt_fused_kvpool_ln
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    # The tiled pool-LN takes the token pool's int array, its plan from
    # pool_ln_tile_plan.
    fn = lib.pvt_fused_kvpool_ln_tiled
    fn.argtypes = [ctypes.c_void_p] * 10 + [ints, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
