"""Build and load the native decode library (``native/decode.cc`` and
``native/pipeline.cc``: FFmpeg decode, the A/V muxer and the decode worker
pool, behind a plain C interface) at first use.

The sources are compiled as they stand with ``g++`` and the flags of
``native/Makefile``, linked against the FFmpeg libraries ``pkg-config``
names, into ``build/pytorchvideo_tpu_torch/`` at the root of the checkout;
nothing is written into ``native/``. The library's file name carries a hash
of both sources and of the flags, so an edited source is rebuilt. The build
goes to a temporary file that is renamed into place, so processes that build
at once do not read a half-written library. ``$PVT_DECODE_LIB`` names a
library built elsewhere, which is then loaded as it is.

A missing ``g++``, a missing ``pkg-config`` entry or a failed build raises
``RuntimeError``: there is no fallback decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

from pytorchvideo_tpu_torch.ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("decode.cc", "pipeline.cc")
FFMPEG_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
ENV_LIBRARY = "PVT_DECODE_LIB"


def missing_tools() -> List[str]:
    """What the build needs and this machine lacks: ``g++``, ``pkg-config``
    and each FFmpeg development package, by name; empty when all are there."""
    missing = [tool for tool in ("g++", "pkg-config") if shutil.which(tool) is None]
    if "pkg-config" in missing:
        return missing + list(FFMPEG_PACKAGES)
    return missing + [pkg for pkg in FFMPEG_PACKAGES
                      if subprocess.run(["pkg-config", "--exists", pkg]).returncode != 0]


def _ffmpeg_flags() -> List[str]:
    out = subprocess.run(["pkg-config", "--cflags", "--libs", *FFMPEG_PACKAGES],
                         capture_output=True, text=True, check=True).stdout
    return out.split()


def library_path(ffmpeg_flags: Optional[List[str]] = None) -> Path:
    """Where the library for the current sources and flags is built."""
    flags = list(CXX_FLAGS) + list(ffmpeg_flags if ffmpeg_flags is not None else _ffmpeg_flags())
    digest = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libpvt_decode_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The path of a built library: ``$PVT_DECODE_LIB`` where it names a
    file, else the library for the current sources, compiled unless it
    exists. Raises ``RuntimeError`` naming what is missing, or with the
    compiler's output."""
    override = os.environ.get(ENV_LIBRARY, "")
    if override and os.path.exists(override):
        return Path(override)
    missing = missing_tools()
    if missing:
        raise RuntimeError(
            "the native decoder cannot be built: missing " + ", ".join(missing)
            + " (it needs g++ and FFmpeg's development libraries through pkg-config)")
    flags = _ffmpeg_flags()
    so_path = library_path(flags)
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp_so = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp_so, *(str(NATIVE_DIR / s) for s in SOURCES), *flags,
           "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_so, so_path)
    finally:
        if os.path.exists(tmp_so):
            os.unlink(tmp_so)
    return so_path


def native_available() -> bool:
    """Whether the library can be had (built or buildable), without raising."""
    try:
        build_library()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return False
    return True


def load_raw() -> ctypes.CDLL:
    """The library, built if needed and opened, with no entry point typed."""
    return ctypes.CDLL(str(build_library()))
