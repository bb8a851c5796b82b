"""Path openers by URI scheme (counterpart of pytorchvideo_tpu/data/io.py,
upstream's iopath ``g_pathmgr`` role): local paths go straight to the
decoder; a path of a registered scheme (``s3://``, ``gs://``, ...) is read
to bytes by its opener.

    from pytorchvideo_tpu_torch.data.io import register_path_opener
    register_path_opener("s3", lambda path: my_s3_client.get_bytes(path))
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

# scheme (without "://") -> fn(full_path) -> bytes
_PATH_OPENERS: Dict[str, Callable[[str], bytes]] = {}


def register_path_opener(scheme: str, opener: Callable[[str], bytes]) -> None:
    """Register a byte reader for a URI scheme (e.g. "s3", "gs", "http")."""
    _PATH_OPENERS[scheme.rstrip(":/")] = opener


def path_scheme(path: str) -> Optional[str]:
    """The URI scheme of ``path``, or None for a plain path."""
    path = str(path)
    idx = path.find("://")
    if idx <= 0:
        return None
    return path[:idx]


def is_local_path(path: str) -> bool:
    scheme = path_scheme(path)
    return scheme is None or scheme == "file"


def local_path(path: str) -> str:
    """``path`` without a ``file://`` prefix."""
    path = str(path)
    return path[len("file://"):] if path.startswith("file://") else path


def read_bytes(path: str) -> bytes:
    """The whole file: from the local file system, or through the opener
    registered for the path's scheme."""
    scheme = path_scheme(path)
    if scheme is None or scheme == "file":
        with open(local_path(path), "rb") as f:
            return f.read()
    opener = _PATH_OPENERS.get(scheme)
    if opener is None:
        raise ValueError(f"no path opener registered for scheme {scheme!r} "
                         f"(register_path_opener({scheme!r}, fn))")
    return opener(str(path))


def exists(path: str) -> bool:
    """Whether a local path exists; a remote one is assumed to (its opener
    raises on the read if not)."""
    if is_local_path(path):
        return os.path.exists(local_path(path))
    return True
