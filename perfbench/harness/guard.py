"""What the process that prints a result may not hold: JAX, or the JAX
package this port was made from. Module names are compared by their
top-level name, whole: ``pytorchvideo_tpu_torch`` (the port) begins with
``pytorchvideo_tpu`` (the JAX package) and is allowed."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Set

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorchvideo_tpu")
PROGRAM = "pytorchvideo_tpu_torch"


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def loaded_forbidden() -> List[str]:
    """The modules in ``sys.modules`` whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if top_level(m) in FORBIDDEN)


def imported_top_levels(path: Path) -> Set[str]:
    """The top-level names that the Python file at ``path`` imports
    (absolute imports only; a relative import names no top level)."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top_level(node.module))
    return names
