"""Which modules a run may not load: JAX and the JAX package, compared by
their whole top-level name (the part before the first dot), so that the
port, whose name begins with the JAX package's, passes."""

from __future__ import annotations

import ast
import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "e2e_asr_pytorch_tpu")
PORT = "e2e_asr_pytorch_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (``sys.modules`` unless given) whose top-level
    name is a forbidden one."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if top_level(n) in FORBIDDEN})


def quiet_libraries():
    """Keep libraries that would load JAX on their own from doing so."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_JAX", "0")


def imported_names(path: Path) -> List[str]:
    """The modules a source file imports (``import a.b`` and ``from a.b
    import c`` give ``a.b``), read with ``ast``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.append(node.module)
    return out


def reference_imports_of(directory: Path, banned=FORBIDDEN + (PORT,)):
    """(file, module) for every import under ``directory`` whose top-level
    name is banned: the plain reference imports neither JAX, the JAX
    package nor the port."""
    bad = []
    for path in sorted(directory.rglob("*.py")):
        for name in imported_names(path):
            if top_level(name) in banned:
                bad.append((str(path), name))
    return bad
