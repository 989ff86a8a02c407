"""The isolation check: no JAX, and nothing of the JAX package, in a process.

Module names are compared by their top-level part (before the first dot)
whole, since the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "zonos_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})
