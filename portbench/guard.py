"""The import guard: no module of JAX or of the JAX package ``repro`` may
be loaded in a run.  Names are compared by their top-level part (before
the first dot) whole, so ``repro_torch`` passes and ``repro`` does not."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def foreign(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
