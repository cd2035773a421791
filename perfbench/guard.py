"""The guard against JAX: the modules of JAX, its libraries and the JAX
package that the process holds, compared by whole top-level name (the
part before the first dot), so ``lp_gnn_tpu_torch`` is not
``lp_gnn_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "lp_gnn_tpu"})


def jax_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
