"""The run's guard against the JAX package: no module whose top-level name
(the part before the first dot) is one of ``FORBIDDEN`` may be loaded in the
process that prints the result.  Names are compared whole, so the port,
``amss_tpu_torch``, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "amss_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
