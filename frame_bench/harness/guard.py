"""The top-level module names the benchmark must never load: JAX and the
JAX package. Compared whole, the part before the first dot:
``zeldaengine_tpu_torch`` (the port) is not ``zeldaengine_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zeldaengine_tpu"})


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), sorted."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & FORBIDDEN)
