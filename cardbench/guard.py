"""The run's check that nothing of JAX or of the JAX package was loaded.

Module names are compared by their top-level part (before the first dot)
whole, so `lives_tpu_torch`, the measured package, passes and
`lives_tpu`, the JAX package it was ported from, does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lives_tpu"})


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
