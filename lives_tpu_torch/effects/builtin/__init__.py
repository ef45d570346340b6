"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py:8-16`, which
registers the JAX package's 147 filters. The port holds every filter of
`blends`, `blur`, `colour`, `effectv`, `generators`, `geometry` and
`keying`, `mask_overlay` of `extra`, and four of `effects/compound.py`'s
six compounds: 102 filters.
"""

from . import (blends, blur, colour, effectv, extra,  # noqa: F401
               generators, geometry, keying)
from ..compound import register_builtin_compounds

register_builtin_compounds()
