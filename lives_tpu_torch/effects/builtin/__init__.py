"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py:8-16`, which
registers the JAX package's 147 filters. The port holds every filter of
`blends`, `blur`, `colour`, `effectv`, `extra`, `generators`, `geometry`
and `keying`, and four of `effects/compound.py`'s six compounds: 117
filters. `effects.host.DEFERRED` names why a missing one is missing;
`puretext.FILTER` is written but deferred.
"""

from . import (blends, blur, colour, effectv, extra,  # noqa: F401
               generators, geometry, keying)
from ..compound import register_builtin_compounds
from ..host import DEFERRED

register_builtin_compounds()
DEFERRED["puretext"] = (
    "ROADMAP Queue 3: its letter positions are hard selects, and the JAX "
    "plan contracts the spiral and spinning modes' `i * c + x` into an "
    "FMA only in the vector lanes of a letter loop LLVM keeps, which "
    "depends on the letter count, the batch size and the fusion; "
    "effects/builtin/puretext.py is exact below 56 letters "
    "(tools/puretext_positions.py)")
