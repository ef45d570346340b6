"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py:8-16`, which
registers the JAX package's 147 filters. The port holds every filter of
`alpha`, `analysers`, `blends`, `blur`, `colour`, `dataplugins`,
`effectv`, `extra`, `generators`, `geometry` and `keying`, `io/kinect.py`'s
depth_key, the six compounds of `effects/compound.py` and the four
built-in MilkDrop presets of `effects/milkdrop.py`: 146 filters.
`effects.host.DEFERRED` names why the missing one is missing: puretext
(written, `puretext.FILTER`).
"""

from . import (alpha, analysers, blends, blur, colour,  # noqa: F401
               dataplugins, effectv, extra, generators, geometry, keying)
from ...io import kinect  # noqa: F401  (registers `depth_key`)
from ..compound import register_builtin_compounds
from ..host import DEFERRED
from ..milkdrop import register_builtin_presets

register_builtin_compounds()
register_builtin_presets()
DEFERRED["puretext"] = (
    "ROADMAP Queue 3: its letter positions are hard selects, and the JAX "
    "plan contracts the spiral and spinning modes' `i * c + x` into an "
    "FMA only in the vector lanes of a letter loop LLVM keeps, which "
    "depends on the letter count, the batch size and the fusion; "
    "effects/builtin/puretext.py is exact below 56 letters "
    "(tools/puretext_positions.py)")
