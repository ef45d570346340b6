"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py:8-16`, which
registers the JAX package's 147 filters. The port holds every filter of
`alpha`, `analysers`, `blends`, `blur`, `colour`, `dataplugins`,
`effectv`, `extra`, `generators`, `geometry` and `keying`, `io/kinect.py`'s
depth_key and the six compounds of `effects/compound.py`: 142 filters.
`effects.host.DEFERRED` names why a missing one is missing: puretext
(written, `puretext.FILTER`) and `effects/milkdrop.py`'s four presets.
"""

from . import (alpha, analysers, blends, blur, colour,  # noqa: F401
               dataplugins, effectv, extra, generators, geometry, keying)
from ...io import kinect  # noqa: F401  (registers `depth_key`)
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
for _name in ("milk_geometry", "milk_pulse", "milk_spin", "milk_tunnel"):
    DEFERRED[_name] = (
        "ROADMAP Queue 1 item 21: effects/milkdrop.py's presets run HLSL "
        "that effects/milkshader.py translates to jnp; they need a torch "
        "emitter")
