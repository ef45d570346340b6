"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py:8-16`, which
registers the JAX package's 147 filters. The port holds every one: each
filter of `alpha`, `analysers`, `blends`, `blur`, `colour`, `dataplugins`,
`effectv`, `extra`, `generators`, `geometry`, `keying` and `puretext`,
`io/kinect.py`'s depth_key, the six compounds of `effects/compound.py` and
the four built-in MilkDrop presets of `effects/milkdrop.py`.
"""

from . import (alpha, analysers, blends, blur, colour,  # noqa: F401
               dataplugins, effectv, extra, generators, geometry, keying,
               puretext)
from ...io import kinect  # noqa: F401  (registers `depth_key`)
from ..compound import register_builtin_compounds
from ..milkdrop import register_builtin_presets

register_builtin_compounds()
register_builtin_presets()
