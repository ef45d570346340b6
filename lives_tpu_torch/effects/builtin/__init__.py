"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py`, which registers the
JAX package's 147 filters. The port holds every filter of `blends`,
`colour` and `keying`, `mask_overlay` of `extra`, the blurs of `blur`, the
stateful EffecTV filters of `effectv` and the generators of `generators`.
"""

from . import (blends, blur, colour, effectv, extra,  # noqa: F401
               generators, keying)
