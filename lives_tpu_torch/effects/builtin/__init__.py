"""Builtin filters ported so far; importing registers them.

Counterpart of `lives_tpu/effects/builtin/__init__.py`, which registers the
JAX package's 147 filters. The port holds the render slice's vocabulary,
the stateful EffecTV filters of `effectv` and the generators of
`generators`.
"""

from . import (blends, blur, colour, effectv, generators,  # noqa: F401
               keying)
