"""Blend transitions: `crossfade` and the `_BLEND_MODES` table.

Counterpart of `lives_tpu/effects/builtin/blends.py:22-74` (reference
`simple_blend.c`, `multi_blends.c`). The other transitions of that module
(wipes, irises, dissolve, compositors) come with Slice 3 (ROADMAP Queue 1
item 13). The fused sweep kernel's vocabulary holds every filter here
(`graph/fused_sweep.py`).
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ..host import (ChannelTemplate, FILTER_IS_TRANSITION, Filter, Param,
                    register_filter)
from ..util import bparam, from_f01, join_alpha, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_TWO_IN = (ChannelTemplate("fg", _RGBX), ChannelTemplate("bg", _RGBX))


def _mk_transition(name, fn, desc=""):
    def process(ins, params, ctx):
        fg, bg = ins[0], ins[1]
        argb, aal = split_alpha(to_f01(fg))
        brgb, bal = split_alpha(to_f01(bg))
        out = torch.clamp(fn(argb, brgb, params), 0.0, 1.0)
        return from_f01(join_alpha(out, aal if aal is not None else bal), fg)

    return register_filter(Filter(
        name=name, process=process, in_channels=_TWO_IN,
        params=(Param("amount", "num", 0.5, 0.0, 1.0),),
        flags=FILTER_IS_TRANSITION, description=desc))


def _crossfade(a, b, p):
    t = bparam(p["amount"])
    return a * t + b * (1.0 - t)


_mk_transition("crossfade", _crossfade,
               desc="linear alpha crossfade of fg over bg")


def _mix(expr):
    """amount-weighted mix of the blend result with bg."""
    def fn(a, b, p):
        t = bparam(p["amount"])
        return expr(a, b) * t + b * (1.0 - t)
    return fn


#: name -> blend of fg `a` over bg `b`; the order is the kernel's mode
#: number (csrc/fused_sweep.cu `blend`)
_BLEND_MODES = {
    "blend_add": lambda a, b: a + b,
    "blend_subtract": lambda a, b: b - a,
    "blend_multiply": lambda a, b: a * b,
    "blend_screen": lambda a, b: 1.0 - (1.0 - a) * (1.0 - b),
    "blend_darken": torch.minimum,
    "blend_lighten": torch.maximum,
    "blend_difference": lambda a, b: torch.abs(a - b),
    "blend_exclusion": lambda a, b: a + b - 2.0 * a * b,
    "blend_overlay": lambda a, b: torch.where(
        b <= 0.5, 2.0 * a * b, 1.0 - 2.0 * (1.0 - a) * (1.0 - b)),
    "blend_hardlight": lambda a, b: torch.where(
        a <= 0.5, 2.0 * a * b, 1.0 - 2.0 * (1.0 - a) * (1.0 - b)),
    "blend_dodge": lambda a, b: b / torch.clamp(1.0 - a, min=1e-3),
    "blend_burn": lambda a, b: 1.0 - (1.0 - b) / torch.clamp(a, min=1e-3),
    "blend_grain_extract": lambda a, b: b - a + 0.5,
    "blend_grain_merge": lambda a, b: b + a - 0.5,
}

for _name, _expr in _BLEND_MODES.items():
    _mk_transition(_name, _mix(_expr), desc=f"{_name} of fg into bg")
