"""Extra filters: `mask_overlay`.

Counterpart of `lives_tpu/effects/builtin/extra.py:84-114` (reference
`gdk/mask_overlay.c`), in its two-input form: fg masked by bg's luma. The
JAX filter also takes a third input, a connected alpha channel (cconx), as
the mask; the port raises `NotImplementedError` for that form until cconx
wiring comes (ROADMAP Queue 1 item 21). The rest of that module is ROADMAP
Queue 1 item 14. The fused sweep kernel's vocabulary holds `mask_overlay`
(`graph/fused_sweep.py`).
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ..host import (ChannelTemplate, FILTER_IS_TRANSITION, Filter, Param,
                    register_filter)
from ..util import bparam, from_f01, join_alpha, luma, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_TWO_IN = (ChannelTemplate("fg", _RGBX), ChannelTemplate("bg", _RGBX))


def _mask_overlay_process(ins, p, ctx):
    if len(ins) > 2 and ins[2] is not None:
        raise NotImplementedError(
            "mask_overlay with a connected alpha channel (cconx) is not "
            "ported yet (ROADMAP Queue 1 item 21)")
    fg, bg = ins[0], ins[1]
    argb, aal = split_alpha(to_f01(fg))
    brgb, _ = split_alpha(to_f01(bg))
    g = luma(brgb)  # the mask from bg's luma (a mask clip on track 1)
    m = torch.clamp((g - bparam(p["threshold"]))
                    / (bparam(p["softness"]) + 1e-4), 0.0, 1.0)
    inv = bparam(p["invert"])
    m = m * (1.0 - inv) + (1.0 - m) * inv
    return from_f01(join_alpha(argb * m, aal), fg)


register_filter(Filter(
    name="mask_overlay", process=_mask_overlay_process, in_channels=_TWO_IN,
    params=(Param("threshold", "num", 0.5, 0.0, 1.0),
            Param("softness", "num", 0.05, 0.0, 1.0),
            Param("invert", "num", 0.0, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="mask fg by bg luma (gdk/mask_overlay.c)"))
