"""Keying filters: `chroma_key`, `luma_key` and `alpha_over`.

Counterpart of `lives_tpu/effects/builtin/keying.py` (reference
`colorkey.c`), every filter of that module. The fused sweep kernel's
vocabulary holds each (`graph/fused_sweep.py`); there a track has no alpha,
so `alpha_over`'s fg counts as opaque, as it does in the JAX package's
sweep.
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ..host import (ChannelTemplate, FILTER_IS_TRANSITION, Filter, Param,
                    register_filter)
from ..util import bparam, from_f01, join_alpha, luma, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_TWO_IN = (ChannelTemplate("fg", _RGBX), ChannelTemplate("bg", _RGBX))


def _chroma_dist(rgb, key_r, key_g, key_b):
    """Chromaticity distance to the key colour (brightness-invariant-ish)."""
    eps = 1e-4
    s = rgb[:, 0:1] + rgb[:, 1:2] + rgb[:, 2:3] + eps
    r, g = rgb[:, 0:1] / s, rgb[:, 1:2] / s
    ks = key_r + key_g + key_b + eps
    kr, kg = key_r / ks, key_g / ks
    return torch.sqrt((r - kr) ** 2 + (g - kg) ** 2)


def _chroma_key_process(ins, p, ctx):
    """fg keyed over bg where fg matches the key colour."""
    fg, bg = ins[0], ins[1]
    argb, _ = split_alpha(to_f01(fg))
    brgb, bal = split_alpha(to_f01(bg))
    d = _chroma_dist(argb, bparam(p["red"]), bparam(p["green"]),
                     bparam(p["blue"]))
    # alpha: 0 where close to the key colour, ramp over softness
    alpha = torch.clamp((d - bparam(p["tolerance"]))
                        / (bparam(p["softness"]) + 1e-4), 0.0, 1.0)
    out = argb * alpha + brgb * (1.0 - alpha)
    return from_f01(join_alpha(out, bal), bg)


register_filter(Filter(
    name="chroma_key", process=_chroma_key_process, in_channels=_TWO_IN,
    params=(Param("red", "num", 0.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 0.0, 0.0, 1.0),
            Param("tolerance", "num", 0.15, 0.0, 1.0),
            Param("softness", "num", 0.1, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="green-screen style chroma key of fg over bg"))


def _luma_key_process(ins, p, ctx):
    fg, bg = ins[0], ins[1]
    argb, _ = split_alpha(to_f01(fg))
    brgb, bal = split_alpha(to_f01(bg))
    alpha = torch.clamp((luma(argb) - bparam(p["threshold"]))
                        / (bparam(p["softness"]) + 1e-4), 0.0, 1.0)
    inv = bparam(p.get("invert", 0.0))
    alpha = alpha * (1.0 - inv) + (1.0 - alpha) * inv
    out = argb * alpha + brgb * (1.0 - alpha)
    return from_f01(join_alpha(out, bal), bg)


register_filter(Filter(
    name="luma_key", process=_luma_key_process, in_channels=_TWO_IN,
    params=(Param("threshold", "num", 0.3, 0.0, 1.0),
            Param("softness", "num", 0.1, 0.0, 1.0),
            Param("invert", "num", 0.0, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="key fg over bg by fg luma"))


def _alpha_over_process(ins, p, ctx):
    """Composite fg over bg by fg's own alpha channel (a fg without one
    counts as opaque), scaled by `opacity`."""
    fg, bg = ins[0], ins[1]
    argb, aal = split_alpha(to_f01(fg))
    brgb, bal = split_alpha(to_f01(bg))
    alpha = aal if aal is not None else torch.ones_like(argb[:, :1])
    alpha = alpha * bparam(p["opacity"])
    out = argb * alpha + brgb * (1.0 - alpha)
    return from_f01(join_alpha(out, bal), bg)


register_filter(Filter(
    name="alpha_over", process=_alpha_over_process,
    in_channels=(ChannelTemplate("fg", (Palette.RGBA32,)),
                 ChannelTemplate("bg", _RGBX)),
    params=(Param("opacity", "num", 1.0, 0.0, 1.0),),
    flags=FILTER_IS_TRANSITION,
    description="alpha composite fg over bg (fg alpha)"))
