"""Colour filters: `colour_balance`, `saturation`, `vignette`.

Counterpart of `lives_tpu/effects/builtin/colour.py:22-191` (`_rgb_filter`,
`colour_balance`, `_saturation`, `_vignette`). The rest of that module's
filters come with Slice 3 (ROADMAP Queue 1 items 13-14).
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ..host import ChannelTemplate, Filter, Param, register_filter
from ..util import (bparam, ctx_grid, from_f01, join_alpha, luma, split_alpha,
                    to_f01)

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)


def _rgb_filter(name, fn, params=(), desc=""):
    """Filter over the ``(B, 3, H, W)`` [0,1] rgb view."""
    def process(ins, p, ctx):
        lay = ins[0]
        rgb, al = split_alpha(to_f01(lay))
        out = torch.clamp(fn(rgb, p, ctx), 0.0, 1.0)
        return from_f01(join_alpha(out, al), lay)
    return register_filter(Filter(name=name, process=process,
                                  in_channels=_ONE_IN, params=tuple(params),
                                  description=desc))


def _colour_balance(rgb, p, c):
    return torch.cat([rgb[:, 0:1] * bparam(p["red"]),
                      rgb[:, 1:2] * bparam(p["green"]),
                      rgb[:, 2:3] * bparam(p["blue"])], 1)


_rgb_filter("colour_balance", _colour_balance,
            params=(Param("red", "num", 1.0, 0.0, 4.0),
                    Param("green", "num", 1.0, 0.0, 4.0),
                    Param("blue", "num", 1.0, 0.0, 4.0)),
            desc="per-channel gain")


def _saturation(rgb, p, c):
    g = luma(rgb)
    return g + (rgb - g) * bparam(p["saturation"])


_rgb_filter("saturation", _saturation,
            params=(Param("saturation", "num", 1.0, 0.0, 4.0),),
            desc="saturation about BT.601 luma")


def _vignette(rgb, p, c):
    h, w = rgb.shape[-2:]
    x, y = ctx_grid(c, h, w, centered=True, device=rgb.device)
    r2 = x * x + y * y
    falloff = torch.exp(-r2 * bparam(p["strength"]) * 2.0)
    return rgb * (1.0 - bparam(p["amount"]) * (1.0 - falloff))


_rgb_filter("vignette", _vignette,
            params=(Param("amount", "num", 0.8, 0.0, 1.0),
                    Param("strength", "num", 1.0, 0.1, 4.0)),
            desc="radial darkening")
