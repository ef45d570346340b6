"""Colour filters.

Counterpart of `lives_tpu/effects/builtin/colour.py`, every filter of that
module (reference `RGBdelay.c` channel mixing, `softlight.c`, `negate.c`,
the brightness/contrast/saturation, `colour_replace.script`,
`modulate.script` and `posterise.script` RFX scripts):

- the per-pixel filters `negate`, `brightness_contrast`, `gamma_adjust`,
  `saturation`, `hue_rotate`, `colour_balance`, `levels`, `greyscale`,
  `sepia`, `posterize`, `solarize`, `threshold`, `softlight`, `tint`,
  `colour_replace`, `modulate`, and `vignette`, which reads its frame
  coordinates through `ctx_grid`: the fused sweep kernel's vocabulary
  holds each (`graph/fused_sweep.py`);
- `white_balance` (a mean over the frame), `posterise` (a bit mask on the
  stored bytes) and `palette_mapper` (a nearest-colour search), which run
  on the plain route only.
"""

from __future__ import annotations

import numpy as np
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


def _chans(rgb):
    return rgb[:, 0:1], rgb[:, 1:2], rgb[:, 2:3]


# -- basics ------------------------------------------------------------------

_rgb_filter("negate", lambda rgb, p, c: 1.0 - rgb, desc="invert RGB")

_rgb_filter(
    "brightness_contrast",
    lambda rgb, p, c: ((rgb - 0.5) * bparam(p["contrast"]) + 0.5
                       + bparam(p["brightness"])),
    params=(Param("brightness", "num", 0.0, -1.0, 1.0),
            Param("contrast", "num", 1.0, 0.0, 4.0)),
    desc="linear brightness/contrast")

_rgb_filter(
    "gamma_adjust",
    lambda rgb, p, c: torch.clamp(rgb, min=0.0) ** bparam(p["gamma"]),
    params=(Param("gamma", "num", 1.0, 0.1, 5.0),),
    desc="power-law gamma tweak")


def _saturation(rgb, p, c):
    g = luma(rgb)
    return g + (rgb - g) * bparam(p["saturation"])


_rgb_filter("saturation", _saturation,
            params=(Param("saturation", "num", 1.0, 0.0, 4.0),),
            desc="saturation about BT.601 luma")

#: hue_rotate's coefficients m0 + cos * m1 + sin * m2 (`colour.py:63-89`),
#: row i giving output channel i from (r, g, b)
HUE_M0 = np.array([[0.213, 0.715, 0.072]] * 3, np.float32)
HUE_M1 = np.array([[0.787, -0.715, -0.072],
                   [-0.213, 0.285, -0.072],
                   [-0.213, -0.715, 0.928]], np.float32)
HUE_M2 = np.array([[-0.213, -0.715, 0.928],
                   [0.143, 0.140, -0.283],
                   [-0.787, 0.715, 0.072]], np.float32)


def _hue_rotate(rgb, p, c):
    """Rotate hue by angle (a YIQ-space rotation at constant luma), one
    coefficient at a time as the JAX package computes it."""
    th = bparam(p["angle"]) * np.float32(2.0 * np.pi)
    cs, sn = torch.cos(th), torch.sin(th)
    r, g, b = _chans(rgb)
    chans = []
    for i in range(3):
        coef = [HUE_M0[i, j] + cs * HUE_M1[i, j] + sn * HUE_M2[i, j]
                for j in range(3)]
        chans.append(coef[0] * r + coef[1] * g + coef[2] * b)
    return torch.cat(chans, 1)


_rgb_filter("hue_rotate", _hue_rotate,
            params=(Param("angle", "num", 0.0, 0.0, 1.0),),
            desc="rotate hue (0..1 = full turn)")


def _colour_balance(rgb, p, c):
    return torch.cat([rgb[:, 0:1] * bparam(p["red"]),
                      rgb[:, 1:2] * bparam(p["green"]),
                      rgb[:, 2:3] * bparam(p["blue"])], 1)


_rgb_filter("colour_balance", _colour_balance,
            params=(Param("red", "num", 1.0, 0.0, 4.0),
                    Param("green", "num", 1.0, 0.0, 4.0),
                    Param("blue", "num", 1.0, 0.0, 4.0)),
            desc="per-channel gain")


def _levels(rgb, p, c):
    lo, hi = bparam(p["black"]), bparam(p["white"])
    x = (rgb - lo) / torch.clamp(hi - lo, min=1e-4)
    return torch.clamp(x, 0.0, 1.0) ** bparam(p["gamma"])


_rgb_filter("levels", _levels,
            params=(Param("black", "num", 0.0, 0.0, 1.0),
                    Param("white", "num", 1.0, 0.0, 1.0),
                    Param("gamma", "num", 1.0, 0.1, 5.0)),
            desc="input levels + gamma")

_rgb_filter("greyscale", lambda rgb, p, c: luma(rgb).expand_as(rgb),
            desc="BT.601 greyscale")


def _sepia(rgb, p, c):
    r, g, b = _chans(rgb)
    tinted = torch.cat([
        r * np.float32(0.393) + g * np.float32(0.769)
        + b * np.float32(0.189),
        r * np.float32(0.349) + g * np.float32(0.686)
        + b * np.float32(0.168),
        r * np.float32(0.272) + g * np.float32(0.534)
        + b * np.float32(0.131)], 1)
    return rgb + (tinted - rgb) * bparam(p["amount"])


_rgb_filter("sepia", _sepia,
            params=(Param("amount", "num", 1.0, 0.0, 1.0),),
            desc="sepia tone")


def _posterize(rgb, p, c):
    n = torch.clamp(torch.as_tensor(bparam(p["levels"]),
                                    dtype=torch.float32), min=2.0)
    return torch.floor(rgb * (n - 1.0) + 0.5) / (n - 1.0)


_rgb_filter("posterize", _posterize,
            params=(Param("levels", "num", 4.0, 2.0, 32.0),),
            desc="quantize colour levels")

_rgb_filter(
    "solarize",
    lambda rgb, p, c: torch.where(rgb > bparam(p["threshold"]), 1.0 - rgb,
                                  rgb),
    params=(Param("threshold", "num", 0.5, 0.0, 1.0),),
    desc="invert above threshold")

_rgb_filter(
    "threshold",
    lambda rgb, p, c: (luma(rgb) > bparam(p["threshold"])).to(torch.float32)
    * torch.ones_like(rgb),
    params=(Param("threshold", "num", 0.5, 0.0, 1.0),),
    desc="binary luma threshold")


def _softlight(rgb, p, c):
    """softlight.c: the image soft-lit by its own luma."""
    g = luma(rgb)
    lit = torch.where(g <= 0.5, rgb * (g + 0.5),
                      1.0 - (1.0 - rgb) * (1.5 - g))
    return rgb + (lit - rgb) * bparam(p["amount"])


_rgb_filter("softlight", _softlight,
            params=(Param("amount", "num", 1.0, 0.0, 1.0),),
            desc="soft-light self-illumination")


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


def _tint(rgb, p, c):
    g = luma(rgb)
    tinted = torch.cat([g * bparam(p["red"]), g * bparam(p["green"]),
                        g * bparam(p["blue"])], 1)
    return rgb + (tinted - rgb) * bparam(p["amount"])


_rgb_filter("tint", _tint,
            params=(Param("amount", "num", 1.0, 0.0, 1.0),
                    Param("red", "num", 1.0, 0.0, 1.0),
                    Param("green", "num", 0.8, 0.0, 1.0),
                    Param("blue", "num", 0.5, 0.0, 1.0)),
            desc="tint greyscale with a colour")


def _white_balance(rgb, p, c):
    """Auto white balance toward grey-world, amount-weighted."""
    means = rgb.mean(dim=(-2, -1), keepdim=True)       # (B, 3, 1, 1)
    grey = means.mean(dim=1, keepdim=True)
    gain = grey / torch.clamp(means, min=1e-4)
    return rgb * (1.0 + (gain - 1.0) * bparam(p["amount"]))


_rgb_filter("white_balance", _white_balance,
            params=(Param("amount", "num", 1.0, 0.0, 1.0),),
            desc="grey-world auto white balance")


# -- RFX colour_replace.script / modulate.script backends ---------------------

def _colour_replace(rgb, p, c):
    """colour_replace.script: pixels within `tolerance` of (red, green,
    blue) become (red2, green2, blue2) (ImageMagick -opaque with -fuzz)."""
    r, g, b = _chans(rgb)
    d2 = ((r - bparam(p["red"])) ** 2 + (g - bparam(p["green"])) ** 2
          + (b - bparam(p["blue"])) ** 2) * np.float32(1.0 / 3.0)
    m = (torch.sqrt(d2) <= bparam(p["tolerance"])).to(torch.float32)
    inv = 1.0 - m
    return torch.cat([r * inv + bparam(p["red2"]) * m,
                      g * inv + bparam(p["green2"]) * m,
                      b * inv + bparam(p["blue2"]) * m], 1)


_rgb_filter("colour_replace", _colour_replace,
            params=(Param("red", "num", 0.0, 0.0, 1.0),
                    Param("green", "num", 0.0, 0.0, 1.0),
                    Param("blue", "num", 0.0, 0.0, 1.0),
                    Param("red2", "num", 1.0, 0.0, 1.0),
                    Param("green2", "num", 1.0, 0.0, 1.0),
                    Param("blue2", "num", 1.0, 0.0, 1.0),
                    Param("tolerance", "num", 0.1, 0.0, 1.0)),
            desc="replace a colour within tolerance (colour_replace.script)")


def _modulate(rgb, p, c):
    """modulate.script / ImageMagick -modulate: brightness, saturation and
    hue scaling together (each 1.0 = unchanged; hue 0..2 maps to a full
    -180..+180 turn about the luma axis)."""
    out = rgb * bparam(p["brightness"])
    g = luma(out)
    out = g + (out - g) * bparam(p["saturation"])
    th = (bparam(p["hue"]) - 1.0) * np.float32(np.pi)
    cs, sn = torch.cos(th), torch.sin(th)
    y = luma(out)
    r0, g0, b0 = _chans(out)
    i = 0.596 * r0 - 0.274 * g0 - 0.322 * b0
    q = 0.211 * r0 - 0.523 * g0 + 0.312 * b0
    i, q = i * cs - q * sn, i * sn + q * cs
    return torch.cat([y + 0.956 * i + 0.621 * q,
                      y - 0.272 * i - 0.647 * q,
                      y - 1.106 * i + 1.703 * q], 1)


_rgb_filter("modulate", _modulate,
            params=(Param("brightness", "num", 1.0, 0.0, 2.0),
                    Param("saturation", "num", 1.0, 0.0, 2.0),
                    Param("hue", "num", 1.0, 0.0, 2.0)),
            desc="combined brightness/saturation/hue (modulate.script)")


# -- posterise (exact script semantics) ---------------------------------------

def _posterise_process(ins, p, ctx):
    """Bit-plane posterise (scripts/posterise.script): keep the top
    `levels` bits of each RGB byte; alpha passes through untouched. On u8
    planes an integer AND, bit-exact with the reference; on float planes
    the same uniform quantisation, step 2^(8 - levels)."""
    lay = ins[0]
    arr = lay.planes[0]
    levels = max(1, min(int(p["levels"]), 8))
    if not arr.is_floating_point():
        m = 0
        for i in range(levels):
            m |= 128 >> i
        rgb = arr[:, :3] & m
    else:
        q = np.float32(1 << (8 - levels))
        v = arr[:, :3].to(torch.float32) * np.float32(255.0)
        rgb = (torch.floor(v / q) * q * np.float32(1 / 255.0)).to(arr.dtype)
    out = torch.cat([rgb, arr[:, 3:4]], 1) if arr.shape[1] == 4 else rgb
    return lay.replace(planes=(out,))


register_filter(Filter(
    name="posterise", process=_posterise_process, in_channels=_ONE_IN,
    params=(Param("levels", "int", 1, 1, 8),),
    description="reduce colour levels by bit-plane mask "
                "(scripts/posterise.script, bit-exact)"))


# -- palette_mapper ------------------------------------------------------------

_FIXED_PALETTES = {
    # name -> (K, 3) float [0,1] rows. Classic machine palettes.
    "mono": np.array([[0, 0, 0], [255, 255, 255]], np.float32) / 255.0,
    "gameboy": np.array([[15, 56, 15], [48, 98, 48], [139, 172, 15],
                         [155, 188, 15]], np.float32) / 255.0,
    "cga": np.array([[0, 0, 0], [85, 255, 255], [255, 85, 255],
                     [255, 255, 255]], np.float32) / 255.0,
    "ega16": np.array(
        [[0, 0, 0], [0, 0, 170], [0, 170, 0], [0, 170, 170],
         [170, 0, 0], [170, 0, 170], [170, 85, 0], [170, 170, 170],
         [85, 85, 85], [85, 85, 255], [85, 255, 85], [85, 255, 255],
         [255, 85, 85], [255, 85, 255], [255, 255, 85],
         [255, 255, 255]], np.float32) / 255.0,
    "c64": np.array(
        [[0, 0, 0], [255, 255, 255], [136, 57, 50], [103, 182, 189],
         [139, 63, 150], [85, 160, 73], [64, 49, 141], [191, 206, 114],
         [139, 84, 41], [87, 66, 0], [184, 105, 98], [80, 80, 80],
         [120, 120, 120], [148, 224, 137], [120, 105, 196],
         [159, 159, 159]], np.float32) / 255.0,
}


def _palette_mapper(rgb, p, c):
    """Map every pixel to the nearest colour of a fixed machine palette
    (nearest in RGB: argmin over k of |c_k|^2 - 2 x.c_k); `strength`
    blends the mapped image back over the original."""
    name = list(_FIXED_PALETTES)[int(p["palette"])]
    pal = torch.from_numpy(_FIXED_PALETTES[name]).to(rgb.device)   # (K, 3)
    dots = torch.einsum("bchw,kc->bkhw", rgb, pal)
    k = torch.argmin((pal * pal).sum(1)[None, :, None, None] - 2.0 * dots,
                     dim=1)                                     # (B, H, W)
    mapped = pal[k].permute(0, 3, 1, 2)                         # (B, 3, H, W)
    s = torch.clamp(torch.as_tensor(bparam(p["strength"]),
                                    dtype=torch.float32), 0.0, 1.0)
    return rgb * (1.0 - s) + mapped * s


_rgb_filter("palette_mapper", _palette_mapper,
            params=(Param("palette", "string_list", 0,
                          choices=tuple(_FIXED_PALETTES)),
                    Param("strength", "num", 1.0, 0.0, 1.0)),
            desc="map colours to the nearest entry of a classic fixed "
                 "palette (mono/gameboy/cga/ega16/c64)")
