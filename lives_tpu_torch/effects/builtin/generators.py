"""Generator filters: zero-input sources.

Counterpart of `lives_tpu/effects/builtin/generators.py` (reference
`plasma.c`, the solid/gradient RFX generators, libvis and projectM roles;
generator lifecycle effects-weed.c:7739): the helpers `_out_layer` (`:20`)
and `_grid` (`:37`), the stateless generators `solid_colour` (`:49`),
`plasma` (`:64`), `gradient` (`:106`), `checkerboard` (`:126`),
`colour_bars` (`:142`), `vu_bars` (`:163`) and `spectrascope` (`:187`), and
the stateful `beat_rings` (`:214-253`).

A generator is a function of (ctx.tc, params, geometry). Here it makes B
frames at once, ``(B, 3, H, W)`` u8, where ctx.tc is a ``(B,)`` float32
tensor (B = 1 on the live path) and a parameter a ``(B,)`` tensor or a
number, on `ctx.device`: a generator has no input layer to take a device
from, so one that runs without `ctx.device` raises. Numbers are made
float32 first, as the JAX package traces them. The grids are 1-D (a row of
x, a column of y) and broadcast, so a term of x alone is computed once a
column; every value is the one the JAX package's (h, w) grid gives.
Nothing inside a generator reads a device value back to the host.

`noise` (`:91`) draws from `jax.random` (threefry) and cannot match without
an integer port of threefry: it is registered, and running it raises
`NotImplementedError` naming ROADMAP Queue 1 item 15, which needs the same
port for `nervous`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import Gamma, Palette
from ...layer import Layer
from ...ops.colorspace import quantise_u8
from ..host import (FILTER_IS_GENERATOR, FILTER_STATEFUL, Filter, Param,
                    register_filter)


def _device(ctx):
    if ctx.device is None:
        raise ValueError("a generator needs ctx.device: it has no input "
                         "layer to take its device from")
    return ctx.device


def _col(v, ctx) -> torch.Tensor:
    """A per-frame value (number, 0-d or (B,) tensor) as float32 (B, 1, 1)
    on the ctx's device."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=_device(ctx)).reshape(-1, 1, 1)


def _out_layer(chans, ctx) -> Layer:
    """R, G, B in [0,1], each broadcasting to (B, H, W) -> the (B, 3, H, W)
    RGB24 layer, quantised round-half-up (`generators.py:20-26`). B is
    ctx.tc's length."""
    shape = (torch.as_tensor(ctx.tc).numel(), ctx.height, ctx.width)
    u8 = torch.stack([torch.broadcast_to(quantise_u8(c), shape)
                      for c in chans], 1)
    return Layer(planes=(u8,), palette=int(Palette.RGB24),
                 gamma=int(Gamma.SRGB))


def _grid(ctx):
    """(x (1, W), y (H, 1)) float32 in [0, 1]: iota times float32(1 /
    max(n - 1, 1)), as `generators.py:37-46` (not linspace: colour_bars
    truncates x * 8, so an ulp moves a bar's edge)."""
    h, w = ctx.height, ctx.width
    dev = _device(ctx)
    x = torch.arange(w, dtype=torch.float32, device=dev) \
        * float(np.float32(1.0 / max(w - 1, 1)))
    y = torch.arange(h, dtype=torch.float32, device=dev) \
        * float(np.float32(1.0 / max(h - 1, 1)))
    return x.reshape(1, w), y.reshape(h, 1)


def _mk_generator(name, fn, params=(), desc=""):
    def process(ins, p, ctx):
        return fn(p, ctx)
    return register_filter(Filter(
        name=name, process=process, in_channels=(),
        params=tuple(params), flags=FILTER_IS_GENERATOR, description=desc))


def _solid(p, ctx):
    return _out_layer([_col(p["red"], ctx), _col(p["green"], ctx),
                       _col(p["blue"], ctx)], ctx)


_mk_generator("solid_colour", _solid,
              params=(Param("red", "num", 0.0, 0.0, 1.0),
                      Param("green", "num", 0.0, 0.0, 1.0),
                      Param("blue", "num", 0.0, 0.0, 1.0)),
              desc="constant colour frame")

_PH = 2.0 * np.pi / 3.0
_COS1, _SIN1 = float(np.float32(np.cos(_PH))), float(np.float32(np.sin(_PH)))
_COS2, _SIN2 = (float(np.float32(np.cos(2 * _PH))),
                float(np.float32(np.sin(2 * _PH))))


def _plasma(p, ctx):
    """plasma.c-style interference of travelling sine fields."""
    x, y = _grid(ctx)
    t = _col(ctx.tc, ctx) * _col(p["speed"], ctx) * 3.0
    s = _col(p["scale"], ctx) * 10.0 + 1.0
    v = (torch.sin(x * s + t)
         + torch.sin((y * s + t) * 0.7)
         + torch.sin((x * s + y * s + t) * 0.5)
         + torch.sin(torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) * s * 2.0
                     + t))
    v = v * 0.25  # -1..1
    sv, cv = torch.sin(v * np.pi), torch.cos(v * np.pi)
    r = 0.5 + 0.5 * sv
    g = 0.5 + 0.5 * (sv * _COS1 + cv * _SIN1)
    b = 0.5 + 0.5 * (sv * _COS2 + cv * _SIN2)
    return _out_layer([r, g, b], ctx)


_mk_generator("plasma", _plasma,
              params=(Param("speed", "num", 0.5, 0.0, 2.0),
                      Param("scale", "num", 0.5, 0.0, 2.0)),
              desc="classic plasma field")


def _noise(p, ctx):
    raise NotImplementedError(
        "noise draws from jax.random's threefry, which the port has no "
        "integer copy of yet (ROADMAP Queue 1 item 15, with nervous)")


_mk_generator("noise", _noise,
              params=(Param("mono", "num", 1.0, 0.0, 1.0),),
              desc="white noise (static per frame number)")


def _gradient(p, ctx):
    x, y = _grid(ctx)
    th = _col(p["angle"], ctx) * float(np.float32(2.0 * np.pi))
    g = torch.clamp(x * torch.cos(th) + y * torch.sin(th), 0.0, 1.0)
    return _out_layer(
        [_col(p[c + "0"], ctx) + (_col(p[c + "1"], ctx)
                                  - _col(p[c + "0"], ctx)) * g
         for c in ("red", "green", "blue")], ctx)


_mk_generator("gradient", _gradient,
              params=(Param("angle", "num", 0.0, 0.0, 1.0),
                      Param("red0", "num", 0.0, 0.0, 1.0),
                      Param("green0", "num", 0.0, 0.0, 1.0),
                      Param("blue0", "num", 0.0, 0.0, 1.0),
                      Param("red1", "num", 1.0, 0.0, 1.0),
                      Param("green1", "num", 1.0, 0.0, 1.0),
                      Param("blue1", "num", 1.0, 0.0, 1.0)),
              desc="linear two-colour gradient")


def _checker(p, ctx):
    x, y = _grid(ctx)
    n = torch.clamp(_col(p["tiles"], ctx), min=1.0)
    phase = _col(ctx.tc, ctx) * _col(p["speed"], ctx)
    cx = torch.floor(x * n + phase)
    cy = torch.floor(y * n)
    v = torch.remainder(cx + cy, 2.0)
    return _out_layer([v, v, v], ctx)


_mk_generator("checkerboard", _checker,
              params=(Param("tiles", "num", 8.0, 1.0, 64.0),
                      Param("speed", "num", 0.0, 0.0, 4.0)),
              desc="scrolling checkerboard")


def _colour_bars(p, ctx):
    """SMPTE-ish bars, also the self-test pattern. Bar k of
    `generators.py:145-147`'s table is white, yellow, cyan, green, magenta,
    red, blue, black: R is on where bit 1 of k is clear, G where bit 2 is,
    B where bit 0 is, so no table is uploaded."""
    x, _ = _grid(ctx)
    bar = torch.clamp(x * 8.0, max=7.0).to(torch.int32)
    return _out_layer([((bar >> b) & 1 == 0).to(torch.float32)
                       for b in (1, 2, 0)], ctx)


_mk_generator("colour_bars", _colour_bars, desc="SMPTE-style colour bars")


# -- audio-reactive visualiser generators (libvis.c / projectM.cpp role) -----
# Scalar drive params (level/bass/mid/treble/beat) come from the audio
# analysers through data connections in the JAX package.

def _vu_bars(p, ctx):
    """libvis-style VU meter: four frequency-band bars."""
    x, y = _grid(ctx)
    heights = torch.clamp(torch.cat(
        [_col(p[k], ctx) for k in ("bass", "mid", "treble", "level")],
        -1), 0.0, 1.0)                                      # (B, 1, 4)
    band = torch.clamp((x * 4.0).to(torch.int32), 0, 3)     # (1, W)
    h_here = heights[:, 0, band.long()]                     # (B, 1, W)
    lit = ((1.0 - y) < h_here).to(torch.float32)
    # in-bar gradient green->red with height
    gap = (torch.remainder(x * 4.0, 1.0) > 0.08).to(torch.float32)
    return _out_layer([lit * (1.0 - y) * gap, lit * y * gap,
                       lit * 0.15 * gap], ctx)


_mk_generator("vu_bars", _vu_bars,
              params=(Param("level", "num", 0.5, 0.0, 1.0),
                      Param("bass", "num", 0.5, 0.0, 1.0),
                      Param("mid", "num", 0.5, 0.0, 1.0),
                      Param("treble", "num", 0.5, 0.0, 1.0)),
              desc="4-band VU bars (libvis.c role; drive via pconx)")


def _radius(ctx, x, y):
    """(cx, cy, r): centred coordinates with the frame's aspect, and twice
    the distance from the centre."""
    cx, cy = x - 0.5, (y - 0.5) * (ctx.height / max(ctx.width, 1))
    return cx, cy, torch.sqrt(cx * cx + cy * cy) * 2.0


def _spectrascope(p, ctx):
    """Radial audio-reactive pattern: rings pulse with bass, spokes spin
    with tc, hue with treble (the projectM-preset capability class)."""
    x, y = _grid(ctx)
    cx, cy, r = _radius(ctx, x, y)
    th = torch.atan2(cy, cx)
    t = _col(ctx.tc, ctx)
    level = _col(p["level"], ctx)
    rings = torch.sin(r * (8.0 + _col(p["bass"], ctx) * 24.0) - t * 4.0)
    spokes = torch.sin(th * torch.floor(3.0 + _col(p["mid"], ctx) * 9.0)
                       + t * 2.0)
    v = torch.clamp(rings * 0.5 + spokes * 0.5 + level, -1.0, 1.0)
    v = (v + 1.0) * 0.5 * torch.exp(-r * (1.5 - level))
    hue = _col(p["treble"], ctx) * 4.0 + t * 0.3
    return _out_layer([v * (0.5 + 0.5 * torch.sin(hue)),
                       v * (0.5 + 0.5 * torch.sin(hue + 2.094)),
                       v * (0.5 + 0.5 * torch.sin(hue + 4.189))], ctx)


_mk_generator("spectrascope", _spectrascope,
              params=(Param("level", "num", 0.5, 0.0, 1.0),
                      Param("bass", "num", 0.3, 0.0, 1.0),
                      Param("mid", "num", 0.3, 0.0, 1.0),
                      Param("treble", "num", 0.3, 0.0, 1.0)),
              desc="radial audio-reactive visualiser (projectM role)")


#: live rings of beat_rings at most
RINGS = 6


def _beat_rings_init(w, h, pal, device):
    """Ages of up to RINGS live rings (< 0: a free slot) as (6,) float32,
    and the next slot as an int32 0-d tensor."""
    return (torch.full((RINGS,), -1.0, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _beat_rings(ins, p, ctx, state):
    """Beat-triggered expanding rings (stateful, one frame a call): a beat
    pulse > 0.5 spawns a ring; rings expand and fade. The spawn is a
    device-side select, as the JAX package's `jnp.where`: no host branch,
    whatever `beat` is."""
    ages, cur = state
    dt = 1.0 / max(ctx.fps, 1.0)
    ages = torch.where(ages >= 0.0, ages + dt, ages)
    ages = torch.where(ages > 2.0, -1.0, ages)       # expire after 2 s
    spawn = (_col(p["beat"], ctx) > 0.5).reshape(())
    ages = torch.where(spawn, ages.index_fill(0, cur.long().reshape(1), 0.0),
                       ages)
    cur = torch.where(spawn, torch.remainder(cur + 1, RINGS), cur)
    x, y = _grid(ctx)
    _, _, r = _radius(ctx, x, y)
    speed = _col(p["speed"], ctx).reshape(())
    v = torch.zeros_like(r)
    for k in range(RINGS):
        a = ages[k]
        live = (a >= 0.0).to(torch.float32)
        radius = a * speed
        ring = torch.exp(-((r - radius) ** 2) * 400.0) * torch.exp(-a * 2.0)
        v = v + ring * live
    v = torch.clamp(v, 0.0, 1.0)
    return (_out_layer([v * _col(p[c], ctx) for c in ("red", "green",
                                                      "blue")], ctx),
            (ages, cur))


register_filter(Filter(
    name="beat_rings", process=_beat_rings, in_channels=(),
    params=(Param("beat", "num", 0.0, 0.0, 1.0),
            Param("speed", "num", 1.0, 0.1, 4.0),
            Param("red", "num", 0.3, 0.0, 1.0),
            Param("green", "num", 0.8, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0)),
    flags=FILTER_IS_GENERATOR | FILTER_STATEFUL, init_state=_beat_rings_init,
    description="beat-triggered expanding rings (audio-reactive)"))
