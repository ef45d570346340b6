"""Geometric filters: flips, mirror, pixelate, the coordinate warps, relief
and the CRT and waveform looks.

Counterpart of `lives_tpu/effects/builtin/geometry.py:20-417` (reference
`mirrors.c`, `kaleidoscope.c`, `tvpic.c`, `bump2d.c`, `warpTV.c`,
rotozoom, and RFXscripts/{rotate,wave,swirl,spread,shift_*,emboss,
charcoal,targeted_zoom,revTV}.script), every filter of that module,
through `_chan_filter` (`:20-28`): the frame as float32 in [0,1], the
filter, a clip to [0,1], back to the layer's storage.

Views are ``(B, C, H, W)`` and a per-frame parameter a ``(B,)`` tensor, so
coordinate grids are ``(B, h, w)`` (`_col` shapes a parameter for them)
where the JAX package vmaps a single-frame function. Every expression keeps
the JAX package's operation order. The warps sample through
`effects.util.bilinear` in mode "nearest", as `map_coordinates(order=1,
mode="nearest")` does (`:63-67`), with the coordinates clamped where the
JAX package clamps them and left alone where it does not (rotozoom,
rotate, swirl, spread). `spread`'s hash amplifies a one-ulp difference of
its `sin` past any pixel bound, so it runs `utils.sinf`, the twin of the
C library's `sinf` that XLA calls, on the argument XLA's jit computes
(see `_spread`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import Palette
from ...ops.resize import resize_plane
from ...utils.sinf import sinf
from ..host import ChannelTemplate, Filter, Param, register_filter
from ..util import bilinear, from_f01, luma, per_frame, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)
_F32 = np.float32


def _chan_filter(name, fn, params=(), desc=""):
    def process(ins, p, ctx):
        lay = ins[0]
        a = to_f01(lay)
        out = torch.clamp(fn(a, p, ctx), 0.0, 1.0)
        return from_f01(out, lay)
    return register_filter(Filter(name=name, process=process,
                                  in_channels=_ONE_IN, params=tuple(params),
                                  description=desc))


def _col(v, a):
    """A per-frame value as float32 on the view `a`'s device, shaped to
    broadcast over (B, h, w) grids."""
    return per_frame(v, a.device).reshape(-1, 1, 1)


def _p4(v, a):
    """A per-frame value as float32, shaped to broadcast over the view."""
    return _col(v, a)[:, None]


def _axes(a, centre=False):
    """float32 (h, 1) row and (1, w) column coordinates of the view `a`,
    less the centre (h - 1) / 2, (w - 1) / 2 with `centre`."""
    h, w = a.shape[-2:]
    y = torch.arange(h, dtype=torch.float32, device=a.device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=a.device)[None, :]
    if centre:
        return y - (h - 1) / 2.0, x - (w - 1) / 2.0
    return y, x


def _warp(a, yy, xx):
    """Bilinear-sample every channel of (B, C, H, W) at float coordinates
    broadcasting to (B, H, W), edges clamped (mode "nearest")."""
    h, w = a.shape[-2:]
    yy, xx = torch.broadcast_tensors(yy, xx)
    if yy.ndim == 2:
        yy, xx = yy[None], xx[None]
    return bilinear(a, yy.expand(-1, h, w), xx.expand(-1, h, w), "nearest")


_chan_filter("flip_horizontal", lambda a, p, c: a.flip(-1),
             desc="mirror left-right")
_chan_filter("flip_vertical", lambda a, p, c: a.flip(-2),
             desc="mirror top-bottom")
_chan_filter("rotate180", lambda a, p, c: a.flip(-2, -1),
             desc="rotate 180 degrees")


def _mirror(a, p, c):
    """mirrors.c: reflect one half onto the other (`:40-44`)."""
    w = a.shape[-1]
    half = a[..., : w // 2]
    return torch.cat([half, half.flip(-1)], -1) if w % 2 == 0 else a


_chan_filter("mirror", _mirror, desc="reflect left half onto right")


def _pixelate(a, p, c):
    """tvpic.c-style blockiness (`:50-56`): box down + nearest up."""
    h, w = a.shape[-2:]
    n = max(2, int(p["block"]))
    small = resize_plane(a, max(1, h // n), max(1, w // n), "area")
    return resize_plane(small, h, w, "nearest")


_chan_filter("pixelate", _pixelate,
             params=(Param("block", "int", 8, 2, 64),),
             desc="mosaic pixelation")


def _rotozoom(a, p, c):
    """`:70-80`."""
    h, w = a.shape[-2:]
    th = _col(p["angle"], a) * float(_F32(2.0 * np.pi))
    z = torch.clamp(_col(p["zoom"], a), min=0.05)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = _axes(a, centre=True)
    cs, sn = torch.cos(th) / z, torch.sin(th) / z
    return _warp(a, cy + y * cs - x * sn, cx + y * sn + x * cs)


_chan_filter("rotozoom", _rotozoom,
             params=(Param("angle", "num", 0.0, 0.0, 1.0),
                     Param("zoom", "num", 1.0, 0.05, 8.0)),
             desc="rotate + zoom about centre")


def _fmod(x, m):
    """`jnp.mod` on floats: the exact C remainder, moved into the
    divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def _kaleidoscope(a, p, c):
    """kaleidoscope.c: fold the plane into N mirrored sectors
    (`:89-104`)."""
    h, w = a.shape[-2:]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = torch.broadcast_tensors(*_axes(a, centre=True))
    r = torch.sqrt(y * y + x * x)
    theta = torch.atan2(y, x) + _col(p["angle"], a) * float(_F32(2.0 * np.pi))
    n = torch.clamp(_col(p["sectors"], a), min=2.0)
    sector = float(_F32(2.0 * np.pi)) / n
    th = _fmod(theta, sector)
    th = torch.minimum(th, sector - th) * 2.0  # mirror within sector
    return _warp(a, torch.clamp(cy + r * torch.sin(th), 0, h - 1),
                 torch.clamp(cx + r * torch.cos(th), 0, w - 1))


_chan_filter("kaleidoscope", _kaleidoscope,
             params=(Param("sectors", "num", 6.0, 2.0, 32.0),
                     Param("angle", "num", 0.0, 0.0, 1.0)),
             desc="N-fold kaleidoscope")


def _ripple(a, p, c):
    """rippleTV-style travelling sine displacement (`:113-126`)."""
    h, w = a.shape[-2:]
    t = _col(c.tc, a) * _col(p["speed"], a) * 10.0
    y, x = _axes(a)
    amp = _col(p["amplitude"], a) * 20.0
    freq = _col(p["frequency"], a) * 0.2
    yy = torch.clamp(y + amp * torch.sin(freq * x + t), 0, h - 1)
    xx = torch.clamp(x + amp * torch.sin(freq * y + t * 1.1), 0, w - 1)
    return _warp(a, yy, xx)


_chan_filter("ripple", _ripple,
             params=(Param("amplitude", "num", 0.3, 0.0, 1.0),
                     Param("frequency", "num", 0.5, 0.0, 1.0),
                     Param("speed", "num", 0.5, 0.0, 1.0)),
             desc="travelling sine-wave warp")


def _lens(a, p, c):
    """bump2d/fisheye-style radial lens distortion (`:135-148`)."""
    h, w = a.shape[-2:]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = _axes(a, centre=True)
    x, y = x / cx, y / cy
    r = torch.sqrt(y * y + x * x)
    k = (_col(p["strength"], a) - 0.5) * 2.0  # -1..1: pincushion..barrel
    scale = 1.0 + k * (r * r)
    return _warp(a, torch.clamp(cy + y * scale * cy, 0, h - 1),
                 torch.clamp(cx + x * scale * cx, 0, w - 1))


_chan_filter("lens", _lens,
             params=(Param("strength", "num", 0.75, 0.0, 1.0),),
             desc="barrel/pincushion lens warp")


def _rotate(a, p, c):
    """rotate.script: arbitrary-angle rotation in degrees (`:162-172`)."""
    h, w = a.shape[-2:]
    th = _col(p["degrees"], a) * float(_F32(np.pi / 180.0))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = _axes(a, centre=True)
    cs, sn = torch.cos(th), torch.sin(th)
    return _warp(a, cy + y * cs - x * sn, cx + y * sn + x * cs)


_chan_filter("rotate", _rotate,
             params=(Param("degrees", "num", 0.0, -360.0, 360.0),),
             desc="arbitrary-angle rotation")


def _wave(a, p, c):
    """wave.script: sinusoidal row displacement (`:180-190`)."""
    h, w = a.shape[-2:]
    amp = _col(p["amplitude"], a) * h * 0.1
    wl = torch.clamp(_col(p["wavelength"], a), min=0.01) * w
    y, x = _axes(a)
    ph = _col(getattr(c, "tc", 0.0), a) * _col(p["speed"], a) \
        * float(_F32(2 * np.pi))
    yy = y + amp * torch.sin(x * float(_F32(2 * np.pi)) / wl + ph)
    return _warp(a, yy, x)


_chan_filter("wave", _wave,
             params=(Param("amplitude", "num", 0.3, 0.0, 1.0),
                     Param("wavelength", "num", 0.25, 0.01, 1.0),
                     Param("speed", "num", 1.0, 0.0, 10.0)),
             desc="sinusoidal wave displacement")


def _swirl(a, p, c):
    """swirl.script: angular twist growing toward the centre
    (`:200-213`)."""
    h, w = a.shape[-2:]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = _axes(a, centre=True)
    r = torch.sqrt(y * y + x * x)
    rmax = float(_F32(np.hypot(cy, cx)))
    m = torch.clamp(1.0 - r / rmax, min=0.0)
    th = _col(p["degrees"], a) * float(_F32(np.pi / 180.0)) * (m * m)
    cs, sn = torch.cos(th), torch.sin(th)
    return _warp(a, cy + y * cs - x * sn, cx + y * sn + x * cs)


_chan_filter("swirl", _swirl,
             params=(Param("degrees", "num", 90.0, -720.0, 720.0),),
             desc="centre swirl/twist")


#: the hash's multipliers as float32, and float64 for the exact product
_SPREAD_U, _SPREAD_V = float(_F32(12.9898)), float(_F32(78.233))


def spread_hash(u, v, k, seed, fused: bool = True):
    """`fract(sin(u * 12.9898 + v * 78.233 + k * 0.317 + seed) *
    43758.5453) * 2 - 1` (`geometry.py:226-228`) on float32 pixel
    coordinates u (1, w) and v (h, 1) and per-frame seeds (B, 1, 1), as
    the JAX package's jitted routes compute it. A one-frame plan (the
    filter alone, `FrameGraph.run`) contracts the first multiply-add into
    a fused one, fma(u, 12.9898, v * 78.233): its product of an integer
    coordinate below 2^13 and a float32 is exact in float64 and so is the
    sum with a float32 below 2^17, so one rounding to float32 gives the
    fused result. The batch plan (`run_batch`, `fused=False`) computes
    the frame-invariant u * 12.9898 + v * 78.233 in a fusion of its own,
    two products and a sum, each rounded. `sin` is `utils.sinf`, the C
    library's `sinf` that XLA calls. Returns float32 (B, h, w) in [-1,
    1)."""
    if fused:
        vv = (v * _F32(78.233)).to(torch.float64)
        arg = (u.to(torch.float64) * _SPREAD_U + vv).to(torch.float32)
    else:
        arg = u * _SPREAD_U + v * _SPREAD_V
    s = sinf(arg + float(_F32(k * 0.317)) + seed) * 43758.5453
    return (s - torch.floor(s)) * 2.0 - 1.0


def _spread(a, p, c):
    """spread.script: random local pixel displacement, hash noise that is
    deterministic a frame (`:217-233`)."""
    amt = _col(p["amount"], a) * 8.0
    y, x = _axes(a)
    seed = _col(torch.as_tensor(getattr(c, "frame", 0), device=a.device)
                .to(torch.float32), a)
    fused = not getattr(c, "batched", False)
    yy = y + amt * spread_hash(x, y, 1.0, seed, fused)
    xx = x + amt * spread_hash(x, y, 2.0, seed, fused)
    return _warp(a, yy, xx)


_chan_filter("spread", _spread,
             params=(Param("amount", "num", 0.3, 0.0, 1.0),),
             desc="random pixel spread")


def _roll(a, n, dim):
    """torch.roll of each frame of `a` by its own count n (B,) int along
    `dim`, gathered on the device."""
    size = a.shape[dim]
    idx = torch.remainder(torch.arange(size, device=a.device)
                          - n.to(torch.int64).reshape(-1, 1), size)
    shape = [a.shape[0], 1, 1, 1]
    shape[dim] = size
    return torch.gather(a, dim, idx.reshape(shape).expand(a.shape))


def _shift(a, p, c):
    """shift_horizontal/vertical.script: wrap-around roll by the nearest
    whole pixel, half to even as `jnp.round` rounds (`:240-246`)."""
    B, _, h, w = a.shape

    def count(v, n):
        v = torch.as_tensor(v, dtype=torch.float32, device=a.device)
        return torch.round(v * n).to(torch.int32).reshape(-1).expand(B)
    out = _roll(a, count(p["dy"], h), 2)
    return _roll(out, count(p["dx"], w), 3)


_chan_filter("shift", _shift,
             params=(Param("dx", "num", 0.0, -1.0, 1.0),
                     Param("dy", "num", 0.0, -1.0, 1.0)),
             desc="wrap-around shift")


def _gradients(g):
    """(d/dy, d/dx) of (B, 1, H, W) as `jnp.gradient`: central
    differences inside, one-sided at the edges."""
    return torch.gradient(g, dim=2)[0], torch.gradient(g, dim=3)[0]


def _bump2d(a, p, c):
    """bump2d.c: luma gradient dotted with a light direction, modulating
    the image, alpha included (`:256-266`)."""
    g = luma(a[:, :3])
    gy, gx = _gradients(g)
    th = _p4(p["light_angle"], a) * float(_F32(2 * np.pi))
    lx, ly = torch.cos(th), torch.sin(th)
    shade = 0.5 + _p4(p["depth"], a) * 4.0 * (gx * lx + gy * ly)
    return a * torch.clamp(shade, 0.0, 1.5)


_chan_filter("bump2d", _bump2d,
             params=(Param("light_angle", "num", 0.125, 0.0, 1.0),
                     Param("depth", "num", 0.5, 0.0, 1.0)),
             desc="bump-map relief lighting (bump2d.c)")


def _keep_alpha(out3, a):
    return torch.cat([out3, a[:, 3:4]], 1) if a.shape[1] == 4 else out3


def _tvpic(a, p, c):
    """tvpic.c: scanlines, an RGB phosphor mask by integer column phase
    x % 3, a slight barrel vignette (`:275-295`)."""
    h, w = a.shape[-2:]
    y, x = _axes(a)
    scan = 1.0 - _p4(p["scanlines"], a) * 0.5 * (
        1.0 + torch.sin(y * float(_F32(np.pi))))
    phase = x.to(torch.int32) % 3
    mask = torch.stack([(phase == k).to(torch.float32) for k in range(3)])
    pm = _p4(p["mask"], a)
    ph = 1.0 - pm * (1.0 - torch.clamp(mask * 3.0, 0.0, 1.0))
    rgb = a[:, :3] * scan * (ph * (1.0 / (1.0 + pm * 0.0)))
    nx = (x / (w - 1) - 0.5) * 2.0
    ny = (y / (h - 1) - 0.5) * 2.0
    vig = 1.0 - _p4(p["corner"], a) * (nx * nx + ny * ny) * 0.5
    return _keep_alpha(rgb * torch.clamp(vig, 0.0, 1.0), a)


_chan_filter("tvpic", _tvpic,
             params=(Param("scanlines", "num", 0.4, 0.0, 1.0),
                     Param("mask", "num", 0.3, 0.0, 1.0),
                     Param("corner", "num", 0.3, 0.0, 1.0)),
             desc="CRT TV picture (tvpic.c)")


def _emboss(a, p, c):
    """emboss.script (ImageMagick -emboss): the luma less its up-left
    neighbour, edge-padded (`:305-316`)."""
    g = luma(a[:, :3])
    up_left = torch.nn.functional.pad(g, (1, 0, 1, 0),
                                      mode="replicate")[..., :-1, :-1]
    out = torch.clamp(0.5 + (up_left - g) * _p4(p["strength"], a) * 8.0,
                      0.0, 1.0)
    rgb = a[:, :3]
    return _keep_alpha(rgb + (out.expand_as(rgb) - rgb) * _p4(p["amount"], a),
                       a)


_chan_filter("emboss", _emboss,
             params=(Param("strength", "num", 0.5, 0.0, 2.0),
                     Param("amount", "num", 1.0, 0.0, 1.0)),
             desc="relief emboss")


def _charcoal(a, p, c):
    """charcoal.script (ImageMagick -charcoal): inverted edge sketch
    (`:325-336`)."""
    g = luma(a[:, :3])
    gy, gx = _gradients(g)
    mag = torch.sqrt(gx * gx + gy * gy) * _p4(p["strength"], a) * 12.0
    sketch = torch.clamp(1.0 - mag, 0.0, 1.0)
    return _keep_alpha(sketch.expand(-1, 3, -1, -1), a)


_chan_filter("charcoal", _charcoal,
             params=(Param("strength", "num", 0.5, 0.0, 2.0),),
             desc="charcoal sketch")


def _warptv(a, p, c):
    """warpTV.c: the frame wobbles on a slow 2-D sine displacement field
    driven by the frame's time (`:345-363`)."""
    h, w = a.shape[-2:]
    t = _col(c.tc, a) * (0.5 + _col(p["speed"], a) * 4.0)
    y, x = _axes(a)
    amp = _col(p["amplitude"], a) * 0.05 * float(_F32(min(h, w)))
    nx = x * float(_F32(2.0 * np.pi / 320.0))
    ny = y * float(_F32(2.0 * np.pi / 240.0))
    dx = amp * (torch.sin(nx * 0.9 + t) * torch.cos(ny * 0.7 - t * 0.83)
                + 0.5 * torch.sin(ny * 1.3 + t * 1.19))
    dy = amp * (torch.cos(nx * 1.1 - t * 0.79) * torch.sin(ny * 0.8 + t)
                + 0.5 * torch.cos(nx * 1.7 - t * 1.07))
    return _warp(a, torch.clamp(y + dy, 0, h - 1),
                 torch.clamp(x + dx, 0, w - 1))


_chan_filter("warptv", _warptv,
             params=(Param("amplitude", "num", 0.5, 0.0, 1.0),
                     Param("speed", "num", 0.5, 0.0, 1.0)),
             desc="rubber-sheet wobble (warpTV.c)")


def _targeted_zoom(a, p, c):
    """targeted_zoom.script: zoom about an arbitrary (x, y) point
    (`:373-384`)."""
    h, w = a.shape[-2:]
    z = torch.clamp(_col(p["zoom"], a), min=1.0)
    cy = _col(p["y"], a) * (h - 1)
    cx = _col(p["x"], a) * (w - 1)
    y, x = _axes(a)
    return _warp(a, torch.clamp(cy + (y - cy) / z, 0, h - 1),
                 torch.clamp(cx + (x - cx) / z, 0, w - 1))


_chan_filter("targeted_zoom", _targeted_zoom,
             params=(Param("zoom", "num", 2.0, 1.0, 16.0),
                     Param("x", "num", 0.5, 0.0, 1.0),
                     Param("y", "num", 0.5, 0.0, 1.0)),
             desc="zoom about a point (targeted_zoom.script)")


def _revtv(a, p, c):
    """revTV (the EffecTV Rutt-Etra look): each band of rows draws its
    centre row's luma as a vertical displacement trace (`:390-411`).
    `abs(y - trace_y) <= 1` is a hard select, so the luma and trace_y
    keep the JAX package's operation order to the bit."""
    h = a.shape[-2]
    lum = luma(a[:, :3])
    band_px = max(int(p["linespace"]) * 2, 2)  # static: rows per band x2
    y = torch.arange(h, device=a.device)
    band_base = torch.clamp((y // band_px) * band_px + band_px // 2,
                            0, h - 1)
    l_band = lum[:, :, band_base]                  # luma at band centres
    trace_y = band_base.to(torch.float32)[:, None] \
        - l_band * _p4(p["gain"], a) * float(_F32(band_px))
    lit = (torch.abs(y.to(torch.float32)[:, None] - trace_y) <= 1.0) \
        .to(torch.float32)
    v = lit * (0.3 + 0.7 * l_band)
    return _keep_alpha(v.expand(-1, 3, -1, -1), a)


_chan_filter("revtv", _revtv,
             params=(Param("linespace", "int", 4, 2, 16),
                     Param("gain", "num", 0.9, 0.0, 2.0)),
             desc="waveform scan rows (revTV.script, Rutt-Etra)")
