"""The plain reference of the multi-camera MJPEG export: the clips' frames,
their JPEG coefficients, the decode of those coefficients, the timeline
over the decoded frames, and the forward transform of a timeline frame
into the coefficients a JFIF file holds.

Written from the published formulas and nothing of the program:

- a clip frame is `ops.synthetic`'s gradient plus per-pixel noise drawn
  from a counter-based hash of (seed, clip, frame, channel, row, column),
  integer arithmetic, so every device draws the same frame;
- ITU-T T.81: the 8x8 DCT in its orthonormal form, F = A^T P A with
  A[x, u] = c(u) / 2 cos((2x + 1) u pi / 16), c(0) = 1 / sqrt(2),
  c(u) = 1 otherwise; quantisation by the Annex K tables scaled to a
  quality as the IJG library scales them (`jpeg_quality_scaling`);
  coefficients in natural (raster) order, (vertical, horizontal);
- JFIF 1.02: full-range BT.601 YCbCr, 4:2:0 chroma as the mean of each
  2x2 block, edges replicated to whole blocks;
- the decode: dequantise, the inverse DCT P = A F A^T, the level shift,
  rounding half up and the clamp to [0, 255]; T.81 leaves the inverse
  DCT's rounding to the decoder (within IEEE 1180's accuracy), and here
  a sample is the float64 product rounded once to float32;
- YCbCr 4:2:0 to RGB24 as LiVES' colourspace.c publishes its full-range
  conversion: the chroma upsampled by replication (nearest: each chroma
  sample covers its 2x2 block), then R = Y + 1.402 (Cr - 128),
  G = Y - 0.344136 (Cb - 128) - 0.714136 (Cr - 128), B = Y + 1.772
  (Cb - 128), each floored and clamped (the coefficients 2 (1 - Kr),
  2 Kb (1 - Kb) / Kg, 2 Kr (1 - Kr) / Kg, 2 (1 - Kb) of Kr = 0.299,
  Kb = 0.114).

The decode and the conversion to RGB run in float32, the precision the
configuration states for the timeline: a float64 decode rounds the
samples within float32's spacing of a half otherwise (~4e-6 of them),
and the keys' soft ramps make a one-step difference there several
steps in the rendered frame. The forward transform runs in float64
unless a dtype is given (the control's bfloat16); the timeline runs in
the dtype it is given, with `ops.py`'s filters, as `render.py` runs it.
Before the forward transform's rounding to an integer its result is
snapped to a multiple of 2^-20 (`SNAP`): the exact transform puts many
values on a half (a block whose only frequencies are 0 and 4, as flat
chroma blocks are: the basis is then +-1 / (2 sqrt 2), and a product of
two is 1/8), and float64 computes them a last bit off, on either side;
snapped, they round as the exact values do. The float32 decode needs
no snap: float64's last bit is lost in the rounding to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import ops
from .render import Schedule, _params

#: ITU-T T.81 Annex K, tables K.1 (luminance) and K.2 (chrominance), in
#: natural (raster) order
STD_LUMA = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
STD_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
              99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99) + (99,) * 37

M32 = 0xFFFFFFFF
#: the grid a float64 transform's result is snapped to before it is
#: rounded to an integer
SNAP = 2.0 ** 20


def qtables(quality: int) -> np.ndarray:
    """(2, 64) int64: the luma and chroma tables at `quality`, scaled as
    the IJG library scales them: s = 5000 / q under 50, else 200 - 2q;
    each entry (t s + 50) / 100, floored, within [1, 255]."""
    q = min(100, max(1, int(quality)))
    s = 5000 // q if q < 50 else 200 - 2 * q
    base = np.array([STD_LUMA, STD_CHROMA], np.int64)
    return np.clip((base * s + 50) // 100, 1, 255)


def basis(dtype=torch.float64, device="cpu") -> torch.Tensor:
    """A[x, u] = c(u) / 2 cos((2x + 1) u pi / 16)."""
    a = np.array([[(math.sqrt(0.5) if u == 0 else 1.0) / 2.0
                   * math.cos((2 * x + 1) * u * math.pi / 16)
                   for u in range(8)] for x in range(8)])
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def geometry(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """(rows, columns, block rows, block columns) of Y, Cb and Cr at
    4:2:0."""
    ch, cw = -(-h // 2), -(-w // 2)
    return [(r, c, -(-r // 8), -(-c // 8))
            for r, c in ((h, w), (ch, cw), (ch, cw))]


# -- the clips --------------------------------------------------------------

def _mulmod32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 h in [0, 2^32): in 16-bit halves, so no
    product leaves the int64 range."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix(h):
    """A 32-bit integer hash (xorshift-multiply): tensors or ints."""
    if isinstance(h, int):
        h = (h ^ (h >> 16)) * 0x7FEB352D & M32
        h = (h ^ (h >> 15)) * 0x846CA68B & M32
        return h ^ (h >> 16)
    h = _mulmod32(h ^ (h >> 16), 0x7FEB352D)
    h = _mulmod32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def noise(seed: int, clip: int, frame: int, h: int, w: int, sigma: float,
          device) -> torch.Tensor:
    """(3, h, w) int32 noise of one clip frame: four bytes of a hash of the
    pixel's index under a key of (seed, clip, frame) summed and centred
    (a near-Gaussian of standard deviation 147.8 over [-510, 510]), scaled
    to `sigma` and rounded."""
    key = _mix(_mix(seed & M32) ^ ((seed >> 32) & M32))
    key = _mix(key ^ _mix((clip & M32) * 0x9E3779B1 & M32))
    key = _mix(key ^ _mix((frame & M32) * 0x85EBCA77 & M32))
    idx = torch.arange(3 * h * w, dtype=torch.int64, device=device)
    hv = _mix(_mix((idx + key) & M32) ^ key)
    s = ((hv & 0xFF) + ((hv >> 8) & 0xFF) + ((hv >> 16) & 0xFF)
         + ((hv >> 24) & 0xFF) - 510)
    n = torch.round(s.to(torch.float64) * (sigma / 147.80))
    return n.to(torch.int32).reshape(3, h, w)


def clip_frames(seed: int, clips, frames, h: int, w: int, sigma: float,
                device) -> torch.Tensor:
    """(N, 3, h, w) u8: clip `clips[i]`'s frame `frames[i]`, the synthetic
    gradient plus its noise, clamped."""
    c = torch.as_tensor(list(clips), dtype=torch.int64, device=device)
    f = torch.as_tensor(list(frames), dtype=torch.int64, device=device)
    base = ops.synthetic(c, f, h, w).to(torch.int32)
    n = torch.stack([noise(seed, int(ci), int(fi), h, w, sigma, device)
                     for ci, fi in zip(clips, frames)])
    return torch.clamp(base + n, 0, 255).to(torch.uint8)


# -- the forward transform: RGB -> quantised coefficients ---------------------

def ycbcr(rgb: torch.Tensor, dtype=torch.float64):
    """(N, 3, H, W) u8 -> JFIF full-range Y, Cb, Cr (N, H, W) in
    `dtype`."""
    r, g, b = (rgb[:, i].to(dtype) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    return y, cb, cr


def _pad(p: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edges replicated out to `rows` x `cols`."""
    n, h, w = p.shape
    if rows > h:
        p = torch.cat([p, p[:, -1:].expand(n, rows - h, p.shape[2])], 1)
    if cols > w:
        p = torch.cat([p, p[:, :, -1:].expand(n, rows, cols - w)], 2)
    return p


def _mean2x2(p: torch.Tensor) -> torch.Tensor:
    n, h, w = p.shape
    p = _pad(p, h + h % 2, w + w % 2)
    return p.reshape(n, p.shape[1] // 2, 2, p.shape[2] // 2, 2).mean((2, 4))


def _blocks(p: torch.Tensor, hb: int, wb: int) -> torch.Tensor:
    """(N, h, w) -> (N, hb, wb, 8, 8), edges replicated to whole
    blocks."""
    n = p.shape[0]
    p = _pad(p, hb * 8, wb * 8)
    return p.reshape(n, hb, 8, wb, 8).permute(0, 1, 3, 2, 4)


def _snapped(x: torch.Tensor) -> torch.Tensor:
    """float64 values on the grid of 1 / SNAP."""
    return torch.round(x * SNAP) / SNAP


def forward(rgb: torch.Tensor, quality: int, dtype=torch.float64
            ) -> list[torch.Tensor]:
    """(N, 3, H, W) u8 -> the quantised coefficients of Y, Cb and Cr at
    4:2:0, each (N, hb * wb, 64) int32 in natural order, rounded half to
    even, as a baseline JFIF file holds them. The colour conversion,
    chroma mean, DCT and quantisation in `dtype`."""
    H, W = rgb.shape[-2:]
    y, cb, cr = ycbcr(rgb, dtype)
    planes = (y, _mean2x2(cb), _mean2x2(cr))
    A = basis(dtype, rgb.device)
    qt = torch.from_numpy(qtables(quality)).to(rgb.device)
    out = []
    for k, (p, (_, _, hb, wb)) in enumerate(zip(planes, geometry(H, W))):
        P = _blocks(p, hb, wb) - 128.0
        F = A.T @ P @ A
        q = qt[min(k, 1)].reshape(8, 8).to(dtype)
        out.append(torch.round(_snapped((F / q).to(torch.float64)))
                   .to(torch.int32).reshape(p.shape[0], hb * wb, 64))
    return out


# -- the decode: quantised coefficients -> YCbCr -> RGB ----------------------

def decode(coefs, quality: int, h: int, w: int) -> list[torch.Tensor]:
    """The quantised coefficients of `forward` (or a file's) -> Y, Cb, Cr
    (N, rows, cols) u8: dequantised and inverse DCT in float64, the
    result rounded to float32, the level shift in float32, rounded half
    up, clamped."""
    dev = coefs[0].device
    A = basis(torch.float64, dev)
    qt = torch.from_numpy(qtables(quality)).to(dev, torch.float64)
    out = []
    for k, (co, (rows, cols, hb, wb)) in enumerate(zip(coefs,
                                                       geometry(h, w))):
        n = co.shape[0]
        F = (co.to(torch.float64) * qt[min(k, 1)]).reshape(n, hb, wb, 8, 8)
        P = (A @ F @ A.T).to(torch.float32)
        P = torch.clamp(torch.floor(P + 128.5), 0, 255).to(torch.uint8)
        out.append(P.permute(0, 1, 3, 2, 4).reshape(n, hb * 8, wb * 8)
                   [:, :rows, :cols])
    return out


#: 2 (1 - Kr), 2 Kb (1 - Kb) / Kg, 2 Kr (1 - Kr) / Kg, 2 (1 - Kb) of
#: BT.601's Kr = 0.299, Kb = 0.114
_KR, _KB = 0.299, 0.114
_KG = 1.0 - _KR - _KB
CR_R = 2.0 * (1.0 - _KR)
CB_G = 2.0 * _KB * (1.0 - _KB) / _KG
CR_G = 2.0 * _KR * (1.0 - _KR) / _KG
CB_B = 2.0 * (1.0 - _KB)


def ycbcr420_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
                    ) -> torch.Tensor:
    """Full-range Y (N, H, W) and 4:2:0 Cb, Cr -> (N, 3, H, W) u8, in
    float32 (the coefficients rounded to float32, each product and sum
    rounded in turn): chroma replicated over its 2x2 block, each channel
    floored and clamped."""
    H, W = y.shape[-2:]

    def up(c):
        c = c.repeat_interleave(2, -2).repeat_interleave(2, -1)
        return c[:, :H, :W].to(torch.float32) - 128.0

    def k(c):
        return torch.tensor(c, dtype=torch.float32, device=y.device)
    yy, u, v = y.to(torch.float32), up(cb), up(cr)
    rgb = torch.stack([yy + v * k(CR_R), yy - u * k(CB_G) - v * k(CR_G),
                       yy + u * k(CB_B)], 1)
    return torch.clamp(torch.floor(rgb), 0, 255).to(torch.uint8)


def decoded(coefs, quality: int, h: int, w: int) -> torch.Tensor:
    """(N, 3, h, w) u8: the frames a player shows of these
    coefficients."""
    return ycbcr420_to_rgb(*decode(coefs, quality, h, w))


# -- the timeline over decoded clips -----------------------------------------

def timeline(sched: Schedule, js, track, dtype=torch.float32
             ) -> torch.Tensor:
    """(N, 3, H, W) u8: timeline frames `js` (one segment, arrangement 0)
    with track t's frames `track(t, js)` ((N, 3, H, W) u8): the
    transitions folding tracks 1.. into track 0, the effects, the sink's
    quantise, in `dtype` (`render.py`'s order and parameters)."""
    js = [int(j) for j in js]
    comp = ops.to_unit(track(0, js), dtype)
    dev = comp.device
    for t in range(1, sched.n_tracks):
        name = sched.transition_at(t, 0)
        comp = ops.TRANSITIONS[name](comp, ops.to_unit(track(t, js), dtype),
                                     _params(sched, name, js, dtype, dev))
    for name, static in sched.effects:
        p = _params(sched, name, js, dtype, dev)
        comp = (ops.gaussian_blur(comp, p, int(static["radius"]))
                if name == "gaussian_blur" else ops.EFFECTS[name](comp, p))
    return ops.quantise(comp)
