"""Plain PyTorch versions of every filter, generator and source the cells
run, written from their published formulas and nothing of the program.

Each function takes frames as ``(N, 3, H, W)`` tensors of values in [0, 1]
in the dtype it is given (float32 for the reference, bfloat16 for the
control), and parameters as ``(N, 1, 1, 1)`` tensors of that dtype. The
formulas are LiVES' (simple_blend.c, multi_blends.c, colorkey.c,
plasma.c, the RFX colour scripts) as the repository's README and
BASELINE.md describe them: a filter's result is clamped to [0, 1] where
the filter clamps, a frame enters as u8 / 255 and leaves quantised round
half up, `floor(x * 255 + 0.5)`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INV255 = 1.0 / 255.0
#: BT.601 luma weights
LUMA = (0.299, 0.587, 0.114)


def to_unit(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """u8 frames -> values in [0, 1]: a multiply by 1/255 a channel."""
    return u8.to(dtype) * INV255


def quantise(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> u8, round half up, clamped before the cast."""
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0, 255).to(torch.uint8)


def synthetic(clip: torch.Tensor, frame: torch.Tensor, h: int, w: int
              ) -> torch.Tensor:
    """The synthetic clip source: (N,) int clip ids and frame numbers ->
    (N, 3, h, w) u8. A clip's frame is a gradient set by its id, moved by
    its frame number: with phase = 37 c + 3 f,
    r = floor(x (3 + c mod 5) / 16) + phase,
    g = floor(y (2 + c mod 3) / 8) - 2 phase,
    b = floor((x + y) / 8) + 5 phase, each taken mod 256, in int32; a
    negative id is a black frame."""
    dev = clip.device
    c = clip.to(torch.int32).reshape(-1, 1, 1)
    f = frame.to(torch.int32).reshape(-1, 1, 1)
    x = torch.arange(w, dtype=torch.int32, device=dev).reshape(1, 1, w)
    y = torch.arange(h, dtype=torch.int32, device=dev).reshape(1, h, 1)
    phase = c * 37 + f * 3
    chans = (torch.div(x * (3 + c % 5), 16, rounding_mode="floor") + phase,
             torch.div(y * (2 + c % 3), 8, rounding_mode="floor")
             - phase * 2,
             torch.div(x + y, 8, rounding_mode="floor") + phase * 5)
    out = torch.stack([torch.where(c < 0, 0, v & 0xFF).expand(-1, h, w)
                       for v in chans], 1)
    return out.to(torch.uint8)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    return (LUMA[0] * rgb[:, 0:1] + LUMA[1] * rgb[:, 1:2]
            + LUMA[2] * rgb[:, 2:3])


def _unit(x):
    return torch.clamp(x, 0.0, 1.0)


# -- two-input transitions: a is the comp (track 0), b the track folded in --

def crossfade(a, b, p):
    t = p["amount"]
    return _unit(a * t + b * (1.0 - t))


#: multi_blends.c's modes, fg a over bg b
BLENDS = {
    "blend_add": lambda a, b: a + b,
    "blend_multiply": lambda a, b: a * b,
    "blend_screen": lambda a, b: 1.0 - (1.0 - a) * (1.0 - b),
    "blend_lighten": torch.maximum,
    "blend_difference": lambda a, b: torch.abs(a - b),
    "blend_overlay": lambda a, b: torch.where(
        b <= 0.5, 2.0 * a * b, 1.0 - 2.0 * (1.0 - a) * (1.0 - b)),
}


def blend(mode):
    def fn(a, b, p):
        t = p["amount"]
        return _unit(BLENDS[mode](a, b) * t + b * (1.0 - t))
    return fn


def luma_key(a, b, p):
    """fg keyed over bg where fg's luma passes the threshold, with a soft
    ramp; `invert` swaps the sides."""
    alpha = _unit((luma(a) - p["threshold"]) / (p["softness"] + 1e-4))
    inv = p["invert"]
    alpha = alpha * (1.0 - inv) + (1.0 - alpha) * inv
    return a * alpha + b * (1.0 - alpha)


def chroma_key(a, b, p):
    """fg keyed over bg where fg's chromaticity (r, g over r + g + b) lies
    near the key colour's."""
    s = a[:, 0:1] + a[:, 1:2] + a[:, 2:3] + 1e-4
    r, g = a[:, 0:1] / s, a[:, 1:2] / s
    ks = p["red"] + p["green"] + p["blue"] + 1e-4
    kr, kg = p["red"] / ks, p["green"] / ks
    d = torch.sqrt((r - kr) ** 2 + (g - kg) ** 2)
    alpha = _unit((d - p["tolerance"]) / (p["softness"] + 1e-4))
    return a * alpha + b * (1.0 - alpha)


TRANSITIONS = {"crossfade": crossfade, "luma_key": luma_key,
               "chroma_key": chroma_key,
               **{m: blend(m) for m in BLENDS}}


# -- one-input effects ------------------------------------------------------

def gauss_taps(radius: int) -> np.ndarray:
    """The Gaussian of sigma max(r / 2, 0.5) over 2r + 1 taps, normalised
    in float64, then in float32."""
    sigma = max(radius / 2.0, 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    return k / k.sum()


def gaussian_blur(rgb, p, radius: int):
    """Two separable passes, rows then columns, edges replicated; the
    result mixed with the input by `amount`."""
    taps = [float(t) for t in gauss_taps(radius)]
    n, c, h, w = rgb.shape
    x = rgb.reshape(n * c, 1, h, w)
    xp = F.pad(x, (0, 0, radius, radius), mode="replicate")
    acc = 0
    for i, t in enumerate(taps):
        acc = acc + t * xp[..., i:i + h, :]
    xp = F.pad(acc, (radius, radius, 0, 0), mode="replicate")
    acc = 0
    for i, t in enumerate(taps):
        acc = acc + t * xp[..., :, i:i + w]
    blurred = acc.reshape(n, c, h, w)
    return _unit(rgb + (blurred - rgb) * p["amount"])


def colour_balance(rgb, p, _=None):
    return _unit(torch.cat([rgb[:, 0:1] * p["red"], rgb[:, 1:2] * p["green"],
                            rgb[:, 2:3] * p["blue"]], 1))


def saturation(rgb, p, _=None):
    g = luma(rgb)
    return _unit(g + (rgb - g) * p["saturation"])


def centred_grid(h: int, w: int, dtype, device):
    """(x (1, w), y (h, 1)) pixel centres' coordinates in [-1, 1]."""
    x = torch.arange(w, dtype=dtype, device=device) * (2.0 / max(w - 1, 1))
    y = torch.arange(h, dtype=dtype, device=device) * (2.0 / max(h - 1, 1))
    return (x - 1.0).reshape(1, w), (y - 1.0).reshape(h, 1)


def vignette(rgb, p, _=None):
    h, w = rgb.shape[-2:]
    x, y = centred_grid(h, w, rgb.dtype, rgb.device)
    r2 = x * x + y * y
    falloff = torch.exp(-r2 * p["strength"] * 2.0)
    return _unit(rgb * (1.0 - p["amount"] * (1.0 - falloff)))


def negate(rgb, p, _=None):
    return _unit(1.0 - rgb)


def brightness_contrast(rgb, p, _=None):
    return _unit((rgb - 0.5) * p["contrast"] + 0.5 + p["brightness"])


EFFECTS = {"gaussian_blur": gaussian_blur, "colour_balance": colour_balance,
           "saturation": saturation, "vignette": vignette, "negate": negate,
           "brightness_contrast": brightness_contrast}


# -- generators -------------------------------------------------------------

def unit_grid(h: int, w: int, dtype, device):
    """(x (1, w), y (h, 1)) in [0, 1]: index times 1 / (n - 1) rounded to
    the dtype."""
    x = torch.arange(w, dtype=dtype, device=device) \
        * float(np.float32(1.0 / max(w - 1, 1)))
    y = torch.arange(h, dtype=dtype, device=device) \
        * float(np.float32(1.0 / max(h - 1, 1)))
    return x.reshape(1, w), y.reshape(h, 1)


_PH = 2.0 * math.pi / 3.0
_ROT = tuple(float(np.float32(v)) for v in (math.cos(_PH), math.sin(_PH),
                                             math.cos(2 * _PH),
                                             math.sin(2 * _PH)))


def plasma(tc, p, h: int, w: int):
    """plasma.c: four travelling sine fields summed, mapped to a colour
    wheel. `tc` (N,) seconds; `speed` and `scale` (N, 1, 1, 1). Returns
    (N, 3, h, w) u8."""
    x, y = unit_grid(h, w, tc.dtype, tc.device)
    t = tc.reshape(-1, 1, 1) * p["speed"].reshape(-1, 1, 1) * 3.0
    s = p["scale"].reshape(-1, 1, 1) * 10.0 + 1.0
    v = (torch.sin(x * s + t)
         + torch.sin((y * s + t) * 0.7)
         + torch.sin((x * s + y * s + t) * 0.5)
         + torch.sin(torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) * s * 2.0
                     + t))
    v = v * 0.25
    sv, cv = torch.sin(v * math.pi), torch.cos(v * math.pi)
    c1, s1, c2, s2 = _ROT
    chans = (0.5 + 0.5 * sv, 0.5 + 0.5 * (sv * c1 + cv * s1),
             0.5 + 0.5 * (sv * c2 + cv * s2))
    n = tc.numel()
    return torch.stack([quantise(ch).expand(n, h, w) for ch in chans], 1)


#: the colour bars, left to right: white, yellow, cyan, green, magenta,
#: red, blue, black (r, g, b each full or off)
BARS = ((1, 1, 1), (1, 1, 0), (0, 1, 1), (0, 1, 0), (1, 0, 1), (1, 0, 0),
        (0, 0, 1), (0, 0, 0))


def colour_bars(n: int, h: int, w: int, device) -> torch.Tensor:
    """Eight vertical bars of equal width: column x shows bar
    min(floor(8 x / (w - 1)), 7), its x / (w - 1) rounded to float32 as
    the generators' grid is. Returns (n, 3, h, w) u8."""
    x, _ = unit_grid(h, w, torch.float32, device)
    bar = torch.clamp(torch.floor(x[0] * 8.0), max=7).long()
    table = torch.tensor(BARS, dtype=torch.uint8, device=device) * 255
    cols = table[bar].T                      # (3, w)
    return cols.reshape(1, 3, 1, w).expand(n, 3, h, w).contiguous()
