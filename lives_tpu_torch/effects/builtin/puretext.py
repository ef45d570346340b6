"""puretext — animated text modes (gdk/puretext.c).

Counterpart of `lives_tpu/effects/builtin/puretext.py:1-257`: the seven op
modes of the reference's text animator (PT_SPIRAL_TEXT ... PT_BOUNCE,
puretext.c:89-98) as a sprite compositor.

- Host, cached: `_text_atlas` rasterises each glyph once with PIL into a
  square cell (16 rotations of each for spinning_letters) and lays the
  text out word-wrapped and centred; `_hash01` gives each letter its two
  random numbers. Both are copies of the JAX package's.
- Device, each frame: every letter's position, visibility and rotation is
  a closed form in the timecode (`positions`), then the letters are
  blended onto the frame one after another in index order, the order of
  the JAX package's `lax.scan`, so overlapping letters blend alike. A
  letter is one gather of its cell from each frame, the blend, and one
  scatter back; nothing is read back to the host.

A letter's cell lands where its float position truncates to, so an ulp of
position moves it a pixel. The positions are therefore computed as the
JAX package's jitted plan computes them, from eager float32 and integer
operations that round alike on the CPU and a GPU: `utils.sinf` and
`utils.sinf.cosf` are the C library's `sinf` and `cosf` that XLA's CPU
backend calls, `utils.xla_exp.expf` is XLA's own `exp`, and `fma32` stands
where XLA's code generator contracts a multiply and an add into one FMA.

The filter is deferred (`effects.host.DEFERRED`, ROADMAP Queue 3): the JAX
plan contracts spiral_text's `i * 0.55 - t * 0.6` and spinning_letters'
`t * 1.5 + i * 0.13` into an FMA only in the vector lanes of a letter loop
that LLVM keeps rather than unrolls, which depends on the letter count,
the batch size and the fusion (`tools/puretext_positions.py` measures
it). The forms here are those of an unrolled loop, exact below 56
letters, so `FILTER` stays out of the registry until the rest is matched.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...constants import Palette
from ...utils.sinf import cosf, sinf
from ...utils.xla_exp import expf, fma32
from ..host import ChannelTemplate, Filter, Param
from ..util import from_f01, join_alpha, per_frame, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)
_F32 = np.float32

MODES = ("spiral_text", "spinning_letters", "letter_starfield",
         "word_coalesce", "terminal", "word_slide", "bounce")
_N_ROT = 16  # rotation variants for spinning_letters


def _hash01(i: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic [0,1) per-letter hash (host-side, numpy)."""
    v = (i.astype(np.int64) * 73856093) ^ (salt * 19349663)
    v = ((v ^ (v >> 13)) * 0x5BD1E995) & 0xFFFFFFFF
    v = v ^ (v >> 15)
    return (v & 0xFFFF).astype(np.float32) / 65536.0


@functools.lru_cache(maxsize=16)
def _text_atlas(text: str, size: int, w: int, h: int, rotations: bool):
    """Glyph atlas + layout for `text` at font `size` in a w*h frame.

    Returns (atlas (N,K,c,c) f32 masks, lx, ly, word_idx, line_idx) as
    numpy arrays; positions are letter-cell top-left for the line-wrapped
    centred layout. Spaces advance the cursor but emit no sprite.
    """
    # headroom so rotations never clip, capped so the sprite always fits
    # inside the frame
    cell = min(max(8, int(size * 1.6)), h, w)
    size = min(size, max(4, int(cell / 1.6)))
    text = text[:256] or "?"
    try:
        from PIL import Image, ImageDraw, ImageFont
        try:
            font = ImageFont.truetype(
                "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf", size)
        except Exception:
            font = ImageFont.load_default()

        def raster(ch):
            img = Image.new("L", (cell, cell), 0)
            d = ImageDraw.Draw(img)
            try:
                bb = d.textbbox((0, 0), ch, font=font)
                ox = (cell - (bb[2] - bb[0])) // 2 - bb[0]
                oy = (cell - (bb[3] - bb[1])) // 2 - bb[1]
            except Exception:
                ox = oy = cell // 4
            d.text((ox, oy), ch, fill=255, font=font)
            return img
    except Exception:  # PIL-less fallback: filled blocks
        Image = None

        def raster(ch):
            a = np.zeros((cell, cell), np.uint8)
            a[cell // 4: 3 * cell // 4, cell // 4: 3 * cell // 4] = 255
            return a

    adv = int(size * 0.62)          # monospacedish advance
    line_h = int(size * 1.25)
    max_cols = max(1, (w - cell) // adv)

    # word-wrapped layout
    glyphs, lx, ly, widx, lidx = [], [], [], [], []
    col = line = word = 0
    for ch in text:
        if ch == "\n":
            line += 1; col = 0; word += 1
            continue
        if ch == " ":
            col += 1
            if col >= max_cols:
                line += 1; col = 0
            word += 1
            continue
        if col >= max_cols:
            line += 1; col = 0
        glyphs.append(ch)
        lx.append(col * adv)
        ly.append(line * line_h)
        widx.append(word)
        lidx.append(line)
        col += 1
    if not glyphs:
        glyphs, lx, ly, widx, lidx = ["?"], [0], [0], [0], [0]
    n_lines = line + 1
    # centre the block
    lx = np.asarray(lx, np.float32)
    ly = np.asarray(ly, np.float32)
    for li in range(n_lines):
        sel = np.asarray(lidx) == li
        if sel.any():
            lx[sel] += (w - (lx[sel].max() + adv)) / 2.0 - lx[sel].min() / 2.0
    ly += (h - n_lines * line_h) / 2.0

    K = _N_ROT if rotations else 1
    atlas = np.zeros((len(glyphs), K, cell, cell), np.float32)
    for gi, ch in enumerate(glyphs):
        img = raster(ch)
        if K == 1 or Image is None:
            base = np.asarray(img, np.float32) / 255.0
            atlas[gi, :] = base[None]
        else:
            for k in range(K):
                rot = img.rotate(k * 360.0 / K, resample=Image.BILINEAR)
                atlas[gi, k] = np.asarray(rot, np.float32) / 255.0
    return (atlas, lx, ly, np.asarray(widx, np.float32),
            np.asarray(lidx, np.float32))


@functools.lru_cache(maxsize=16)
def _atlas_on(text: str, size: int, w: int, h: int, rotations: bool,
              device: str):
    """`_text_atlas` and the letters' hashes as device tensors: (atlas,
    lx, ly, widx, rnd, rnd2, cos(ang), sin(ang)) with ang = rnd * 2 pi in
    float32. XLA folds the starfield's angles, constants of the plan, at
    compile time, where its sine and cosine are the float64 functions
    rounded to float32; so do these."""
    atlas, lx, ly, widx, _ = _text_atlas(text, size, w, h, rotations)
    idx = np.arange(atlas.shape[0])
    rnd = _hash01(idx, 11)
    ang = (rnd * _F32(2 * np.pi)).astype(np.float64)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (atlas, lx, ly, widx, rnd, _hash01(idx, 97),
                           np.cos(ang).astype(np.float32),
                           np.sin(ang).astype(np.float32)))


def _mod(x: torch.Tensor, m: float = 1.0) -> torch.Tensor:
    """`jnp.mod(x, m)` for m > 0: the C library's fmod, plus m where
    negative."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _smooth(s: torch.Tensor) -> torch.Tensor:
    return s * s * (3.0 - 2.0 * s)


def _fold(*factors) -> float:
    """The float32 constant XLA folds a chain of constant factors into,
    multiplied left to right in float32."""
    out = _F32(factors[0])
    for f in factors[1:]:
        out = _F32(out * _F32(f))
    return float(out)


def positions(mode: int, t, speed, consts, n: int, w: int, h: int,
              cell: int):
    """Each letter's (px, py, alpha, variant in [0, 1)) float32, (B, n),
    from (B, 1) t and speed (`puretext.py:155-195`), rounded as the jitted
    plan rounds them. XLA's simplifier turns a division by a constant into
    a product with its float32 reciprocal and folds the constant factors
    of a product into one (`_fold`); its code generator contracts the
    multiply-adds the plan's position sums end in (`fma32`)."""
    lx, ly, widx, rnd, rnd2, cos_ang, sin_ang = consts
    dev = lx.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    cx, cy = float(_F32((w - cell) / 2.0)), float(_F32((h - cell) / 2.0))
    one = torch.ones_like(i).expand(t.shape[0], n)
    var = torch.zeros_like(one)
    ts = t * speed
    if mode == 0:      # spiral_text (puretext.c:2048 Archimedean unwind)
        prog = torch.clamp(ts * 0.25, 0.0, 1.0)
        theta = i * float(_F32(0.55)) - ts * float(_F32(0.6))
        r = (i + 3.0) * _fold(_F32(1) / _F32(n + 3), min(w, h), 0.45) * prog
        px = fma32(r, cosf(theta), cx)
        py = fma32(r, sinf(theta), cy)
        alpha = one * (prog > i * float(_F32(1) / _F32(n + 1)))
    elif mode == 1:    # spinning_letters (puretext.c:1952): layout + rot
        px, py = lx.expand_as(one), ly.expand_as(one)
        alpha = one
        var = _mod(ts * 1.5 + i * float(_F32(0.13)))
    elif mode == 2:    # letter_starfield (puretext.c:1614): radial fly-out
        d = _mod(ts * float(_F32(0.4)) + rnd2)
        rad = d * _fold(min(w, h), 0.7)
        px = fma32(cos_ang, rad, cx)
        py = fma32(sin_ang, rad, cy)
        alpha = torch.clamp(d * 4.0, 0.0, 1.0) \
            * torch.clamp((1.0 - d) * 4.0, 0.0, 1.0)
    elif mode == 3:    # word_coalesce (puretext.c:1248): random -> layout
        off = -(widx * float(_F32(0.35)))
        s = _smooth(torch.clamp(ts * float(_F32(0.8)) + off, 0.0, 1.0))
        px = fma32(lx, s, rnd * float(w - cell) * (1.0 - s))
        py = fma32(ly, s, rnd2 * float(h - cell) * (1.0 - s))
        alpha = torch.clamp(ts * float(_F32(0.8)) + off + float(_F32(0.3)),
                            0.0, 1.0)
    elif mode == 4:    # terminal (puretext.c:1746): typed reveal
        px, py = lx.expand_as(one), ly.expand_as(one)
        alpha = (i < ts * 8.0).to(torch.float32)
    elif mode == 5:    # word_slide (puretext.c:1346): words slide in
        s = _smooth(torch.clamp(ts * float(_F32(1.2)) - widx * 0.5,
                                0.0, 1.0))
        side = torch.where(_mod(widx, 2.0) < 1.0, -float(cell) * 2.0,
                           float(w) + cell)
        px = fma32(lx, s, side * (1.0 - s))
        py = ly.expand_as(one)
        alpha = (s > 0.0).to(torch.float32)
    else:              # bounce (puretext.c:1453): damped vertical bounce
        px = lx.expand_as(one)
        phase = rnd * float(_F32(np.pi))
        amp = expf(-t * float(_F32(0.45))) * float(h * 0.5)
        py = fma32(-torch.abs(cosf(ts * 3.0 + phase)), amp, ly)
        alpha = one
    return px, py, alpha, var


def letters(mode: int, t, speed, atlas_on, w: int, h: int):
    """(pxi, pyi, vki) int64 and alpha float32, each (B, n): every
    letter's cell origin, rotation and opacity, as the compositor takes
    them (`puretext.py:219-226`)."""
    atlas = atlas_on[0]
    n, K, cell, _ = atlas.shape
    px, py, alpha, var = positions(mode, t, speed, atlas_on[1:], n, w, h,
                                   cell)
    # letters fully outside the frame vanish instead of clamping at edges
    inside = ((px > -cell) & (px < w) & (py > -cell) & (py < h)) \
        .to(torch.float32)
    pxi = torch.clamp(px.to(torch.int32), 0, w - cell).to(torch.int64)
    pyi = torch.clamp(py.to(torch.int32), 0, h - cell).to(torch.int64)
    vki = torch.clamp((var * K).to(torch.int32), 0, K - 1).to(torch.int64)
    return pxi, pyi, vki, alpha * inside


def _puretext_process(ins, p, ctx):
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    B, _, h, w = rgb.shape
    dev = rgb.device
    mode = int(p["mode"])
    atlas_on = _atlas_on(str(p["text"]), max(8, int(p["size"])), w, h,
                         mode == 1, str(dev))
    atlas = atlas_on[0]
    n, K, cell, _ = atlas.shape
    t = per_frame(ctx.tc, dev).reshape(-1, 1)
    speed = per_frame(p["speed"], dev).reshape(-1, 1)
    pxi, pyi, vki, alpha = letters(mode, t, speed, atlas_on, w, h)
    Bk = max(B, pxi.shape[0])
    pxi, pyi, vki, alpha = (v.expand(Bk, n) for v in (pxi, pyi, vki, alpha))
    colour = torch.stack(torch.broadcast_tensors(
        *(per_frame(p[c], dev) for c in ("red", "green", "blue"))), 1) \
        .reshape(-1, 3, 1)
    canvas = rgb.expand(Bk, 3, h, w).reshape(Bk, 3, h * w).clone()
    offs = torch.arange(cell, device=dev)
    flat_atlas = atlas.reshape(n * K, cell * cell)
    for j in range(n):
        at = ((pyi[:, j, None, None] + offs[:, None]) * w
              + pxi[:, j, None, None] + offs).reshape(Bk, 1, cell * cell)
        at = at.expand(Bk, 3, cell * cell)
        sprite = flat_atlas[j * K + vki[:, j]]              # (Bk, c*c)
        m = (sprite * alpha[:, j, None])[:, None]
        patch = torch.gather(canvas, 2, at)
        canvas.scatter_(2, at, patch * (1.0 - m) + colour * m)
    out = canvas.reshape(Bk, 3, h, w)
    return from_f01(join_alpha(out, al), lay)


#: the filter, not registered (see the module's docstring)
FILTER = Filter(
    name="puretext", process=_puretext_process, in_channels=_ONE_IN,
    params=(Param("text", "string", "pure text"),
            Param("mode", "string_list", 4, choices=MODES),
            Param("size", "int", 48, 8, 200),
            Param("speed", "num", 1.0, 0.05, 10.0),
            Param("red", "num", 1.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0)),
    description="animated text over video: 7 motion modes "
                "(gdk/puretext.c PT_* op modes)")
