"""Blend and transition filters.

Counterpart of `lives_tpu/effects/builtin/blends.py` (reference
`simple_blend.c`, `multi_blends.c`, `slide_over.c`, `layout_blends.c`,
`multi_transitions.c`, `gdk/compositor.c`), every filter of that module:

- `crossfade` and the `_BLEND_MODES` table (`:22-74`);
- the coordinate transitions `wipe`, `iris_circle`, `iris_rectangle`,
  `dissolve` and `rand_replace` (`:79-136,251-345`), which read their frame
  coordinates through `effects.util.ctx_grid` or `_pixel_hash`, so a band
  or tile gets the whole frame's pixels;
- `chroma_blend` and the luma-threshold overlays (`:407-445`);
- `picture_in_picture`, `grid4`, `slide_over`, `compositor`,
  `averaged_luma_overlay` and `triple_split`, which gather, resize or
  average over neighbours and so run on the plain route only.

The fused sweep kernel's vocabulary holds every filter of the first three
groups (`graph/fused_sweep.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...constants import Palette
from ..host import (ChannelTemplate, FILTER_IS_TRANSITION, Filter, Param,
                    register_filter)
from ..util import (bilinear, bparam, ctx_grid, from_f01, join_alpha,
                    luma, split_alpha, to_f01)

_RGBX = (Palette.RGB24, Palette.RGBA32)
_TWO_IN = (ChannelTemplate("fg", _RGBX), ChannelTemplate("bg", _RGBX))
_AMOUNT0 = Param("amount", "num", 0.0, 0.0, 1.0)
_SOFTNESS = Param("softness", "num", 0.05, 0.0, 0.5)
_DIRECTION = Param("direction", "string_list", 0,
                   choices=("left", "right", "top", "bottom"))


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
#: number (csrc/sweep_common.cuh `blend_op`)
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


# -- masked transitions: fg where the mask is 1, bg where it is 0, no clip --

def _masked(name, mask, params, desc):
    """A transition `fg * m + bg * (1 - m)` with the per-pixel mask
    `mask(argb, params, ctx)`, fg's alpha kept (`blends.py:91-100`)."""
    def process(ins, p, ctx):
        fg, bg = ins[0], ins[1]
        argb, aal = split_alpha(to_f01(fg))
        brgb, _ = split_alpha(to_f01(bg))
        m = mask(argb, p, ctx)
        out = argb * m + brgb * (1.0 - m)
        return from_f01(join_alpha(out, aal), fg)

    return register_filter(Filter(
        name=name, process=process, in_channels=_TWO_IN, params=params,
        flags=FILTER_IS_TRANSITION, description=desc))


#: wipe's masks by direction: 1 where fg shows (`blends.py:79-90`)
_EDGES = (lambda xx, yy, pos: xx < pos,          # left -> right
          lambda xx, yy, pos: (1.0 - xx) < pos,  # right -> left
          lambda xx, yy, pos: yy < pos,          # top -> bottom
          lambda xx, yy, pos: (1.0 - yy) < pos)  # bottom -> top


def _wipe_mask(argb, p, ctx):
    h, w = argb.shape[-2:]
    xx, yy = ctx_grid(ctx, h, w, device=argb.device)
    # direction is a static (non-interpolated) choice
    return _EDGES[int(p.get("direction", 0))](
        xx, yy, bparam(p["amount"])).to(torch.float32)


_masked("wipe", _wipe_mask, (_AMOUNT0, _DIRECTION),
        "hard-edged directional wipe")


def _iris_mask(argb, p, ctx):
    h, w = argb.shape[-2:]
    fh, fw = (ctx.height or h), (ctx.width or w)
    x, y = ctx_grid(ctx, h, w, centered=True, device=argb.device)
    x = x * (fw / fh)
    r = torch.sqrt(x * x + y * y)
    # the JAX package's float64 radius enters its float32 product as
    # float32
    rmax = np.float32(np.sqrt(1.0 + (fw / fh) ** 2))
    soft = bparam(p["softness"]) + 1e-4
    return torch.clamp((bparam(p["amount"]) * rmax - r) / soft + 0.5, 0.0,
                       1.0)


_masked("iris_circle", _iris_mask, (_AMOUNT0, _SOFTNESS),
        "circular iris wipe")


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 values they wrap to."""
    v = v & 0xFFFFFFFF
    return v - ((v & 0x80000000) << 1)


def _pixel_hash(ctx, h: int, w: int, salt=None, *,
                device: torch.device | str) -> torch.Tensor:
    """Deterministic per-pixel uniform field in [0,1) from full-frame
    integer coordinates (tile-origin aware, clamped to the frame),
    optionally salted per frame (`blends.py:251-272`): (h, w), or
    (B, 1, h, w) for a (B,) salt. An integer hash with int32 wraparound,
    computed in int64 and wrapped after every multiply, so it is exact on
    every device; `>>` shifts arithmetically, as on int32."""
    H, W = int(ctx.height or h), int(ctx.width or w)
    iy = torch.clamp(torch.arange(h, device=device) + int(ctx.y0), 0, H - 1)
    ix = torch.clamp(torch.arange(w, device=device) + int(ctx.x0), 0, W - 1)
    v = _wrap32(ix[None, :] * 73856093) ^ _wrap32(iy[:, None] * 19349663)
    if salt is not None:
        s = torch.as_tensor(salt, device=device).to(torch.int64)
        v = v ^ _wrap32(bparam(s) * 83492791)
    # murmur-style finalizer
    v = _wrap32((v ^ (v >> 13)) * 0x5BD1E995)
    v = v ^ (v >> 15)
    return (v & 0xFFFF).to(torch.float32) * np.float32(1 / 65536)


def _dissolve_mask(argb, p, ctx):
    """multi_transitions.c "dissolve": a fixed random per-pixel threshold;
    pixels switch fg -> bg in a stable random order as amount rises."""
    h, w = argb.shape[-2:]
    return (_pixel_hash(ctx, h, w, device=argb.device)
            >= bparam(p["amount"])).to(torch.float32)


_masked("dissolve", _dissolve_mask, (_AMOUNT0,),
        "random-pixel dissolve (multi_transitions.c)")


def _rand_replace_mask(argb, p, ctx):
    """multi_transitions.c "rand replace": like dissolve but the random
    field re-rolls every frame, salted by the frame number."""
    h, w = argb.shape[-2:]
    return (_pixel_hash(ctx, h, w, ctx.frame, device=argb.device)
            >= bparam(p["amount"])).to(torch.float32)


_masked("rand_replace", _rand_replace_mask, (_AMOUNT0,),
        "per-frame random replace (multi_transitions.c)")


def _iris_rect_mask(argb, p, ctx):
    """multi_transitions.c "iris rectangle": an expanding centred
    rectangle (the Chebyshev-distance analogue of iris_circle)."""
    h, w = argb.shape[-2:]
    x, y = ctx_grid(ctx, h, w, centered=True, device=argb.device)
    r = torch.maximum(torch.abs(x), torch.abs(y))
    soft = bparam(p["softness"]) + 1e-4
    return torch.clamp((bparam(p["amount"]) - r) / soft + 0.5, 0.0, 1.0)


_masked("iris_rectangle", _iris_rect_mask, (_AMOUNT0, _SOFTNESS),
        "rectangular iris wipe (multi_transitions.c)")


# -- simple_blend.c: chroma blend and the luma-threshold overlays ------------

def _luma_select(kind):
    """The luma-threshold overlay family: a per-pixel hard select between
    fg and bg driven by a luma comparison (`blends.py:407-434`)."""
    def fn(a, b, p):
        t = bparam(p["amount"])
        if kind == "overlay":          # luma(fg) < t -> bg
            m = luma(a) < t
        elif kind == "underlay":       # luma(bg) > 1-t -> bg
            m = luma(b) > 1.0 - t
        elif kind == "negative":       # luma(fg) > 1-t -> bg
            m = luma(a) > 1.0 - t
        else:                          # averaged: 3x3 mean luma(fg) < t
            g = luma(a)
            gp = F.pad(g, (1, 1, 1, 1), mode="replicate")
            h, w = g.shape[-2:]
            avg = sum(gp[..., dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)) / 9.0
            m = avg < t
        m = m.to(torch.float32)
        return b * m + a * (1.0 - m)

    return fn


def _chroma_blend(a, b, p):
    t = bparam(p["amount"])
    return a * (1.0 - t) + b * t


_mk_transition("chroma_blend", _chroma_blend,
               desc="per-channel table mix (simple_blend.c chroma blend)")
_mk_transition("luma_overlay", _luma_select("overlay"),
               desc="bg where fg luma < t (simple_blend.c)")
_mk_transition("luma_underlay", _luma_select("underlay"),
               desc="bg where bg luma bright (simple_blend.c)")
_mk_transition("negative_luma_overlay", _luma_select("negative"),
               desc="bg where fg luma > 1-t (simple_blend.c)")
_mk_transition("averaged_luma_overlay", _luma_select("averaged"),
               desc="bg where 3x3 mean fg luma < t (simple_blend.c)")


# -- the plain-route transitions: gathers, resizes, neighbourhoods ------------

def _pip_process(ins, params, ctx):
    """gdk/compositor.c essence: fg scaled and pasted over bg at (x, y)
    (`blends.py:139-170`). A traced scale takes 0.5, as in the JAX package
    (its geometry must be static)."""
    from ...ops.resize import resize_layer
    fg, bg = ins[0], ins[1]
    brgb, bal = split_alpha(to_f01(bg))
    h, w = brgb.shape[-2:]
    scale = params["scale"]
    scale = 0.5 if isinstance(scale, torch.Tensor) else float(scale)
    sw, sh = max(2, int(w * scale)), max(2, int(h * scale))
    srgb, _ = split_alpha(to_f01(resize_layer(fg, sw, sh)))
    B = brgb.shape[0]
    ox = torch.clamp(torch.as_tensor(params["x"]) * (w - sw), 0,
                     w - sw).to(torch.int32).expand(B).tolist()
    oy = torch.clamp(torch.as_tensor(params["y"]) * (h - sh), 0,
                     h - sh).to(torch.int32).expand(B).tolist()
    out = brgb.clone()
    for b in range(B):
        out[b, :, oy[b]:oy[b] + sh, ox[b]:ox[b] + sw] = srgb[b]
    return from_f01(join_alpha(out, bal), bg)


register_filter(Filter(
    name="picture_in_picture", process=_pip_process, in_channels=_TWO_IN,
    params=(Param("scale", "num", 0.5, 0.05, 1.0),
            Param("x", "num", 1.0, 0.0, 1.0),
            Param("y", "num", 0.0, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="scale fg and paste over bg at (x,y)"))


def _grid4_process(ins, params, ctx):
    """2x2 grid of up to four tracks (layout_blends.c quad view)."""
    from ...ops.resize import resize_layer
    base = ins[0]
    h, w = base.height, base.width
    hh, hw = max(2, h // 2), max(2, w // 2)
    cells = [to_f01(resize_layer(ins[i] if i < len(ins) else ins[-1], hw,
                                 hh))[:, :3] for i in range(4)]
    grid = torch.cat([torch.cat(cells[:2], -1), torch.cat(cells[2:], -1)],
                     -2)
    # pad odd geometries back to full size
    ph, pw = h - grid.shape[-2], w - grid.shape[-1]
    if ph or pw:
        grid = F.pad(grid, (0, pw, 0, ph), mode="replicate")
    _, al = split_alpha(to_f01(base))
    return from_f01(join_alpha(grid, al), base)


register_filter(Filter(
    name="grid4", process=_grid4_process,
    in_channels=tuple(ChannelTemplate(f"in{i}", _RGBX, optional=i > 0)
                      for i in range(4)),
    flags=FILTER_IS_TRANSITION,
    description="2x2 grid of four tracks (layout_blends.c)"))


def _roll(a: torch.Tensor, shift: torch.Tensor, dim: int) -> torch.Tensor:
    """`a` (B, C, H, W) rolled by a (B,) shift along `dim`, as jnp.roll
    rolls each frame: out[i] = a[(i - shift) mod n]."""
    n = a.shape[dim]
    i = torch.arange(n, device=a.device)
    idx = torch.remainder(i[None, :] - shift[:, None], n)   # (B, n)
    shape = [a.shape[0], 1, 1, 1]
    shape[dim] = n
    return torch.gather(a, dim, idx.reshape(shape).expand_as(a))


def _slide_over_process(ins, params, ctx):
    """slide_over.c: fg slides in over bg from one side
    (`blends.py:193-230`)."""
    fg, bg = ins[0], ins[1]
    argb, aal = split_alpha(to_f01(fg))
    brgb, _ = split_alpha(to_f01(bg))
    B, _, h, w = argb.shape
    amt = torch.clamp(torch.as_tensor(params["amount"], dtype=torch.float32,
                                      device=argb.device), 0.0, 1.0)
    amt = amt.expand(B)
    d = int(params.get("direction", 0))
    n, dim = (w, 3) if d < 2 else (h, 2)
    coord = torch.arange(n, device=argb.device)[None, :]
    ofs = torch.round((1.0 - amt) * n).to(torch.int64)
    if d in (0, 2):    # from left / top: fg content right-aligned
        fgs = _roll(argb, -ofs, dim)
        mask = coord < torch.round(amt * n).to(torch.int64)[:, None]
    else:              # from right / bottom
        fgs = _roll(argb, ofs, dim)
        mask = coord >= torch.round((1.0 - amt) * n).to(torch.int64)[:, None]
    m = mask.to(torch.float32)
    m = m[:, None, None, :] if dim == 3 else m[:, None, :, None]
    out = fgs * m + brgb * (1.0 - m)
    return from_f01(join_alpha(out, aal), fg)


register_filter(Filter(
    name="slide_over", process=_slide_over_process, in_channels=_TWO_IN,
    params=(_AMOUNT0, _DIRECTION),
    flags=FILTER_IS_TRANSITION,
    description="fg slides in over bg (slide_over.c)"))


def _compositor_process(ins, p, ctx):
    """gdk/compositor.c: up to four inputs, each placed at (x, y) scaled by
    (sx, sy) with its own alpha, composited in z order (revz reverses) over
    a background colour; placement is inverse bilinear sampling
    (`blends.py:348-400`)."""
    base = ins[0]
    a0 = to_f01(base)
    _, aal = split_alpha(a0)
    B, _, h, w = a0.shape
    dev = a0.device
    y_t, x_t = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                           device=dev),
                              torch.arange(w, dtype=torch.float32,
                                           device=dev), indexing="ij")

    def pv(name):  # a per-frame parameter as (B, 1, 1)
        return torch.as_tensor(p[name], dtype=torch.float32,
                               device=dev).reshape(-1, 1, 1).expand(B, 1, 1)

    acc = torch.stack([pv("bg_red"), pv("bg_green"), pv("bg_blue")],
                      1).expand(B, 3, h, w)
    order = range(len(ins))
    if int(p.get("revz", 0)):
        order = reversed(list(order))
    for i in order:
        src, _ = split_alpha(to_f01(ins[i]))
        sx = torch.clamp(pv(f"sx{i}"), min=1e-3)
        sy = torch.clamp(pv(f"sy{i}"), min=1e-3)
        u = (x_t - pv(f"x{i}") * w) / sx
        v = (y_t - pv(f"y{i}") * h) / sy
        inside = ((u >= 0) & (u <= w - 1) & (v >= 0)
                  & (v <= h - 1)).to(torch.float32)
        sampled = bilinear(src, torch.clamp(v, 0, h - 1),
                           torch.clamp(u, 0, w - 1))
        m = (inside * torch.clamp(pv(f"alpha{i}"), 0.0, 1.0))[:, None]
        acc = acc * (1.0 - m) + sampled * m
    return from_f01(join_alpha(torch.clamp(acc, 0.0, 1.0), aal), base)


register_filter(Filter(
    name="compositor", process=_compositor_process,
    in_channels=tuple(ChannelTemplate(f"in{i}", _RGBX, optional=i > 0)
                      for i in range(4)),
    params=tuple(
        Param(f"{k}{i}", "num", d, lo, hi)
        for i in range(4)
        for k, d, lo, hi in (("x", 0.25 * (i % 2), -1.0, 1.0),
                             ("y", 0.25 * (i // 2), -1.0, 1.0),
                             ("sx", 0.5, 0.01, 4.0),
                             ("sy", 0.5, 0.01, 4.0),
                             ("alpha", 1.0, 0.0, 1.0)))
    + (Param("bg_red", "num", 0.0, 0.0, 1.0),
       Param("bg_green", "num", 0.0, 0.0, 1.0),
       Param("bg_blue", "num", 0.0, 0.0, 1.0),
       Param("revz", "int", 0, 0, 1)),
    flags=FILTER_IS_TRANSITION,
    description="4-input geometric compositor (gdk/compositor.c)"))


def _triple_split_process(ins, p, ctx):
    """layout_blends.c "triple split": three tracks side by side at
    boundaries xstart/xend (sym centres them), vertical or horizontal, with
    a coloured border band of half-width bw (`blends.py:448-490`)."""
    argb, aal = split_alpha(to_f01(ins[0]))
    srcs = [argb] + [split_alpha(to_f01(ins[i] if i < len(ins)
                                        else ins[-1]))[0] for i in (1, 2)]
    B, _, h, w = argb.shape
    xs, xe = bparam(p["xstart"]), bparam(p["xend"])
    sym = torch.as_tensor(bparam(p["sym"])) > 0.5
    xs = torch.where(sym, xs / 2.0, xs)
    xe = torch.where(sym, 1.0 - xs, xe)
    lo, hi = torch.minimum(xs, xe), torch.maximum(xs, xe)
    vert = int(p.get("vert", 0))
    n = h if vert else w
    t = torch.arange(n, dtype=torch.float32, device=argb.device) \
        / np.float32(max(n - 1, 1))
    t = t.reshape(1, 1, n, 1) if vert else t.reshape(1, 1, 1, n)
    out = torch.where(t < lo, srcs[0], torch.where(t < hi, srcs[1], srcs[2]))
    bw = bparam(p["bw"])
    border = (torch.abs(t - lo) < bw) | (torch.abs(t - hi) < bw)
    bc = torch.cat([torch.as_tensor(bparam(p[k]), dtype=torch.float32,
                                    device=argb.device).reshape(-1, 1, 1, 1)
                    .expand(B, 1, 1, 1)
                    for k in ("border_r", "border_g", "border_b")], 1)
    out = torch.where(border, bc, out)
    return from_f01(join_alpha(out, aal), ins[0])


register_filter(Filter(
    name="triple_split", process=_triple_split_process,
    in_channels=tuple(ChannelTemplate(f"in{i}", _RGBX, optional=i > 0)
                      for i in range(3)),
    params=(Param("xstart", "num", 0.33, 0.0, 1.0),
            Param("sym", "num", 0.0, 0.0, 1.0),
            Param("xend", "num", 0.67, 0.0, 1.0),
            Param("vert", "int", 0, 0, 1),
            Param("bw", "num", 0.0, 0.0, 0.1),
            Param("border_r", "num", 0.0, 0.0, 1.0),
            Param("border_g", "num", 0.0, 0.0, 1.0),
            Param("border_b", "num", 0.0, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="three tracks side by side (layout_blends.c triple split)"))
