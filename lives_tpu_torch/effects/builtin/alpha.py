"""Alpha-channel producers and consumers: the cconx filter family.

Counterpart of `lives_tpu/effects/builtin/alpha.py:66-314`, its six
filters: motion_mask (`:66-90`), farneback_analyser (`:95-143`),
alpha_visualizer (`:148-182`), fg_bg_removal (`:187-248`),
vector_visualiser (`:253-300`) and alpha_to_grey (`:305-314`). Views are
``(B, C, H, W)``, an alpha layer's plane ``(B, H, W)``; the three
stateful filters take one frame at a time and keep their states in the
JAX package's contract ((H, W) planes and 0-d scalars).

Alpha out-channels ride data connections (`effects/data.py`) into
downstream alpha in-channels; inside a `FrameGraph` they are the graph's
cconx. Out-values are 0-d tensors on the frame's device.

A value that feeds a hard select is computed as the JAX package's jitted
plan computes it: the luma as XLA contracts it (`extra.luma_fma`), the
mask's `floor(m * 255 + 0.5)` and the background average's
`avg * count + g` as FMAs (`fma32`), vector_visualiser's gate
`sqrt(vx * vx + vy * vy) > 0.25` with its FMA. fg_bg_removal's noise
hash wraps in int32 as the JAX package's does, computed in int64.
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ...layer import Layer
from ...utils.xla_exp import fma32
from ..host import (FILTER_STATEFUL, ChannelTemplate, Filter, Param,
                    register_filter)
from ..util import bparam, from_f01, join_alpha, per_frame, split_alpha, \
    to_f01
from .extra import luma_fma

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)
_ALPHA_ANY = (Palette.A8, Palette.AFLOAT, Palette.A1)


#: np.float32(1 / 255), the factor `_alpha_f01` scales an A8 plane by
_INV255 = float(torch.tensor(1 / 255.0, dtype=torch.float32))


def alpha_f01(a: Layer) -> torch.Tensor:
    """``(B, H, W)`` float32 [0, 1] view of an alpha layer (any alpha
    palette)."""
    p = a.planes[0]
    if a.palette in (int(Palette.AFLOAT), int(Palette.A1)):
        return p.to(torch.float32)
    return p.to(torch.float32) * _INV255


def a8(m_f01: torch.Tensor) -> Layer:
    """A [0, 1] float mask ``(B, H, W)`` -> an A8 alpha Layer:
    floor(m * 255 + 0.5) as one FMA, clipped."""
    u8 = torch.clamp(torch.floor(fma32(m_f01, 255.0, 0.5)), 0, 255) \
        .to(torch.uint8)
    return Layer(planes=(u8,), palette=int(Palette.A8))


def afloat(m: torch.Tensor) -> Layer:
    return Layer(planes=(m.to(torch.float32),), palette=int(Palette.AFLOAT))


def scalar(v, device) -> torch.Tensor:
    """One frame's parameter (a number, or a (1,) or 0-d tensor) as a 0-d
    float32 tensor on `device`."""
    return per_frame(v, device).reshape(())


def frame_luma(lay: Layer) -> torch.Tensor:
    """The frame's luma ``(B, H, W)``, as the jitted plan computes it."""
    return luma_fma(split_alpha(to_f01(lay))[0])[:, 0]


def one_frame(f: str, lay: Layer):
    """A stateful filter takes one frame at a time."""
    if lay.planes[0].shape[0] != 1:
        raise ValueError(f"{f} takes one frame at a time")


# -- motion_mask: frame difference -> A8 mask ---------------------------------

def _motion_mask_process(ins, p, ctx, state):
    one_frame("motion_mask", ins[0])
    dev = ins[0].device
    g = frame_luma(ins[0])[0]
    d = torch.abs(g - state)
    m = torch.clamp((d - scalar(p["threshold"], dev))
                    / torch.clamp(scalar(p["softness"], dev), min=1e-4),
                    0.0, 1.0)
    return ins[0], g, {"mask": a8(m[None]), "motion": torch.mean(d)}


register_filter(Filter(
    name="motion_mask", process=_motion_mask_process, in_channels=_ONE_IN,
    params=(Param("threshold", "num", 0.05, 0.0, 1.0),
            Param("softness", "num", 0.1, 0.0, 1.0)),
    out_params=(Param("motion", "num", 0.0, 0.0, 1.0),),
    alpha_outs=(ChannelTemplate("mask", (Palette.A8,)),),
    flags=FILTER_STATEFUL,
    init_state=lambda w, h, pal, device: torch.zeros(
        (h, w), dtype=torch.float32, device=device),
    description="frame-difference motion mask exported as an A8 "
                "out-channel (cconx source)"))


# -- farneback_analyser: dense flow as AFLOAT channels ------------------------

def _box3(x):
    """3x3 box filter with wrap-around (`alpha.py:95-99`'s rolls)."""
    x = x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
    return (x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) * float(
        torch.tensor(1 / 9, dtype=torch.float32))


def _farneback_process(ins, p, ctx, state):
    """One-iteration Lucas-Kanade dense flow: the 2x2 normal equations of
    I_x*u + I_y*v = -I_t over a 3x3 window, solved per pixel."""
    one_frame("farneback_analyser", ins[0])
    g = frame_luma(ins[0])[0]
    ix = (torch.roll(g, -1, 1) - torch.roll(g, 1, 1)) * 0.5
    iy = (torch.roll(g, -1, 0) - torch.roll(g, 1, 0)) * 0.5
    it = g - state
    a11 = _box3(ix * ix) + 1e-4
    a12 = _box3(ix * iy)
    a22 = _box3(iy * iy) + 1e-4
    b1 = -_box3(ix * it)
    b2 = -_box3(iy * it)
    det = a11 * a22 - a12 * a12
    u = (a22 * b1 - a12 * b2) / det
    v = (a11 * b2 - a12 * b1) / det
    mag = torch.sqrt(u * u + v * v)
    scale = scalar(p["scale"], g.device)
    return ins[0], g, {
        "flow_x": afloat((u * scale)[None]),
        "flow_y": afloat((v * scale)[None]),
        "mean_flow_x": torch.mean(u), "mean_flow_y": torch.mean(v),
        "mean_magnitude": torch.mean(mag), "max_magnitude": torch.max(mag)}


register_filter(Filter(
    name="farneback_analyser", process=_farneback_process,
    in_channels=_ONE_IN,
    params=(Param("scale", "num", 1.0, 0.0, 16.0),),
    out_params=(Param("mean_flow_x", "num", 0.0, -64.0, 64.0),
                Param("mean_flow_y", "num", 0.0, -64.0, 64.0),
                Param("mean_magnitude", "num", 0.0, 0.0, 64.0),
                Param("max_magnitude", "num", 0.0, 0.0, 64.0)),
    alpha_outs=(ChannelTemplate("flow_x", (Palette.AFLOAT,)),
                ChannelTemplate("flow_y", (Palette.AFLOAT,))),
    flags=FILTER_STATEFUL,
    init_state=lambda w, h, pal, device: torch.zeros(
        (h, w), dtype=torch.float32, device=device),
    description="dense optical flow -> two AFLOAT out-channels + flow "
                "stats (farneback_analyser.cpp)"))


# -- alpha_visualizer: alpha in-channel -> RGB(A) -----------------------------

def _alpha_vis_process(ins, p, ctx):
    video, a = ins[0], ins[1]
    vrgb, al = split_alpha(to_f01(video))
    if a is not None:
        lo, hi = bparam(p["fmin"]), bparam(p["fmax"])
        span = hi - lo
        span = torch.clamp(span, min=1e-6) if isinstance(
            span, torch.Tensor) else max(span, 1e-6)
        if a.palette == int(Palette.A8):
            # the jitted plan folds the 1/255 scale and `- fmin` into one
            # FMA; a narrow range amplifies the difference
            m = fma32(a.planes[0].to(torch.float32)[:, None], _INV255,
                      -torch.as_tensor(lo, dtype=torch.float32))
        else:
            m = alpha_f01(a)[:, None] - lo
        m = torch.clamp(m / span, 0.0, 1.0)
    else:
        # unconnected: the layer's own alpha, or its luma
        m = al if al is not None else luma_fma(vrgb)
    rgb = torch.clamp(torch.cat([m * bparam(p["red"]),
                                 m * bparam(p["green"]),
                                 m * bparam(p["blue"])], 1), 0.0, 1.0)
    # an output alpha goes opaque, as the reference documents
    out = join_alpha(rgb, torch.ones_like(al) if al is not None else None)
    return from_f01(out, video)


register_filter(Filter(
    name="alpha_visualizer", process=_alpha_vis_process,
    in_channels=_ONE_IN,
    alpha_ins=(ChannelTemplate("alpha", _ALPHA_ANY, optional=True),),
    params=(Param("red", "num", 1.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0),
            Param("fmin", "num", 0.0, -64.0, 64.0),
            Param("fmax", "num", 1.0, -64.0, 64.0)),
    description="render a connected alpha channel as RGB(A) "
                "(alpha_visualizer.c)"))


# -- fg_bg_removal: background model + replacement ----------------------------

def _wrap32(v):
    """int64 -> the int32 value it wraps to, held in int64."""
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def hash01(h: int, w: int, salt, device) -> torch.Tensor:
    """`alpha.py:192-201` `_hash01`: the integer-hash noise field in
    [0, 1), (h, w), in int32 arithmetic (wrapping products, arithmetic
    shifts); `salt` a number or a 0-d integer tensor."""
    iy = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    ix = torch.arange(w, dtype=torch.int64, device=device)[None]
    salt = torch.as_tensor(salt, device=device).to(torch.int64)
    v = _wrap32(ix * 73856093) ^ _wrap32(iy * 19349663) \
        ^ _wrap32(_wrap32(salt) * 83492791)
    v = _wrap32((v ^ (v >> 13)) * 0x5BD1E995)
    v = v ^ (v >> 15)
    return (v & 0xFFFF).to(torch.float32) * (1 / 65536)


def _fg_bg_process(ins, p, ctx, state):
    """Static pixels (|luma - running average| < threshold) are replaced:
    type 0 black, 1 fire noise, 2 blue glow (fg_bg_removal.c:135-160);
    the moving-foreground mask is exported."""
    lay = ins[0]
    one_frame("fg_bg_removal", lay)
    dev = lay.device
    rgb, al = split_alpha(to_f01(lay))
    g = luma_fma(rgb)[0, 0]
    avg, count = state
    new_avg = fma32(avg, count, g) / (count + 1.0)
    is_bg = (torch.abs(g - new_avg)
             < scalar(p["threshold"], dev)).to(torch.float32)
    h, w = g.shape
    t = int(p.get("type", 0))
    frame = torch.as_tensor(ctx.frame, device=dev).reshape(-1)[0]
    if t == 1:    # fire-ish: random red + green, no blue
        r = hash01(h, w, frame, dev) * 0.5
        gg = hash01(h, w, frame + 7919, dev) * 0.5
        repl = torch.stack([r + gg, gg, torch.zeros_like(g)])[None]
    elif t == 2:  # blue glow: random grey + full blue
        n = hash01(h, w, frame, dev)
        repl = torch.stack([n, n, torch.ones_like(g)])[None]
    else:         # black
        repl = torch.zeros_like(rgb)
    out = rgb * (1.0 - is_bg) + repl * is_bg
    new_count = torch.minimum(count + 1.0, scalar(p["history"], dev))
    return (from_f01(join_alpha(out, al), lay), (new_avg, new_count),
            {"mask": a8((1.0 - is_bg)[None])})


register_filter(Filter(
    name="fg_bg_removal", process=_fg_bg_process, in_channels=_ONE_IN,
    params=(Param("threshold", "num", 64 / 255.0, 0.0, 1.0),
            Param("type", "int", 0, 0, 2),
            Param("history", "num", 255.0, 1.0, 1000.0)),
    alpha_outs=(ChannelTemplate("mask", (Palette.A8,)),),
    flags=FILTER_STATEFUL,
    init_state=lambda w, h, pal, device: (
        torch.zeros((h, w), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device)),
    description="running-average background removal, 3 replacement types; "
                "exports the fg mask (fg_bg_removal.c)"))


# -- vector_visualiser: flow-field arrows over video --------------------------

def _cells(c, rows: int, cols: int, h: int, w: int):
    """Each coarse value (B, ny, nx) repeated over its (rows, cols) cell,
    the last row and column repeated into the remainder: (B, h, w)."""
    r = c.repeat_interleave(rows, 1).repeat_interleave(cols, 2)
    pad_y, pad_x = h - r.shape[1], w - r.shape[2]
    if pad_y > 0:
        r = torch.cat([r, r[:, -1:].expand(-1, pad_y, -1)], 1)
    if pad_x > 0:
        r = torch.cat([r, r[:, :, -1:].expand(-1, -1, pad_x)], 2)
    return r[:, :h, :w]


def _vector_vis_process(ins, p, ctx):
    """cairo/vector_visualiser.c grid mode: at each centre of a ~20x20
    grid an arrow of the connected (x-plane, y-plane) vector, drawn as
    per-pixel distance fields (segment and tip ring)."""
    video, ax, ay = ins[0], ins[1], ins[2]
    if ax is None or ay is None:
        return video  # nothing connected: pass through
    rgb, al = split_alpha(to_f01(video))
    h, w = rgb.shape[-2:]
    sm_h, sm_w = max(h // 20, 1), max(w // 20, 1)
    scale = per_frame(p["scale"], rgb.device).reshape(-1, 1, 1)
    fx = ax.planes[0].to(torch.float32) * scale
    fy = ay.planes[0].to(torch.float32) * scale
    # arrow bases at (sm + 2*sm*k), the reference's loop lattice
    vx = _cells(fx[:, sm_h::2 * sm_h, sm_w::2 * sm_w], 2 * sm_h, 2 * sm_w,
                h, w)
    vy = _cells(fy[:, sm_h::2 * sm_h, sm_w::2 * sm_w], 2 * sm_h, 2 * sm_w,
                h, w)
    yy = torch.arange(h, dtype=torch.float32, device=rgb.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=rgb.device)[None]
    by = torch.floor(yy / (2 * sm_h)) * (2 * sm_h) + sm_h
    bx = torch.floor(xx / (2 * sm_w)) * (2 * sm_w) + sm_w
    sx, sy = bx - vx - 0.5, by - vy - 0.5
    dx, dy = bx - sx, by - sy
    seg2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
    t = torch.clamp(((xx - sx) * dx + (yy - sy) * dy) / seg2, 0.0, 1.0)
    qx, qy = sx + t * dx - xx, sy + t * dy - yy
    d_seg = torch.sqrt(qx * qx + qy * qy)
    ln = torch.sqrt(fma32(vx, vx, vy * vy))
    d_tip = torch.abs(torch.sqrt((xx - bx) ** 2 + (yy - by) ** 2)
                      - ln * 0.25)
    lw = 2.0  # cairo line width 4 -> half-width 2
    stroke = torch.clamp(lw - torch.minimum(d_seg, d_tip) + 0.5, 0.0, 1.0)
    # suppress degenerate (near-zero) vectors so still frames stay clean
    stroke = (stroke * (ln > 0.25))[:, None]
    red = torch.zeros_like(rgb[:1, :, :1, :1])
    red[:, 0] = 1.0
    out = rgb * (1.0 - stroke) + red * stroke
    return from_f01(join_alpha(out, al), video)


register_filter(Filter(
    name="vector_visualiser", process=_vector_vis_process,
    in_channels=_ONE_IN,
    alpha_ins=(ChannelTemplate("x-plane", (Palette.AFLOAT,), optional=True),
               ChannelTemplate("y-plane", (Palette.AFLOAT,), optional=True)),
    params=(Param("scale", "num", 1.0, 0.0, 64.0),),
    description="overlay a 20x20 grid of flow arrows from two connected "
                "AFLOAT channels (cairo/vector_visualiser.c grid mode)"))


# -- alpha_to_grey ------------------------------------------------------------

def _alpha_to_grey_process(ins, p, ctx):
    """scripts/alpha_to_grey.script: the alpha channel as a grey image
    (alpha passes through); an RGB frame gives its luma."""
    lay = ins[0]
    a, alpha = split_alpha(to_f01(lay))
    g = alpha if alpha is not None else luma_fma(a)
    return from_f01(join_alpha(torch.cat([g, g, g], 1), alpha), lay)


register_filter(Filter(
    name="alpha_to_grey", process=_alpha_to_grey_process,
    in_channels=_ONE_IN,
    description="alpha channel as grey pixels "
                "(scripts/alpha_to_grey.script)"))
