"""Extra filters: text, walls, transitions, data plugins, the Toonz family,
deinterlace, censoring, glyph art, the graphic-novel look and haip.

Counterpart of `lives_tpu/effects/builtin/extra.py:20-609`, all sixteen
filters: livetext (`:27-56`), videowall (`:60-81`), mask_overlay
(`:84-114`), push (`:119-149`), data_processor and randomiser
(`:153-208`), the Toonz family (`:213-328`), deinterlace (`:334-349`),
scribbler (`:356-401`), textfun (`:407-481`), photo_censor (`:486-522`),
xeffect (`:528-563`) and haip (`:567-609`). Views are ``(B, C, H, W)`` and
a per-frame parameter a ``(B,)`` tensor or a number.

mask_overlay's third input is an optional alpha in-channel: a connected
alpha layer (cconx) is its mask in place of the bg's luma. The fused
sweep kernel's vocabulary holds mask_overlay (`graph/fused_sweep.py`),
its two-input form; no other filter here is in it.

Text is rasterised on the host by `text.render_text_mask` and kept on the
device in a cache keyed by (text, width, height, size, device).

Where a value feeds a hard select (a floor, a comparison, a truncation to
an index), the port computes it as the JAX package's jitted plan does,
since a filter runs inside `FrameGraph`'s jit there: XLA folds constant
factors (`to_f01`'s 1/255 times 255 is 1.0, see `_src255`), its code
generator contracts a multiply feeding an add into one FMA (`fma32`),
it calls the C library's `sinf` (`utils.sinf`), and it sums a reduction
in vector lanes (`block_means`). haip and randomiser draw JAX's threefry numbers through
`utils.prng`, bit for bit; haip resolves its scatters' repeated targets
as XLA's CPU scatter does, the last write in index order winning, with
an explicit `scatter_reduce` of the write order, since torch leaves the
winner of repeated indices unspecified on a GPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...constants import Gamma, Palette
from ...layer import Layer
from ...ops.resize import resize_plane
from ...utils import prng
from ...utils.sinf import cosf, sinf
from ...utils.xla_exp import fma32
from ..host import (ChannelTemplate, FILTER_IS_GENERATOR,
                    FILTER_IS_TRANSITION, Filter, Param, register_filter)
from ..util import (bparam, ctx_grid, from_f01, join_alpha, luma, per_frame,
                    split_alpha, to_f01)
from .blur import _gauss_kernel, sep_conv

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)
_TWO_IN = (ChannelTemplate("fg", _RGBX), ChannelTemplate("bg", _RGBX))
_F32 = np.float32


def _p4(v, device):
    """A per-frame value as float32 (B or 1, 1, 1, 1) on `device`."""
    return per_frame(v, device).reshape(-1, 1, 1, 1)


def luma_fma(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of (B, 3, H, W) as (B, 1, H, W), as XLA's jit computes
    `0.299 * r + 0.587 * g + 0.114 * b`: fma(0.114, b, fma(0.299, r,
    0.587 * g))."""
    return fma32(rgb[:, 2:3], float(_F32(0.114)),
                 fma32(rgb[:, 0:1], float(_F32(0.299)),
                       rgb[:, 1:2] * float(_F32(0.587))))


# -- text (livetext.c / scribbler.c) -----------------------------------------

@functools.lru_cache(maxsize=16)
def text_mask(text: str, w: int, h: int, size: int, device: str):
    """(mask (4, h, w) uint8 on `device`, rows (y0, y1) the text's alpha
    spans or None): `render_text_mask(text, w, h, size, valign="middle")`
    uploaded once a key."""
    from ...text import render_text_mask
    mask = render_text_mask(text, w, h, size=size, valign="middle")
    rows = mask[3].any(axis=1)
    span = (int(np.argmax(rows)), int(len(rows) - np.argmax(rows[::-1]))) \
        if rows.any() else None
    return torch.from_numpy(mask).to(device), span


def _livetext_process(ins, p, ctx):
    dev = ctx.device
    if dev is None:
        raise ValueError("livetext needs ctx.device: a generator has no "
                         "input layer to take its device from")
    mask, _ = text_mask(str(p["text"]), ctx.width, ctx.height,
                        max(8, int(p["size"])), str(dev))
    m = mask.to(torch.float32) / 255.0
    colour = torch.stack(torch.broadcast_tensors(
        *(per_frame(p[c], dev) for c in ("red", "green", "blue"))), 1)
    B = max(colour.shape[0], torch.as_tensor(ctx.tc).numel())
    rgb = m[:3] * colour.reshape(-1, 3, 1, 1) * m[3:4]
    a = m[3:4].expand(B, 1, -1, -1)
    arr = torch.cat([
        torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
        .expand(B, -1, -1, -1),
        (a * 255.0 + 0.5).to(torch.uint8)], 1)
    return Layer(planes=(arr,), palette=int(Palette.RGBA32),
                 gamma=int(Gamma.SRGB))


register_filter(Filter(
    name="livetext", process=_livetext_process, in_channels=(),
    params=(Param("text", "string", "lives_tpu"),
            Param("size", "int", 48, 8, 256),
            Param("red", "num", 1.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0)),
    flags=FILTER_IS_GENERATOR,
    description="text generator with alpha (livetext.c)"))


# -- videowall ---------------------------------------------------------------

def _videowall_process(ins, p, ctx):
    lay = ins[0]
    a = to_f01(lay)
    h, w = a.shape[-2:]
    n = max(1, int(p["tiles"]))
    small = resize_plane(a, max(1, h // n), max(1, w // n), "area")
    tiled = small.repeat(1, 1, n, n)[..., :h, :w]
    pad_h, pad_w = h - tiled.shape[-2], w - tiled.shape[-1]
    if pad_h or pad_w:
        tiled = F.pad(tiled, (0, pad_w, 0, pad_h), mode="replicate")
    return from_f01(tiled, lay)


register_filter(Filter(
    name="videowall", process=_videowall_process, in_channels=_ONE_IN,
    params=(Param("tiles", "int", 3, 1, 16),),
    description="NxN repeated tiles (gdk/videowall.c)"))


# -- mask overlay ------------------------------------------------------------

def _mask_overlay_process(ins, p, ctx):
    fg, bg = ins[0], ins[1]
    argb, aal = split_alpha(to_f01(fg))
    alpha_in = ins[2] if len(ins) > 2 else None
    if alpha_in is not None:
        # a connected alpha channel (cconx) is the mask: an analyser
        # (motion_mask, fg_bg_removal) drives the overlay live
        from .alpha import alpha_f01
        g = alpha_f01(alpha_in)[:, None]
    else:
        brgb, _ = split_alpha(to_f01(bg))
        g = luma(brgb)  # the mask from bg's luma (a mask clip on track 1)
    m = torch.clamp((g - bparam(p["threshold"]))
                    / (bparam(p["softness"]) + 1e-4), 0.0, 1.0)
    inv = bparam(p["invert"])
    m = m * (1.0 - inv) + (1.0 - m) * inv
    return from_f01(join_alpha(argb * m, aal), fg)


register_filter(Filter(
    name="mask_overlay", process=_mask_overlay_process, in_channels=_TWO_IN,
    alpha_ins=(ChannelTemplate(
        "mask", (Palette.A8, Palette.AFLOAT, Palette.A1),
        optional=True),),
    params=(Param("threshold", "num", 0.5, 0.0, 1.0),
            Param("softness", "num", 0.05, 0.0, 1.0),
            Param("invert", "num", 0.0, 0.0, 1.0)),
    flags=FILTER_IS_TRANSITION,
    description="mask fg by bg luma, or by a connected alpha channel "
                "(gdk/mask_overlay.c + cconx, effects-data.c:1730)"))


# -- push transition (true slide: fg pushes bg out) --------------------------

def _roll_lanes(x, shift):
    """Roll (B, C, H, W) along W by each frame's `shift` ((B or 1, 1, 1)
    int): out[..., c] = x[..., (c - shift) % W]."""
    w = x.shape[-1]
    col = torch.arange(w, device=x.device)
    idx = (col - shift) % w
    return torch.gather(x, -1, idx[:, None].expand(
        x.shape[0], x.shape[1], x.shape[2], w))


def _push_process(ins, p, ctx):
    fg, bg = ins[0], ins[1]
    argb, aal = split_alpha(to_f01(fg))
    brgb, _ = split_alpha(to_f01(bg))
    w = argb.shape[-1]
    shift = (per_frame(p["amount"], argb.device) * w).to(torch.int32) \
        .to(torch.int64).reshape(-1, 1, 1)
    col = torch.arange(w, device=argb.device)
    out = torch.where((col < shift)[:, None],
                      _roll_lanes(argb, w - shift), _roll_lanes(brgb, -shift))
    return from_f01(join_alpha(out, aal), fg)


register_filter(Filter(
    name="push", process=_push_process, in_channels=_TWO_IN,
    params=(Param("amount", "num", 0.0, 0.0, 1.0),),
    flags=FILTER_IS_TRANSITION,
    description="fg pushes bg out horizontally (slide_over.c push mode)"))


# -- data plugins ------------------------------------------------------------

def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


#: data_processor's functions: the JAX package's, over float32 tensors,
#: sin and cos as the C library computes them (`utils.sinf`)
_DP_FUNCS = {"sin": lambda v: sinf(_f32(v)), "cos": lambda v: cosf(_f32(v)),
             "abs": lambda v: torch.abs(_f32(v)),
             "sqrt": lambda v: torch.sqrt(_f32(v)), "pi": np.pi,
             "min": lambda a, b: torch.minimum(_f32(a), _f32(b)),
             "max": lambda a, b: torch.maximum(_f32(a), _f32(b))}


def _data_processor_analyse(ins, p, ctx):
    """data_processor.c: evaluate expressions over scalar inputs a..d and
    the timecode t, in a restricted `eval` with no builtins; an expression
    that fails gives 0.0."""
    env = {"a": p["a"], "b": p["b"], "c": p["c"], "d": p["d"],
           "t": ctx.tc, **_DP_FUNCS}
    out = {}
    for slot in ("o0", "o1"):
        expr = str(p[f"expr_{slot}"]).strip()
        if not expr:
            continue
        try:
            out[slot] = eval(compile(expr, "<data_processor>", "eval"),
                             {"__builtins__": {}}, env)
        except Exception:
            out[slot] = 0.0
    return out


register_filter(Filter(
    name="data_processor",
    process=lambda ins, p, ctx: ins[0] if ins else None,
    in_channels=_ONE_IN,
    params=(Param("a", "num", 0.0, -1e6, 1e6),
            Param("b", "num", 0.0, -1e6, 1e6),
            Param("c", "num", 0.0, -1e6, 1e6),
            Param("d", "num", 0.0, -1e6, 1e6),
            Param("expr_o0", "string", "a + b"),
            Param("expr_o1", "string", "")),
    out_params=(Param("o0", "num", 0.0, -1e6, 1e6),
                Param("o1", "num", 0.0, -1e6, 1e6)),
    analyse=_data_processor_analyse,
    description="scalar expression evaluator (data_processor.c)"))


def _frame_device(ins, ctx):
    if ctx.device is not None:
        return ctx.device
    if ins and ins[0] is not None:
        return ins[0].device
    raise ValueError("no device: pass ctx.device or an input layer")


def _randomiser_analyse(ins, p, ctx):
    """`uniform(fold_in(PRNGKey(777), frame), (4,))` a frame."""
    dev = _frame_device(ins, ctx)
    key = prng.fold_in(prng.prng_key(777, dev),
                       torch.as_tensor(ctx.frame, device=dev))
    vals = prng.uniform(key, (4,))
    return {f"rand{i}": vals[..., i] for i in range(4)}


register_filter(Filter(
    name="randomiser",
    process=lambda ins, p, ctx: ins[0] if ins else None,
    in_channels=_ONE_IN,
    out_params=tuple(Param(f"rand{i}", "num", 0.0, 0.0, 1.0)
                     for i in range(4)),
    analyse=_randomiser_analyse,
    description="per-frame random out-params (randomiser.c)"))


# -- Toonz family (reference toonz.cpp: DWANGO OpenToonz ports) ---------------

def _register_rgb(name, fn, params=(), desc=""):
    """`extra.py:213-228`: the frame's RGB as float32 in [0,1], the filter,
    a clip to [0,1], the alpha back, the layer's storage."""
    def process(ins, p, ctx):
        lay = ins[0]
        rgb, al = split_alpha(to_f01(lay))
        out = torch.clamp(fn(rgb, p, ctx), 0.0, 1.0)
        return from_f01(join_alpha(out, al), lay)

    return register_filter(Filter(
        name=name, process=process, in_channels=_ONE_IN,
        params=tuple(params), description=desc))


def _light_bloom(rgb, p, ctx):
    """Toonz: Light Bloom (`:231-242`). The blur's size comes from the
    radius on the host, so a per-frame radius is refused, as the JAX
    graph refuses it (`int()` of a traced value there); eager
    `apply_instance` with a number is the form that runs."""
    radius = p["radius"]
    if isinstance(radius, torch.Tensor):
        raise TypeError(
            "toonz_light_bloom: the 'radius' parameter sets the blur's "
            "kernel size and must be a number, not a per-frame (traced) "
            "tensor; the JAX package's FrameGraph fails here too "
            "(ConcretizationTypeError)")
    g = luma(rgb)
    hi = torch.clamp(g - 1.0 / (1.0 + bparam(p["exposure"])), min=0.0)
    hi = hi ** (1.0 / torch.clamp(_p4(p["gamma"], rgb.device), min=0.1))
    glow = sep_conv(hi, _gauss_kernel(max(1, int(radius * 24))))
    return rgb + glow * bparam(p["gain"]) * torch.clamp(rgb, 0.2, 1.0)


def _paraffin(rgb, p, ctx):
    """Toonz: Paraffin — graduated tinted wash (`:245-257`)."""
    h, w = rgb.shape[-2:]
    x, y = ctx_grid(ctx, h, w, device=rgb.device)
    th = _p4(p["angle"], rgb.device) * float(_F32(2 * np.pi))
    t = x * torch.cos(th) + y * torch.sin(th)
    band = torch.clamp((t - bparam(p["offset"]))
                       / torch.clamp(_p4(p["softness"], rgb.device),
                                     min=1e-3), 0.0, 1.0)
    tint = torch.cat([band * bparam(p["red"]), band * bparam(p["green"]),
                      band * bparam(p["blue"])], 1)
    dens = bparam(p["density"])
    return rgb * (1.0 - band * dens) + tint * dens


def _pencil_hatching(rgb, p, ctx):
    """Toonz: Pencil Hatching (`:260-275`); the strokes' darkness
    thresholds read the jitted luma (`luma_fma`)."""
    h, w = rgb.shape[-2:]
    x, y = ctx_grid(ctx, h, w, device=rgb.device)
    dark = 1.0 - luma_fma(rgb)
    freq = 40.0 + _p4(p["density"], rgb.device) * 160.0
    h1 = torch.sin((x + y) * freq) * 0.5 + 0.5
    h2 = torch.sin((x - y) * freq) * 0.5 + 0.5
    stroke = torch.where(dark > 0.33, torch.minimum(h1, 1.0 - dark * 0.2),
                         1.0)
    stroke = torch.where(dark > 0.66, torch.minimum(stroke, h2), stroke)
    v = torch.clamp(stroke, 0.0, 1.0).expand(-1, 3, -1, -1)
    return rgb + (v - rgb) * bparam(p["amount"])


def noise_hash(ix, iy, t):
    """Coherent noise's lattice hash `fract(sin(ix * 127.1 + iy * 311.7 +
    t * 74.7) * 43758.5453)` (`:290-292`), with `sin` the C library's
    (`utils.sinf`): the fract amplifies an ulp of its argument or of the
    sine past any pixel bound. The jitted plan rounds each product and
    sum of the argument on its own (no FMA), as eager operations do."""
    arg = (ix * float(_F32(127.1)) + iy * float(_F32(311.7))) \
        + t * float(_F32(74.7))
    s = sinf(arg) * float(_F32(43758.5453))
    return s - torch.floor(s)


def _coherent_noise(rgb, p, ctx):
    """Toonz: Coherent Noise (`:278-298`): hash-based bilinear value noise
    animated by tc."""
    h, w = rgb.shape[-2:]
    dev = rgb.device
    x, y = ctx_grid(ctx, h, w, device=dev)
    cells = fma32(_p4(p["scale"], dev), 28.0, 4.0)
    gx, gy = x * cells, y * cells
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    t = torch.floor(_p4(ctx.tc, dev) * _p4(p["speed"], dev) * 8.0)
    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    n = (noise_hash(x0, y0, t) * (1 - sx) + noise_hash(x0 + 1, y0, t) * sx) \
        * (1 - sy) + (noise_hash(x0, y0 + 1, t) * (1 - sx)
                      + noise_hash(x0 + 1, y0 + 1, t) * sx) * sy
    return rgb + (n - 0.5) * bparam(p["amount"])


_register_rgb("toonz_light_bloom", _light_bloom,
              params=(Param("gamma", "num", 2.2, 0.1, 5.0),
                      Param("exposure", "num", 1.0, 0.125, 8.0),
                      Param("gain", "num", 1.0, 0.1, 10.0),
                      Param("radius", "num", 0.1, 0.01, 1.0)),
              desc="highlight bloom (Toonz: Light Bloom)")
_register_rgb("toonz_paraffin", _paraffin,
              params=(Param("angle", "num", 0.25, 0.0, 1.0),
                      Param("offset", "num", 0.3, 0.0, 1.0),
                      Param("softness", "num", 0.4, 0.01, 1.0),
                      Param("density", "num", 0.5, 0.0, 1.0),
                      Param("red", "num", 1.0, 0.0, 1.0),
                      Param("green", "num", 0.9, 0.0, 1.0),
                      Param("blue", "num", 0.6, 0.0, 1.0)),
              desc="graduated light wash (Toonz: Paraffin)")
_register_rgb("toonz_pencil_hatching", _pencil_hatching,
              params=(Param("density", "num", 0.3, 0.0, 1.0),
                      Param("amount", "num", 1.0, 0.0, 1.0)),
              desc="pencil hatch strokes (Toonz: Pencil Hatching)")
_register_rgb("toonz_coherent_noise", _coherent_noise,
              params=(Param("scale", "num", 0.3, 0.0, 1.0),
                      Param("speed", "num", 1.0, 0.0, 8.0),
                      Param("amount", "num", 0.3, 0.0, 1.0)),
              desc="animated smooth noise (Toonz: Coherent Noise)")


# -- deinterlace (reference deinterlace.script / cdata interlace flag) --------

def _deinterlace(rgb, p, ctx):
    """Linear-blend deinterlace (`:334-341`): each row mixes with the mean
    of its neighbours."""
    up = torch.cat([rgb[:, :, :1], rgb[:, :, :-1]], 2)
    down = torch.cat([rgb[:, :, 1:], rgb[:, :, -1:]], 2)
    blended = (up + down) * 0.5
    return rgb + (blended - rgb) * (bparam(p["amount"]) * 0.5)


_register_rgb("deinterlace", _deinterlace,
              params=(Param("amount", "num", 1.0, 0.0, 1.0),),
              desc="linear-blend deinterlace")


# -- scribbler (gdk/scribbler.c) ----------------------------------------------

def _scribbler_process(ins, p, ctx):
    """gdk/scribbler.c (`:356-384`): text over the input frame in a
    foreground colour, with an optional background box over the rows the
    text spans; `mode` foreground only / background only / both."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    h, w = rgb.shape[-2:]
    dev = rgb.device
    mask, span = text_mask(str(p["text"]), w, h, max(8, int(p["size"])),
                           str(dev))
    mode = int(p["mode"])
    out = rgb
    if mode != 0 and span is not None:  # the box: full width, +-4 rows
        box = torch.zeros((h, 1), dtype=torch.float32, device=dev)
        box[max(span[0] - 4, 0):min(span[1] + 4, h)] = 1.0
        bg_col = torch.stack(torch.broadcast_tensors(
            *(per_frame(p[c], dev) for c in ("bg_red", "bg_green",
                                             "bg_blue"))), 1)
        mb = box * torch.clamp(_p4(p["bg_alpha"], dev), 0.0, 1.0)
        out = out * (1.0 - mb) + bg_col.reshape(-1, 3, 1, 1) * mb
    if mode != 1:  # foreground text
        fg_col = torch.stack(torch.broadcast_tensors(
            *(per_frame(p[c], dev) for c in ("red", "green", "blue"))), 1)
        m = mask[3].to(torch.float32) / 255.0
        mf = m * torch.clamp(_p4(p["fg_alpha"], dev), 0.0, 1.0)
        out = out * (1.0 - mf) + fg_col.reshape(-1, 3, 1, 1) * mf
    return from_f01(join_alpha(out, al), lay)


register_filter(Filter(
    name="scribbler", process=_scribbler_process, in_channels=_ONE_IN,
    params=(Param("text", "string", "lives"),
            Param("size", "int", 32, 8, 256),
            Param("mode", "string_list", 0,
                  choices=("foreground only", "background only",
                           "foreground and background")),
            Param("red", "num", 1.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0),
            Param("fg_alpha", "num", 1.0, 0.0, 1.0),
            Param("bg_red", "num", 0.0, 0.0, 1.0),
            Param("bg_green", "num", 0.0, 0.0, 1.0),
            Param("bg_blue", "num", 0.0, 0.0, 1.0),
            Param("bg_alpha", "num", 0.5, 0.0, 1.0)),
    description="text + background box over input (gdk/scribbler.c)"))


# -- textfun (textfun.c): glyph-art -------------------------------------------

@functools.lru_cache(maxsize=4)
def glyph_atlas(cell: int = 8) -> np.ndarray:
    """(K, cell, cell) float32 glyph atlas sorted by ink coverage
    (`:407-427`): PIL's default font's " .:-=+*#%@", sorted by
    `np.argsort` of each glyph's mean (a density ramp of filled squares
    without PIL)."""
    ramp = " .:-=+*#%@"
    try:
        from PIL import Image, ImageDraw, ImageFont
        font = ImageFont.load_default()
        glyphs = []
        for ch in ramp:
            img = Image.new("L", (cell, cell), 0)
            ImageDraw.Draw(img).text((0, -2), ch, fill=255, font=font)
            glyphs.append(np.asarray(img, np.float32) / 255.0)
        atlas = np.stack(glyphs)
    except Exception:
        atlas = np.stack([np.full((cell, cell), i / (len(ramp) - 1.0),
                                  np.float32) for i in range(len(ramp))])
    order = np.argsort(atlas.mean((1, 2)))
    return atlas[order]


def block_means(vals: torch.Tensor, cell: int, scale=None) -> torch.Tensor:
    """(B, 3, hh*cell, ww*cell) -> each cell x cell block's mean, (B, 3,
    hh, ww), summed as XLA's CPU code sums it: each of the block's rows in
    a vector lane, its values added left to right (each times `scale` in
    one FMA, where the frame is u8 and `to_f01`'s 1/255 rides along), the
    lanes then folded in halves, and the sum times 1 / cell^2."""
    B, C, H, W = vals.shape
    blocks = vals.reshape(B, C, H // cell, cell, W // cell, cell)
    lanes = []
    for i in range(cell):
        acc = torch.zeros_like(blocks[:, :, :, 0, :, 0])
        for j in range(cell):
            v = blocks[:, :, :, i, :, j]
            acc = fma32(v, scale, acc) if scale is not None else acc + v
        lanes.append(acc)
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[k] + lanes[k + half] for k in range(half)]
    return lanes[0] * (1.0 / (cell * cell))


def textfun_glyphs(lay: Layer, cell: int, k: int):
    """(block mean colours (B, 3, hh, ww), their luma (B, 1, hh, ww), the
    glyph index of each block (int64)): `(g * k).astype(int32)` clipped to
    [0, k - 1] of the jitted luma."""
    arr = lay.planes[0]
    h, w = arr.shape[-2:]
    crop = arr[:, :3, :(h // cell) * cell, :(w // cell) * cell]
    if arr.is_floating_point():
        mean_col = block_means(crop.to(torch.float32), cell)
    else:
        mean_col = block_means(crop.to(torch.float32), cell,
                               float(_F32(1.0 / 255.0)))
    g = luma_fma(mean_col)
    idx = torch.clamp((g * float(k)).to(torch.int32), 0, k - 1)
    return mean_col, g, idx.to(torch.int64)


def _up(x, cell):
    return x.repeat_interleave(cell, -2).repeat_interleave(cell, -1)


def _textfun_process(ins, p, ctx):
    """textfun.c (`:430-472`): each 8x8 block becomes the glyph whose ink
    density matches the block's luma; modes colour pixels / monochrome /
    greyscale / solid colours."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    h, w = rgb.shape[-2:]
    cell = 8
    hh, ww = h // cell, w // cell
    atlas = torch.from_numpy(glyph_atlas(cell)).to(rgb.device)
    mean_col, g, idx = textfun_glyphs(lay, cell, atlas.shape[0])
    B = rgb.shape[0]
    glyph = atlas[idx[:, 0]]                             # (B, hh, ww, c, c)
    canvas = glyph.permute(0, 1, 3, 2, 4).reshape(B, 1, hh * cell, ww * cell)
    gate = _up((g >= _p4(p["threshold"], rgb.device)).to(torch.float32),
               cell)
    canvas = canvas * gate
    mode = int(p["mode"])
    if mode == 0:    # colour pixels: glyphs in the block's mean colour
        out = _up(mean_col, cell) * canvas
    elif mode == 1:  # monochrome
        out = canvas.expand(-1, 3, -1, -1)
    elif mode == 2:  # greyscale: glyph scaled by block luma
        out = (canvas * _up(g, cell)).expand(-1, 3, -1, -1)
    else:            # solid colours: quantised block colour, no glyph shape
        out = _up(torch.round(mean_col * 4) / 4, cell) * gate
    ph, pw = h - out.shape[-2], w - out.shape[-1]
    if ph or pw:
        out = F.pad(out, (0, pw, 0, ph))
    return from_f01(join_alpha(torch.clamp(out, 0.0, 1.0), al), lay)


register_filter(Filter(
    name="textfun", process=_textfun_process, in_channels=_ONE_IN,
    params=(Param("threshold", "num", 0.1, 0.0, 1.0),
            Param("mode", "string_list", 0,
                  choices=("colour pixels", "monochrome", "greyscale",
                           "solid colours"))),
    description="frame as glyph-art text (textfun.c)"))


# -- photo_censor --------------------------------------------------------------

def _photo_censor_process(ins, p, ctx):
    """Censor a rectangle given in relative coordinates (`:486-511`):
    pixelate (each pixel reads its block's top-left corner), black bar or
    invert."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    h, w = rgb.shape[-2:]
    dev = rgb.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    def col(name):
        return per_frame(p[name], dev).reshape(-1, 1, 1)
    box = ((yy >= col("top") * h) & (yy < col("bottom") * h)
           & (xx >= col("left") * w) & (xx < col("right") * w))
    mode = int(p["mode"])
    if mode == 1:            # black bar
        repl = torch.zeros_like(rgb)
    elif mode == 2:          # invert
        repl = 1.0 - rgb
    else:                    # pixelate
        blk = max(2, int(p["block"]))
        ys = (torch.arange(h, device=dev) // blk) * blk
        xs = (torch.arange(w, device=dev) // blk) * blk
        repl = rgb[:, :, ys][:, :, :, xs]
    out = torch.where(box[:, None], repl, rgb)
    return from_f01(join_alpha(out, al), lay)


register_filter(Filter(
    name="photo_censor", process=_photo_censor_process, in_channels=_ONE_IN,
    params=(Param("left", "num", 0.25, 0.0, 1.0),
            Param("top", "num", 0.25, 0.0, 1.0),
            Param("right", "num", 0.75, 0.0, 1.0),
            Param("bottom", "num", 0.75, 0.0, 1.0),
            Param("mode", "string_list", 0,
                  choices=("pixelate", "black", "invert")),
            Param("block", "int", 16, 2, 128)),
    description="censor a region: pixelate / black bar / invert"))


# -- xeffect (graphic novel) --------------------------------------------------

def _src255(lay):
    """(the frame's RGB as float32 0-255 values (B, 3, H, W), its alpha
    channel as stored or None). A u8 frame's values are its bytes: the
    jitted plan folds `to_f01`'s 1/255 and the filter's * 255 into 1.0."""
    arr = lay.planes[0]
    if arr.is_floating_point():
        rgb, alpha = split_alpha(to_f01(lay))
        return rgb * 255.0, alpha
    rgb, alpha = split_alpha(arr)
    return rgb.to(torch.float32), alpha


def xeffect_edges(y100: torch.Tensor, thr) -> torch.Tensor:
    """(B, H, W) bool: 2 to 5 of the 8 neighbours (edges replicated)
    differ from the pixel by more than `thr` ((B, 1, 1) or a number)."""
    h, w = y100.shape[-2:]
    pad = F.pad(y100[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    nbr = torch.zeros_like(y100)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sh = pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            nbr = nbr + (torch.abs(sh - y100) > thr)
    return (nbr >= 2) & (nbr <= 5)


def _xeffect_process(ins, p, ctx):
    """Graphic-novel look (scripts/xeffect.script, `:528-555`): where 2-5
    neighbours differ in luma by more than the threshold, a pixel inks
    black (dark), white (bright) or keeps its colour."""
    lay = ins[0]
    rgb, alpha = _src255(lay)
    y100 = luma_fma(rgb)[:, 0] * 100.0     # the jit's luma of 0-255 values
    edge = xeffect_edges(y100, per_frame(p["threshold"], rgb.device)
                         .reshape(-1, 1, 1))
    yc = y100[:, None]
    ink = torch.where(yc < 12500.0, 0.0, torch.where(yc > 20000.0, 255.0,
                                                     rgb))
    out = torch.where(edge[:, None], ink, rgb)
    if lay.planes[0].is_floating_point():
        return from_f01(join_alpha(out / 255.0, alpha), lay)
    return lay.replace(planes=(join_alpha(out.to(torch.uint8), alpha),))


register_filter(Filter(
    name="xeffect", process=_xeffect_process, in_channels=_ONE_IN,
    params=(Param("threshold", "num", 10000.0, 1000.0, 25000.0),),
    description="graphic novel: luma-edge ink quantise "
                "(scripts/xeffect.script)"))


# -- haip (autonomous painter) ------------------------------------------------

HAIP_WURMS, HAIP_WLEN = 48, 32     # num_wurms * WMULT ceiling, haip.c WLEN


def haip_trails(frame, h: int, w: int, device):
    """The wurms of each frame (`:582-592`): (xs, ys) int64 (B, n, wlen)
    trail positions and bright (B, n, wlen) float32, from
    `fold_in(PRNGKey(1913), frame)` split four ways, bit for bit."""
    n, wlen = HAIP_WURMS, HAIP_WLEN
    key = prng.fold_in(prng.prng_key(1913, device),
                       torch.as_tensor(frame, device=device).reshape(-1))
    ks = prng.split(key, 4)
    sx = prng.randint(ks[:, 0], (n, 1), 1, w - 1).to(torch.int64)
    sy = prng.randint(ks[:, 1], (n, 1), 1, h - 1).to(torch.int64)
    steps = prng.randint(ks[:, 2], (2, n, wlen), -1, 2).to(torch.int64)
    xs = torch.clamp(sx + torch.cumsum(steps[:, 0], 2), 1, w - 2)
    ys = torch.clamp(sy + torch.cumsum(steps[:, 1], 2), 1, h - 2)
    bright = 1.0 + 0.05 * (prng.uniform(ks[:, 3], (n, wlen)) < 0.01) \
        .to(torch.float32)
    return xs, ys, bright


def scatter_last(out: torch.Tensor, flat: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """out (B, C, P) with vals (B, C, N) written at flat (B, N) positions,
    in index order, so that where positions repeat the last write wins
    (XLA's CPU scatter). The winner of each position is the largest write
    order there (`scatter_reduce` amax); every write then stores its
    position's winning value, so repeated positions receive equal values
    and the result does not depend on the order the device writes them."""
    B, C, P = out.shape
    N = flat.shape[1]
    order = torch.arange(N, device=out.device).expand(B, N)
    win = torch.full((B, P), -1, dtype=torch.int64, device=out.device)
    win.scatter_reduce_(1, flat, order, "amax")
    src = torch.gather(vals, 2, win.gather(1, flat)[:, None].expand(B, C, N))
    return out.scatter(2, flat[:, None].expand(B, C, N), src)


def _haip_process(ins, p, ctx):
    """haip.c (`:567-602`): 48 wurms start at random positions each frame
    and random-walk 32 steps, smearing the source colour (5 % brighter at
    1 % of the steps) in 3x3 blocks along their trails; the active share
    is `wurms` / 100, the rest park (they rewrite what is there)."""
    lay = ins[0]
    src, alpha = _src255(lay)
    B, C, h, w = src.shape
    dev = src.device
    n, wlen = HAIP_WURMS, HAIP_WLEN
    # / 100 as the jit computes it: times float32(0.01)
    amount = torch.clamp(per_frame(p["wurms"], dev) * float(_F32(0.01)),
                         0, 1)
    xs, ys, bright = haip_trails(ctx.frame, h, w, dev)
    Bk = max(B, xs.shape[0])
    xs, ys = xs.expand(Bk, n, wlen), ys.expand(Bk, n, wlen)
    src = src.expand(Bk, C, h, w)
    active = (torch.arange(n, device=dev)[None, :, None]
              < (amount * n).reshape(-1, 1, 1)).expand(-1, n, wlen) \
        .reshape(-1, 1, n * wlen)
    flat0 = (ys * w + xs).reshape(Bk, n * wlen)
    out = src.reshape(Bk, C, h * w)
    colour = torch.gather(out, 2, flat0[:, None].expand(Bk, C, n * wlen)) \
        * bright.reshape(-1, 1, n * wlen)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy = torch.clamp(ys + dy, 0, h - 1)
            xx = torch.clamp(xs + dx, 0, w - 1)
            flat = (yy * w + xx).reshape(Bk, n * wlen)
            here = torch.gather(out, 2, flat[:, None].expand(Bk, C,
                                                             n * wlen))
            out = scatter_last(out, flat, torch.where(active, colour, here))
    out = torch.clamp(out.reshape(Bk, C, h, w), 0, 255)
    if lay.planes[0].is_floating_point():
        return from_f01(join_alpha(out / 255.0, alpha), lay)
    # the jit folds / 255 and from_f01's * 255 away: floor(out + 0.5)
    u8 = torch.floor(out + 0.5).to(torch.uint8)
    return lay.replace(planes=(join_alpha(u8, alpha),))


register_filter(Filter(
    name="haip", process=_haip_process, in_channels=_ONE_IN,
    params=(Param("wurms", "num", 80.0, 0.0, 100.0),),
    description="autonomous painting wurms smear brightened source "
                "trails (haip.c)"))
