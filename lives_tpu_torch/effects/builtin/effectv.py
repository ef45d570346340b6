"""Stateful feedback effects: `rgb_delay`, `fire`, `life`, `alien_overlay`,
`blurzoom`, `onedtv`, `nervous`, `feedback`, `vertigo`, and the stateless
`edge`.

Counterpart of `lives_tpu/effects/builtin/effectv.py:35-402` (reference
`RGBdelay.c`, `fireTV.c`, `lifeTV.c`, `blurzoom.c`, `onedTV.c`,
`nervousTV.c`, `edge.c`, `vertigoTV`, `scripts/alien_overlay.script`),
every filter of that module. State is explicit, as in the JAX package:
`process(ins, params, ctx, state) -> (out, new_state)`, one frame
``(1, C, H, W)`` at a time, with the state in the JAX package's contract
(fire and blurzoom ``(H, W)`` f32, life ``(H, W)`` u8 0/1, alien_overlay,
feedback and vertigo ``(3, H, W)`` f32, onedtv ``{"row": int32, "acc":
(3, H, W) f32}``, rgb_delay ``{"ring": (16, 3, H, W) u8, "head": int32}``,
nervous ``{"ring": (8, 3, H, W) u8, "head": int32}``), so a state carries
over between the packages (`graph.nodemodel.states_from_numpy`). A
per-frame parameter is a ``(1,)`` tensor, which broadcasts like the JAX
package's scalar; `edge`, stateless, takes a batch.

The spatial steps of fire and life live in `*_core` functions with
edge-CLAMPED shifts, as in the JAX package; the plain frame loop uses them,
and the fused stateful sweep kernel (`csrc/stateful_sweep.cu`) evaluates
the same formulas per pixel at clamped coordinates. blurzoom and edge read
their neighbours with `roll`, which wraps. feedback and vertigo sample
their state through `effects.util.bilinear` in mode "nearest".

rgb_delay and nervous write the current frame into their rings in place
(the JAX package returns a new ring; the in-place write saves a 99.5 MB
copy a 1080p frame for rgb_delay). nervous shows the slot
`randint(fold_in(PRNGKey(1234), frame), (), 0, 8)` (`utils.prng`, on the
device: the frame number is the packed column's, never read back).
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ...ops.colorspace import INV255, quantise_u8
from ...ops.resize import resize_plane
from ...utils import prng
from ..host import (ChannelTemplate, FILTER_STATEFUL, Filter, Param,
                    register_filter)
from ..util import (bilinear, from_f01, join_alpha, luma, per_frame,
                    split_alpha, to_f01)

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)

MAX_DELAY = 16


def _stateful(name, process, init_state, params=(), desc=""):
    return register_filter(Filter(
        name=name, process=process, in_channels=_ONE_IN,
        params=tuple(params), flags=FILTER_STATEFUL,
        init_state=init_state, description=desc))


# -- rgb_delay ---------------------------------------------------------------

def _rgbdelay_init(w, h, pal, device):
    return {"ring": torch.zeros((MAX_DELAY, 3, h, w), dtype=torch.uint8,
                                device=device),
            "head": torch.zeros((), dtype=torch.int32, device=device)}


def _rgbdelay_process(ins, p, ctx, state):
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    head = state["head"]
    ring = state["ring"]
    # a device-side index: no host sync on the frame loop's path
    ring.index_copy_(0, head.reshape(1).long(), quantise_u8(rgb))

    def chan(d, c):
        # delays clip, then truncate to int32; (head - d) % 16 floors, as
        # torch.remainder does (C's % would not)
        d = torch.clamp(torch.as_tensor(d, device=ring.device), 0,
                        MAX_DELAY - 1).to(torch.int32)
        idx = torch.remainder(head - d, MAX_DELAY).reshape(-1)
        return ring.index_select(0, idx.long())[:, c].to(torch.float32) \
            * INV255

    out = torch.stack([chan(p["delay_r"], 0), chan(p["delay_g"], 1),
                       chan(p["delay_b"], 2)], 1)
    return (from_f01(join_alpha(out, al), lay),
            {"ring": ring, "head": torch.remainder(head + 1, MAX_DELAY)})


_stateful("rgb_delay", _rgbdelay_process, _rgbdelay_init,
          params=(Param("delay_r", "num", 0.0, 0.0, MAX_DELAY - 1),
                  Param("delay_g", "num", 4.0, 0.0, MAX_DELAY - 1),
                  Param("delay_b", "num", 8.0, 0.0, MAX_DELAY - 1)),
          desc="per-channel temporal delay (RGBdelay.c)")


# -- fire --------------------------------------------------------------------

def _shift_lr(a):
    """Column neighbours with edge clamp: (left, right) of a (..., W)."""
    left = torch.cat([a[..., :1], a[..., :-1]], -1)
    right = torch.cat([a[..., 1:], a[..., -1:]], -1)
    return left, right


def fire_core(mid_ext, cooling):
    """One fire propagation step. `mid_ext` is max(state, sparks) with
    ONE extra row BELOW (edge-clamped): (n+1, W) -> (n, W)."""
    up = mid_ext[1:]
    left, right = _shift_lr(up)
    return (up * 2.0 + left + right) * 0.25 * (1.0 - 0.04 - cooling * 0.1)


def fire_flame(buf):
    """Fire palette black->red->yellow->white: (n, W) -> (3, n, W)."""
    fr = torch.clamp(buf * 3.0, 0.0, 1.0)
    fg = torch.clamp(buf * 3.0 - 1.0, 0.0, 1.0)
    fb = torch.clamp(buf * 3.0 - 2.0, 0.0, 1.0)
    return torch.stack([fr, fg, fb])


def fire_compose(rgb, flame, amount):
    base = rgb * (1.0 - amount)
    return torch.clamp(torch.maximum(base, flame * amount + base), 0.0, 1.0)


def _fire_init(w, h, pal, device):
    return torch.zeros((h, w), dtype=torch.float32, device=device)


def _fire_process(ins, p, ctx, state):
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    g = luma(rgb[None])[0, 0]
    # spark injection where the image is bright
    sparks = torch.where(g > p["threshold"], g, 0.0)
    mid = torch.maximum(state, sparks)
    # flames rise: up-shift + neighbour average + decay (edge-clamped)
    buf = fire_core(torch.cat([mid, mid[-1:]], 0), p["cooling"])
    out = fire_compose(rgb, fire_flame(buf), p["amount"])
    return from_f01(join_alpha(out[None], al), lay), buf


_stateful("fire", _fire_process, _fire_init,
          params=(Param("threshold", "num", 0.6, 0.0, 1.0),
                  Param("cooling", "num", 0.3, 0.0, 1.0),
                  Param("amount", "num", 1.0, 0.0, 1.0)),
          desc="rising flames from bright areas (fireTV.c)")


# -- life --------------------------------------------------------------------

def _life_init(w, h, pal, device):
    return torch.zeros((h, w), dtype=torch.uint8, device=device)


def life_core(cells_ext, g_ext, threshold):
    """One life step. `cells_ext` is the f32 cell field with one
    edge-clamped row above AND below ((n+2, W)); `g_ext` is comp luma
    with one clamped row ABOVE ((n+1, W)). Returns f32 0/1 (n, W)."""
    above, mid, below = cells_ext[:-2], cells_ext[1:-1], cells_ext[2:]
    al_, ar_ = _shift_lr(above)
    ml_, mr_ = _shift_lr(mid)
    bl_, br_ = _shift_lr(below)
    n = above + below + al_ + ar_ + ml_ + mr_ + bl_ + br_
    born = n == 3.0
    survive = (mid > 0) & ((n == 2.0) | (n == 3.0))
    # seed new life from image edges (luma gradient, edge-clamped)
    g = g_ext[1:]
    gl, _ = _shift_lr(g)
    gx = torch.abs(g - gl)
    gy = torch.abs(g - g_ext[:-1])
    seed = (gx + gy) > threshold
    return (born | survive | seed).to(torch.float32)


def _life_process(ins, p, ctx, state):
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    g = luma(rgb[None])[0, 0]
    cells = state.to(torch.float32)
    cells_ext = torch.cat([cells[:1], cells, cells[-1:]], 0)
    g_ext = torch.cat([g[:1], g], 0)
    overlay = life_core(cells_ext, g_ext, p["threshold"])
    out = torch.clamp(rgb + overlay[None] * p["amount"], 0.0, 1.0)
    return (from_f01(join_alpha(out[None], al), lay),
            overlay.to(torch.uint8))


_stateful("life", _life_process, _life_init,
          params=(Param("threshold", "num", 0.2, 0.0, 1.0),
                  Param("amount", "num", 0.6, 0.0, 1.0)),
          desc="Conway life seeded by image edges (lifeTV.c)")


# -- alien overlay (scripts/alien_overlay.script) -----------------------------

def _alien_init(w, h, pal, device):
    return torch.zeros((3, h, w), dtype=torch.float32, device=device)


def alien_core(rgb, ghost_old):
    """Pointwise ghost blend (shared with the fused stateful sweep)."""
    ghost = ghost_old + (rgb - ghost_old) * 0.1
    return torch.clamp(rgb * 0.5 + ghost * 0.5, 0.0, 1.0), ghost


def _alien_process(ins, p, ctx, state):
    """Blend the frame with a slow exponential ghost of itself: static
    areas stay solid, motion leaves translucent trails."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    out, ghost = alien_core(rgb[0], state)
    return from_f01(join_alpha(out[None], al), lay), ghost


_stateful("alien_overlay", _alien_process, _alien_init,
          desc="ghost-blend motion trails (alien_overlay.script)")


# -- blurzoom (radioactive glow) --------------------------------------------

def _blurzoom_init(w, h, pal, device):
    return torch.zeros((h, w), dtype=torch.float32, device=device)


def _blurzoom_process(ins, p, ctx, state):
    """Edges (wrapping neighbours) add glow to a buffer that zooms out by
    5 % and decays each frame (`effectv.py:187-209`)."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    dev = rgb.device
    h, w = rgb.shape[-2:]
    g = luma(rgb[None])[0, 0]
    edges = torch.abs(g - torch.roll(g, 1, 1)) \
        + torch.abs(g - torch.roll(g, 1, 0))
    buf = state + torch.where(edges > 0.25, 1.0, 0.0)
    zh, zw = int(h * 0.95), int(w * 0.95)
    inner = resize_plane(buf, zh, zw, "bilinear")
    pad_t, pad_l = (h - zh) // 2, (w - zw) // 2
    buf = torch.nn.functional.pad(
        inner, (pad_l, w - zw - pad_l, pad_t, h - zh - pad_t))
    buf = buf * (0.75 + 0.2 * (1.0 - per_frame(p["decay"], dev)))
    glow = torch.stack([per_frame(p["red"], dev), per_frame(p["green"], dev),
                        per_frame(p["blue"], dev)]).reshape(3, 1, 1)
    out = torch.clamp(rgb + buf[None] * glow * per_frame(p["amount"], dev),
                      0.0, 1.0)
    return from_f01(join_alpha(out[None], al), lay), buf


_stateful("blurzoom", _blurzoom_process, _blurzoom_init,
          params=(Param("decay", "num", 0.5, 0.0, 1.0),
                  Param("amount", "num", 0.8, 0.0, 1.0),
                  Param("red", "num", 0.3, 0.0, 1.0),
                  Param("green", "num", 1.0, 0.0, 1.0),
                  Param("blue", "num", 0.3, 0.0, 1.0)),
          desc="expanding motion glow (blurzoom.c radioacTV)")


# -- onedTV ------------------------------------------------------------------

def _oned_init(w, h, pal, device):
    return {"row": torch.zeros((), dtype=torch.int32, device=device),
            "acc": torch.zeros((3, h, w), dtype=torch.float32,
                               device=device)}


def _oned_process(ins, p, ctx, state):
    """Freeze one scan line a frame into an accumulator, a bright cursor
    line below it (`effectv.py:222-235`). The row is a device index."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    h = rgb.shape[-2]
    row = state["row"]
    at = row.reshape(1).long()
    acc = state["acc"].index_copy(1, at, rgb.index_select(1, at))
    out = acc.index_fill(1, torch.remainder(at + 1, h), 1.0)
    speed = torch.clamp(per_frame(p["speed"], rgb.device), min=1.0) \
        .to(torch.int32).reshape(())
    return (from_f01(join_alpha(out[None], al), lay),
            {"row": torch.remainder(row + speed, h).to(torch.int32),
             "acc": acc})


_stateful("onedtv", _oned_process, _oned_init,
          params=(Param("speed", "num", 1.0, 1.0, 16.0),),
          desc="scanline-at-a-time freeze (onedTV.c)")


# -- nervous -----------------------------------------------------------------

NERVOUS_DEPTH = 8


def _nervous_init(w, h, pal, device):
    # a rotating u8 ring, written in place (see rgb_delay)
    return {"ring": torch.zeros((NERVOUS_DEPTH, 3, h, w), dtype=torch.uint8,
                                device=device),
            "head": torch.zeros((), dtype=torch.int32, device=device)}


def nervous_slot(frame, device) -> torch.Tensor:
    """The ring slot nervous shows at `frame` (an int or a (B,) integer
    tensor): `randint(fold_in(PRNGKey(1234), frame), (), 0, 8)`, int32."""
    key = prng.fold_in(prng.prng_key(1234, device), frame)
    return prng.randint(key, (), 0, NERVOUS_DEPTH)


def _nervous_process(ins, p, ctx, state):
    """Store the frame, show a random one of the last eight
    (`effectv.py:255-277`)."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    head, ring = state["head"], state["ring"]
    ring.index_copy_(0, head.reshape(1).long(), quantise_u8(rgb))
    frame = torch.as_tensor(ctx.frame, device=ring.device).reshape(-1)
    idx = nervous_slot(frame.to(torch.int32), ring.device)
    out = ring.index_select(0, idx.long()).to(torch.float32) * INV255
    return (from_f01(join_alpha(out, al), lay),
            {"ring": ring,
             "head": torch.remainder(head + 1, NERVOUS_DEPTH)})


_stateful("nervous", _nervous_process, _nervous_init,
          desc="random recent-frame flashback (nervousTV.c)")


# -- video feedback and vertigo ---------------------------------------------

def _warp_init(w, h, pal, device):
    return torch.zeros((3, h, w), dtype=torch.float32, device=device)


def _feed_back(lay, rgb, al, state, yy, xx, fb):
    """The frame over the state sampled at (yy, xx), edges clamped; the
    blend is the new state."""
    prev = bilinear(state[None], yy[None], xx[None], "nearest")[0]
    out = torch.clamp(rgb * (1.0 - fb) + prev * fb, 0.0, 1.0)
    return from_f01(join_alpha(out[None], al), lay), out


def _feedback_process(ins, p, ctx, state):
    """The previous output zoomed about the centre under the frame
    (`effectv.py:292-311`)."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    dev = rgb.device
    h, w = rgb.shape[-2:]
    z = 0.9 + per_frame(p["zoom"], dev) * 0.2  # 0.9 .. 1.1
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy) \
        / z + cy
    xx = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx) \
        / z + cx
    yy = torch.clamp(yy.expand(h, w), 0, h - 1)
    xx = torch.clamp(xx.expand(h, w), 0, w - 1)
    return _feed_back(lay, rgb, al, state, yy, xx,
                      per_frame(p["feedback"], dev))


_stateful("feedback", _feedback_process, _warp_init,
          params=(Param("feedback", "num", 0.7, 0.0, 0.98),
                  Param("zoom", "num", 0.6, 0.0, 1.0)),
          desc="classic video feedback tunnel")


def _vertigo_process(ins, p, ctx, state):
    """The previous output rotated and zoomed under the frame
    (`effectv.py:345-368`)."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    rgb = rgb[0]
    dev = rgb.device
    h, w = rgb.shape[-2:]
    th = (per_frame(p["speed"], dev) - 0.5) * 0.2  # rotation per frame
    z = 1.0 + per_frame(p["zoom"], dev) * 0.1
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    cs, sn = torch.cos(th) / z, torch.sin(th) / z
    yy = torch.clamp(cy + y * cs - x * sn, 0, h - 1)
    xx = torch.clamp(cx + y * sn + x * cs, 0, w - 1)
    return _feed_back(lay, rgb, al, state, yy, xx,
                      per_frame(p["feedback"], dev))


_stateful("vertigo", _vertigo_process, _warp_init,
          params=(Param("feedback", "num", 0.7, 0.0, 0.98),
                  Param("speed", "num", 0.6, 0.0, 1.0),
                  Param("zoom", "num", 0.5, 0.0, 1.0)),
          desc="rotating/zooming feedback (vertigoTV)")


# -- edge (EffecTV edge detect) ----------------------------------------------

def _edge_process(ins, p, ctx):
    """Gradient magnitude from wrapping neighbours, tinted, over the frame
    (`effectv.py:317-330`); a batch of frames."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    g = luma(rgb)
    gx = torch.roll(g, -1, 3) - torch.roll(g, 1, 3)
    gy = torch.roll(g, -1, 2) - torch.roll(g, 1, 2)
    dev = rgb.device

    def pv(name):  # a per-frame value as (B or 1, 1, 1, 1)
        return per_frame(p[name], dev).reshape(-1, 1, 1, 1)
    mag = torch.sqrt(gx * gx + gy * gy) * pv("gain")
    tinted = mag * torch.cat(torch.broadcast_tensors(
        pv("red"), pv("green"), pv("blue")), 1)
    amount = pv("amount")
    out = torch.clamp(rgb * (1.0 - amount) + tinted * amount, 0.0, 1.0)
    return from_f01(join_alpha(out, al), lay)


register_filter(Filter(
    name="edge", process=_edge_process, in_channels=_ONE_IN,
    params=(Param("gain", "num", 2.0, 0.1, 10.0),
            Param("amount", "num", 1.0, 0.0, 1.0),
            Param("red", "num", 1.0, 0.0, 1.0),
            Param("green", "num", 1.0, 0.0, 1.0),
            Param("blue", "num", 1.0, 0.0, 1.0)),
    description="Sobel edge glow (edge detect, EffecTV)"))
