"""Stateful feedback effects: `rgb_delay`, `fire`, `life`, `alien_overlay`.

Counterpart of `lives_tpu/effects/builtin/effectv.py:35-184,378-402`
(reference `RGBdelay.c`, `fireTV.c`, `lifeTV.c`,
`scripts/alien_overlay.script`). State is explicit, as in the JAX package:
`process(ins, params, ctx, state) -> (out, new_state)`, one frame
``(1, C, H, W)`` at a time, with the state in the JAX package's contract
(fire ``(H, W)`` f32, life ``(H, W)`` u8 0/1, alien_overlay ``(3, H, W)``
f32, rgb_delay ``{"ring": (16, 3, H, W) u8, "head": int32}``), so a state
carries over between the packages (`graph.nodemodel.states_from_numpy`).
A per-frame parameter is a ``(1,)`` tensor, which broadcasts like the JAX
package's scalar.

The spatial steps live in `*_core` functions with edge-CLAMPED shifts, as
in the JAX package; the plain frame loop uses them, and the fused stateful
sweep kernel (`csrc/stateful_sweep.cu`) evaluates the same formulas per
pixel at clamped coordinates.

rgb_delay writes the current frame into its ring in place (the JAX package
returns a new ring; the in-place write saves a 99.5 MB copy a 1080p frame).

Not ported yet; a chain holding one raises `NotImplementedError` naming
its ROADMAP item (`DEFERRED`, read by `events.renderer._chain_for`).
"""

from __future__ import annotations

import torch

from ...constants import Palette
from ...ops.colorspace import INV255, quantise_u8
from ..host import (ChannelTemplate, FILTER_STATEFUL, Filter, Param,
                    register_filter)
from ..util import from_f01, join_alpha, luma, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)

MAX_DELAY = 16

#: EffecTV filters of the JAX package the port does not hold yet
DEFERRED = {
    "blurzoom": "ROADMAP Queue 1 item 15: its zoom runs "
                "ops/resize.resize_plane, which the port holds",
    "feedback": "ROADMAP Queue 1 item 15: it needs bilinear "
                "map_coordinates",
    "vertigo": "ROADMAP Queue 1 item 15: it needs bilinear map_coordinates",
    "nervous": "ROADMAP Queue 1 item 15: it needs an integer port of "
               "jax.random.randint",
    "onedtv": "ROADMAP Queue 1 item 15",
    "edge": "ROADMAP Queue 1 item 15",
}


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
