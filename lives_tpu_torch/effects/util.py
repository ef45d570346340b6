"""Shared helpers for builtin effects: normalised-float RGB views.

Counterpart of `lives_tpu/effects/util.py:15-111`. Arrays here are batched:
an RGB view is ``(B, C, H, W)``, a per-frame parameter is a ``(B,)`` tensor
(or a Python number), and `bparam` gives it the shape that broadcasts
against the view. `bilinear` is the port's `jax.scipy.ndimage.
map_coordinates(order=1)`, which the compositor (`lives_tpu/effects/
builtin/blends.py:364-389`) and the coordinate warps of `geometry.py` and
`effectv.py` sample through.
"""

from __future__ import annotations

import torch

from ..layer import Layer
from ..ops.colorspace import INV255, quantise_u8

def bparam(v):
    """A per-frame parameter shaped to broadcast over ``(B, C, H, W)``:
    a ``(B,)`` tensor becomes ``(B, 1, 1, 1)``; scalars pass through."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.reshape(-1, 1, 1, 1)
    return v


def per_frame(v, device) -> torch.Tensor:
    """A per-frame value (a number or a (B,) tensor) as a float32 (B,)
    tensor, (1,) for a number, on `device`: rounded to float32 as the JAX
    package's traced scalar is."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)


def to_f01(layer: Layer) -> torch.Tensor:
    """Canonical ``(B, C, H, W)`` float32 view in [0,1] of an RGB-family
    layer."""
    arr = layer.planes[0]
    if arr.is_floating_point():
        return arr.to(torch.float32)
    return arr.to(torch.float32) * INV255


def from_f01(arr: torch.Tensor, like: Layer) -> Layer:
    """Back to the layer's storage dtype (round-half-up, clamped before the
    cast, for uint8)."""
    ref = like.planes[0]
    if ref.is_floating_point():
        return like.replace(planes=(arr.to(ref.dtype),))
    return like.replace(planes=(quantise_u8(arr),))


def split_alpha(arr: torch.Tensor):
    """``(B, C, H, W)`` -> (rgb ``(B, 3, H, W)``, alpha ``(B, 1, H, W)`` or
    None)."""
    if arr.shape[1] == 4:
        return arr[:, :3], arr[:, 3:4]
    return arr, None


def join_alpha(rgb: torch.Tensor, alpha):
    if alpha is None:
        return rgb
    return torch.cat([rgb, alpha], 1)


def luma(rgb_f01: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of a ``(B, 3, H, W)`` [0,1] array, as ``(B, 1, H, W)``."""
    return (0.299 * rgb_f01[:, 0:1] + 0.587 * rgb_f01[:, 1:2]
            + 0.114 * rgb_f01[:, 2:3])


def _normalise(x, y, h: int, w: int, centered: bool):
    """Pixel coordinates -> [0,1] (or -1..1 when centered). A Python scale
    multiplies a float32 tensor as a float32, the factor
    `lives_tpu/effects/util.py:72-78` uses."""
    if centered:
        return (x * (2.0 / max(w - 1, 1)) - 1.0,
                y * (2.0 / max(h - 1, 1)) - 1.0)
    return x * (1.0 / max(w - 1, 1)), y * (1.0 / max(h - 1, 1))


def lazy_grid(h: int, w: int, centered: bool = False, *,
              device: torch.device | str):
    """(x, y) float32 coordinate grids of shape (h, w)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return _normalise(x, y, h, w, centered)


def ctx_grid(ctx, h: int, w: int, centered: bool = False, *,
             device: torch.device | str):
    """Frame-coordinate grids for the current (sub)tile.

    Like `lazy_grid`, but when ctx carries a tile origin (ctx.y0, ctx.x0)
    and the full-frame dims (ctx.height, ctx.width) the grids hold the
    FULL-FRAME normalised coordinates of this tile's pixels, clamped to the
    frame (halo pixels replicate the edge). For a whole frame
    (y0 == x0 == 0, ctx dims == shape) this equals lazy_grid(h, w,
    centered). Coordinate-dependent effects use this so a tiled caller
    gets the same pixels as a whole-frame one."""
    H = int(getattr(ctx, "height", 0) or h)
    W = int(getattr(ctx, "width", 0) or w)
    y0 = int(getattr(ctx, "y0", 0))
    x0 = int(getattr(ctx, "x0", 0))
    yi = torch.clamp(torch.arange(h, device=device) + y0, 0, H - 1)
    xi = torch.clamp(torch.arange(w, device=device) + x0, 0, W - 1)
    y, x = torch.meshgrid(yi.to(torch.float32), xi.to(torch.float32),
                          indexing="ij")
    return _normalise(x, y, H, W, centered)


def bilinear(src: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
             mode: str = "constant") -> torch.Tensor:
    """`jax.scipy.ndimage.map_coordinates(src[b, c], [v[b], u[b]],
    order=1, mode=mode)` for every frame and channel: src (B, C, H, W),
    v and u (B or 1, h, w) float32 -> (B, C, h, w).

    Each axis gives the corners floor(coord) and floor(coord) + 1 with
    weights 1 - frac and frac; the four are summed in JAX's order (v0, u0),
    (v0, u1), (v1, u0), (v1, u1), each weighted by wy * wx
    (`jax/_src/scipy/ndimage.py` `_map_coordinates`). In mode "constant" a
    corner outside the plane contributes 0; in mode "nearest" its index is
    clipped to [0, size - 1] and it contributes."""
    if mode not in ("constant", "nearest"):
        raise ValueError(f"bilinear: unknown mode {mode!r}")
    B, C, H, W = src.shape
    v, u = torch.broadcast_tensors(v, u)
    v = v.expand(B, *v.shape[1:])
    u = u.expand(B, *u.shape[1:])
    flat = src.reshape(B, C, H * W)
    nodes = []
    for coord in (v, u):
        lo = torch.floor(coord)
        up_w = coord - lo
        idx = lo.to(torch.int64)
        nodes.append(((idx, 1 - up_w), (idx + 1, up_w)))
    out = None
    for (iy, wy) in nodes[0]:
        for (ix, wx) in nodes[1]:
            at = (torch.clamp(iy, 0, H - 1) * W
                  + torch.clamp(ix, 0, W - 1)).reshape(B, 1, -1)
            val = torch.gather(flat, 2, at.expand(B, C, -1)).reshape(
                B, C, *v.shape[1:])
            if mode == "constant":
                ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                val = torch.where(ok[:, None], val, 0.0)
            term = (wy * wx)[:, None] * val
            out = term if out is None else out + term
    return out
