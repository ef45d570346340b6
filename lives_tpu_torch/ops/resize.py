"""Resize / letterbox engine (reference `resize_layer_full`, LiVES
`src/colourspace.c:14759`, `letterbox_layer` :15343, `unletterbox_layer`
:15570).

Counterpart of `lives_tpu/ops/resize.py:31-195`. Resampling is separable,
so a resize is two dense interpolation-matrix products
`A_h @ img @ A_w^T` in float32; the JAX package leaves them to XLA, outside
any Pallas kernel, and the port leaves them to `torch.einsum`. The
matrices are built on the host per (n_in, n_out, method) (`interp_matrix`,
a copy) and cached on each device. Planes may carry leading batch axes.

Methods: 'nearest', 'bilinear' (half-pixel centres), 'area' (box filter),
'smooth' (area for downscale / bilinear for upscale, per axis).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (CHROMA_SUBSAMPLING, Palette, has_alpha,
                         is_float_palette, is_rgb_palette, is_yuv_palette)
from ..layer import Layer


@lru_cache(maxsize=256)
def interp_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) float32 resampling matrix, rows sum to 1."""
    if method == "smooth":
        method = "area" if n_out < n_in else "bilinear"
    a = np.zeros((n_out, n_in), np.float64)
    if n_in == n_out:
        np.fill_diagonal(a, 1.0)
        return a.astype(np.float32)
    scale = n_in / n_out
    if method == "nearest":
        src = np.minimum((np.arange(n_out) * scale + scale * 0.5).astype(int),
                         n_in - 1)
        a[np.arange(n_out), src] = 1.0
    elif method == "bilinear":
        x = (np.arange(n_out) + 0.5) * scale - 0.5
        x = np.clip(x, 0.0, n_in - 1.0)
        i0 = np.floor(x).astype(int)
        i1 = np.minimum(i0 + 1, n_in - 1)
        f = x - i0
        a[np.arange(n_out), i0] += 1.0 - f
        a[np.arange(n_out), i1] += f
    elif method == "area":
        for o in range(n_out):
            lo, hi = o * scale, (o + 1) * scale
            i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
            for i in range(i0, min(i1, n_in)):
                w = min(hi, i + 1) - max(lo, i)
                if w > 0:
                    a[o, i] = w
            a[o] /= a[o].sum()
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return a.astype(np.float32)


@lru_cache(maxsize=256)
def _matrix_on(n_in: int, n_out: int, method: str,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(interp_matrix(n_in, n_out, method)).to(device)


def resize_plane(p: torch.Tensor, h_out: int, w_out: int,
                 method: str = "bilinear") -> torch.Tensor:
    """Resize one plane (..., H, W) -> (..., h_out, w_out). uint8 or
    float."""
    h_in, w_in = p.shape[-2], p.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return p
    f = p.to(torch.float32)
    ah = _matrix_on(h_in, h_out, method, p.device)
    aw = _matrix_on(w_in, w_out, method, p.device)
    out = torch.einsum("oh,...hw->...ow", ah, f)
    out = torch.einsum("...ow,xw->...ox", out, aw)
    if not p.is_floating_point():
        out = torch.clamp(torch.floor(out + 0.5), 0, 255).to(p.dtype)
    return out


def resize_layer(layer: Layer, width: int, height: int,
                 method: str = "smooth") -> Layer:
    """Resize a layer to (width, height) keeping palette/metadata."""
    if (layer.width, layer.height) == (width, height):
        return layer
    pal = Palette(layer.palette)
    if is_yuv_palette(pal):
        sh, sv = CHROMA_SUBSAMPLING[pal]
        y = resize_plane(layer.planes[0], height, width, method)
        u = resize_plane(layer.planes[1], height // sv, width // sh, method)
        v = resize_plane(layer.planes[2], height // sv, width // sh, method)
        planes = [y, u, v]
        if len(layer.planes) > 3:
            planes.append(resize_plane(layer.planes[3], height, width,
                                       method))
        return layer.replace(planes=tuple(planes))
    return layer.replace(planes=tuple(resize_plane(p, height, width, method)
                                      for p in layer.planes))


def letterbox_geometry(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Scaled size + offsets to fit src aspect inside dst (reference
    `get_letterbox_sizes`, maintains aspect, centred)."""
    scale = min(dst_w / src_w, dst_h / src_h)
    lw = max(2, int(src_w * scale) & ~1)
    lh = max(2, int(src_h * scale) & ~1)
    ox = (dst_w - lw) // 2
    oy = (dst_h - lh) // 2
    return lw, lh, ox, oy


def _black_values(layer: Layer):
    """Per-plane black levels for a palette (YUV black = (min_y,128,128))."""
    pal = Palette(layer.palette)
    if is_yuv_palette(pal):
        ymin = 16 if layer.clamping == 0 else 0
        vals = [ymin, 128, 128]
        if len(layer.planes) > 3:
            vals.append(255)
        return vals
    if is_float_palette(pal):
        return [0.0] * len(layer.planes)
    return [0] * len(layer.planes)


def letterbox_layer(layer: Layer, width: int, height: int,
                    method: str = "smooth") -> Layer:
    """Resize into (width, height) preserving aspect, pad with black bars
    (reference letterbox_layer)."""
    lw, lh, ox, oy = letterbox_geometry(layer.width, layer.height,
                                        width, height)
    inner = resize_layer(layer, lw, lh, method)
    pal = Palette(layer.palette)
    blacks = _black_values(layer)
    subs = CHROMA_SUBSAMPLING.get(pal, (1, 1))
    out_planes = []
    for idx, p in enumerate(inner.planes):
        sh, sv = subs if is_yuv_palette(pal) and idx in (1, 2) else (1, 1)
        th, tw = height // sv, width // sh
        pox, poy = ox // sh, oy // sv
        ph, pw = p.shape[-2], p.shape[-1]
        value = 0 if is_rgb_palette(pal) else blacks[idx]
        out_planes.append(F.pad(p, (pox, tw - pox - pw, poy, th - poy - ph),
                                value=value))
    out = layer.replace(planes=tuple(out_planes))
    # RGB alpha bars are opaque
    if is_rgb_palette(pal) and has_alpha(pal):
        arr = out.planes[0].clone()
        a = arr[..., -1, :, :]
        opaque = 1.0 if is_float_palette(pal) else 255
        mask = torch.zeros(a.shape[-2:], dtype=torch.bool, device=a.device)
        mask[oy:oy + lh, ox:ox + lw] = True
        arr[..., -1, :, :] = torch.where(mask, a,
                                         torch.full_like(a, opaque))
        out = out.replace(planes=(arr,))
    return out


def unletterbox_layer(layer: Layer, lw: int, lh: int, ox: int,
                      oy: int) -> Layer:
    """Crop letterbox bars back out (reference unletterbox_layer)."""
    pal = Palette(layer.palette)
    subs = CHROMA_SUBSAMPLING.get(pal, (1, 1))
    planes = []
    for idx, p in enumerate(layer.planes):
        sh, sv = subs if is_yuv_palette(pal) and idx in (1, 2) else (1, 1)
        planes.append(p[..., oy // sv: (oy + lh) // sv,
                        ox // sh: (ox + lw) // sh])
    return layer.replace(planes=tuple(planes))
