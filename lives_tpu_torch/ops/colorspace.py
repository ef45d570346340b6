"""Device colour engine: palette conversions as torch ops.

Counterpart of `lives_tpu/ops/colorspace.py:55-308`. Device layers are
planar and canonical (`layer.py`), so every palette pair decomposes into at
most three steps: a colour matrix (RGB <-> YUV, float32), a chroma
re-sample (integer, exact vs the numpy twin `colorspace_ref`), and alpha
added or dropped. Matrix maths is within +/-1 LSB of the twin's 16.16
fixed-point tables.

Batch-aware: planes may carry leading batch axes, so an RGB-family plane
is ``(..., C, H, W)`` with channels on axis -3, a YUV or alpha plane
``(..., H, W)``. (The JAX version stacks channels on axis 0,
`colorspace.py:223,278`, which holds only for one frame.)

For YUV420P-family <-> RGB the pairs run the colour kernels of
`ops/yuv_kernels.py`: K2 (`yuv420_to_rgb`) and K3 (`rgb_to_yuv420`), hand
written in CUDA for CUDA tensors, their plain versions for CPU tensors.
Alpha is added or dropped around the kernel.

Three cases differ from the JAX package on purpose, where it mislabels
data (ROADMAP Queue 3): YUV -> RGBFLOAT/RGBAFLOAT returns float32 in
[0,1] (the JAX version returns the u8 values under a float palette);
RGBFLOAT/RGBAFLOAT -> YUV quantises to u8 first (the JAX version runs the
matrix on [0,1] values as if they were 0..255); a YUV -> YUV change of
subspace subsamples the chroma to the target palette (the JAX version
returns 4:4:4 chroma).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    CHROMA_SUBSAMPLING,
    CLAMP_FACTOR_UV,
    CLAMP_FACTOR_Y,
    Palette,
    UV_BIAS,
    YUV_CLAMP_MIN,
    YUVClamping,
    YUVSubspace,
    has_alpha,
    is_float_palette,
    is_rgb_palette,
    is_yuv_palette,
)
from ..layer import Layer
from . import colorspace_ref as ref

#: float32 1/255, the factor every u8 -> float conversion multiplies by
INV255 = 1.0 / 255.0

_ALPHA = (Palette.A8, Palette.A1, Palette.AFLOAT)


def f32(c) -> float:
    """A constant rounded to float32, as a Python float: torch multiplies a
    float32 tensor by it exactly as XLA multiplies by np.float32(c)."""
    return float(np.float32(c))


def quantise_u8(arr: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> u8 by round-half-up, `floor(x*255+0.5)`. The clamp
    comes before the cast: torch's float -> u8 cast does not saturate."""
    return torch.clamp(torch.floor(arr * 255.0 + 0.5), 0, 255).to(torch.uint8)


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ---------------------------------------------------------------------------
# RGB <-> YUV matrix ops (per plane, any leading axes)
# ---------------------------------------------------------------------------

def rgb2yuv_constants(subspace: int, clamping: int):
    """(3x3 float32 matrix, cfy, cfuv, yoff, ymin, ymax, uvmax) of
    `rgb_to_yuv` (`colorspace.py:58-70`); K3 takes the same values."""
    m = ref.rgb2yuv_coeffs(subspace).astype(np.float32)
    clamp = clamping == YUVClamping.CLAMPED
    cfy = f32(CLAMP_FACTOR_Y if clamp else 1.0)
    cfuv = f32(CLAMP_FACTOR_UV if clamp else 1.0)
    yoff = f32(YUV_CLAMP_MIN if clamp else 0.0)
    bounds = (16.0, 235.0, 240.0) if clamp else (0.0, 255.0, 255.0)
    return m, cfy, cfuv, yoff, *bounds


def yuv2rgb_constants(subspace: int):
    """(ky, kuv, cr_v, cg_u, cg_v, cb_u): the clamped-range factors and
    the float32 coefficients of `yuv_to_rgb` (`colorspace.py:80-92`); K2
    takes the same values."""
    cc = ref.yuv2rgb_coeffs(subspace).astype(np.float32)
    return (f32(255.0 / 219.0), f32(255.0 / 224.0), float(cc[0, 1]),
            float(cc[1, 0]), float(cc[1, 1]), float(cc[2, 0]))


def rgb_to_yuv(r, g, b, subspace: int = YUVSubspace.YCBCR,
               clamping: int = YUVClamping.CLAMPED):
    """uint8 R,G,B -> uint8 Y,U,V (444). +/-1 LSB vs twin."""
    m, cfy, cfuv, yoff, ymin, ymax, uvmax = rgb2yuv_constants(subspace,
                                                              clamping)
    m = [[float(c) for c in row] for row in m]
    r, g, b = _f(r), _f(g), _f(b)
    y = (r * m[0][0] + g * m[0][1] + b * m[0][2]) * cfy + yoff
    u = (r * m[1][0] + g * m[1][1] + b * m[1][2]) * cfuv + UV_BIAS
    v = (r * m[2][0] + g * m[2][1] + b * m[2][2]) * cfuv + UV_BIAS

    def to8(x, lo, hi):
        return torch.clamp(torch.floor(x), lo, hi).to(torch.uint8)
    return to8(y, ymin, ymax), to8(u, ymin, uvmax), to8(v, ymin, uvmax)


def yuv_to_rgb(y, u, v, subspace: int = YUVSubspace.YCBCR,
               clamping: int = YUVClamping.CLAMPED):
    """uint8 Y,U,V (444) -> uint8 R,G,B. +/-1 LSB vs twin."""
    ky, kuv, cr_v, cg_u, cg_v, cb_u = yuv2rgb_constants(subspace)
    y, u, v = _f(y), _f(u), _f(v)
    if clamping == YUVClamping.CLAMPED:
        yy = (torch.clamp(y, 16.0, 235.0) - 16.0) * ky
        uu = (torch.clamp(u, 16.0, 240.0) - 16.0) * kuv - 128.0
        vv = (torch.clamp(v, 16.0, 240.0) - 16.0) * kuv - 128.0
    else:
        yy = y
        uu = u - 128.0
        vv = v - 128.0

    def to8(x):
        return torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)
    return (to8(yy + vv * cr_v), to8(yy + uu * cg_u + vv * cg_v),
            to8(yy + uu * cb_u))


def yuv_clamp_convert(y, u, v, from_clamping: int, to_clamping: int):
    """Clamped <-> unclamped range remap; matches twin tables within 1 LSB
    (`colorspace.py:97-110`)."""
    if from_clamping == to_clamping:
        return y, u, v
    y, u, v = _f(y), _f(u), _f(v)
    cfy, cfuv = f32(CLAMP_FACTOR_Y), f32(CLAMP_FACTOR_UV)
    if from_clamping == YUVClamping.CLAMPED:
        yo = (y - YUV_CLAMP_MIN) / cfy

        def uvo(c):
            return (c - UV_BIAS) / cfuv + UV_BIAS
    else:
        yo = y * cfy + YUV_CLAMP_MIN

        def uvo(c):
            return (c - UV_BIAS) * cfuv + UV_BIAS

    def to8(x):
        return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)
    return to8(yo), to8(uvo(u)), to8(uvo(v))


# ---------------------------------------------------------------------------
# Chroma resampling: integer-exact twin of colorspace_ref.chroma_down/up
# ---------------------------------------------------------------------------

def chroma_down(plane: torch.Tensor, sh: int, sv: int) -> torch.Tensor:
    """Box-average subsample by (sh, sv), round half up; a ragged last row
    or column is dropped."""
    if sh == 1 and sv == 1:
        return plane
    p = plane.to(torch.int32)
    h, w = p.shape[-2], p.shape[-1]
    p = p[..., : h - h % sv, : w - w % sh]
    p = p.reshape(*p.shape[:-2], h // sv, sv, w // sh, sh)
    s = p.sum(dim=(-3, -1))
    n = sh * sv
    return torch.div(s + n // 2, n, rounding_mode="floor").to(torch.uint8)


def chroma_up(plane: torch.Tensor, sh: int, sv: int) -> torch.Tensor:
    """Nearest (replicate) upsample."""
    if sh == 1 and sv == 1:
        return plane
    p = torch.repeat_interleave(plane, sv, dim=-2)
    return torch.repeat_interleave(p, sh, dim=-1)


# ---------------------------------------------------------------------------
# Alpha
# ---------------------------------------------------------------------------

def alpha_premultiply(planes, alpha, un: bool = False):
    """(Un)premultiply colour planes by alpha (reference `alpha_premult`,
    LiVES `src/colourspace.c:11968`). uint8 in/out."""
    a = _f(alpha) * INV255
    out = []
    for p in planes:
        f = _f(p)
        if un:
            f = torch.where(a > 0, f / torch.clamp(a, min=1e-6), f)
        else:
            f = f * a
        out.append(torch.clamp(torch.floor(f + 0.5), 0, 255)
                   .to(torch.uint8))
    return out


def _fix_alpha_chan(arr: torch.Tensor, had: bool, want: bool) -> torch.Tensor:
    """Add an opaque alpha channel or drop one; channels are axis -3."""
    if had == want:
        return arr
    if want:
        opaque = 1.0 if arr.is_floating_point() else 255
        shape = arr.shape[:-3] + (1,) + arr.shape[-2:]
        return torch.cat([arr, torch.full(shape, opaque, dtype=arr.dtype,
                                          device=arr.device)], -3)
    return arr[..., :3, :, :]


def _chan(arr: torch.Tensor, c: int) -> torch.Tensor:
    return arr[..., c, :, :]


# ---------------------------------------------------------------------------
# Layer-level palette conversion
# ---------------------------------------------------------------------------

def convert_layer(layer: Layer, palette: int,
                  clamping: int | None = None,
                  subspace: int | None = None,
                  sampling: int | None = None) -> Layer:
    """Convert a layer to a target palette (+ optional clamping/subspace)
    (`colorspace.py:164`). No-op conversions return the input."""
    from . import yuv_kernels
    pal_in = Palette(layer.palette)
    pal_out = Palette(palette)
    clamping = layer.clamping if clamping is None else clamping
    subspace = layer.subspace if subspace is None else subspace
    sampling = layer.sampling if sampling is None else sampling

    if (pal_in == pal_out and clamping == layer.clamping
            and subspace == layer.subspace):
        return layer

    meta = dict(palette=int(pal_out), clamping=int(clamping),
                sampling=int(sampling), subspace=int(subspace),
                gamma=layer.gamma, premult=layer.premult)

    # --- RGB -> RGB: canonical planes identical; only alpha membership and
    # int <-> float representation change ---
    if is_rgb_palette(pal_in) and is_rgb_palette(pal_out):
        arr = layer.planes[0]
        fin, fout = is_float_palette(pal_in), is_float_palette(pal_out)
        if fin and not fout:
            arr = quantise_u8(arr)
        elif fout and not fin:
            arr = arr.to(torch.float32) * INV255
        arr = _fix_alpha_chan(arr, has_alpha(pal_in), has_alpha(pal_out))
        return Layer(planes=(arr,), **meta)

    # --- RGB -> YUV ---
    if is_rgb_palette(pal_in) and is_yuv_palette(pal_out):
        arr = layer.planes[0]
        if is_float_palette(pal_in):
            arr = quantise_u8(arr)
        sh, sv = CHROMA_SUBSAMPLING[pal_out]
        if (sh, sv) == (2, 2):
            y, u, v = yuv_kernels.rgb_to_yuv420(arr, subspace, clamping)
        else:
            y, u, v = rgb_to_yuv(_chan(arr, 0), _chan(arr, 1), _chan(arr, 2),
                                 subspace, clamping)
            u, v = chroma_down(u, sh, sv), chroma_down(v, sh, sv)
        planes = [y, u, v]
        if has_alpha(pal_out):
            planes.append(_chan(arr, 3) if has_alpha(pal_in)
                          else torch.full_like(y, 255))
        return Layer(planes=tuple(planes), **meta)

    # --- YUV -> RGB ---
    if is_yuv_palette(pal_in) and is_rgb_palette(pal_out):
        y, u, v = layer.planes[:3]
        sh, sv = CHROMA_SUBSAMPLING[pal_in]
        if (sh, sv) == (2, 2):
            arr = yuv_kernels.yuv420_to_rgb(y, u, v, layer.subspace,
                                            layer.clamping)
        else:
            r, g, b = yuv_to_rgb(y, chroma_up(u, sh, sv),
                                 chroma_up(v, sh, sv), layer.subspace,
                                 layer.clamping)
            arr = torch.stack([r, g, b], -3)
        if has_alpha(pal_out):
            a = (layer.planes[3] if has_alpha(pal_in)
                 else torch.full_like(y, 255))
            arr = torch.cat([arr, a.unsqueeze(-3)], -3)
        if is_float_palette(pal_out):
            arr = arr.to(torch.float32) * INV255
        return Layer(planes=(arr,), **meta)

    # --- YUV -> YUV: clamp remap + chroma re-sample + alpha ---
    if is_yuv_palette(pal_in) and is_yuv_palette(pal_out):
        y, u, v = layer.planes[:3]
        shi, svi = CHROMA_SUBSAMPLING[pal_in]
        sho, svo = CHROMA_SUBSAMPLING[pal_out]
        if subspace != layer.subspace:
            # through the RGB matrices (rare; the reference warns too)
            r, g, b = yuv_to_rgb(y, chroma_up(u, shi, svi),
                                 chroma_up(v, shi, svi), layer.subspace,
                                 layer.clamping)
            y, u, v = rgb_to_yuv(r, g, b, subspace, clamping)
            # the JAX version stops here and returns 4:4:4 chroma under a
            # subsampled palette (ROADMAP Queue 3)
            u, v = chroma_down(u, sho, svo), chroma_down(v, sho, svo)
        else:
            y, u, v = yuv_clamp_convert(y, u, v, layer.clamping, clamping)
            if (shi, svi) != (sho, svo):
                u, v = chroma_up(u, shi, svi), chroma_up(v, shi, svi)
                u, v = chroma_down(u, sho, svo), chroma_down(v, sho, svo)
        planes = [y, u, v]
        if has_alpha(pal_out):
            planes.append(layer.planes[3] if has_alpha(pal_in)
                          else torch.full_like(y, 255))
        return Layer(planes=tuple(planes), **meta)

    # --- alpha palettes (A8 / A1 / AFLOAT) ---
    # Device representations: A8 = (..., H, W) u8, A1 = (..., H, W) u8 in
    # {0,1} (bit-packing happens at the host boundary, layer.py), AFLOAT =
    # (..., H, W) f32 in [0,1]; colour <-> alpha goes through luma.
    def _encode_alpha(a8):
        if pal_out == Palette.A8:
            return a8
        if pal_out == Palette.A1:
            return (a8 >= 128).to(torch.uint8)
        return a8.to(torch.float32) * INV255                  # AFLOAT

    if pal_in in _ALPHA:
        a = layer.planes[0]
        if pal_in == Palette.A1:
            a8 = (a.to(torch.uint8) & 1) * 255
        elif pal_in == Palette.AFLOAT:
            a8 = quantise_u8(a)
        else:
            a8 = a
        a8 = a8.to(torch.uint8)
        if pal_out in _ALPHA:
            return Layer(planes=(_encode_alpha(a8),), **meta)
        # alpha -> colour: grey RGB, then on to YUV or another RGB palette
        grey = Layer(planes=(torch.stack([a8, a8, a8], -3),),
                     palette=int(Palette.RGB24), clamping=layer.clamping,
                     sampling=layer.sampling, subspace=layer.subspace,
                     gamma=layer.gamma, premult=layer.premult)
        if pal_out == Palette.RGB24:
            return Layer(planes=grey.planes, **meta)
        return convert_layer(grey, pal_out, clamping, subspace, sampling)
    if pal_out in _ALPHA:
        if is_rgb_palette(pal_in):
            arr = layer.planes[0]
            if is_float_palette(pal_in):
                arr = quantise_u8(arr)
            y, _, _ = rgb_to_yuv(_chan(arr, 0), _chan(arr, 1), _chan(arr, 2),
                                 subspace, YUVClamping.UNCLAMPED)
            return Layer(planes=(_encode_alpha(y),), **meta)
        if is_yuv_palette(pal_in):
            return Layer(planes=(_encode_alpha(layer.planes[0]),), **meta)

    raise NotImplementedError(
        f"convert_layer: {pal_in.name} -> {pal_out.name}")
