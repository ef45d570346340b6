"""CPU golden-reference colour engine (numpy, integer-exact).

A copy of `lives_tpu/ops/colorspace_ref.py:1-213` (code verbatim): the
module holds no device code, but importing it from `lives_tpu` would import
jax (`lives_tpu/__init__.py:40`). Keep the two in step. It is the coefficient
source of the colour kernels K2 and K3 (`ops/yuv_kernels.py`) and an oracle
of the tests.

This is the framework's bit-exactness contract: every conversion kernel
must match these functions within +/-1 LSB.

The arithmetic structure mirrors the reference engine's fixed-point LUT
pipeline (LiVES `src/colourspace.c:851-1108,2119-2360`): 256-entry int32
tables built with round-half-away-from-zero at 16 fractional bits, summed
per pixel, then arithmetic-shifted down and clamped. The matrix
coefficients are the mathematically standard BT.601/709 ones (the
reference's hand-approximated G coefficients, e.g. `-.5/(1+Kb+Kr)` at
colourspace.c:1005, are deliberately not reproduced: exact matrices give
self-consistent round-trips, which its approximations do not).

Chroma sub/up-sampling is defined here in pure integer maths and reproduced
exactly (not just within 1 LSB) by the device path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..constants import (
    CLAMP_FACTOR_UV,
    CLAMP_FACTOR_Y,
    FP_BITS,
    SCALE,
    UV_BIAS,
    UV_CLAMP_MAX,
    Y_CLAMP_MAX,
    YUV_CLAMP_MIN,
    YUVClamping,
    YUVSubspace,
    kr_kb,
)


def myround(x):
    """Round half away from zero (reference maths.h:118)."""
    return np.where(np.asarray(x) >= 0, np.floor(np.asarray(x) + 0.5),
                    np.ceil(np.asarray(x) - 0.5)).astype(np.int64)


def _spc_rnd(v):
    """Fixed-point descale (reference colourspace.c:831 `_spc_rnd`,
    non-HIGH-quality path: arithmetic shift)."""
    return np.asarray(v, np.int64) >> FP_BITS


# ---------------------------------------------------------------------------
# Matrix coefficients
# ---------------------------------------------------------------------------

def rgb2yuv_coeffs(subspace: int) -> np.ndarray:
    """3x3 matrix: [Y,U,V] = M @ [R,G,B] (full-range, before clamping),
    U/V relative to bias."""
    kr, kb = kr_kb(subspace)
    kg = 1.0 - kr - kb
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ])


def yuv2rgb_coeffs(subspace: int) -> np.ndarray:
    """Per-channel [coef_Cb, coef_Cr] for full-range YUV -> RGB."""
    kr, kb = kr_kb(subspace)
    kg = 1.0 - kr - kb
    return np.array([
        [0.0, 2.0 * (1 - kr)],                                # R
        [-2.0 * kb * (1 - kb) / kg, -2.0 * kr * (1 - kr) / kg],  # G
        [2.0 * (1 - kb), 0.0],                                # B
    ])


# ---------------------------------------------------------------------------
# Fixed-point tables (reference init_RGB_to_YUV_tables colourspace.c:851)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def rgb2yuv_tables(subspace: int, clamping: int):
    """9 int32 tables T[c][chan][i]; per pixel:
    out = clamp(_spc_rnd(T_R[i_r] + T_G[i_g] + T_B[i_b]))."""
    m = rgb2yuv_coeffs(subspace)
    i = np.arange(256, dtype=np.float64)
    clamp = clamping == YUVClamping.CLAMPED
    cf = np.array([CLAMP_FACTOR_Y, CLAMP_FACTOR_UV, CLAMP_FACTOR_UV]) \
        if clamp else np.ones(3)
    # per-row offset added to the *last* (B) table, as the reference does
    offs = np.array([YUV_CLAMP_MIN if clamp else 0.0, UV_BIAS, UV_BIAS])
    tabs = np.empty((3, 3, 256), np.int64)
    for row in range(3):
        for col in range(3):
            v = m[row, col] * i * cf[row] * SCALE
            if col == 2:
                v = v + offs[row] * SCALE
            tabs[row, col] = myround(v)
    return tabs


@lru_cache(maxsize=None)
def yuv2rgb_tables(subspace: int, clamping: int):
    """Tables (Ytab, CbCr[3][2][256]) for yuv2rgb:
    r = clamp0255(_spc_rnd(Ytab[y] + Cr_r[v])), etc.
    Mirrors reference init_YUV_to_RGB_tables (colourspace.c:984), except that
    out-of-range clamped inputs are clipped continuously into [16,235]/[16,240]
    (the reference discontinuously zeroes sub-16 chroma contributions)."""
    cc = yuv2rgb_coeffs(subspace)
    i = np.arange(256, dtype=np.float64)
    if clamping == YUVClamping.CLAMPED:
        yc = np.clip(i, YUV_CLAMP_MIN, Y_CLAMP_MAX)
        ytab = myround((yc - YUV_CLAMP_MIN)
                       / (Y_CLAMP_MAX - YUV_CLAMP_MIN) * 255.0 * SCALE)
        uvc = np.clip(i, YUV_CLAMP_MIN, UV_CLAMP_MAX)
        cval = (uvc - YUV_CLAMP_MIN) / (UV_CLAMP_MAX - YUV_CLAMP_MIN) * 255.0 - UV_BIAS
        cbcr = np.empty((3, 2, 256), np.int64)
        for row in range(3):
            for k in range(2):
                cbcr[row, k] = myround(cc[row, k] * cval * SCALE)
    else:
        ytab = (np.arange(256, dtype=np.int64)) * SCALE
        cbcr = np.empty((3, 2, 256), np.int64)
        for row in range(3):
            for k in range(2):
                cbcr[row, k] = myround(cc[row, k] * (i - UV_BIAS) * SCALE)
    return ytab, cbcr


# ---------------------------------------------------------------------------
# Per-plane conversions (vectorised over whole planes)
# ---------------------------------------------------------------------------

def rgb_to_yuv_planes(r, g, b, subspace=YUVSubspace.YCBCR,
                      clamping=YUVClamping.CLAMPED):
    """uint8 R,G,B planes -> uint8 Y,U,V planes (444)."""
    t = rgb2yuv_tables(int(subspace), int(clamping))
    r = np.asarray(r, np.int64)
    g = np.asarray(g, np.int64)
    b = np.asarray(b, np.int64)
    if clamping == YUVClamping.CLAMPED:
        ymin, ymax, uvmin, uvmax = 16, 235, 16, 240
    else:
        ymin, ymax, uvmin, uvmax = 0, 255, 0, 255
    y = np.clip(_spc_rnd(t[0, 0][r] + t[0, 1][g] + t[0, 2][b]), ymin, ymax)
    u = np.clip(_spc_rnd(t[1, 0][r] + t[1, 1][g] + t[1, 2][b]), uvmin, uvmax)
    v = np.clip(_spc_rnd(t[2, 0][r] + t[2, 1][g] + t[2, 2][b]), uvmin, uvmax)
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def yuv_to_rgb_planes(y, u, v, subspace=YUVSubspace.YCBCR,
                      clamping=YUVClamping.CLAMPED):
    """uint8 Y,U,V planes (444, co-sited) -> uint8 R,G,B planes."""
    ytab, cbcr = yuv2rgb_tables(int(subspace), int(clamping))
    y = np.asarray(y, np.int64)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    yy = ytab[y]
    r = np.clip(_spc_rnd(yy + cbcr[0, 1][v]), 0, 255)
    g = np.clip(_spc_rnd(yy + cbcr[1, 0][u] + cbcr[1, 1][v]), 0, 255)
    b = np.clip(_spc_rnd(yy + cbcr[2, 0][u]), 0, 255)
    return r.astype(np.uint8), g.astype(np.uint8), b.astype(np.uint8)


# ---------------------------------------------------------------------------
# Chroma resampling — pure integer; device path must match EXACTLY
# ---------------------------------------------------------------------------

def chroma_down(plane: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """Box-average subsample by (sh horizontal, sv vertical), round half up."""
    p = np.asarray(plane, np.int64)
    h, w = p.shape
    p = p[: h - h % sv, : w - w % sh]
    blocks = p.reshape(h // sv, sv, w // sh, sh)
    s = blocks.sum((1, 3))
    n = sh * sv
    return ((s + n // 2) // n).astype(np.uint8)


def chroma_up(plane: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """Nearest (replicate) upsample — matches the reference's 420p->RGB use
    of one chroma sample per 2x2 block (colourspace.c convert_yuv420p ops)."""
    return np.repeat(np.repeat(plane, sv, 0), sh, 1)


# ---------------------------------------------------------------------------
# YUV clamped <-> unclamped (reference init_Y_to_Y / init_UV_to_UV tables)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def yuv_clamp_tables(direction: str):
    """direction: 'c2u' (clamped->unclamped) or 'u2c'."""
    i = np.arange(256, dtype=np.float64)
    if direction == "c2u":
        y = np.clip(myround((i - YUV_CLAMP_MIN) / CLAMP_FACTOR_Y), 0, 255)
        uv = np.clip(myround((i - YUV_CLAMP_MIN) / CLAMP_FACTOR_UV + 0), 0, 255)
        # keep chroma centred: unclamp around bias
        uv = np.clip(myround((i - UV_BIAS) / CLAMP_FACTOR_UV + UV_BIAS), 0, 255)
    else:
        y = np.clip(myround(i * CLAMP_FACTOR_Y + YUV_CLAMP_MIN), 0, 255)
        uv = np.clip(myround((i - UV_BIAS) * CLAMP_FACTOR_UV + UV_BIAS), 0, 255)
    return y.astype(np.uint8), uv.astype(np.uint8)


def yuv_clamp_convert(y, u, v, from_clamping, to_clamping):
    if from_clamping == to_clamping:
        return y, u, v
    d = "c2u" if from_clamping == YUVClamping.CLAMPED else "u2c"
    ty, tuv = yuv_clamp_tables(d)
    return ty[np.asarray(y)], tuv[np.asarray(u)], tuv[np.asarray(v)]
