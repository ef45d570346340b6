"""Palette / colourspace constants, Weed-compatible.

A copy of `lives_tpu/constants.py:1-168` (code verbatim; citations of the
LiVES reference tree given relative to its root): the module holds no
device code, but importing it from `lives_tpu` would import jax
(`lives_tpu/__init__.py:40` pulls in `layer.py`). Keep the two in step.

Numeric values match the Weed plugin ABI so that serialized event lists,
plugin metadata and external tools interoperate with the reference
(LiVES `libweed/weed-palettes.h:40-185`).

The conversion constants (Kr/Kb, clamp ranges, fixed-point scale) mirror the
reference engine's colour maths (LiVES `src/colourspace.h:49-129`)
so our CPU golden twin reproduces its integer LUT arithmetic exactly.
"""

from __future__ import annotations

import enum


class Palette(enum.IntEnum):
    """Pixel format IDs (Weed ABI values)."""

    ANY = -1
    NONE = 0
    # RGB palettes
    RGB24 = 1
    BGR24 = 2
    RGBA32 = 3
    BGRA32 = 4
    ARGB32 = 5
    RGBFLOAT = 64
    RGBAFLOAT = 65
    # planar YUV
    YUV420P = 512
    YVU420P = 513
    YUV422P = 522
    YUV444P = 544
    YUVA4444P = 545
    # packed YUV
    UYVY = 564
    YUYV = 565
    YUV888 = 588
    YUVA8888 = 589
    YUV411 = 595
    # alpha palettes
    A8 = 1024
    A1 = 1025
    AFLOAT = 1064


# Aliases (same ABI aliasing as weed-palettes.h)
Palette.I420 = Palette.YUV420P
Palette.YV12 = Palette.YVU420P
Palette.YUY2 = Palette.YUYV


class YUVClamping(enum.IntEnum):
    CLAMPED = 0    # MPEG range: Y 16..235, U/V 16..240
    UNCLAMPED = 1  # JPEG range: 0..255


class YUVSubspace(enum.IntEnum):
    YUV = 0
    YCBCR = 1      # BT.601
    BT709 = 2


class YUVSampling(enum.IntEnum):
    DEFAULT = 0    # JPEG: chroma sited between luma samples
    JPEG = 0
    MPEG = 1       # chroma co-sited with left luma sample
    DVPAL = 2
    DVNTSC = 3


class Gamma(enum.IntEnum):
    UNKNOWN = 0
    LINEAR = -1
    SRGB = 1
    BT709 = 2
    # host-only variants (reference colourspace.h:27-29): resolved to one of
    # the above plus a numeric exponent before hitting kernels
    MONITOR = 3
    FILE = 4
    VARIANT = 5


# ---------------------------------------------------------------------------
# Conversion maths constants (reference src/colourspace.h:49-129)
# ---------------------------------------------------------------------------

FP_BITS = 16
SCALE = 1 << FP_BITS  # 65536 (reference SCALE_FACTORX; USE_EXTEND off)

KR_YCBCR = 0.299
KB_YCBCR = 0.114
KR_BT709 = 0.2126
KB_BT709 = 0.0722

YUV_CLAMP_MIN = 16.0
Y_CLAMP_MAX = 235.0
UV_CLAMP_MAX = 240.0
UV_BIAS = 128.0

CLAMP_FACTOR_Y = (Y_CLAMP_MAX - YUV_CLAMP_MIN) / 255.0   # 219/255
CLAMP_FACTOR_UV = (UV_CLAMP_MAX - YUV_CLAMP_MIN) / 255.0  # 224/255

# Gamma transfer-function constants (reference src/colourspace.h:157-171):
# piecewise linear/power-law: x < thresh -> x / lin ; else ((x+offs)/(1+offs))^pf
GAMMA_SRGB = dict(lin=12.92, thresh=0.04045, pf=2.4)
GAMMA_BT709 = dict(lin=4.5, thresh=0.018, pf=1.0 / 0.45)


def kr_kb(subspace: int) -> tuple[float, float]:
    """Luma coefficients for a YUV subspace."""
    if subspace == YUVSubspace.BT709:
        return KR_BT709, KB_BT709
    return KR_YCBCR, KB_YCBCR


def is_rgb_palette(pal: int) -> bool:
    return pal in (Palette.RGB24, Palette.BGR24, Palette.RGBA32,
                   Palette.BGRA32, Palette.ARGB32, Palette.RGBFLOAT,
                   Palette.RGBAFLOAT)


def is_yuv_palette(pal: int) -> bool:
    return 512 <= pal < 1024


def is_alpha_palette(pal: int) -> bool:
    return pal in (Palette.A8, Palette.A1, Palette.AFLOAT)


def is_float_palette(pal: int) -> bool:
    return pal in (Palette.RGBFLOAT, Palette.RGBAFLOAT, Palette.AFLOAT)


def has_alpha(pal: int) -> bool:
    return pal in (Palette.RGBA32, Palette.BGRA32, Palette.ARGB32,
                   Palette.RGBAFLOAT, Palette.YUVA4444P, Palette.YUVA8888)


#: (horizontal, vertical) chroma subsampling per YUV palette
CHROMA_SUBSAMPLING = {
    Palette.YUV420P: (2, 2),
    Palette.YVU420P: (2, 2),
    Palette.YUV422P: (2, 1),
    Palette.YUV444P: (1, 1),
    Palette.YUVA4444P: (1, 1),
    Palette.UYVY: (2, 1),
    Palette.YUYV: (2, 1),
    Palette.YUV888: (1, 1),
    Palette.YUVA8888: (1, 1),
    Palette.YUV411: (4, 1),
}


def n_channels(pal: int) -> int:
    """Logical channel count (alpha included)."""
    if pal in (Palette.RGB24, Palette.BGR24, Palette.RGBFLOAT,
               Palette.YUV444P, Palette.YUV888, Palette.YUV420P,
               Palette.YVU420P, Palette.YUV422P, Palette.UYVY,
               Palette.YUYV, Palette.YUV411):
        return 3
    if pal in (Palette.RGBA32, Palette.BGRA32, Palette.ARGB32,
               Palette.RGBAFLOAT, Palette.YUVA4444P, Palette.YUVA8888):
        return 4
    if pal in (Palette.A8, Palette.A1, Palette.AFLOAT):
        return 1
    raise ValueError(f"unknown palette {pal}")
