"""Blur / sharpen filters: `gaussian_blur`, `box_blur`, `sharpen`,
`motion_blur`.

Counterpart of `lives_tpu/effects/builtin/blur.py:28-147`. `sep_conv` keeps
both of the JAX package's forms, because they round differently at the
frame edge and in precision: shifted adds over edge-padded planes for
kernels of up to 33 taps, and the band-matrix product with edge
renormalisation above that, bf16 in and f32 accumulate. The band product
stays a plain `torch.matmul`, as the JAX package leaves it to XLA.
`motion_blur` is the box kernel's band matrix along rows alone, a float32
product (`:130-147`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ...constants import Palette
from ..host import ChannelTemplate, Filter, Param, register_filter
from ..util import bparam, from_f01, join_alpha, split_alpha, to_f01

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)


@lru_cache(maxsize=128)
def _band_matrix(n: int, kernel: tuple[float, ...]) -> np.ndarray:
    """(n,n) banded convolution matrix with edge renormalisation."""
    k = np.asarray(kernel, np.float64)
    r = len(k) // 2
    m = np.zeros((n, n), np.float64)
    for o in range(n):
        lo = max(0, o - r)
        hi = min(n, o + r + 1)
        seg = k[lo - (o - r): hi - (o - r)]
        m[o, lo:hi] = seg / seg.sum()
    return m.astype(np.float32)


def _box_kernel(radius: int) -> tuple[float, ...]:
    return tuple([1.0] * (2 * radius + 1))


@lru_cache(maxsize=64)
def _gauss_kernel(radius: int) -> tuple[float, ...]:
    sigma = max(radius / 2.0, 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(k / k.sum())


def shift_taps(kernel: tuple[float, ...]) -> np.ndarray:
    """The float32 taps of the shifted-add form, renormalised in float32
    (`lives_tpu/effects/builtin/blur.py:75-76`); the sweep kernel uses the
    same ones."""
    k = np.asarray(kernel, np.float32)
    return k / k.sum()


def sep_conv(planes: torch.Tensor, kernel: tuple[float, ...]) -> torch.Tensor:
    """Separable 2D convolution over the last two axes of `planes`."""
    if len(kernel) <= 33:
        return _sep_conv_shifts(planes, kernel)
    h, w = planes.shape[-2], planes.shape[-1]
    dev = planes.device

    def bf16(a):  # round to bf16; the f32 product of two is exact
        return a.to(torch.bfloat16).to(torch.float32)
    kh = bf16(torch.from_numpy(_band_matrix(h, kernel)).to(dev))
    kw = bf16(torch.from_numpy(_band_matrix(w, kernel)).to(dev))
    out = torch.matmul(kh, bf16(planes))
    return torch.matmul(bf16(out), kw.T)


def _sep_conv_shifts(planes: torch.Tensor,
                     kernel: tuple[float, ...]) -> torch.Tensor:
    """Vertical then horizontal shifted adds over edge-padded planes, summed
    in tap order."""
    k = shift_taps(kernel)
    r = len(k) // 2
    x = planes.to(torch.float32)
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    xp = F.pad(x4, (0, 0, r, r), mode="replicate")
    h = x.shape[-2]
    acc = 0
    for i in range(len(k)):
        acc = acc + float(k[i]) * xp[..., i:i + h, :]
    xp = F.pad(acc, (r, r, 0, 0), mode="replicate")
    w = x.shape[-1]
    acc = 0
    for i in range(len(k)):
        acc = acc + float(k[i]) * xp[..., :, i:i + w]
    return acc.reshape(lead + acc.shape[-2:])


def _mk_blur(name, kernel_fn, desc):
    def process(ins, p, ctx):
        lay = ins[0]
        rgb, al = split_alpha(to_f01(lay))
        radius = max(1, int(p["radius"]))
        blurred = sep_conv(rgb, kernel_fn(radius))
        out = rgb + (blurred - rgb) * bparam(p["amount"])
        return from_f01(join_alpha(torch.clamp(out, 0.0, 1.0), al), lay)

    return register_filter(Filter(
        name=name, process=process, in_channels=_ONE_IN,
        params=(Param("radius", "int", 4, 1, 64),
                Param("amount", "num", 1.0, 0.0, 1.0)),
        description=desc))


_mk_blur("box_blur", _box_kernel, "box blur (separable)")
_mk_blur("gaussian_blur", _gauss_kernel, "gaussian blur (separable)")


def _unsharp_process(ins, p, ctx):
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    radius = max(1, int(p["radius"]))
    blurred = sep_conv(rgb, _gauss_kernel(radius))
    out = rgb + (rgb - blurred) * bparam(p["amount"])
    return from_f01(join_alpha(torch.clamp(out, 0.0, 1.0), al), lay)


register_filter(Filter(
    name="sharpen", process=_unsharp_process, in_channels=_ONE_IN,
    params=(Param("radius", "int", 2, 1, 16),
            Param("amount", "num", 0.8, 0.0, 4.0)),
    description="unsharp-mask sharpen"))


@lru_cache(maxsize=32)
def _band_on(n: int, kernel: tuple[float, ...],
             device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_matrix(n, kernel)).to(device)


def _motion_blur_h(ins, p, ctx):
    """Horizontal motion blur: each row times the (W, W) box band matrix,
    float32 in and out."""
    lay = ins[0]
    rgb, al = split_alpha(to_f01(lay))
    radius = max(1, int(p["radius"]))
    kw = _band_on(rgb.shape[-1], _box_kernel(radius), rgb.device)
    out = torch.matmul(rgb, kw.T)
    out = rgb + (out - rgb) * bparam(p["amount"])
    return from_f01(join_alpha(torch.clamp(out, 0.0, 1.0), al), lay)


register_filter(Filter(
    name="motion_blur", process=_motion_blur_h, in_channels=_ONE_IN,
    params=(Param("radius", "int", 8, 1, 128),
            Param("amount", "num", 1.0, 0.0, 1.0)),
    description="horizontal motion blur"))
