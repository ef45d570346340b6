"""Gamma transfer functions (reference `create_gamma_lut8`, LiVES
`src/colourspace.c:655`; `gamma_convert_layer` :14146).

Counterpart of `lives_tpu/ops/gamma.py:26-139`. The transfer functions run
in float32 on the device; the numpy LUT twin `ref_gamma_lut` (a copy) is
the +/-1 LSB contract.

Piecewise model (both directions):
  decode (encoded -> linear):  a <  lin*thresh ? a/lin : ((a+offs)/(1+offs))^pf
  encode (linear -> encoded):  a <  thresh     ? a*lin : (1+offs)*a^(1/pf)-offs
with (lin, thresh, pf) = (12.92, 0.0031308, 2.4) for sRGB and
(4.5, 0.018, 1/0.45) for BT.709; offs derived so the pieces meet.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import Gamma, Palette, is_rgb_palette
from ..layer import Layer
from .colorspace import INV255

# (lin, linear-domain threshold, power) per encoded space
_TX = {
    Gamma.SRGB: (12.92, 0.0031308, 2.4),
    Gamma.BT709: (4.5, 0.018, 1.0 / 0.45),
}


class _TorchOps:
    """The three array functions `_tx_chain` needs, over torch tensors."""
    where = staticmethod(torch.where)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)


def _offs(lin, thresh, pf):
    # continuity: (1+o)*t^(1/pf) - o == lin*t  =>  o = (k - lin*t)/(1 - k)
    k = thresh ** (1.0 / pf)
    return (k - lin * thresh) / (1.0 - k)


def _decode(a, gtype, xp):
    """encoded -> linear, a in [0,1]."""
    lin, thresh, pf = _TX[Gamma(gtype)]
    o = _offs(lin, thresh, pf)
    enc_thresh = lin * thresh
    return xp.where(a < enc_thresh, a / lin,
                    ((a + o) / (1.0 + o)) ** pf)


def _encode(a, gtype, xp):
    """linear -> encoded, a in [0,1]."""
    lin, thresh, pf = _TX[Gamma(gtype)]
    o = _offs(lin, thresh, pf)
    a = xp.maximum(a, 0.0)
    return xp.where(a < thresh, a * lin,
                    (1.0 + o) * a ** (1.0 / pf) - o)


def _tx_chain(a, gamma_from, gamma_to, xp, file_gamma=1.0, screen_gamma=1.4):
    """Compose decode(from) then encode(to) in linear light."""
    gamma_from = Gamma(gamma_from)
    gamma_to = Gamma(gamma_to)
    if gamma_from == Gamma.FILE:
        a = a ** file_gamma
    elif gamma_from in _TX:
        a = _decode(a, gamma_from, xp)
    # LINEAR / UNKNOWN: already linear
    if gamma_to == Gamma.MONITOR:
        a = a ** (1.0 / screen_gamma)
    elif gamma_to == Gamma.FILE:
        a = a ** (1.0 / file_gamma)
    elif gamma_to in _TX:
        a = _encode(a, gamma_to, xp)
    return a


@lru_cache(maxsize=None)
def ref_gamma_lut(gamma_from: int, gamma_to: int, file_gamma: float = 1.0,
                  screen_gamma: float = 1.4) -> np.ndarray:
    """uint8[256] LUT (reference create_gamma_lut8)."""
    a = np.arange(256, dtype=np.float64) / 255.0
    out = _tx_chain(a, gamma_from, gamma_to, np, file_gamma, screen_gamma)
    return np.clip(np.floor(out * 255.0 + 0.5), 0, 255).astype(np.uint8)


def ref_gamma_convert(planes, gamma_from: int, gamma_to: int, **kw):
    """Apply the twin LUT to uint8 numpy planes."""
    if gamma_from == gamma_to or Gamma(gamma_from) == Gamma.UNKNOWN \
            or Gamma(gamma_to) == Gamma.UNKNOWN:
        return planes
    lut = ref_gamma_lut(int(gamma_from), int(gamma_to), **kw)
    return [lut[np.asarray(p)] for p in planes]


def gamma_convert_planes(planes, gamma_from: int, gamma_to: int,
                         file_gamma: float = 1.0, screen_gamma: float = 1.4):
    """uint8 planes -> uint8, the transfer computed in float32. +/-1 LSB vs
    the twin."""
    if gamma_from == gamma_to or Gamma(gamma_from) == Gamma.UNKNOWN \
            or Gamma(gamma_to) == Gamma.UNKNOWN:
        return list(planes)
    out = []
    for p in planes:
        a = p.to(torch.float32) * INV255
        a = _tx_chain(a, gamma_from, gamma_to, _TorchOps, file_gamma,
                      screen_gamma)
        out.append(torch.clamp(torch.floor(a * 255.0 + 0.5), 0, 255)
                   .to(torch.uint8))
    return out


def gamma_convert_layer(layer: Layer, gamma_to: int,
                        file_gamma: float = 1.0,
                        screen_gamma: float = 1.4) -> Layer:
    """RGB layers: all colour channels (axis -3, alpha kept); YUV layers:
    luma only (chroma is colour-difference), as the JAX version does."""
    if layer.gamma == gamma_to:
        return layer
    pal = Palette(layer.palette)
    if is_rgb_palette(pal):
        arr = layer.planes[0]
        rgb = gamma_convert_planes([arr[..., :3, :, :]], layer.gamma,
                                   gamma_to, file_gamma, screen_gamma)[0]
        if arr.shape[-3] == 4:
            arr = torch.cat([rgb, arr[..., 3:4, :, :]], -3)
        else:
            arr = rgb
        return layer.replace(planes=(arr,), gamma=int(gamma_to))
    y = gamma_convert_planes([layer.planes[0]], layer.gamma, gamma_to,
                             file_gamma, screen_gamma)[0]
    return layer.replace(planes=(y,) + tuple(layer.planes[1:]),
                         gamma=int(gamma_to))
