"""Palette conversion, RGB family only.

Counterpart of `lives_tpu/ops/colorspace.py:164` (`convert_layer`), cut to
the pairs the float chain and the RGB24 sink use
(`lives_tpu/graph/nodemodel.py:801-806`, `:260`): RGB24/RGBA32 and the rest
of the RGB family to and from RGBFLOAT/RGBAFLOAT. Every other pair raises
`NotImplementedError` until Slice 2 (ROADMAP Queue 1 item 11) ports it.
"""

from __future__ import annotations

import torch

from ..constants import Palette, has_alpha, is_float_palette, is_rgb_palette
from ..layer import Layer

#: float32 1/255, the factor every u8 -> float conversion multiplies by
INV255 = 1.0 / 255.0


def quantise_u8(arr: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> u8 by round-half-up, `floor(x*255+0.5)`. The clamp
    comes before the cast: torch's float -> u8 cast does not saturate."""
    return torch.clamp(torch.floor(arr * 255.0 + 0.5), 0, 255).to(torch.uint8)


def convert_layer(layer: Layer, palette: int) -> Layer:
    """Convert an RGB-family layer to another RGB-family palette (alpha
    membership and int <-> float representation change; the canonical
    R,G,B[,A] planes are shared)."""
    pal_in = Palette(layer.palette)
    pal_out = Palette(palette)
    if pal_in == pal_out:
        return layer
    if not (is_rgb_palette(pal_in) and is_rgb_palette(pal_out)):
        raise NotImplementedError(
            f"convert_layer: {pal_in.name} -> {pal_out.name} is not ported "
            "yet (ROADMAP Queue 1 item 11)")
    arr = layer.planes[0]
    fin, fout = is_float_palette(pal_in), is_float_palette(pal_out)
    if fin and not fout:
        arr = quantise_u8(arr)
    elif fout and not fin:
        arr = arr.to(torch.float32) * INV255
    arr = _fix_alpha_chan(arr, has_alpha(pal_in), has_alpha(pal_out))
    return layer.replace(planes=(arr,), palette=int(pal_out))


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
