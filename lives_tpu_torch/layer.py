"""Layer: the frame object, as planar torch tensors.

Counterpart of `lives_tpu/layer.py:54` (`Layer`) and `:122`
(`layer_blank`); reference `src/layers.c:30`, `src/layers.h:96-144`.

The device representation is the same as the JAX package's: planar,
channel-major. RGB-family palettes hold one ``(C, H, W)`` tensor in R,G,B[,A]
order, YUV palettes hold ``(Y, U, V[, A])`` planes at their subsampled sizes.
A batch of frames carries a leading ``B`` axis on every plane, so the
renderer's layers are ``(B, C, H, W)``. The colour metadata is plain Python
and decides which code path runs, as the JAX package's static fields decide
which template is traced.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .constants import (
    CHROMA_SUBSAMPLING,
    Gamma,
    Palette,
    YUVClamping,
    YUVSampling,
    YUVSubspace,
    has_alpha,
    is_float_palette,
    is_rgb_palette,
    is_yuv_palette,
)


@dataclass(frozen=True)
class Layer:
    """One video frame (or a batch of frames) on a device."""

    planes: tuple[torch.Tensor, ...]
    palette: int = Palette.RGB24
    clamping: int = YUVClamping.CLAMPED
    sampling: int = YUVSampling.DEFAULT
    subspace: int = YUVSubspace.YCBCR
    gamma: int = Gamma.SRGB
    premult: bool = False  # alpha premultiplied?

    @property
    def height(self) -> int:
        return self.planes[0].shape[-2]

    @property
    def width(self) -> int:
        return self.planes[0].shape[-1]

    @property
    def size(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def dtype(self) -> torch.dtype:
        return self.planes[0].dtype

    @property
    def device(self) -> torch.device:
        return self.planes[0].device

    def replace(self, **kw) -> "Layer":
        return dataclasses.replace(self, **kw)

    @property
    def config(self) -> tuple:
        """Hashable colour + shape key (the plan-cache key contribution,
        `lives_tpu/layer.py:89`)."""
        shapes = tuple((tuple(p.shape), str(p.dtype)) for p in self.planes)
        return (self.palette, self.clamping, self.sampling, self.subspace,
                self.gamma, self.premult, shapes)


def _plane_shapes(palette: int, width: int,
                  height: int) -> list[tuple[int, ...]]:
    """Plane shapes for a palette at a frame geometry
    (`lives_tpu/layer.py:99`)."""
    pal = Palette(palette)
    if is_rgb_palette(pal):
        return [(4 if has_alpha(pal) else 3, height, width)]
    if pal in (Palette.A8, Palette.A1, Palette.AFLOAT):
        return [(height, width)]
    if is_yuv_palette(pal):
        sh, sv = CHROMA_SUBSAMPLING[pal]
        shapes = [(height, width),
                  (height // sv, width // sh),
                  (height // sv, width // sh)]
        if has_alpha(pal):
            shapes.append((height, width))
        return shapes
    raise ValueError(f"unsupported palette {palette}")


def layer_blank(width: int, height: int, palette: int = Palette.RGB24, *,
                device: torch.device | str,
                clamping: int = YUVClamping.CLAMPED,
                gamma: int = Gamma.SRGB,
                subspace: int = YUVSubspace.YCBCR) -> Layer:
    """Black frame (reference `create_empty_pixel_data` with blank=TRUE,
    `src/colourspace.c:11434`). YUV black = luma min, chroma 128."""
    dtype = torch.float32 if is_float_palette(palette) else torch.uint8
    shapes = _plane_shapes(palette, width, height)
    pal = Palette(palette)
    if is_yuv_palette(pal):
        ymin = 16 if clamping == YUVClamping.CLAMPED else 0
        planes = [torch.full(shapes[0], ymin, dtype=dtype, device=device),
                  torch.full(shapes[1], 128, dtype=dtype, device=device),
                  torch.full(shapes[2], 128, dtype=dtype, device=device)]
        if has_alpha(pal):
            planes.append(torch.full(shapes[3], 255, dtype=dtype,
                                     device=device))
    else:
        arr = torch.zeros(shapes[0], dtype=dtype, device=device)
        if has_alpha(pal) and len(shapes[0]) == 3:
            arr[-1] = 1.0 if is_float_palette(pal) else 255
        planes = [arr]
    return Layer(planes=tuple(planes), palette=palette, clamping=clamping,
                 gamma=gamma, subspace=subspace)
