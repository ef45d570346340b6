"""Layer: the frame object, as planar torch tensors.

Counterpart of `lives_tpu/layer.py:54` (`Layer`), `:122` (`layer_blank`)
and `:153-273` (`layer_from_bytes`, `layer_to_bytes`, the host boundary);
reference `src/layers.c:30`, `src/layers.h:96-144`.

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

import numpy as np
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


# ---------------------------------------------------------------------------
# Host boundary: byte layout pack/unpack (numpy, at IO edges)
# ---------------------------------------------------------------------------

_RGB_BYTE_ORDER = {
    Palette.RGB24: (0, 1, 2),
    Palette.BGR24: (2, 1, 0),
    Palette.RGBA32: (0, 1, 2, 3),
    Palette.BGRA32: (2, 1, 0, 3),
    Palette.ARGB32: (3, 0, 1, 2),  # byte k holds channel _RGB_BYTE_ORDER[k]
}


def _planes_from_bytes(buf, width: int, height: int, pal: Palette):
    """Host numpy planes of one frame of reference-format bytes."""
    a = (np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray)
         else buf.reshape(-1))
    if pal in _RGB_BYTE_ORDER:
        order = _RGB_BYTE_ORDER[pal]
        img = a.reshape(height, width, len(order))
        # channel c sits at the byte index where order == c
        return (np.stack([img[..., order.index(c)]
                          for c in range(len(order))], 0),)
    if pal in (Palette.YUV420P, Palette.YVU420P):
        y = a[: height * width].reshape(height, width)
        cs = (height // 2) * (width // 2)
        c1 = a[height * width: height * width + cs].reshape(height // 2,
                                                            width // 2)
        c2 = a[height * width + cs: height * width + 2 * cs].reshape(
            height // 2, width // 2)
        return (y, c1, c2) if pal == Palette.YUV420P else (y, c2, c1)
    if pal == Palette.YUV422P:
        y = a[: height * width].reshape(height, width)
        cs = height * (width // 2)
        u = a[height * width: height * width + cs].reshape(height, width // 2)
        v = a[height * width + cs:].reshape(height, width // 2)
        return (y, u, v)
    if pal in (Palette.YUV444P, Palette.YUVA4444P):
        n = 4 if pal == Palette.YUVA4444P else 3
        return tuple(a.reshape(n, height, width))
    if pal in (Palette.UYVY, Palette.YUYV):
        m = a.reshape(height, width // 2, 4)
        if pal == Palette.UYVY:
            u, y0, v, y1 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        else:
            y0, u, y1, v = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        return (np.stack([y0, y1], -1).reshape(height, width), u, v)
    if pal in (Palette.YUV888, Palette.YUVA8888):
        n = 4 if pal == Palette.YUVA8888 else 3
        img = a.reshape(height, width, n)
        return tuple(img[..., i] for i in range(n))
    if pal == Palette.YUV411:
        # u y y v y y per 4 pixels (IYU1)
        m = a.reshape(height, width // 4, 6)
        y = np.stack([m[..., 1], m[..., 2], m[..., 4], m[..., 5]], -1
                     ).reshape(height, width)
        return (y, m[..., 0], m[..., 3])
    if pal == Palette.A8:
        return (a.reshape(height, width),)
    if pal == Palette.A1:
        # packed 1 bit a pixel, rowstride (width+7)>>3 (reference
        # colourspace.c:11335); on the device (H,W) u8 in {0,1}
        rs = (width + 7) >> 3
        rows = a[: height * rs].reshape(height, rs)
        return (np.unpackbits(rows, axis=1)[:, :width],)
    if pal == Palette.AFLOAT:
        f = (np.frombuffer(buf, np.float32)
             if not isinstance(buf, np.ndarray)
             else buf.reshape(-1).view(np.float32))
        return (f[: height * width].reshape(height, width),)
    raise ValueError(f"layer_from_bytes: unsupported palette {pal}")


def layer_from_bytes(buf: bytes | np.ndarray, width: int, height: int,
                     palette: int, *, device: torch.device | str,
                     **meta) -> Layer:
    """A Layer on `device` from reference-format pixel bytes (one frame,
    compact rowstrides; the byte layouts of weed-palettes.h)."""
    pal = Palette(palette)
    planes = _planes_from_bytes(buf, width, height, pal)
    return Layer(planes=tuple(torch.from_numpy(np.array(p)).to(device)
                              for p in planes), palette=palette, **meta)


def layer_to_bytes(layer: Layer) -> bytes:
    """Serialise one frame to reference-format pixel bytes (compact rows),
    on the host."""
    pal = Palette(layer.palette)
    planes = [p.detach().cpu().numpy() for p in layer.planes]
    if pal in _RGB_BYTE_ORDER:
        chans = planes[0]
        return np.stack([chans[c] for c in _RGB_BYTE_ORDER[pal]],
                        -1).tobytes()
    if pal in (Palette.YUV420P, Palette.YVU420P):
        y, u, v = planes
        if pal == Palette.YVU420P:
            u, v = v, u
        return y.tobytes() + u.tobytes() + v.tobytes()
    if pal in (Palette.YUV422P, Palette.YUV444P, Palette.YUVA4444P):
        return b"".join(p.tobytes() for p in planes)
    if pal in (Palette.UYVY, Palette.YUYV):
        y, u, v = planes
        h, w = y.shape
        y2 = y.reshape(h, w // 2, 2)
        order = ([u, y2[..., 0], v, y2[..., 1]] if pal == Palette.UYVY
                 else [y2[..., 0], u, y2[..., 1], v])
        return np.stack(order, -1).tobytes()
    if pal in (Palette.YUV888, Palette.YUVA8888):
        return np.stack(planes, -1).tobytes()
    if pal == Palette.YUV411:
        y, u, v = planes
        h, w = y.shape
        y4 = y.reshape(h, w // 4, 4)
        return np.stack([u, y4[..., 0], y4[..., 1], v, y4[..., 2],
                         y4[..., 3]], -1).tobytes()
    if pal == Palette.A8:
        return planes[0].tobytes()
    if pal == Palette.A1:
        return np.packbits(planes[0].astype(np.uint8) & 1, axis=1).tobytes()
    if pal == Palette.AFLOAT:
        return planes[0].astype(np.float32).tobytes()
    raise ValueError(f"layer_to_bytes: unsupported palette {pal}")
