"""The colour kernels K2 and K3: wrappers, plain versions, launch counts,
launch geometry.

Counterpart of `lives_tpu/ops/pallas_kernels.py:88-204`
(`yuv420_to_rgb_supported`, `yuv420_to_rgb`, `rgb_to_yuv420`). The kernels
are CUDA C++ for the H100 (`csrc/yuv420.cu`, one library); its note says
what bounds them. `ops/colorspace.convert_layer` runs its YUV420P-family
<-> RGB pairs through them, so the decoded-clip path (`events.renderer.
ClipFrameSource`) converts every track chunk with K2 and the YUV4MPEG
encoder (`io/encoders.py`) every chunk with K3.

- `yuv420_to_rgb(y, u, v, subspace, clamping)`: y ``(..., H, W)``, u and v
  ``(..., H/2, W/2)`` u8 -> ``(..., 3, H, W)`` u8, the canonical RGB24
  plane. (The JAX API returns R, G, B as three planes; the stacked form
  is what the kernel writes and what a Layer holds.) H and W even.
- `rgb_to_yuv420(rgb, subspace, clamping)`: rgb ``(..., C, H, W)`` u8,
  C = 3 or 4 (alpha ignored) -> y ``(..., H, W)``, u and v
  ``(..., H//2, W//2)``. (The JAX API takes R, G, B planes.)
- Each takes its kernel for CUDA tensors, counting the launch in
  `LAUNCHES`, and its plain version (`plain_yuv420_to_rgb`,
  `plain_rgb_to_yuv420`: the formulas of `ops/colorspace.py`) for CPU
  tensors, where the kernel cannot run; any other device raises.
- `colour_geometry(B, H, W, full, chroma, run)`: the launch both kernels
  take: the run of pixels a thread, the access width of the
  full-resolution planes and of the chroma planes (from the alignment of
  every pointer, stride and pitch), the grid.
- `build()` compiles the library with nvcc on first use (`native.load`)
  and binds it with ctypes.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import YUVClamping, YUVSubspace
from . import colorspace as cs

#: launches of each kernel since its count was last set to 0
LAUNCHES = {"yuv420_to_rgb": 0, "rgb_to_yuv420": 0}

#: pixels a thread's run may take (csrc/yuv420.cu's template argument), and
#: the one a launch takes unless asked for another
RUNS = (8, 16)
RUN = 16
#: a block's threads, at most (csrc/yuv420.cu MAX_THREADS)
MAX_THREADS = 1024
#: the access widths the kernel has, in bytes
WIDTHS = (16, 8, 4, 1)
_GRID_X, _GRID_Y = 2**31 - 1, 65535


@dataclass(frozen=True)
class ColourGeometry:
    """One launch of K2 or K3 over B frames of H x W (csrc/yuv420.cu): runs
    of `run` pixels of a row pair a thread; `wide` and `narrow` bytes an
    access of the full-resolution planes and of U and V; `threads` a
    block, a row pair's runs rounded up to a warp (at most MAX_THREADS);
    the grid (B * row pairs, blocks a row pair)."""
    B: int
    H: int
    W: int
    run: int
    wide: int
    narrow: int
    threads: int
    grid: tuple

    def runs(self):
        """(frame, row pair, first pixel, pixels) of every thread that has
        a run, by the kernel's own index arithmetic."""
        for bx in range(self.grid[0]):
            b, qy = divmod(bx, -(-self.H // 2))
            for by in range(self.grid[1]):
                for tx in range(self.threads):
                    x0 = (by * self.threads + tx) * self.run
                    if x0 < self.W:
                        yield b, qy, x0, min(self.run, self.W - x0)


def _width(values, cap: int) -> int:
    """The widest access of WIDTHS, at most `cap` bytes, that divides every
    value (byte addresses and strides)."""
    return next(w for w in WIDTHS
                if w <= cap and all(int(x) % w == 0 for x in values))


def colour_geometry(B: int, H: int, W: int, full=(), chroma=(),
                    run: int | None = None) -> ColourGeometry:
    """The launch of K2 or K3 over B frames of H x W: `full` holds the
    byte addresses and the frame, plane and row strides of the
    full-resolution planes (Y and RGB), `chroma` those of U and V; each
    plane's widest access is the widest of WIDTHS that divides all of them,
    up to the run's bytes (the run's chroma bytes for U and V). Raises on
    what the kernel does not take: a run not in RUNS, no frame, no pixel,
    a grid over its limits."""
    run = RUN if run is None else run
    if run not in RUNS:
        raise ValueError(f"colour_geometry: a run of {run} pixels; the "
                         f"kernel has {RUNS}")
    if B < 1 or H < 1 or W < 1:
        raise ValueError(f"colour_geometry: {B} frames of {W}x{H}")
    runs = -(-W // run)  # a row pair's
    threads = min(MAX_THREADS, -(-runs // 32) * 32)
    grid = (B * -(-H // 2), -(-runs // threads))
    if grid[0] > _GRID_X or grid[1] > _GRID_Y:
        raise ValueError(f"colour_geometry: grid {grid} over the limits "
                         f"({_GRID_X}, {_GRID_Y})")
    return ColourGeometry(B, H, W, run, _width(full, run),
                          _width(chroma, run // 2), threads, grid)


def yuv420_to_rgb_supported(h: int, w: int) -> bool:
    """K2 takes any even geometry: it masks ragged tiles and has no tile
    rule (the TPU kernel needed H % 8 == 0 and W % 128 == 0)."""
    return h >= 2 and w >= 2 and h % 2 == 0 and w % 2 == 0


def _device_kind(t: torch.Tensor, who: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {t.device}")
    return t.device.type


def _check_yuv(y, u, v):
    for p in (y, u, v):
        if p.dtype != torch.uint8:
            raise TypeError("yuv420_to_rgb: planes must be uint8")
    h, w = y.shape[-2:]
    if not yuv420_to_rgb_supported(h, w):
        raise ValueError(f"yuv420_to_rgb: {w}x{h} is not an even geometry")
    want = y.shape[:-2] + (h // 2, w // 2)
    if u.shape != want or v.shape != want:
        raise ValueError(f"yuv420_to_rgb: chroma {tuple(u.shape)} and "
                         f"{tuple(v.shape)}, want {tuple(want)}")
    if not (y.device == u.device == v.device):
        raise ValueError("yuv420_to_rgb: planes on different devices")


def plain_yuv420_to_rgb(y, u, v, subspace: int = YUVSubspace.YCBCR,
                        clamping: int = YUVClamping.CLAMPED) -> torch.Tensor:
    """K2's plain version: `chroma_up` then `yuv_to_rgb`, stacked."""
    _check_yuv(y, u, v)
    r, g, b = cs.yuv_to_rgb(y, cs.chroma_up(u, 2, 2), cs.chroma_up(v, 2, 2),
                            subspace, clamping)
    return torch.stack([r, g, b], -3)


def yuv420_to_rgb(y, u, v, subspace: int = YUVSubspace.YCBCR,
                  clamping: int = YUVClamping.CLAMPED) -> torch.Tensor:
    """YUV420P planes -> the (..., 3, H, W) RGB24 plane: K2 on CUDA
    tensors, its plain version on CPU tensors."""
    _check_yuv(y, u, v)
    if _device_kind(y, "yuv420_to_rgb") == "cpu":
        return plain_yuv420_to_rgb(y, u, v, subspace, clamping)
    return _launch_k2(y, u, v, subspace, clamping)


def plain_rgb_to_yuv420(rgb, subspace: int = YUVSubspace.YCBCR,
                        clamping: int = YUVClamping.CLAMPED):
    """K3's plain version: `rgb_to_yuv` then the 2x2 `chroma_down`."""
    _check_rgb(rgb)
    y, u, v = cs.rgb_to_yuv(rgb[..., 0, :, :], rgb[..., 1, :, :],
                            rgb[..., 2, :, :], subspace, clamping)
    return y, cs.chroma_down(u, 2, 2), cs.chroma_down(v, 2, 2)


def rgb_to_yuv420(rgb, subspace: int = YUVSubspace.YCBCR,
                  clamping: int = YUVClamping.CLAMPED):
    """The (..., C, H, W) RGB(A) u8 plane -> YUV420P (y, u, v): K3 on CUDA
    tensors, its plain version on CPU tensors."""
    _check_rgb(rgb)
    if _device_kind(rgb, "rgb_to_yuv420") == "cpu":
        return plain_rgb_to_yuv420(rgb, subspace, clamping)
    return _launch_k3(rgb, subspace, clamping)


def _check_rgb(rgb):
    if rgb.dtype != torch.uint8:
        raise TypeError("rgb_to_yuv420: the RGB plane must be uint8")
    if rgb.ndim < 3 or rgb.shape[-3] not in (3, 4):
        raise ValueError(f"rgb_to_yuv420: plane {tuple(rgb.shape)}, want "
                         "(..., 3 or 4, H, W)")


def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("yuv420")
    lib = built.lib
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.lives_yuv420_to_rgb.argtypes = [p, p, p, ll, ll, ll, p, i, i, i,
                                        i, i, i, i, f, f, f, f, f, f, i, p]
    lib.lives_yuv420_to_rgb.restype = i
    lib.lives_rgb_to_yuv420.argtypes = [p, ll, p, p, p, i, i, i, i, i, i,
                                        i, p, p, p]
    lib.lives_rgb_to_yuv420.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def _frames(p: torch.Tensor, B: int):
    """p as (B, h, w) with contiguous rows, and its frame stride in bytes;
    a strided view (planes of one upload) stays a view."""
    h, w = p.shape[-2:]
    if p.stride(-1) != 1 or (h > 1 and p.stride(-2) != w):
        p = p.contiguous()
    p = p.reshape(B, h, w)
    return p, (p.stride(0) if B > 1 else h * w)


def k2_geometry(y3, ys, u3, us, v3, vs, out, run=None) -> ColourGeometry:
    """K2's launch: planes (B, h, w) and (B, h/2, w/2) of contiguous rows
    with frame strides ys, us, vs (`_frames`), out (B, 3, h, w)
    contiguous."""
    B, h, w = y3.shape
    return colour_geometry(
        B, h, w, (y3.data_ptr(), ys, w, out.data_ptr(), h * w),
        (u3.data_ptr(), v3.data_ptr(), us, vs, w // 2), run)


def k3_geometry(rgb, y, u, v, run=None) -> ColourGeometry:
    """K3's launch: rgb (..., C, h, w) contiguous, its outputs y, u, v."""
    C, h, w = rgb.shape[-3:]
    return colour_geometry(
        math.prod(rgb.shape[:-3]), h, w,
        (rgb.data_ptr(), C * h * w, h * w, y.data_ptr(), w),
        (u.data_ptr(), v.data_ptr(), (h // 2) * (w // 2), w // 2), run)


def _raise_on(lib, err: int, who: str):
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"{who} launch failed: CUDA error {err} ({msg})")


def _launch_k2(y, u, v, subspace, clamping, run=None) -> torch.Tensor:
    lead = y.shape[:-2]
    h, w = y.shape[-2:]
    B = math.prod(lead)
    out = torch.empty(lead + (3, h, w), dtype=torch.uint8, device=y.device)
    if B == 0:
        return out
    (y3, ys), (u3, us), (v3, vs) = (_frames(p, B) for p in (y, u, v))
    g = k2_geometry(y3, ys, u3, us, v3, vs, out, run)
    lib = build().lib
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.lives_yuv420_to_rgb(
            y3.data_ptr(), u3.data_ptr(), v3.data_ptr(), ys, us, vs,
            out.data_ptr(), B, h, w, g.run, g.wide, g.narrow, g.threads,
            *cs.yuv2rgb_constants(subspace),
            int(clamping == YUVClamping.CLAMPED), stream)
    _raise_on(lib, err, "yuv420_to_rgb")
    LAUNCHES["yuv420_to_rgb"] += 1
    return out


def _launch_k3(rgb, subspace, clamping, run=None):
    lead = rgb.shape[:-3]
    C, h, w = rgb.shape[-3:]
    B = math.prod(lead)
    dev = rgb.device
    y = torch.empty(lead + (h, w), dtype=torch.uint8, device=dev)
    u = torch.empty(lead + (h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty_like(u)
    if B == 0 or h == 0 or w == 0:
        return y, u, v
    src = rgb.contiguous()
    fs = C * h * w
    g = k3_geometry(src, y, u, v, run)
    m, *lim = cs.rgb2yuv_constants(subspace, clamping)
    m9 = (ctypes.c_float * 9)(*m.reshape(-1).tolist())
    lim6 = (ctypes.c_float * 6)(*np.asarray(lim, np.float32).tolist())
    lib = build().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lives_rgb_to_yuv420(
            src.data_ptr(), fs, y.data_ptr(), u.data_ptr(), v.data_ptr(), B,
            h, w, g.run, g.wide, g.narrow, g.threads, m9, lim6, stream)
    _raise_on(lib, err, "rgb_to_yuv420")
    LAUNCHES["rgb_to_yuv420"] += 1
    return y, u, v
