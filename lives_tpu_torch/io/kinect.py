"""Kinect (libfreenect) capture: the depth-keyed RGB source, and the
`depth_key` filter.

Counterpart of `lives_tpu/io/kinect.py:47-212` (reference
`lives-plugins/weed-plugins/freenect.c:1-343`: a generator that opens the
Kinect, streams 640x480 RGB with registered depth, and replaces every
pixel outside the [minthresh, maxthresh) depth window with a solid
colour at alpha 0, `:276-300`; the optional depth out-channel, `:311-321`).

- `KinectCamera`: ctypes over the libfreenect sync API
  (`freenect_sync_get_video`, `freenect_sync_get_depth`), gated:
  `load_freenect()` returns None where the library is absent, and every
  class takes an injected lib, so the path runs against a mock
  (tests/test_torch_kinect.py).
- `KinectClip`: a clip-like live source on its torch device (`device`,
  the card unless the caller asks for the CPU). Each `get_frame` pulls
  RGB and depth on the host, copies both to the device once, and keys
  there (`key_frame`, the JAX `_key_fn`, `:101-126`, in plain torch).
  `last_depth` holds the depth as an AFLOAT Layer ([0, 1], millimetres /
  65536), the cconx-routable twin of the reference's depth channel.
- the `depth_key` filter: the same keying as an effect on any RGB layer
  with a connected AFLOAT depth channel (the thresholds in millimetres,
  rescaled here). Unconnected, the frame passes through.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..constants import Palette
from ..effects.host import ChannelTemplate, Filter, Param, register_filter
from ..effects.util import bparam, split_alpha, to_f01
from ..layer import Layer

KINECT_W, KINECT_H = 640, 480
_DEPTH_MAX = 65536

# freenect.h enums (the reference selects RGB video + REGISTERED depth,
# freenect.c:181-182)
FREENECT_VIDEO_RGB = 0
FREENECT_DEPTH_REGISTERED = 4


def load_freenect():
    """The sync-API library, or None (gated feature)."""
    for name in ("libfreenect_sync.so.0", "libfreenect_sync.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


class KinectCamera:
    """Blocking-pull Kinect camera over the libfreenect sync API."""

    def __init__(self, lib=None, index: int = 0):
        self.lib = lib if lib is not None else load_freenect()
        if self.lib is None:
            raise RuntimeError("libfreenect_sync not available")
        self.index = index
        self._lock = threading.Lock()

    def get_rgb(self) -> np.ndarray:
        """(480, 640, 3) u8 RGB."""
        data = ctypes.c_void_p()
        ts = ctypes.c_uint32()
        with self._lock:
            rc = self.lib.freenect_sync_get_video(
                ctypes.byref(data), ctypes.byref(ts), self.index,
                FREENECT_VIDEO_RGB)
        if rc != 0 or not data.value:
            raise RuntimeError(f"freenect_sync_get_video rc={rc}")
        buf = ctypes.string_at(data.value, KINECT_W * KINECT_H * 3)
        return np.frombuffer(buf, np.uint8).reshape(KINECT_H, KINECT_W, 3)

    def get_depth(self) -> np.ndarray:
        """(480, 640) u16 registered depth (mm-domain, like the
        reference's FREENECT_DEPTH_REGISTERED stream)."""
        data = ctypes.c_void_p()
        ts = ctypes.c_uint32()
        with self._lock:
            rc = self.lib.freenect_sync_get_depth(
                ctypes.byref(data), ctypes.byref(ts), self.index,
                FREENECT_DEPTH_REGISTERED)
        if rc != 0 or not data.value:
            raise RuntimeError(f"freenect_sync_get_depth rc={rc}")
        buf = ctypes.string_at(data.value, KINECT_W * KINECT_H * 2)
        return np.frombuffer(buf, np.uint16).reshape(KINECT_H, KINECT_W)

    def close(self):
        try:
            self.lib.freenect_sync_stop()
        except Exception:
            pass


def key_frame(rgb: torch.Tensor, depth: torch.Tensor, minthresh: float,
              maxthresh: float, ccol) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-window keying (`lives_tpu/io/kinect.py:101-126`): (3, H, W)
    u8 RGB and (H, W) depth in millimetres (any integer dtype) on one
    device -> (4, H, W) u8 RGBA keyed (outside [minthresh, maxthresh):
    `ccol` at alpha 0) and the (H, W) f32 depth / 65536."""
    d = depth.to(torch.float32)
    cut = (d >= maxthresh) | (d < minthresh)  # freenect.c:277
    col = torch.tensor([float(c) for c in ccol], dtype=torch.float32,
                       device=rgb.device)[:, None, None]
    out = torch.where(cut[None], col, rgb.to(torch.float32))
    alpha = torch.where(cut, 0.0, 255.0)
    rgba = torch.cat([out, alpha[None]], 0)
    return (torch.clamp(rgba, 0, 255).to(torch.uint8),
            d * (1.0 / _DEPTH_MAX))


class KinectClip:
    """Clip-like live Kinect source (the V4L2Source contract): RGBA32
    frames with outside-the-depth-window pixels replaced by `ccol` and
    alpha 0, on `device`. `last_depth` holds the matching AFLOAT depth
    Layer."""

    def __init__(self, camera: KinectCamera | None = None, lib=None,
                 minthresh: int = 0, maxthresh: int = _DEPTH_MAX,
                 ccol=(0, 0, 0), *, device: torch.device | str = "cuda"):
        self.camera = camera if camera is not None else KinectCamera(lib)
        self.device = torch.device(device)
        self.width, self.height = KINECT_W, KINECT_H
        self.fps = 25.0  # the reference's preferred fps (freenect.c:337)
        self.frames = 1 << 30
        from ..utils.uid import stable_uid
        self.unique_id = stable_uid("kinect", str(self.camera.index))
        self.scrap_on_record = True
        self.minthresh, self.maxthresh = minthresh, maxthresh
        self.ccol = tuple(ccol)
        self.last_depth: Layer | None = None

    def get_frame(self, n: int = 0) -> Layer:
        rgb = np.ascontiguousarray(np.moveaxis(self.camera.get_rgb(), -1, 0))
        # u16 crosses as its bytes (an int16 view), widened on the device
        depth = self.camera.get_depth()
        d16 = torch.from_numpy(depth.view(np.int16).copy()).to(self.device)
        rgba, d = key_frame(torch.from_numpy(rgb).to(self.device),
                            d16.to(torch.int32) & 0xFFFF,
                            float(self.minthresh), float(self.maxthresh),
                            self.ccol)
        self.last_depth = Layer(planes=(d,), palette=int(Palette.AFLOAT))
        return Layer(planes=(rgba,), palette=int(Palette.RGBA32))

    def close(self):
        self.camera.close()


def _depth_key_process(ins, p, ctx):
    lay = ins[0]
    depth_lay = ins[1] if len(ins) > 1 else None
    if depth_lay is None:
        return lay
    rgb, _ = split_alpha(to_f01(lay))
    d = depth_lay.planes[0].to(torch.float32)[:, None]
    cut = (d >= bparam(p["maxthresh"]) * (1.0 / _DEPTH_MAX)) \
        | (d < bparam(p["minthresh"]) * (1.0 / _DEPTH_MAX))
    col = torch.stack(torch.broadcast_tensors(*(
        torch.as_tensor(p[c], dtype=torch.float32, device=rgb.device)
        .reshape(-1) for c in ("ccol_r", "ccol_g", "ccol_b"))), 1)
    out = torch.where(cut, col[:, :, None, None], rgb)
    alpha = torch.where(cut, 0.0, 1.0)
    arr = torch.cat([out, alpha], 1)
    return lay.replace(
        planes=(torch.clamp(arr * 255.0 + 0.5, 0, 255).to(torch.uint8),),
        palette=int(Palette.RGBA32))


register_filter(Filter(
    name="depth_key", process=_depth_key_process,
    in_channels=(ChannelTemplate("in", (Palette.RGB24, Palette.RGBA32)),),
    alpha_ins=(ChannelTemplate("depth", (Palette.AFLOAT,), optional=True),),
    params=(Param("minthresh", "num", 0.0, 0.0, float(_DEPTH_MAX)),
            Param("maxthresh", "num", float(_DEPTH_MAX), 0.0,
                  float(_DEPTH_MAX)),
            Param("ccol_r", "num", 0.0, 0.0, 1.0),
            Param("ccol_g", "num", 0.0, 0.0, 1.0),
            Param("ccol_b", "num", 0.0, 0.0, 1.0)),
    description="depth-window keying (freenect.c:276 keying loop) "
                "for any RGB + AFLOAT depth pair"))
