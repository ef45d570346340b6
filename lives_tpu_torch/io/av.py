"""In-process libav decoder and encoder: ctypes over native/avbridge.cpp.

Counterpart of `lives_tpu/io/av.py` (the reference's decoder plugins,
`lives-plugins/plugins/decoders/decplugin.h`: get_clip_data, `get_frame`
:280, `rip_audio` :294, `estimate_delay` :305, and its encoder plugins).
The bridge is the JAX package's C++ source, shared and not copied; the
port builds its own library from it (`native.load_avbridge`, into
`build/lives_tpu_torch/`). A host without libavformat or the libav
headers has no libav lane: `load_avbridge()` returns None,
`absent_reason()` says why, `AVDecoder` claims nothing and the "av"
encoder is not registered.

`AVDecoder` (`av.py:110-220`) serves a compressed clip's frames as
YUV420P layers of host planes with the container's range and subspace,
read into caller-owned arrays when given (`get_frame(n, out=...)`, the
port's decoder contract): the renderer and the player upload them and
convert on the device (K2). It is registered after the YUV4MPEG2, WAV
and AVI decoders (`io/__init__.py`), so an MJPEG `.avi` keeps the device
JPEG lane. `AVEncodeSession` (`:261-334`) writes RGB frames and s16
audio to any avformat target, `AVStreamSource` (`:336-402`) reads a live
stream in order, and `ENC_CODECS` (`:244`) maps a container to its
codecs.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import native
from ..constants import Gamma, Palette, YUVClamping, YUVSubspace
from ..layer import Layer
from .decoders import ClipData, Decoder, register_decoder

#: containers the reference's decoder plugins claim (plus modern ones)
VIDEO_EXTS = {".mkv", ".mp4", ".m4v", ".mov", ".avi", ".webm", ".ogv",
              ".ogg", ".ogm", ".mpg", ".mpeg", ".ts", ".m2ts", ".mts",
              ".flv", ".asf", ".wmv", ".dv", ".3gp", ".vob", ".divx",
              ".gif", ".rm", ".h264", ".264"}

_BOUND = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The bridge's signatures (`av.py:62-101`)."""
    c = ctypes
    u8p, i64p = c.POINTER(c.c_uint8), c.POINTER(c.c_int64)
    sig = {
        "avb_open": (c.c_void_p, [c.c_char_p]),
        "avb_open_mode": (c.c_void_p, [c.c_char_p, c.c_int]),
        "avb_next_frame": (c.c_int, [c.c_void_p, u8p]),
        "avb_info": (c.c_int, [c.c_void_p, i64p]),
        "avb_codec_name": (c.c_char_p, [c.c_void_p]),
        "avb_seek_cost": (c.c_int64, [c.c_void_p, c.c_int64, c.c_int64]),
        "avb_get_frame": (c.c_int, [c.c_void_p, c.c_int64, u8p]),
        "avb_rip_audio": (c.c_int64, [c.c_void_p, c.c_char_p]),
        "avb_close": (None, [c.c_void_p]),
        "avb_enc_open2": (c.c_void_p, [
            c.c_char_p, c.c_char_p, c.c_char_p, c.c_int, c.c_int,
            c.c_int, c.c_int, c.c_int64, c.c_int, c.c_char_p, c.c_int,
            c.c_int]),
        "avb_enc_video": (c.c_int, [c.c_void_p, u8p, c.c_int]),
        "avb_enc_audio": (c.c_int, [c.c_void_p, c.POINTER(c.c_int16),
                                    c.c_int64]),
        "avb_enc_close": (c.c_int, [c.c_void_p]),
        "avb_have_encoder": (c.c_int, [c.c_char_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load_avbridge():
    """The bound libav bridge, or None where this host has no libav lane
    (`absent_reason()`). A failed build raises with g++'s stderr."""
    global _BOUND
    lib = native.load_avbridge()
    if lib is None:
        return None
    if _BOUND is not lib:
        _BOUND = _bind(lib)
    return lib


def absent_reason() -> str:
    """Why this host has no libav lane ("" where it has one or has not
    been asked yet)."""
    return native.AVBRIDGE_ABSENT


def _i420(buf, w: int, h: int, out=None):
    """The Y, U, V planes of a contiguous I420 frame, copied into `out`
    (three writable uint8 arrays) or new arrays."""
    a = np.frombuffer(buf, np.uint8)
    cs = (w // 2) * (h // 2)
    src = (a[: w * h].reshape(h, w),
           a[w * h: w * h + cs].reshape(h // 2, w // 2),
           a[w * h + cs: w * h + 2 * cs].reshape(h // 2, w // 2))
    if out is None:
        return tuple(p.copy() for p in src)
    for dst, p in zip(out, src):
        dst[...] = p
    return tuple(out)


def _yuv_layer(planes, clamping, subspace) -> Layer:
    return Layer(planes=tuple(torch.from_numpy(p) for p in planes),
                 palette=int(Palette.YUV420P), clamping=clamping,
                 subspace=subspace)


@register_decoder
class AVDecoder(Decoder):
    """Compressed-media decoder over the bridge (H.264/HEVC/Theora/VP8/
    VP9/MPEG-4/MJPEG/DV/WMV in mkv/mp4/avi/ogg/webm/mpegts/flv/asf/dv)."""

    name = "avformat"

    def __init__(self, cdata: ClipData, handle, lib):
        self.cdata = cdata
        self._h = handle
        self._lib = lib
        w, h = cdata.width, cdata.height
        self._buf = (ctypes.c_uint8 * (w * h + 2 * (w // 2) * (h // 2)))() \
            if w > 0 else None
        # one native handle is stateful (seek + warm position); the
        # player's precache thread and main loop both pull frames
        self._lock = threading.Lock()

    @classmethod
    def get_clip_data(cls, uri: str) -> Optional[ClipData]:
        p = Path(uri)
        if not (p.is_file() and p.suffix.lower() in VIDEO_EXTS):
            return None
        lib = load_avbridge()
        if lib is None:
            return None
        h = lib.avb_open(str(p).encode())
        if not h:
            return None
        info = (ctypes.c_int64 * 11)()
        lib.avb_info(h, info)
        w, hh, num, den, nframes, has_a, arate, achans, inter, full, bt709 \
            = [int(v) for v in info]
        if w <= 0 or nframes <= 0:
            if has_a and arate > 0:
                # audio-only media: a WavDecoder-style clip, no video
                cd = ClipData(uri=uri, nframes=0, width=0, height=0,
                              fps=25.0, arate=arate, achans=achans)
                cd.decoder = cls(cd, h, lib)
                return cd
            lib.avb_close(h)
            return None
        # keyframe spacing feeds the precache seek-cost ordering
        cost_cold = int(lib.avb_seek_cost(h, -1, nframes - 1))
        cd = ClipData(
            uri=uri, nframes=nframes, width=w, height=hh,
            fps=(num / den) if den else 25.0,
            palette=int(Palette.YUV420P),
            yuv_clamping=int(YUVClamping.UNCLAMPED if full
                             else YUVClamping.CLAMPED),
            yuv_subspace=int(YUVSubspace.BT709 if bt709
                             else YUVSubspace.YCBCR),
            gamma=int(Gamma.SRGB),
            arate=arate, achans=achans, interlace=inter,
            kframe_dist=max(1, cost_cold))
        cd.decoder = cls(cd, h, lib)
        return cd

    @property
    def codec(self) -> str:
        return self._lib.avb_codec_name(self._h).decode()

    def get_frame(self, n: int, out=None) -> Layer:
        """Frame n: host Y, U, V planes, read into `out` (three writable
        contiguous uint8 arrays of (H, W), (H/2, W/2), (H/2, W/2)) when
        given."""
        cd = self.cdata
        n = max(0, min(int(n), cd.nframes - 1))
        with self._lock:
            if not self._lib.avb_get_frame(self._h, n, self._buf):
                raise IOError(f"avbridge: decode of frame {n} failed")
            planes = _i420(self._buf, cd.width, cd.height, out)
        return _yuv_layer(planes, cd.yuv_clamping, cd.yuv_subspace)

    def rip_audio(self, path: str) -> bool:
        if not self.cdata.arate:
            return False
        with self._lock:
            return self._lib.avb_rip_audio(self._h,
                                           str(path).encode()) > 0

    def estimate_delay(self, from_frame: int, to_frame: int) -> float:
        cost = int(self._lib.avb_seek_cost(self._h, from_frame, to_frame))
        return cost * self.cdata.const_time_per_frame

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avb_close(self._h)
            self._h = None

    def __del__(self):  # a native handle must not outlive its wrapper
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.avb_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

#: container extension -> (video codec, audio codec) (`av.py:244`)
ENC_CODECS = {
    "mpegts": ("libx264", "aac"),
    "ogg": ("libtheora", "libvorbis"),
    "mkv": ("libx264", "aac"),
    "mp4": ("libx264", "aac"),
    "webm": ("libvpx", "libvorbis"),
    "ogv": ("libtheora", "libvorbis"),
    "avi": ("mpeg4", "pcm_s16le"),
    "mov": ("libx264", "aac"),
    "ts": ("libx264", "aac"),
    # long-tail reference encoder plugins: lives_gif_encoder and
    # encodedv_encoder, video only
    "gif": ("gif", ""),
    "dv": ("dvvideo", ""),
}


def host_rgb(frame) -> np.ndarray:
    """A frame ((3|4, H, W) or (H, W, 3|4) uint8, numpy or a tensor on any
    device) as a contiguous (H, W, 3) host array."""
    if isinstance(frame, torch.Tensor):
        frame = frame.cpu().numpy()
    arr = np.asarray(frame, np.uint8)
    if arr.shape[0] in (3, 4) and arr.ndim == 3:
        arr = np.moveaxis(arr[:3], 0, -1)
    return np.ascontiguousarray(arr[..., :3])


class AVEncodeSession:
    """A streaming encode (`av.py:261`): open, write frames and audio,
    close. The reference's encoder plugins consume rendered frames the
    same way."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 vcodec: str | None = None, acodec: str | None = None,
                 arate: int = 0, achans: int = 2, bitrate: int = 0,
                 gop: int = 12, container: str = ""):
        lib = load_avbridge()
        if lib is None:
            raise RuntimeError(f"no libav lane: {absent_reason()}")
        ext = container or Path(path).suffix.lstrip(".").lower()
        dflt = ENC_CODECS.get(ext, ("libx264", "aac"))
        vcodec = vcodec or dflt[0]
        acodec = acodec or dflt[1]
        if not acodec:
            # the container has no audio codec (gif, raw dv): video only
            arate = 0
        fr = Fraction(fps).limit_denominator(1001 * 60)
        self._lib = lib
        self._h = lib.avb_enc_open2(
            str(path).encode(), container.encode(), vcodec.encode(),
            width, height, fr.numerator, fr.denominator, bitrate, gop,
            acodec.encode() if arate else b"", arate, achans)
        if not self._h:
            raise RuntimeError(f"avbridge: cannot open encoder for {path}")
        self.width, self.height = width, height
        self.achans = achans if arate else 0

    def write_frame(self, frame):
        """An RGB frame ((3,H,W)/(H,W,3) uint8, numpy or tensor), or flat
        I420 bytes (a 1-D array)."""
        arr = frame.cpu().numpy() if isinstance(frame, torch.Tensor) \
            else np.asarray(frame, np.uint8)
        if arr.ndim == 3:
            rgb = host_rgb(arr)
            ok = self._lib.avb_enc_video(
                self._h, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                1)
        else:
            flat = np.ascontiguousarray(arr.reshape(-1), np.uint8)
            ok = self._lib.avb_enc_video(
                self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                0)
        if not ok:
            raise IOError("avbridge: encode_video failed")

    def write_audio(self, pcm: np.ndarray):
        """(N,) or (N, chans) int16 interleaved samples."""
        pcm = np.ascontiguousarray(np.asarray(pcm, np.int16).reshape(-1))
        if not self._lib.avb_enc_audio(
                self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                pcm.size // max(1, self.achans)):
            raise IOError("avbridge: encode_audio failed")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avb_enc_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.avb_enc_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AVStreamSource:
    """A sequential reader of live or network media (udp:// MPEG-TS,
    icecast/http, pipes, or any file) without the open-time index scan
    (`av.py:336`): clip-like, `get_frame(n)` returns the NEXT frame in
    stream order as host YUV420P planes, and holds the last frame at an
    underrun."""

    def __init__(self, uri: str):
        lib = load_avbridge()
        if lib is None:
            raise RuntimeError(f"no libav lane: {absent_reason()}")
        self._lib = lib
        self._h = lib.avb_open_mode(str(uri).encode(), 1)
        if not self._h:
            raise IOError(f"cannot open stream {uri!r}")
        info = (ctypes.c_int64 * 11)()
        lib.avb_info(self._h, info)
        self.width, self.height = int(info[0]), int(info[1])
        self.fps = (int(info[2]) / int(info[3])) if info[3] else 25.0
        self._clamping = int(YUVClamping.UNCLAMPED if int(info[9])
                             else YUVClamping.CLAMPED)
        self._subspace = int(YUVSubspace.BT709 if int(info[10])
                             else YUVSubspace.YCBCR)
        if self.width <= 0:
            lib.avb_close(self._h)
            self._h = None
            raise IOError(f"no video stream in {uri!r}")
        w, h = self.width, self.height
        self._buf = (ctypes.c_uint8 * (w * h + 2 * (w // 2) * (h // 2)))()
        self.frames = 1 << 30
        self.unique_id = 0x4156  # 'AV'
        self.scrap_on_record = True  # live feed: recordings scrap frames
        self._last: Optional[Layer] = None

    def get_frame(self, n: int = 0) -> Layer:
        if not self._lib.avb_next_frame(self._h, self._buf):
            if self._last is not None:
                return self._last  # EOF / underrun: hold the last frame
            raise EOFError("stream ended")
        self._last = _yuv_layer(_i420(self._buf, self.width, self.height),
                                self._clamping, self._subspace)
        return self._last

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avb_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.avb_close(self._h)
            self._h = None
