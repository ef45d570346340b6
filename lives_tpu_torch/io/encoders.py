"""Encoder plugins: the capability-query contract, the YUV4MPEG2, MJPEG
AVI, PNG-sequence, PDF and WAV encoders.

Counterpart of `lives_tpu/io/encoders.py:24-169,295-364` (`Encoder`,
`register_encoder`, `get_encoder`, `Y4MEncoder`, `PNGSeqEncoder`,
`PDFEncoder`, `WavEncoder`, `MJPEGDeviceEncoder`); the reference drives
encoder scripts over a stdout protocol (`get_capabilities` / `get_formats`
/ `encode`, LiVES src/plugins.c:1813). `Y4MEncoder` sets
`accepts_device_frames`, the flag the JAX base class defines
(`encoders.py:37-39`) and `transcode.render_to_encoder` honours: frames on
the card are converted there (K3, `ops/yuv_kernels.py`) and only their
YUV planes cross to the host; the file is written as frames arrive.
`render_to_encoder` hands such an encoder each rendered chunk whole, a
(B, C, H, W) item, which `Y4MEncoder` converts with one K3 launch and
brings to the host in one copy; a 3-D item is one frame, as in the JAX
package, and writes the same bytes. `MJPEGDeviceEncoder` ("mjpeg", the
default of `render_to_encoder`) also takes device frames: it encodes them
through the compressed lane (`io/jpeg_encode.py`) in batches of its fixed
`batch`, whatever the items' sizes, so a chunk writes the same bytes as
its frames one at a time.

The PNG and PDF encoders take host frames and code them through PIL,
with the array layout the JAX package hands PIL (so equal pixels give
equal files); `WavEncoder` writes s16le RIFF WAVE at `a * 32767`, as the
JAX package does (the clip store's `write_audio` scales by 32768). The
audio of the YUV4MPEG2 and MJPEG encoders goes through `WavEncoder` into
the file beside the video (`.wav` for the video's suffix).

Not ported (ROADMAP Queue 1 item 11): the ffmpeg encoder (an `ffmpeg`
binary) and the libav encoder (`io/av.py`); `get_encoder("ffmpeg")`
raises naming the item.
"""

from __future__ import annotations

import struct
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..constants import Palette
from ..layer import Layer

CAP_VIDEO = 1
CAP_AUDIO = 2

#: the JAX package's other encoders, and why the port lacks them
DEFERRED = {
    "ffmpeg": "ROADMAP Queue 1 item 11 (an ffmpeg binary)",
}


@dataclass
class EncFormat:
    name: str
    extension: str
    description: str = ""


class Encoder:
    name = "base"
    #: True when encode() takes frames that lie on the device: callers then
    #: skip the device -> host copy of raw RGB
    accepts_device_frames = False

    @classmethod
    def get_capabilities(cls) -> int:
        return CAP_VIDEO

    @classmethod
    def get_formats(cls) -> list[EncFormat]:
        return []

    def encode(self, out_path: str, frames: Iterable, fps: float,
               audio: np.ndarray | None = None, arate: int = 44100) -> bool:
        """frames: iterable of (3,H,W) or (H,W,3) uint8 RGB frames (numpy
        arrays, or torch tensors where `accepts_device_frames`; there also
        (B,3,H,W) or (B,H,W,3) chunks of B frames)."""
        raise NotImplementedError


_ENCODERS: dict[str, type[Encoder]] = {}


def register_encoder(cls):
    _ENCODERS[cls.name] = cls
    return cls


def get_encoder(name: str) -> Encoder:
    if name not in _ENCODERS and name in DEFERRED:
        raise NotImplementedError(f"encoder {name!r} is not ported yet "
                                  f"({DEFERRED[name]})")
    return _ENCODERS[name]()


def list_encoders() -> list[str]:
    return sorted(_ENCODERS)


def _chw(f: torch.Tensor) -> torch.Tensor:
    """A frame (C, H, W) or a chunk (B, C, H, W), channels first."""
    return f if f.shape[-3] in (3, 4) else f.movedim(-1, -3)


def _host_hwc(f) -> np.ndarray:
    """A host frame as the (H, W, 3) uint8 array the JAX package hands PIL
    (`np.moveaxis(_chw(f)[:3], 0, -1)`, `encoders.py:113,130`)."""
    f = f.cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
    chw = f if f.shape[0] in (3, 4) else np.moveaxis(f, -1, 0)
    return np.moveaxis(chw[:3], 0, -1)


def _write_audio_beside(out_path, fps, audio, arate):
    """The video's audio as a WAV file beside it (`encoders.py:91-93`)."""
    if audio is not None:
        WavEncoder().encode(str(Path(out_path).with_suffix(".wav")), [],
                            fps, audio, arate)


@register_encoder
class Y4MEncoder(Encoder):
    name = "yuv4mpeg"
    accepts_device_frames = True

    @classmethod
    def get_formats(cls):
        return [EncFormat("yuv4mpeg2", "y4m", "raw YUV420 stream")]

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        from ..ops.colorspace import convert_layer
        from .decoders import write_y4m

        def planar():
            for f in frames:
                if not isinstance(f, torch.Tensor):
                    f = torch.from_numpy(np.ascontiguousarray(f))
                rgb = _chw(f)[..., :3, :, :]
                lay = Layer(planes=(rgb,), palette=int(Palette.RGB24))
                yuv = convert_layer(lay, Palette.YUV420P).planes
                # one device -> host copy of the item's three planes
                host = torch.cat([p.reshape(-1) for p in yuv]).cpu().numpy()
                sizes = np.cumsum([p.numel() for p in yuv])[:2]
                y, u, v = (a.reshape(p.shape) for a, p in
                           zip(np.split(host, sizes), yuv))
                if rgb.ndim == 3:
                    yield y, u, v
                else:
                    yield from zip(y, u, v)
        write_y4m(out_path, planar(), fps)
        _write_audio_beside(out_path, fps, audio, arate)
        return True


@register_encoder
class PNGSeqEncoder(Encoder):
    """Numbered PNG images in a directory (`encoders.py:103-118`)."""

    name = "pngseq"

    @classmethod
    def get_formats(cls):
        return [EncFormat("png_sequence", "png", "numbered PNG images")]

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        from PIL import Image
        from .decoders import PIL_SECONDS
        d = Path(out_path)
        d.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            arr = _host_hwc(f)
            t0 = time.perf_counter()
            Image.fromarray(arr).save(d / f"{i + 1:08d}.png")
            PIL_SECONDS["encode"] += time.perf_counter() - t0
        return True


@register_encoder
class PDFEncoder(Encoder):
    """One page per frame (the reference pdf_encoder plugin,
    lives-plugins/plugins/encoders/pdf_encoder; `encoders.py:121-141`)."""

    name = "pdf"

    @classmethod
    def get_formats(cls):
        return [EncFormat("pdf", "pdf", "one page per frame")]

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        from PIL import Image
        from .decoders import PIL_SECONDS
        imgs = [Image.fromarray(_host_hwc(f)) for f in frames]
        if not imgs:
            return False
        t0 = time.perf_counter()
        imgs[0].save(out_path, format="PDF", save_all=True,
                     append_images=imgs[1:],
                     resolution=72.0)
        PIL_SECONDS["encode"] += time.perf_counter() - t0
        return True


@register_encoder
class WavEncoder(Encoder):
    """RIFF WAVE pcm s16le (`encoders.py:144-169`): `a * 32767`, clipped
    and truncated, as the JAX package writes it."""

    name = "wav"

    @classmethod
    def get_capabilities(cls):
        return CAP_AUDIO

    @classmethod
    def get_formats(cls):
        return [EncFormat("wav", "wav", "RIFF WAVE pcm s16le")]

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        if audio is None:
            return False
        a = np.atleast_2d(np.asarray(audio, np.float32))
        if a.shape[0] < a.shape[1]:
            a = a.T
        ch = a.shape[1]
        pcm = np.clip(a * 32767, -32768, 32767).astype("<i2").tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " \
            + struct.pack("<IHHIIHH", 16, 1, ch, arate, arate * ch * 2,
                          ch * 2, 16) + b"data" \
            + struct.pack("<I", len(pcm))
        Path(out_path).write_bytes(hdr + pcm)
        return True


@register_encoder
class MJPEGDeviceEncoder(Encoder):
    """MJPEG AVI export through the compressed lane (`io/jpeg_encode.py`):
    batches of frames are converted, transformed, quantised and packed on
    their device and cross as coefficients; the host runs the entropy
    encode and writes the AVI (`decoders.write_mjpeg_avi`). Frames that
    are tensors are encoded on their device, host (numpy) frames on
    `device`. Reference role: jpeg stream export (marcos-encoders
    family).

    `overflows` totals, over every `encode`, the frames the lane wrote
    with their ACs cut at its pool (`JpegDeviceEncoder.overflows`, a loss
    of quality, never corruption); a warning names the file the first
    time it is above 0."""

    name = "mjpeg"
    accepts_device_frames = True

    @classmethod
    def get_formats(cls):
        return [EncFormat("mjpeg_avi", "avi", "Motion-JPEG AVI")]

    def __init__(self, quality: int = 90, batch: int = 8, *,
                 device="cuda"):
        self.quality = quality
        self.batch = batch
        self.device = device
        self.overflows = 0

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        from .decoders import write_mjpeg_avi
        from .jpeg_encode import JpegDeviceEncoder
        enc = None
        datas: list[bytes] = []
        pending: list[torch.Tensor] = []   # (n, 3, H, W) pieces, in order

        def flush(final=False):
            nonlocal enc
            n = sum(int(p.shape[0]) for p in pending)
            while n >= self.batch or (final and n):
                batch = torch.cat(pending) if len(pending) > 1 \
                    else pending[0]
                take = min(n, self.batch)
                pending[:] = [batch[take:]] if take < n else []
                if enc is None:
                    h, w = batch.shape[-2:]
                    enc = JpegDeviceEncoder(w, h, quality=self.quality,
                                            batch=self.batch,
                                            device=batch.device)
                datas.extend(enc.encode_batch(batch[:take]))
                n -= take

        for f in frames:
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.ascontiguousarray(f)).to(self.device)
            f = _chw(f)[..., :3, :, :]
            pending.append(f if f.ndim == 4 else f[None])
            flush()
        flush(final=True)
        if not datas:
            return False
        if enc.overflows and not self.overflows:
            warnings.warn(f"MJPEGDeviceEncoder: {out_path}: {enc.overflows} "
                          "frames written with their ACs cut at the pool",
                          stacklevel=2)
        self.overflows += enc.overflows
        h, w = enc.meta.height, enc.meta.width
        write_mjpeg_avi(out_path, datas, w, h, fps)
        _write_audio_beside(out_path, fps, audio, arate)
        return True
