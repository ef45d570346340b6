"""Decoder services, host side: the decoder-plugin contract and the
YUV4MPEG2 decoder and writer.

Counterpart of `lives_tpu/io/decoders.py:41-114,166-295,353-367`
(`ClipData`, `Decoder`, `register_decoder`, `try_decoders`, `Y4MDecoder`,
`write_y4m`); reference decoder-plugin API, LiVES
`lives-plugins/plugins/decoders/decplugin.h`. A decoder claims a URI, returns
its clip data and serves frames by index as Layers of host (CPU) planes;
the device upload happens once a chunk, in `events.renderer.
ClipFrameSource`. `get_frame(n, out=...)` reads a frame's planes straight
into caller-owned arrays, the rows of a chunk's stacked planes, so a chunk
is read with no further host copy.

Plain Python file IO. Not ported yet (ROADMAP Queue 1 item 11): the JAX
decoder's optional native prefetch cache (`enable_prefetch`, `:191-205`),
`Y4MStreamSource`, the image-sequence, WAV, AVI and ffmpeg decoders, and
the contract's `rip_audio` and `estimate_delay` (`:80-90`), which only
audio and the player's prefetcher call.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from ..constants import Gamma, Palette, YUVClamping, YUVSampling, YUVSubspace
from ..layer import Layer


@dataclass
class ClipData:
    """lives_clip_data_t analogue (decplugin.h:~180-267)."""
    uri: str
    nframes: int = 0
    fps: float = 25.0
    width: int = 0
    height: int = 0
    palette: int = Palette.RGB24
    yuv_clamping: int = YUVClamping.CLAMPED
    yuv_sampling: int = YUVSampling.DEFAULT
    yuv_subspace: int = YUVSubspace.YCBCR
    gamma: int = Gamma.SRGB
    par: float = 1.0            # pixel aspect ratio
    arate: int = 0
    achans: int = 0
    asamps: int = 16
    asigned: bool = True
    interlace: int = 0
    # seek model (adv_timing_t analogue, decplugin.h:70-88)
    kframe_dist: int = 1        # keyframe spacing; 1 = all intra
    const_time_per_frame: float = 0.001

    decoder: "Decoder | None" = None


class Decoder:
    """Base decoder. Subclasses claim URIs and serve frames."""

    name = "base"

    @classmethod
    def get_clip_data(cls, uri: str) -> Optional[ClipData]:
        """Return ClipData if this decoder can handle uri, else None."""
        return None

    def get_frame(self, n: int, out=None) -> Layer:
        """Frame n as a Layer of host planes; `out`, when given, holds one
        writable uint8 array a plane to read them into."""
        raise NotImplementedError

    def close(self):
        pass


_DECODERS: list[type[Decoder]] = []


def register_decoder(cls: type[Decoder]) -> type[Decoder]:
    _DECODERS.append(cls)
    return cls


def try_decoders(uri: str) -> Optional[ClipData]:
    """Probe decoders in order (reference try_decoder_plugins,
    src/plugins.c:2647)."""
    for cls in _DECODERS:
        try:
            cd = cls.get_clip_data(uri)
        except Exception:
            cd = None
        if cd is not None:
            return cd
    return None


@register_decoder
class Y4MDecoder(Decoder):
    """YUV4MPEG2 files of 4:2:0 frames (reference src/lives-yuv4mpeg.c
    ingest path)."""

    name = "yuv4mpeg"

    def __init__(self, cdata: ClipData, path: Path, data_start: int,
                 frame_size: int, header_skip: int, offsets=None):
        self.cdata = cdata
        self.path = path
        self.data_start = data_start
        self.frame_size = frame_size
        self.header_skip = header_skip
        #: per-frame payload offsets when FRAME headers vary in length
        #: (YUV4MPEG2 allows per-frame parameters, e.g. ``FRAME Ix\n``);
        #: None = constant stride
        self.offsets = offsets
        self._fh = open(path, "rb")
        self._lock = threading.Lock()

    @classmethod
    def get_clip_data(cls, uri: str):
        p = Path(uri)
        if not (p.is_file() and p.suffix.lower() in (".y4m", ".yuv4mpeg")):
            return None
        with open(p, "rb") as fh:
            header = fh.readline()
            if not header.startswith(b"YUV4MPEG2"):
                return None
            w = h = 0
            fps = 25.0
            for tok in header.split()[1:]:
                t = tok.decode()
                if t[0] == "W":
                    w = int(t[1:])
                elif t[0] == "H":
                    h = int(t[1:])
                elif t[0] == "F":
                    num, den = t[1:].split(":")
                    fps = int(num) / int(den)
                elif t[0] == "C" and not t[1:].startswith("420"):
                    return None  # only 420 for now
            data_start = fh.tell()
            frame_size = w * h * 3 // 2
            # scan every FRAME header: header length may vary, and then an
            # explicit per-frame offset index is kept
            file_size = os.fstat(fh.fileno()).st_size
            offsets = []
            header_skip = None
            constant = True
            while True:
                frame_hdr = fh.readline()
                if not frame_hdr:
                    break
                if not frame_hdr.startswith(b"FRAME"):
                    return None
                if header_skip is None:
                    header_skip = len(frame_hdr)
                elif len(frame_hdr) != header_skip:
                    constant = False
                pos = fh.tell()
                # a truncated last frame is excluded
                if pos + frame_size > file_size:
                    break
                offsets.append(pos)
                fh.seek(pos + frame_size)
            if header_skip is None:
                return None
        cd = ClipData(uri=uri, nframes=len(offsets), width=w, height=h,
                      fps=fps, palette=int(Palette.YUV420P),
                      yuv_clamping=int(YUVClamping.CLAMPED))
        cd.decoder = cls(cd, p, data_start, frame_size, header_skip,
                         offsets=None if constant else offsets)
        return cd

    def _offset(self, n: int) -> int:
        if self.offsets is not None:
            return self.offsets[n]
        return (self.data_start + n * (self.frame_size + self.header_skip)
                + self.header_skip)

    def get_frame(self, n: int, out=None) -> Layer:
        """Frame n: host Y, U, V planes, read into `out` (three writable
        contiguous uint8 arrays of (H, W), (H/2, W/2), (H/2, W/2)) when
        given."""
        w, h = self.cdata.width, self.cdata.height
        if out is None:
            out = (np.empty((h, w), np.uint8),
                   np.empty((h // 2, w // 2), np.uint8),
                   np.empty((h // 2, w // 2), np.uint8))
        with self._lock:
            self._fh.seek(self._offset(n))
            for p in out:
                if self._fh.readinto(memoryview(p).cast("B")) != p.size:
                    raise EOFError(f"{self.path}: frame {n} is truncated")
        return Layer(planes=tuple(torch.from_numpy(p) for p in out),
                     palette=int(Palette.YUV420P),
                     clamping=self.cdata.yuv_clamping,
                     subspace=self.cdata.yuv_subspace)

    def close(self):
        self._fh.close()


def write_y4m(path: str, frames_yuv420: Iterable, fps: float = 25.0):
    """Write (Y,U,V) planar uint8 frame tuples (host arrays) as YUV4MPEG2,
    4:2:0 JPEG siting; any iterable, written as it is consumed."""
    num, den = int(round(fps * 1001)), 1001
    if abs(fps - round(fps)) < 1e-6:
        num, den = int(round(fps)), 1
    with open(path, "wb") as fh:
        for i, (y, u, v) in enumerate(frames_yuv420):
            if i == 0:
                h, w = np.asarray(y).shape
                fh.write(f"YUV4MPEG2 W{w} H{h} F{num}:{den} Ip A1:1 "
                         "C420jpeg\n".encode())
            fh.write(b"FRAME\n")
            for p in (y, u, v):
                fh.write(np.ascontiguousarray(p, np.uint8).tobytes())
