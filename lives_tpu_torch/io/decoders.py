"""Decoder services, host side: the decoder-plugin contract, the
image-sequence, YUV4MPEG2, WAV and AVI decoders, the YUV4MPEG2 fifo
reader and the writers.

Counterpart of `lives_tpu/io/decoders.py:41-461,462-661` (`ClipData`,
`Decoder` with `rip_audio` and `estimate_delay`, `register_decoder`,
`try_decoders`, `ImageSeqDecoder`, `Y4MDecoder`, `Y4MStreamSource`,
`write_y4m`, `WavDecoder`, `write_mjpeg_avi`, `AVIDecoder`); reference
decoder-plugin API, LiVES
`lives-plugins/plugins/decoders/decplugin.h`. A decoder claims a URI, returns
its clip data and serves frames by index as Layers of host (CPU) planes;
the device upload happens once a chunk (`events.renderer.ClipFrameSource`,
`io.clips.read_rgb_batch`). `get_frame(n, out=...)` reads a frame's
planes straight into caller-owned arrays, the rows of a chunk's stacked
planes, so a chunk is read with no further host copy.

`ImageSeqDecoder` opens a directory of numbered PNG/JPEG images in
numeric order through PIL; `WavDecoder` opens a RIFF WAVE file as an
audio-only clip and rips it to the clip store's s16le (float32 WAVs at
`* 32767`, as the JAX package). `Y4MStreamSource` reads a YUV4MPEG2
stream that cannot seek (a fifo, stdin): `get_frame` returns the next
frame, and the player captures it to a scrap clip while recording
(`scrap_on_record`).

`AVIDecoder` opens MJPEG and raw-DIB AVIs (the JAX package's own
compressed clip format, `write_mjpeg_avi`): `get_frame` decodes through
PIL on the host as RGB24; for MJPG, `get_frames_device(ns, device=...)`
is the compressed lane (`io/jpeg_ingest.py`: entropy decode on the host,
the rest on the device), which the player's precache takes.

Plain Python file IO. Not ported yet (ROADMAP Queue 1 item 11): the JAX
decoder's optional native prefetch cache (`enable_prefetch`, `:191-205`),
the libav bridge and the ffmpeg decoder, which need a native library and
an `ffmpeg` binary.
"""

from __future__ import annotations

import io
import mmap
import os
import re
import struct
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

    def rip_audio(self, path: str) -> bool:
        """Extract raw pcm audio to path; False if no audio."""
        return False

    def estimate_delay(self, from_frame: int, to_frame: int) -> float:
        """Seek+decode cost estimate in seconds (decplugin.h:305)."""
        cd = self.cdata
        if to_frame >= from_frame and to_frame - from_frame < cd.kframe_dist:
            return (to_frame - from_frame) * cd.const_time_per_frame
        back = to_frame % max(cd.kframe_dist, 1)
        return (back + 1) * cd.const_time_per_frame

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


# ---------------------------------------------------------------------------
# Image sequence decoder (the reference's CLIP_TYPE_DISK path)
# ---------------------------------------------------------------------------

@register_decoder
class ImageSeqDecoder(Decoder):
    """Directory of numbered images (00000001.png ...), in numeric order
    (`decoders.py:122-160`)."""

    name = "imageseq"

    def __init__(self, cdata: ClipData, files: list[Path]):
        self.cdata = cdata
        self.files = files

    @classmethod
    def get_clip_data(cls, uri: str):
        from PIL import Image
        p = Path(uri)
        if not p.is_dir():
            return None
        # numeric sort: unpadded sequences (1, 2, ..., 10) must not play
        # in lexicographic order
        files = sorted([f for f in p.iterdir()
                        if re.fullmatch(r"\d+\.(png|jpg|jpeg)", f.name)],
                       key=lambda f: int(f.stem))
        if not files:
            return None
        with Image.open(files[0]) as im:
            w, h = im.size
        cd = ClipData(uri=uri, nframes=len(files), width=w, height=h,
                      palette=int(Palette.RGB24), fps=25.0)
        cd.decoder = cls(cd, files)
        return cd

    def get_frame(self, n: int, out=None) -> Layer:
        """Frame n as a host RGB24 (or RGBA32, for an image with alpha)
        (C, H, W) plane; read into `out` (one writable (C, H, W) uint8
        array, its C channels kept) when given."""
        return image_layer(self.files[n], out,
                           lambda im: im.mode in ("RGBA", "LA", "PA"))


#: wall seconds the host spent in PIL coding frame images, summed over the
#: process: "decode" (`clips.read_rgb_batch`'s image runs), "encode"
#: (`clips.Clip.put_frames`, `PNGSink`, the PNG and PDF encoders)
PIL_SECONDS = {"decode": 0.0, "encode": 0.0}


def image_layer(path, out=None, has_alpha=None) -> Layer:
    """An image file through PIL as a Layer of one host (C, H, W) uint8
    plane: RGBA32 where `has_alpha(image)` (default: an "A" band), else
    RGB24. With `out` (one writable (C, H, W) array) the pixels land there,
    C channels of them."""
    from PIL import Image
    with Image.open(path) as im:
        has_a = has_alpha(im) if has_alpha else "A" in im.getbands()
        if out is not None:
            has_a = out[0].shape[0] == 4
        arr = np.asarray(im.convert("RGBA" if has_a else "RGB"))
    chans = np.moveaxis(arr, -1, 0)
    if out is None:
        out = (np.ascontiguousarray(chans),)
    else:
        out[0][...] = chans
    pal = Palette.RGBA32 if has_a else Palette.RGB24
    return Layer(planes=(torch.from_numpy(out[0]),), palette=int(pal),
                 gamma=int(Gamma.SRGB))



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


class Y4MStreamSource:
    """Sequential YUV4MPEG2 reader for inputs that cannot seek (named pipes,
    stdin): the reference's yuv4mpeg fifo ingest (src/lives-yuv4mpeg.c),
    `decoders.py:298-350`. Clip-like: `get_frame(n)` returns the NEXT
    frame of the stream as host planes, and holds the last frame once
    the stream ends."""

    def __init__(self, fh_or_path):
        self._fh = open(fh_or_path, "rb") if isinstance(fh_or_path,
                                                        (str, Path)) \
            else fh_or_path
        header = self._fh.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 stream")
        self.width = self.height = 0
        self.fps = 25.0
        for tok in header.split()[1:]:
            t = tok.decode()
            if t[0] == "W":
                self.width = int(t[1:])
            elif t[0] == "H":
                self.height = int(t[1:])
            elif t[0] == "F":
                num, den = t[1:].split(":")
                self.fps = int(num) / int(den)
        self.frames = 1 << 30
        self.unique_id = 0x59344D  # 'Y4M'
        self.scrap_on_record = True  # live feed: recordings scrap frames
        self._last = None

    def get_frame(self, n: int = 0) -> Layer:
        line = self._fh.readline()
        if not line.startswith(b"FRAME"):
            if self._last is not None:
                return self._last  # EOF: hold last frame
            raise EOFError("y4m stream ended")
        w, h = self.width, self.height
        buf = self._fh.read(w * h * 3 // 2)
        if len(buf) < w * h * 3 // 2:
            if self._last is not None:
                return self._last  # stream died mid-frame: hold
            raise EOFError("y4m stream ended mid-frame")
        a = np.frombuffer(buf, np.uint8)
        cs = (w // 2) * (h // 2)
        y = a[: w * h].reshape(h, w)
        u = a[w * h: w * h + cs].reshape(h // 2, w // 2)
        v = a[w * h + cs: w * h + 2 * cs].reshape(h // 2, w // 2)
        self._last = Layer(
            planes=tuple(torch.from_numpy(p.copy()) for p in (y, u, v)),
            palette=int(Palette.YUV420P))
        return self._last

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


@register_decoder
class WavDecoder(Decoder):
    """RIFF WAVE pcm: audio-only clips (the reference opens audio files as
    zero-video clips with audio), `decoders.py:370-456`."""

    name = "wav"

    def __init__(self, cdata, path, data_ofs, data_len, fmt=(1, 16)):
        self.cdata = cdata
        self.path = path
        self.data_ofs = data_ofs
        self.data_len = data_len
        self._fmt = fmt

    @classmethod
    def get_clip_data(cls, uri: str):
        p = Path(uri)
        if not (p.is_file() and p.suffix.lower() == ".wav"):
            return None
        with open(p, "rb") as fh:
            try:
                data = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            except (ValueError, OSError):
                return None
            try:
                return cls._probe_wav(uri, p, data)
            finally:
                data.close()

    @classmethod
    def _probe_wav(cls, uri, p, data):
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            return None
        pos = 12
        fmt = None
        data_ofs = data_len = 0
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            (sz,) = struct.unpack("<I", data[pos + 4:pos + 8])
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", data[pos + 8:pos + 24])
            elif cid == b"data":
                data_ofs, data_len = pos + 8, sz
            pos += 8 + sz + (sz & 1)
        if fmt is None or not data_len:
            return None
        tag, channels, rate, _, _, bits = fmt
        if tag not in (1, 3) or bits not in (8, 16, 24, 32):
            return None  # 1=PCM, 3=IEEE float; exotic formats -> libav
        cd = ClipData(uri=uri, nframes=0, fps=25.0, width=0, height=0,
                      arate=rate, achans=channels, asamps=16)
        cd.decoder = cls(cd, p, data_ofs, data_len, (tag, bits))
        return cd

    def get_frame(self, n: int, out=None) -> Layer:
        raise RuntimeError("wav clips have no video frames")

    def rip_audio(self, path: str) -> bool:
        """Clip audio is s16le by contract (`Clip.read_audio` parses
        '<i2'); 8/24/32-bit PCM and 32-bit float convert on the way."""
        with open(self.path, "rb") as fh:
            fh.seek(self.data_ofs)
            raw = fh.read(self.data_len)
        tag, bits = self._fmt
        if tag == 3 and bits == 32:  # IEEE float
            f = np.frombuffer(raw, "<f4")
            pcm = np.clip(f * 32767.0, -32768, 32767).astype("<i2")
        elif bits == 8:              # unsigned 8-bit
            pcm = ((np.frombuffer(raw, np.uint8).astype(np.int16) - 128)
                   << 8).astype("<i2")
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) - len(raw) % 3], np.uint8)
            b = b.reshape(-1, 3)
            v = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            pcm = (v >> 8).astype("<i2")
        elif bits == 32:             # 32-bit int PCM
            pcm = (np.frombuffer(raw, "<i4") >> 16).astype("<i2")
        else:                        # already s16le
            Path(path).write_bytes(raw)
            return True
        Path(path).write_bytes(pcm.tobytes())
        return True


# ---------------------------------------------------------------------------
# AVI: MJPEG + raw DIB, pure-python RIFF parse
# ---------------------------------------------------------------------------

def write_mjpeg_avi(path, jpeg_frames, width: int, height: int,
                    fps: float = 25.0):
    """Minimal MJPEG AVI writer (RIFF avih/strh/strf + movi 00dc chunks +
    idx1), byte for byte the JAX package's. Streams: `jpeg_frames` may be
    any iterable; the frame count and sizes are backpatched."""

    def chunk(cid, payload):
        pad = b"\0" if len(payload) & 1 else b""
        return cid + struct.pack("<I", len(payload)) + payload + pad

    rate = int(round(fps * 1000))

    def avih(n):
        return struct.pack("<IIIIIIIIIIIIII", int(1e6 / fps), 0, 0, 0x10,
                           n, 0, 1, 0, width, height, 0, 0, 0, 0)

    def strh(n):
        return (b"vids" + b"MJPG"
                + struct.pack("<IHHIIIIIIIII", 0, 0, 0, 0, 1000, rate,
                              0, n, 0, 0xFFFFFFFF, 0, 0))

    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)

    def hdrl(n):
        return chunk(b"LIST", b"hdrl" + chunk(b"avih", avih(n))
                     + chunk(b"LIST", b"strl" + chunk(b"strh", strh(n))
                             + chunk(b"strf", strf)))

    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 0))   # size backpatched
        fh.write(b"AVI " + hdrl(0))                # counts backpatched
        movi_start = fh.tell()
        fh.write(b"LIST" + struct.pack("<I", 0) + b"movi")
        idx = bytearray()
        off = 4
        n = 0
        for f in jpeg_frames:
            fh.write(chunk(b"00dc", f))
            idx += b"00dc" + struct.pack("<III", 0x10, off, len(f))
            off += 8 + len(f) + (len(f) & 1)
            n += 1
        movi_end = fh.tell()
        fh.write(chunk(b"idx1", bytes(idx)))
        total = fh.tell()
        fh.seek(movi_start + 4)
        fh.write(struct.pack("<I", movi_end - movi_start - 8))
        fh.seek(4)
        fh.write(struct.pack("<I", total - 8))
        fh.seek(12)
        fh.write(hdrl(n))


@register_decoder
class AVIDecoder(Decoder):
    """MJPEG and raw-DIB AVIs: frames as host RGB24 planes (PIL for MJPG),
    and for MJPG the compressed lane onto a device."""

    name = "avi"

    def __init__(self, cdata: ClipData, path: Path,
                 offsets: list[tuple[int, int]], fourcc: str,
                 topdown: bool = False):
        self.cdata = cdata
        self.path = path
        self.offsets = offsets
        self.fourcc = fourcc
        # negative biHeight = top-down DIB rows (no flip needed)
        self.topdown = topdown
        self._fh = open(path, "rb")
        self._lock = threading.Lock()
        self._jsrc: dict = {}    # device -> MJPEGClipSource

    @classmethod
    def get_clip_data(cls, uri: str):
        p = Path(uri)
        if not (p.is_file() and p.suffix.lower() == ".avi"):
            return None
        # mmap, not read_bytes: the probe touches only chunk headers
        with open(p, "rb") as fh:
            try:
                data = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            except (ValueError, OSError):
                return None
            try:
                if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
                    return None
                return cls._probe_avi(uri, p, data)
            finally:
                data.close()

    @classmethod
    def _probe_avi(cls, uri, p, data):
        i = data.find(b"strh")
        if i < 0 or data[i + 8: i + 12] != b"vids":
            return None
        fourcc = data[i + 12: i + 16].decode("latin1").strip("\0 ").upper()
        scale, rate = struct.unpack("<II", data[i + 28: i + 36])
        fps = rate / scale if scale else 25.0
        j = data.find(b"strf", i)
        w, h = struct.unpack("<ii", data[j + 12: j + 20])
        if fourcc not in ("MJPG", "DIB", ""):
            return None  # compressed codecs need ffmpeg
        # scan movi chunks
        m = data.find(b"movi")
        offsets = []
        pos = m + 4
        while pos + 8 <= len(data):
            cid = data[pos: pos + 4]
            (sz,) = struct.unpack("<I", data[pos + 4: pos + 8])
            if cid == b"LIST":
                # interleave groups ('rec ') wrap frame chunks: step INTO
                # the list (past its 4-byte type), not over it
                pos += 12
                continue
            if cid[2:4] in (b"db", b"dc"):
                offsets.append((pos + 8, sz))
            if cid == b"idx1" or sz == 0 and cid[:4] == b"\0\0\0\0":
                break
            pos += 8 + sz + (sz & 1)
        if not offsets:
            return None
        cd = ClipData(uri=uri, nframes=len(offsets), width=w, height=abs(h),
                      fps=fps, palette=int(Palette.RGB24))
        cd.decoder = cls(cd, p, offsets, fourcc, topdown=h < 0)
        return cd

    def get_frame_bytes(self, n: int) -> bytes:
        """Raw codec chunk (the JPEG bitstream for MJPG streams), what the
        compressed lane (`io/jpeg_ingest.py`) reads."""
        ofs, sz = self.offsets[n]
        with self._lock:
            self._fh.seek(ofs)
            return self._fh.read(sz)

    def _lane(self, device):
        if self.fourcc != "MJPG":
            raise RuntimeError("device decode is MJPG-only")
        from .jpeg_ingest import MJPEGClipSource
        dev = torch.device(device)
        if dev not in self._jsrc:
            self._jsrc[dev] = MJPEGClipSource(self, device=dev)
        return self._jsrc[dev]

    def get_frames_device(self, ns, device="cuda") -> list[Layer]:
        """Batched compressed-domain decode onto `device`: one host
        entropy-pack pass, one upload, one decode for the whole batch,
        split into per-frame Layers (views of the batch's planes). The
        player's precache worker takes this lane; `get_frame` keeps the
        host-decode contract (decplugin.h:280)."""
        from .jpeg_ingest import split_layer_batch
        return split_layer_batch(self._lane(device).get_batch(None,
                                                              list(ns)))

    def get_frame_device(self, n: int, device="cuda") -> Layer:
        """Frame n through the compressed lane onto `device`."""
        return self.get_frames_device([n], device)[0]

    @property
    def fallbacks(self) -> int:
        """Frames the lane decoded through the host twin (past the wire's
        capacity)."""
        return sum(s.fallbacks for s in self._jsrc.values())

    def get_frame(self, n: int, out=None) -> Layer:
        """Frame n as a host RGB24 (3, H, W) plane, read into `out` (one
        writable (3, H, W) uint8 array) when given."""
        raw = self.get_frame_bytes(n)
        w, h = self.cdata.width, self.cdata.height
        if self.fourcc == "MJPG":
            from PIL import Image
            with Image.open(io.BytesIO(raw)) as im:
                arr = np.asarray(im.convert("RGB"))
        else:  # raw DIB: bottom-up BGR rows, 4-byte aligned
            stride = (w * 3 + 3) & ~3
            arr = np.frombuffer(raw[: stride * h], np.uint8
                                ).reshape(h, stride)[:, : w * 3]
            arr = arr.reshape(h, w, 3)[:, :, ::-1]
            if not self.topdown:  # bottom-up rows (positive biHeight)
                arr = arr[::-1]
        if out is None:
            out = (np.empty((3, h, w), np.uint8),)
        out[0][...] = np.moveaxis(arr, -1, 0)
        return Layer(planes=(torch.from_numpy(out[0]),),
                     palette=int(Palette.RGB24), gamma=int(Gamma.SRGB))

    def close(self):
        self._fh.close()
