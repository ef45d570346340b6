"""Clip model: frame access over a decoder's virtual frames, the frame
index and `open_clip`.

Counterpart of `lives_tpu/io/clips.py:38-162,208-236,299-328` (reference
`src/cliphandler.h:428`, `docs/clip_format.txt`, `src/cvirtual.c`). A clip
directory holds `header.lives` (tagged text, header_version 104) and
`frame_index`, a little-endian int32 array: an entry >= 0 is a decoder
frame ("virtual"), -1 a numbered image.

Image frames (`put_frame`, `realize`, PIL), clip audio (`read_audio`,
`write_audio`, the audio rip of `open_clip`) and `Clip.load` are not
ported yet (ROADMAP Queue 1 item 11; no decoder of the port serves audio);
`get_frame` of an image frame raises.
"""

from __future__ import annotations

import enum
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from ..constants import Gamma
from ..layer import Layer
from .decoders import ClipData, try_decoders

HEADER_VERSION = 104


class ClipType(enum.IntEnum):
    """cliphandler.h:86-95."""
    DISK = 0          # all frames are images on disk
    FILE = 1          # has virtual frames served by a decoder
    GENERATOR = 2
    NULL_VIDEO = 3
    YUV4MPEG = 4
    LIVES2LIVES = 5
    VIDEODEV = 6


@dataclass
class Clip:
    """lives_clip_t successor."""
    handle: str
    clip_dir: Path
    clip_type: ClipType = ClipType.DISK
    frames: int = 0
    fps: float = 25.0
    pb_fps: float = 0.0
    width: int = 0
    height: int = 0
    bpp: int = 24
    unique_id: int = field(default_factory=lambda: random.getrandbits(63))
    name: str = ""
    achans: int = 0
    arate: int = 0
    asampsize: int = 16
    asigned: bool = True
    aendian: int = 0
    gamma: int = Gamma.SRGB
    img_type: str = "png"
    frame_index: Optional[np.ndarray] = None   # int32; None = all images
    cdata: Optional[ClipData] = None
    #: original media uri, so the decoder can be reattached
    source_uri: str = ""
    # content generation: bumped whenever frame n -> pixels changes
    version: int = 0

    def close(self):
        """Release the decoder's file (close_clip analogue)."""
        if self.cdata is not None and self.cdata.decoder is not None:
            try:
                self.cdata.decoder.close()
            except Exception:
                pass

    # -- frame access ------------------------------------------------------
    def is_virtual_frame(self, n: int) -> bool:
        """cvirtual.c:1717. n is 0-based here (reference is 1-based)."""
        return self.frame_index is not None and self.frame_index[n] >= 0

    def image_path(self, n: int) -> Path:
        return self.clip_dir / f"{n + 1:08d}.{self.img_type}"

    def _clamp(self, n: int) -> int:
        return max(0, min(n, self.frames - 1)) if self.frames else 0

    def frame_config(self, n: int):
        """(palette, width, height, clamping, subspace, gamma) of the
        Layer `get_frame(n)` returns, known without reading it; None for an
        image frame."""
        n = self._clamp(n)
        if not self.is_virtual_frame(n):
            return None
        cd = self.cdata
        return (int(cd.palette), cd.width, cd.height, int(cd.yuv_clamping),
                int(cd.yuv_subspace), int(cd.gamma))

    def get_frame(self, n: int, out=None) -> Layer:
        """pull_frame successor (frameloader.c:2686): the decoder's frame as
        a Layer of host planes, read into `out` when given (see
        `Decoder.get_frame`)."""
        n = self._clamp(n)
        if self.is_virtual_frame(n):
            return self.cdata.decoder.get_frame(int(self.frame_index[n]),
                                                out=out)
        raise NotImplementedError(
            "image frames (PIL) are not ported yet (ROADMAP Queue 1 "
            "item 11)")

    # -- frame_index ops (cvirtual.c) --------------------------------------
    def create_frame_index(self, all_virtual: bool = True):
        """cvirtual.c:133."""
        self.frame_index = (np.arange(self.frames, dtype=np.int32)
                            if all_virtual
                            else np.full(self.frames, -1, np.int32))

    def delete_frames(self, start: int, count: int):
        if self.frame_index is not None:
            self.frame_index = np.delete(self.frame_index,
                                         slice(start, start + count))
        self.frames -= count
        self.version += 1

    def insert_frames(self, at: int, entries: np.ndarray):
        if self.frame_index is None:
            self.create_frame_index(all_virtual=False)
        self.frame_index = np.insert(self.frame_index, at,
                                     entries.astype(np.int32))
        self.frames += len(entries)
        self.version += 1

    def reverse(self):
        """reverse_frame_index (cvirtual.c)."""
        if self.frame_index is not None:
            self.frame_index = self.frame_index[::-1].copy()
        self.version += 1

    # -- header ------------------------------------------------------------
    def save_header(self):
        t = []

        def tag(k, v):
            t.append(f"<{k}>\n{v}\n</{k}>")

        tag("header_version", HEADER_VERSION)
        tag("bpp", self.bpp)
        tag("frames", self.frames)
        tag("width", self.width)
        tag("height", self.height)
        tag("unique_id", self.unique_id)
        tag("fps", repr(self.fps))
        tag("pb_fps", repr(self.pb_fps))
        tag("audio_channels", self.achans)
        tag("audio_rate", self.arate)
        tag("audio_sample_size", self.asampsize)
        tag("audio_signed", "true" if self.asigned else "false")
        tag("audio_endian", self.aendian)
        tag("clipname", self.name)
        tag("img_type", self.img_type)
        tag("gamma_type", int(self.gamma))
        tag("clip_type", int(self.clip_type))
        if self.source_uri:
            tag("source_uri", self.source_uri)
        (self.clip_dir / "header.lives").write_text("\n".join(t) + "\n")
        if self.frame_index is not None:
            (self.clip_dir / "frame_index").write_bytes(
                self.frame_index.astype("<i4").tobytes())


_handle_counter = 0


def _new_handle() -> str:
    global _handle_counter
    _handle_counter += 1
    return f"clip{_handle_counter:05d}_{random.getrandbits(24):06x}"


def open_clip(uri: str, workdir: str | Path) -> Clip:
    """Open a media URI (clip_load_save.c:3570 open_file): a decoder claims
    it -> CLIP_TYPE_FILE with an all-virtual frame index; else raises."""
    workdir = Path(workdir)
    cd = try_decoders(uri)
    if cd is None:
        raise ValueError(f"no decoder claims {uri!r}")
    handle = _new_handle()
    clip_dir = workdir / handle
    clip_dir.mkdir(parents=True, exist_ok=True)
    c = Clip(handle=handle, clip_dir=clip_dir, clip_type=ClipType.FILE,
             frames=cd.nframes, fps=cd.fps, width=cd.width,
             height=cd.height, name=Path(uri).name, cdata=cd,
             source_uri=str(uri))
    c.create_frame_index(all_virtual=True)
    c.save_header()
    return c
