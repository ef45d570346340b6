"""Encoder plugins: the capability-query contract and the YUV4MPEG2
encoder.

Counterpart of `lives_tpu/io/encoders.py:24-99` (`Encoder`,
`register_encoder`, `get_encoder`, `Y4MEncoder`); the reference drives
encoder scripts over a stdout protocol (`get_capabilities` / `get_formats`
/ `encode`, LiVES src/plugins.c:1813). `Y4MEncoder` sets
`accepts_device_frames`, the flag the JAX base class defines
(`encoders.py:37-39`) and `transcode.render_to_encoder` honours: frames on
the card are converted there (K3, `ops/yuv_kernels.py`) and only their
YUV planes cross to the host; the file is written as frames arrive.
`render_to_encoder` hands such an encoder each rendered chunk whole, a
(B, C, H, W) item, which `Y4MEncoder` converts with one K3 launch and
brings to the host in one copy; a 3-D item is one frame, as in the JAX
package, and writes the same bytes.

Not ported yet (ROADMAP Queue 1 item 11): `WavEncoder` (so `Y4MEncoder`'s
`audio` raises), `PNGSeqEncoder`, the MJPEG encoder (Slice 5) and the
ffmpeg encoder. `get_encoder` names the item for each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from ..constants import Palette
from ..layer import Layer

CAP_VIDEO = 1

#: the JAX package's other encoders, and why the port lacks them
DEFERRED = {
    "pngseq": "ROADMAP Queue 1 item 11 (PNG images need PIL)",
    "wav": "ROADMAP Queue 1 item 11",
    "mjpeg": "ROADMAP Queue 1 item 19 (the compressed MJPEG lane)",
    "ffmpeg": "ROADMAP Queue 1 item 11",
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


def _chw(f: torch.Tensor) -> torch.Tensor:
    """A frame (C, H, W) or a chunk (B, C, H, W), channels first."""
    return f if f.shape[-3] in (3, 4) else f.movedim(-1, -3)


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
        if audio is not None:
            raise NotImplementedError(
                "audio beside a YUV4MPEG2 stream needs WavEncoder, which is "
                "not ported yet (ROADMAP Queue 1 item 11)")

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
        return True
