"""Clip model and the on-disk clip format: frame access over a decoder's
virtual frames and numbered images, the frame index, clip audio, the
header, and batched reads onto a device.

Counterpart of `lives_tpu/io/clips.py:38-353` (reference
`src/cliphandler.h:428`, `docs/clip_format.txt`, `src/cvirtual.c`,
`src/frameloader.c`). A clip directory holds:

  header.lives   tagged text header (<tag>value</tag>, header_version 104)
  00000001.png…  real frames (numbered images)
  frame_index    little-endian int32 array: an entry >= 0 is a decoder
                 frame ("virtual"), -1 a numbered image (cvirtual.c:245)
  audio          raw pcm (interleaved s16le)

A clip directory is the system's state, and both packages read and write
the same bytes: `header.lives`, `frame_index`, `audio` and the images
(PIL's PNG coder, fed the array layout the JAX package feeds it).

`get_frame` returns host planes (a decoder's, or an image's through PIL);
`read_rgb_batch` is the batched path of the clip editor (`rfx`,
`clipedit`, `transcode`): a run of virtual frames is read into one
stacked host array a plane (pinned on a CUDA device), uploaded once a
plane and converted once on the device (K2 for a YUV4MPEG clip on the
card, `ops/yuv_kernels.py`); a run of image frames is decoded by PIL on
a pool of threads and uploaded once. `put_frame` converts on the layer's
device and writes the image on the host through a temporary file and
`os.replace`, never truncating an image in place: undo snapshots
hardlink image inodes (`clipedit.snapshot_edit_undo`); `put_frames`
writes a batch of host frames so, coding the images on a pool of threads
(PIL releases the GIL while it compresses; the files are the same). The
seconds PIL spends coding images are summed in `decoders.PIL_SECONDS`.
"""

from __future__ import annotations

import enum
import hashlib
import os
import random
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import Gamma, Palette
from ..layer import Layer, _plane_shapes
from .decoders import PIL_SECONDS, ClipData, image_layer, try_decoders

HEADER_VERSION = 104
#: frames a batch where the JAX function works frame by frame and takes
#: no batch size (`realize`, `clipedit.copy_frames`, the RFX runners)
BATCH = 32


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
    #: original media uri, persisted so reload can reattach the decoder
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
        """pull_frame successor (frameloader.c:2686): the decoder's frame or
        the image file, as a Layer of host planes, read into `out` when
        given (see `Decoder.get_frame`)."""
        n = self._clamp(n)
        if self.is_virtual_frame(n):
            return self.cdata.decoder.get_frame(int(self.frame_index[n]),
                                                out=out)
        return image_layer(self.image_path(n), out).replace(
            gamma=int(self.gamma))

    def put_frame(self, n: int, layer: Layer):
        """Write a frame image (layer_to_png successor, frameloader.c:1985):
        converted to RGB24 on the layer's device, written on the host to a
        temporary file that `os.replace` moves over the old image (a crash
        mid-write must not corrupt the frame, and undo snapshots hardlink
        image inodes)."""
        from ..ops.colorspace import convert_layer
        rgb = convert_layer(layer, Palette.RGB24)
        self.put_frames([n], [rgb.planes[0].cpu().numpy()])

    def put_frames(self, ns, frames) -> None:
        """Write host (3, H, W) uint8 RGB24 frames as the images of frames
        `ns`, each as `put_frame` writes it. PIL's coder releases the GIL
        while it compresses, so the images are coded on a pool of threads;
        the index and version change as a `put_frame` a frame does."""
        ns = [int(n) for n in ns]
        fmt = {"jpg": "JPEG", "jpeg": "JPEG"}.get(self.img_type.lower(),
                                                  self.img_type.upper())

        def write(job):
            from PIL import Image
            n, f = job
            arr = np.ascontiguousarray(np.moveaxis(np.asarray(f), 0, -1))
            dst = self.image_path(n)
            tmp = dst.with_suffix(dst.suffix + ".tmp")
            Image.fromarray(arr).save(tmp, format=fmt)
            os.replace(tmp, dst)

        t0 = time.perf_counter()
        _pool_map(write, list(zip(ns, frames)))
        PIL_SECONDS["encode"] += time.perf_counter() - t0
        for n in ns:
            if self.frame_index is not None:
                self.frame_index[n] = -1
            self.version += 1

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

    def realize(self, start: int = 0, end: int | None = None,
                progress=None, *, device="cuda"):
        """virtual_to_images (cvirtual.c:1127): materialise decoder frames
        to numbered images, converted on `device` a batch at a time."""
        end = self.frames if end is None else end
        virt = [n for n in range(start, end) if self.is_virtual_frame(n)]
        for ofs in range(0, len(virt), BATCH):
            ns = virt[ofs: ofs + BATCH]
            self.put_frames(ns, read_rgb_batch(self, ns, device).cpu()
                            .numpy())
            if progress:
                for n in ns:
                    progress(n, end)

    # -- audio -------------------------------------------------------------
    @property
    def audio_path(self) -> Path:
        return self.clip_dir / "audio"

    def read_audio(self) -> np.ndarray:
        """(n, channels) float32 in [-1,1] from the raw pcm file."""
        if not self.audio_path.exists() or self.achans == 0:
            return np.zeros((0, max(self.achans, 1)), np.float32)
        raw = self.audio_path.read_bytes()
        if self.asampsize == 16:
            dt = "<i2" if self.aendian == 0 else ">i2"
            a = np.frombuffer(raw, dt).astype(np.float32) / 32768.0
        else:
            a = (np.frombuffer(raw, np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        n = len(a) // self.achans
        return a[: n * self.achans].reshape(n, self.achans)

    def write_audio(self, data: np.ndarray, arate: int | None = None):
        data = np.atleast_2d(np.asarray(data, np.float32))
        if data.shape[0] < data.shape[1]:
            data = data.T
        self.achans = data.shape[1]
        if arate:
            self.arate = arate
        # symmetric with read_audio's /32768 so read->edit->write round
        # trips are sample-exact; +1.0 clamps to 32767
        i16 = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
        self.audio_path.write_bytes(i16.tobytes())
        self.asampsize, self.aendian, self.asigned = 16, 0, True

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

    @classmethod
    def load(cls, clip_dir: str | Path) -> "Clip":
        clip_dir = Path(clip_dir)
        text = (clip_dir / "header.lives").read_text()

        def get(k, default=None, conv=str):
            m = re.search(rf"<{k}>\s*\n?(.*?)\n?\s*</{k}>", text, re.S)
            return conv(m.group(1).strip()) if m else default

        c = cls(handle=clip_dir.name, clip_dir=clip_dir)
        c.bpp = get("bpp", 24, int)
        c.frames = get("frames", 0, int)
        c.width = get("width", 0, int)
        c.height = get("height", 0, int)
        c.unique_id = get("unique_id", 0, int)
        c.fps = get("fps", 25.0, float)
        c.pb_fps = get("pb_fps", 0.0, float)
        c.achans = get("audio_channels", 0, int)
        c.arate = get("audio_rate", 0, int)
        c.asampsize = get("audio_sample_size", 16, int)
        c.asigned = get("audio_signed", "true") == "true"
        c.aendian = get("audio_endian", 0, int)
        c.name = get("clipname", "")
        c.img_type = get("img_type", "png")
        c.gamma = get("gamma_type", int(Gamma.SRGB), int)
        c.clip_type = ClipType(get("clip_type", 0, int))
        c.source_uri = get("source_uri", "")
        fi = clip_dir / "frame_index"
        if fi.exists():
            c.frame_index = np.frombuffer(fi.read_bytes(), "<i4").copy()
        if c.source_uri and c.frame_index is not None \
                and (c.frame_index >= 0).any():
            # virtual frames need their decoder back (reload_clip role,
            # clip_load_save.c:2208); a vanished source leaves cdata
            # None and check_integrity rejects the clip
            try:
                c.cdata = try_decoders(c.source_uri)
            except Exception:
                c.cdata = None
        return c

    def check_integrity(self) -> bool:
        """check_clip_integrity (cvirtual.c:532): frame_index entries in
        range, images present for -1 entries."""
        if self.frame_index is not None:
            if len(self.frame_index) != self.frames:
                return False
            if self.cdata is None and (self.frame_index >= 0).any():
                return False   # virtual frames but no decoder to serve them
            if self.cdata and (self.frame_index >= self.cdata.nframes).any():
                return False
            for n in np.nonzero(self.frame_index < 0)[0][:64]:
                if not self.image_path(int(n)).exists():
                    return False
        return True


def _pool_map(fn, items: list) -> list:
    """[fn(x) for x in items] on a pool of threads (image coding, which
    PIL runs with the GIL released), in order; one item runs inline."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def rgb_layer(arr) -> Layer:
    """A (3, H, W) uint8 RGB24 frame (numpy array or tensor) as a Layer."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    return Layer(planes=(t,), palette=int(Palette.RGB24))


def _staging(shape, device: torch.device) -> torch.Tensor:
    """A host array to read frames into: pinned for a CUDA device, so its
    upload is one DMA (`player.UploadRing`'s role; PyTorch's host
    allocator keeps a pinned block until the copies reading it are
    done)."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True) if device.type == "cuda" \
        else t.to(device)


def read_rgb_batch(clip, ns: Sequence[int], device) -> torch.Tensor:
    """Frames `ns` of a clip as one (B, 3, H, W) uint8 RGB24 tensor on
    `device` (the JAX package's `convert_layer(clip.get_frame(n), RGB24)`
    per frame, stacked).

    A run of virtual frames that share a configuration is read into one
    stacked host array a plane, uploaded once a plane and converted once
    (one K2 launch for a YUV4MPEG clip on a CUDA device). A run of image
    frames is read through PIL and uploaded once. Any other frame (a
    clip-like without `frame_config`, a mixed run) is uploaded and
    converted on its own."""
    from ..ops.colorspace import convert_layer
    from ..utils.device import resolve_device
    dev = resolve_device(device, "read_rgb_batch")
    ns = [int(n) for n in ns]
    cfg_of = getattr(clip, "frame_config", None)
    runs: list[tuple[object, list[int]]] = []
    for n in ns:
        kind = cfg_of(n) if cfg_of is not None else ("frame",)
        if kind is None:
            kind = ("image",)
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(n)
        else:
            runs.append((kind, [n]))
    parts = []
    for kind, run in runs:
        if kind == ("image",):
            t0 = time.perf_counter()
            lays = _pool_map(clip.get_frame, run)
            PIL_SECONDS["decode"] += time.perf_counter() - t0
            if all(l.palette == Palette.RGB24 for l in lays) and \
                    len({tuple(l.planes[0].shape) for l in lays}) == 1:
                host = _staging((len(run),) + tuple(lays[0].planes[0].shape),
                                dev)
                for j, l in enumerate(lays):
                    host[j].copy_(l.planes[0])
                parts.append(_upload(host, dev))
                continue
            parts.append(torch.stack([
                convert_layer(l.replace(planes=tuple(
                    _upload(p, dev) for p in l.planes)),
                    Palette.RGB24).planes[0] for l in lays]))
        elif kind == ("frame",):
            frames = []
            for n in run:
                lay = clip.get_frame(n)
                lay = lay.replace(planes=tuple(p.to(dev) for p in lay.planes))
                frames.append(convert_layer(lay, Palette.RGB24).planes[0])
            parts.append(torch.stack(frames))
        else:
            pal, w, h, clamping, subspace, gamma = kind
            host = [_staging((len(run),) + s, dev)
                    for s in _plane_shapes(pal, w, h)]
            views = [p.numpy() for p in host]
            for j, n in enumerate(run):
                clip.get_frame(n, out=tuple(v[j] for v in views))
            lay = Layer(planes=tuple(_upload(p, dev) for p in host),
                        palette=pal, clamping=clamping, subspace=subspace,
                        gamma=gamma)
            parts.append(convert_layer(lay, Palette.RGB24).planes[0])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# ---------------------------------------------------------------------------
# Opening / creating clips (clip_load_save.c:3570 open_file)
# ---------------------------------------------------------------------------

_handle_counter = 0


def _new_handle() -> str:
    global _handle_counter
    _handle_counter += 1
    return f"clip{_handle_counter:05d}_{random.getrandbits(24):06x}"


def open_clip(uri: str, workdir: str | Path) -> Clip:
    """Open a media URI (clip_load_save.c:3570 open_file): a decoder claims
    it -> CLIP_TYPE_FILE with an all-virtual frame index, its audio ripped
    into the clip directory; else raises."""
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
    if cd.decoder and cd.achans:
        if cd.decoder.rip_audio(str(c.audio_path)):
            c.achans, c.arate = cd.achans, cd.arate
    c.save_header()
    return c


def create_clip(workdir: str | Path, width: int, height: int,
                fps: float = 25.0, name: str = "") -> Clip:
    """New empty (to-be-rendered-into) clip."""
    workdir = Path(workdir)
    handle = _new_handle()
    clip_dir = workdir / handle
    clip_dir.mkdir(parents=True, exist_ok=True)
    c = Clip(handle=handle, clip_dir=clip_dir, clip_type=ClipType.DISK,
             width=width, height=height, fps=fps, name=name)
    c.save_header()
    return c


def md5_frame(clip: Clip, n: int) -> str:
    """Frame identity hash (reference md5_frame, frameloader.c:2189):
    virtual frames hash (decoder uri, decoder frame); image frames hash
    the file bytes."""
    if clip.is_virtual_frame(n):
        key = f"{clip.cdata.uri}#{int(clip.frame_index[n])}".encode()
        return hashlib.md5(key).hexdigest()
    p = clip.image_path(n)
    return hashlib.md5(p.read_bytes()).hexdigest()
