"""Scrap files: raw and MJPEG captures of live-source output during a
performance (reference `src/frameloader.c:1212,1313` scrap write/read), so
a re-render does not need to re-run the live sources.

Counterpart of `lives_tpu/io/scrap.py:1-322` (`ScrapWriter`,
`ScrapReader`, `MJPEGScrapRecorder`, `ScrapSink`, `scan_scrap_clips`).
The raw format is a header JSON line, then per frame a fixed-size record
of planar payload (layout from palette + geometry), byte for byte the JAX
package's; `ScrapReader` serves host planes, like a decoder.

`MJPEGScrapRecorder` is what the player's recording uses: `put` queues
the live source's device layer (never converting or copying on the
serving thread) with an event recorded on the serving stream, and a
worker thread drains the queue in fixed batches of 8 on a side stream of
its own, which waits on each layer's event: convert to RGB24 (K2 for a
YUV420P feed on the card), then the device JPEG lane
(`io/jpeg_encode.JpegDeviceEncoder`: transform, quantise and pack on the
device; only coefficients cross to the host), batch k+1 dispatched
before batch k is collected. The JPEGs spill to a temporary file as they
land; `finalize` writes an MJPEG AVI that re-renders read back through
the AVI decoder. A full queue stops the capture (`overflowed`) rather
than stall the serving loop, and the recording falls back to the live
source's reference from there.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..constants import Palette
from ..layer import Layer, layer_from_bytes, layer_to_bytes


def _frame_size(palette: int, w: int, h: int) -> int:
    pal = Palette(palette)
    if pal == Palette.RGB24:
        return w * h * 3
    if pal in (Palette.RGBA32, Palette.BGRA32, Palette.ARGB32):
        return w * h * 4
    if pal == Palette.YUV420P:
        # floor-divided chroma planes, matching layer_to_bytes for odd
        # geometry (853x480 is NOT w*h*3//2)
        return w * h + 2 * ((h // 2) * (w // 2))
    if pal == Palette.YUV422P:
        return w * h + 2 * (h * (w // 2))
    if pal in (Palette.YUV444P,):
        return w * h * 3
    raise ValueError(f"scrap: unsupported palette {pal}")


class ScrapWriter:
    def __init__(self, path: str | Path, width: int, height: int,
                 palette: int = Palette.RGB24, fps: float = 25.0):
        self.path = Path(path)
        self.width, self.height = width, height
        self.palette = int(palette)
        self.frame_size = _frame_size(palette, width, height)
        self._fh = open(self.path, "wb")
        hdr = json.dumps({"magic": "lives_tpu_scrap", "version": 1,
                          "width": width, "height": height,
                          "palette": self.palette, "fps": fps,
                          "frame_size": self.frame_size})
        self._fh.write(hdr.encode() + b"\n")
        self.data_start = self._fh.tell()
        self.nframes = 0

    def write(self, layer: Layer):
        data = layer_to_bytes(layer)
        if len(data) != self.frame_size:
            raise ValueError("scrap: geometry/palette mismatch")
        self._fh.write(data)
        self.nframes += 1

    def close(self):
        self._fh.close()


class ScrapReader:
    """Clip-like reader over a scrap file (usable as a Player source):
    frames as host planes."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        hdr = json.loads(self._fh.readline())
        if hdr.get("magic") != "lives_tpu_scrap":
            raise ValueError("not a scrap file")
        self.width = hdr["width"]
        self.height = hdr["height"]
        self.palette = hdr["palette"]
        self.fps = hdr["fps"]
        self.frame_size = hdr["frame_size"]
        if self.frame_size <= 0 or self.width <= 0 or self.height <= 0:
            raise ValueError("corrupt scrap header")
        self.data_start = self._fh.tell()
        self._fh.seek(0, os.SEEK_END)
        self.frames = (self._fh.tell() - self.data_start) // self.frame_size
        from ..utils.uid import stable_uid
        self.unique_id = stable_uid("scrapfile", str(path))

    def get_frame(self, n: int) -> Layer:
        if self.frames == 0:
            raise EOFError("empty scrap file")
        n = max(0, min(n, self.frames - 1))
        self._fh.seek(self.data_start + n * self.frame_size)
        buf = self._fh.read(self.frame_size)
        return layer_from_bytes(buf, self.width, self.height, self.palette,
                                device="cpu")

    def close(self):
        self._fh.close()


class MJPEGScrapRecorder:
    """Asynchronous capture of live-source output during a recording (the
    reference's save_to_scrap_file, frameloader.c:1212): device layers
    queue, a worker encodes them in fixed batches through the device JPEG
    lane, `finalize()` writes an MJPEG AVI and opens it as a clip.

    `put()` returns the scrap frame index, or None once the bounded queue
    has overflowed (the recorder then stops accepting and the caller
    records the live source's reference itself)."""

    BATCH = 8

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 quality: int = 85, max_queue: int = 128, *,
                 device="cuda"):
        from ..utils.device import resolve_device
        self.device = resolve_device(device, "MJPEGScrapRecorder")
        self.width, self.height, self.fps = width, height, fps
        self.quality = quality
        # random (not hash-seeded) so the id is unique across processes:
        # the finalized filename encodes the FULL uid, which lets crash
        # recovery rebuild the uid->clip map from the scrap directory
        self.unique_id = (int.from_bytes(os.urandom(8), "little")
                          & ((1 << 63) - 1))
        self.max_queue = max_queue
        self.overflowed = False
        self.frames = 0
        # encoded JPEGs spill to disk as they land
        self._spill = tempfile.TemporaryFile(prefix="lives_tpu_scrap_")
        self._sizes: list[int] = []
        #: per-index (clip_uid, frame) live-source references, appended by
        #: the recording player; used to rewrite events if encoding fails
        self.origs: list[tuple] = []
        self._q: list = []
        self._cv = threading.Condition()
        self._stop = False
        self._err = None
        #: set once the worker's first batch has landed
        self._compiled = False
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="scrap-encode")
        self._worker.start()

    def put(self, layer: Layer):
        """Queue one device layer (no conversion, no copy on the caller's
        thread)."""
        if self.overflowed:
            return None
        ev = None
        if self._stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        with self._cv:
            if len(self._q) >= self.max_queue:
                # never stall the serving loop and never leave index
                # gaps: stop scrapping, the recording falls back to the
                # live source reference from here on
                self.overflowed = True
                return None
            self._q.append((layer, ev))
            idx = self.frames
            self.frames += 1
            self._cv.notify()
        return idx

    def _run(self):
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                self._loop()
        else:
            self._loop()

    def _loop(self):
        from .jpeg_encode import JpegDeviceEncoder
        enc = None
        pending = None      # (device buf, n_frames) already dispatched
        while True:
            with self._cv:
                while not self._q and not self._stop \
                        and pending is None:
                    self._cv.wait(0.2)
                stopping = not self._q and self._stop
                batch = self._q[:self.BATCH]
                del self._q[:self.BATCH]
            try:
                # dispatch batch k+1's device work BEFORE fetching batch
                # k: the device computes while k's coefficients cross
                dispatched = None
                if batch:
                    if enc is None:
                        enc = JpegDeviceEncoder(self.width, self.height,
                                                quality=self.quality,
                                                batch=self.BATCH,
                                                device=self.device)
                    dispatched = (enc.dispatch_batch(
                        [self._rgb_plane(lay, ev) for lay, ev in batch]),
                        len(batch))
                if pending is not None:
                    for d in enc.collect_batch(*pending):
                        self._spill.write(d)
                        self._sizes.append(len(d))
                    self._compiled = True
                pending = dispatched
                if stopping and pending is None:
                    return
            except Exception as e:  # noqa: BLE001
                self._err = e
                with self._cv:
                    self.overflowed = True
                    self._q.clear()
                return

    def _rgb_plane(self, lay: Layer, ev) -> torch.Tensor:
        """The layer's RGB24 plane on the recorder's device, read on the
        worker's stream once the serving stream has produced it."""
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            for p in lay.planes:
                if p.device.type == "cuda":
                    p.record_stream(stream)
        lay = lay.replace(planes=tuple(p.to(self.device)
                                       for p in lay.planes))
        if int(lay.palette) != int(Palette.RGB24):
            from ..ops.colorspace import convert_layer
            lay = convert_layer(lay, Palette.RGB24)
        return lay.planes[0]

    def finalize(self, path: str | Path):
        """Drain, write the MJPEG AVI, and return a clip over it (or
        None when nothing was captured / the encoder failed)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # bounded but progress-aware: a worker wedged in a device call
        # must not hang the stop forever; the first batch (the kernels'
        # first launch in the process) gets a long budget
        t_last = time.monotonic()
        progress = len(self._sizes)
        while self._worker.is_alive():
            self._worker.join(timeout=5)
            if len(self._sizes) != progress:
                progress = len(self._sizes)
                t_last = time.monotonic()
            budget = 600.0 if not self._compiled else 120.0
            if time.monotonic() - t_last > budget:
                break
        if self._worker.is_alive() or not self._sizes:
            return None
        from .clips import open_clip
        from .decoders import write_mjpeg_avi
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)

        def jpegs():
            self._spill.seek(0)
            for size in self._sizes:
                yield self._spill.read(size)

        write_mjpeg_avi(str(path), jpegs(), self.width, self.height,
                        self.fps)
        self._spill.close()
        clip = open_clip(str(path), tempfile.mkdtemp(prefix="scrap_"))
        clip.unique_id = self.unique_id
        return clip


class ScrapSink:
    """Player sink that tees frames into a scrap file."""

    palette_list = (Palette.RGB24,)

    def __init__(self, path: str | Path, inner=None):
        self.path = path
        self.inner = inner
        self._writer = None

    def init_screen(self, width: int, height: int, fps: float):
        self._writer = ScrapWriter(self.path, width, height,
                                   Palette.RGB24, fps)
        if self.inner:
            self.inner.init_screen(width, height, fps)

    def play_frame(self, layer: Layer, tc: float) -> bool:
        from ..ops.colorspace import convert_layer
        if self._writer is None:
            self._writer = ScrapWriter(self.path, layer.width, layer.height,
                                       Palette.RGB24)
        self._writer.write(convert_layer(layer, Palette.RGB24))
        return self.inner.play_frame(layer, tc) if self.inner else True

    def exit_screen(self):
        if self._writer:
            self._writer.close()
        if self.inner:
            self.inner.exit_screen()


def scan_scrap_clips(base) -> dict:
    """Rebuild the uid -> clip map from a workdir's scrap directory: crash
    recovery for recordings whose FRAME events reference scrap clips (the
    uid is encoded in the filename by Player.record_stop). Newest take
    wins per uid."""
    from .clips import open_clip
    out: dict = {}
    d = Path(base) / "scrap"
    if not d.is_dir():
        return out
    for p in sorted(d.glob("scrap_*.avi")):
        parts = p.stem.split("_")
        if len(parts) < 2:
            continue
        try:
            uid = int(parts[1], 16)
        except ValueError:
            continue
        try:
            clip = open_clip(str(p), tempfile.mkdtemp(prefix="scrap_"))
        except Exception:
            continue  # truncated file from a crash mid-write
        clip.unique_id = uid
        out[uid] = clip
    return out
