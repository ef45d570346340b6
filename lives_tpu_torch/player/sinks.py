"""Output sinks: the playback-plugin boundary.

Counterpart of `lives_tpu/player/sinks.py:20-138` (reference
`plugins/playback/video/videoplugin.h`: `play_frame(layer, tc)` :145,
palette negotiation :104-110). A sink declares the palettes it accepts;
the player's frame graph converts on the device and only the final bytes
cross to the host, once a frame (or once a group, when the player fetches
groups: `Player.fetch_batch`).

`NullSink` bounds the device's queue with a `torch.cuda.Event` recorded
every `sync_every` frames: before recording one it waits for the one
before, so at most about two `sync_every` windows of frames are queued.
(The JAX version fetched a tiny device value on a helper thread, because
its attachment's `block_until_ready` did not wait; PyTorch's events do.)

`PNGSink` (`sinks.py:93-106`) writes numbered PNGs through PIL on the
host, the frame crossing in one copy. `AVStreamSink` (`sinks.py:140`)
encodes RGB frames through the libav bridge (`io/av.py`) to a file or a
network target. `VLoopbackSink` (`sinks.py:190-233`) writes RGB24 frames
to a v4l2loopback device; `host_rgb24` is the one copy the display sinks
(`player/gl.py`, `player/sdl.py`) make of a frame.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..constants import Palette
from ..layer import Layer


def host_rgb24(layer: Layer) -> np.ndarray:
    """One frame as interleaved (H, W, 3) uint8 host pixels: converted to
    RGB24 on its device, then one device -> host copy."""
    from ..ops.colorspace import convert_layer
    rgb = convert_layer(layer, Palette.RGB24).planes[0]
    return rgb.movedim(-3, -1).contiguous().cpu().numpy()


def host_planes(layer: Layer) -> list[np.ndarray]:
    """The layer's planes as host arrays: planes on a device cross to the
    host in one copy (concatenated on the device first, when they share a
    dtype); host planes are returned as they are."""
    planes = layer.planes
    if planes[0].device.type == "cpu":
        return [p.numpy() for p in planes]
    if len({p.dtype for p in planes}) > 1:
        return [p.cpu().numpy() for p in planes]
    flat = torch.cat([p.reshape(-1) for p in planes]).cpu().numpy()
    out, o = [], 0
    for p in planes:
        out.append(flat[o:o + p.numel()].reshape(tuple(p.shape)))
        o += p.numel()
    return out


class Sink:
    """Base sink. `palette_list` drives sink-side palette negotiation."""

    palette_list: tuple[int, ...] = (Palette.RGB24,)
    fetches_frames = True   # most sinks fetch pixels to host each frame

    def init_screen(self, width: int, height: int, fps: float):
        pass

    def play_frame(self, layer: Layer, tc: float) -> bool:
        raise NotImplementedError

    def exit_screen(self):
        pass


class NullSink(Sink):
    """Discards frames (benchmark sink). Every `sync_every` frames on a
    CUDA device it records an event on the current stream after waiting
    for the previous one, so the device runs at most about 2 *
    `sync_every` frames behind the host, as a display consuming
    asynchronously would; `strict=True` synchronizes inline instead."""

    fetches_frames = False

    def __init__(self, sync_every: int = 8, strict: bool = False):
        self.count = 0
        self.sync_every = max(1, sync_every)
        self.strict = strict
        self._event = None

    def play_frame(self, layer: Layer, tc: float) -> bool:
        self.count += 1
        dev = layer.planes[0].device
        if self.count % self.sync_every == 0 and dev.type == "cuda":
            if self.strict:
                torch.cuda.synchronize(dev)
                return True
            if self._event is not None:
                self._event.synchronize()
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        return True

    def exit_screen(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None


class CollectSink(Sink):
    """Keeps frames in memory, as host arrays (tests)."""

    def __init__(self, max_frames: int = 1 << 30):
        self.frames: list[np.ndarray] = []
        self.tcs: list[float] = []
        self.max_frames = max_frames

    def play_frame(self, layer: Layer, tc: float) -> bool:
        if len(self.frames) < self.max_frames:
            self.frames.append(layer.planes[0].cpu().numpy())
            self.tcs.append(tc)
        return True


class PNGSink(Sink):
    """Writes numbered PNGs (render-to-images path); the bytes are the JAX
    sink's for equal pixels."""

    def __init__(self, out_dir: str | Path):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.n = 0

    def play_frame(self, layer: Layer, tc: float) -> bool:
        from PIL import Image
        from ..io.decoders import PIL_SECONDS
        arr = np.moveaxis(layer.planes[0].cpu().numpy(), 0, -1)
        t0 = time.perf_counter()
        Image.fromarray(arr).save(self.out_dir / f"{self.n + 1:08d}.png")
        PIL_SECONDS["encode"] += time.perf_counter() - t0
        self.n += 1
        return True


class Y4MSink(Sink):
    """Streams YUV4MPEG2 (reference yuv4mpeg_stream / lives2lives output
    plugins): YUV420P frames, their three planes in one host copy a
    frame."""

    palette_list = (Palette.YUV420P,)

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self.fps = 25.0

    def init_screen(self, width: int, height: int, fps: float):
        self.fps = fps
        num, den = int(round(fps * 1001)), 1001
        if abs(fps - round(fps)) < 1e-6:
            num, den = int(round(fps)), 1
        self._fh = open(self.path, "wb")
        self._fh.write(f"YUV4MPEG2 W{width} H{height} F{num}:{den} Ip A1:1 "
                       f"C420jpeg\n".encode())

    def play_frame(self, layer: Layer, tc: float) -> bool:
        self._fh.write(b"FRAME\n")
        for p in host_planes(layer.replace(planes=layer.planes[:3])):
            self._fh.write(p.tobytes())
        return True

    def exit_screen(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class AVStreamSink(Sink):
    """Network / container streaming through the libav bridge
    (`lives_tpu/player/sinks.py:140`): frames encode to any avformat
    target, `udp://host:port` (MPEG-TS, the lives2lives-class network
    path), `icecast://` / `http://` (Theora/OGG), `rtp://`, `srt://` or a
    file. Container defaults: udp/rtp/srt mean mpegts, icecast/http mean
    ogg, any other target is guessed from its extension. The session
    opens at the first frame's size when init_screen was not called."""

    palette_list = (Palette.RGB24,)

    def __init__(self, url: str, fps: float = 25.0, bitrate: int = 0,
                 container: str = "", vcodec: str | None = None):
        self.url = url
        self.fps = fps
        self.bitrate = bitrate
        if not container:
            if url.startswith(("udp://", "rtp://", "srt://")):
                container = "mpegts"
            elif url.startswith(("icecast://", "http://", "https://")):
                container = "ogg"
        self.container = container
        self.vcodec = vcodec
        self._sess = None
        self.frames = 0

    def init_screen(self, width, height, fps):
        from ..io.av import AVEncodeSession
        self.fps = fps or self.fps
        self._sess = AVEncodeSession(self.url, width, height, self.fps,
                                     vcodec=self.vcodec,
                                     bitrate=self.bitrate,
                                     container=self.container)

    def play_frame(self, layer: Layer, tc: float) -> bool:
        (frame,) = host_planes(layer.replace(planes=layer.planes[:1]))
        if self._sess is None:
            c, h, w = frame.shape[-3:]
            self.init_screen(w, h, self.fps)
        self._sess.write_frame(frame.reshape(frame.shape[-3:]))
        self.frames += 1
        return True

    def exit_screen(self):
        if self._sess is not None:
            self._sess.close()
            self._sess = None


class VLoopbackSink(Sink):
    """v4l2loopback output (`lives_tpu/player/sinks.py:190-233`,
    reference vloopback2.c): raw RGB24 frames written to a /dev/videoN
    loopback device, so any V4L2 consumer (a browser, OBS, ffmpeg) sees a
    camera. Gated: raises RuntimeError where the device is absent. The
    frame crosses to the host in one copy, interleaved (H, W, 3)."""

    palette_list = (Palette.RGB24,)

    V4L2_PIX_FMT_RGB24 = 0x33424752  # 'RGB3'

    def __init__(self, device: str = "/dev/video10"):
        import os
        if not os.path.exists(device):
            raise RuntimeError(f"{device} absent (v4l2loopback not loaded)")
        self.device = device
        self._fd = None
        self.frames = 0

    def init_screen(self, width, height, fps):
        import fcntl
        import os
        import struct as st
        self._fd = os.open(self.device, os.O_WRONLY)
        # VIDIOC_S_FMT with v4l2_format(type=V4L2_BUF_TYPE_VIDEO_OUTPUT=2)
        fmt = st.pack("<I", 2) + st.pack("<IIIII", width, height,
                                         self.V4L2_PIX_FMT_RGB24, 1,
                                         width * 3) \
            + st.pack("<II", width * height * 3, 0) + bytes(200 - 36)
        VIDIOC_S_FMT = 0xC0D05605
        fcntl.ioctl(self._fd, VIDIOC_S_FMT, bytearray(fmt))

    def play_frame(self, layer: Layer, tc: float) -> bool:
        import os
        (arr,) = host_planes(layer.replace(planes=layer.planes[:1]))
        os.write(self._fd, np.ascontiguousarray(
            np.moveaxis(arr, -3, -1)).tobytes())
        self.frames += 1
        return True

    def exit_screen(self):
        import os
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
