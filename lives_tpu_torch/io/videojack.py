"""Video-JACK (the videojack fork of libjack): frame receive and send.

Counterpart of `lives_tpu/io/videojack.py:1-255`, which succeeds two
reference plugins on the videojack libjack fork (frames travel through
JACK ports typed JACK_DEFAULT_VIDEO_TYPE; the port's geometry rides the
fork's `jack_video_get_width/height` and
`jack_video_set_width_and_height`):

- `lives-plugins/weed-plugins/gdk/vjack_rcv.c:1-426`, a generator: a
  video input port whose process callback drains whole RGBA32 frames,
  the render pass taking the newest, holding the previous one where none
  arrived (:340-346) and rescaling to the out-channel geometry
  (:350-380);
- `lives-plugins/plugins/playback/video/vjack_output.c:1-159`, a playback
  plugin: a video output port fed from a 16-frame ring (:140, :31-41).

Gated and mock-tested like `audio/jack.py` (`load_vjack()` is None where
libjack lacks the video entry points):

- `VJackSource`, a clip-like live source on its torch device (`device`,
  the card unless the caller asks for the CPU). The process callback
  keeps the newest complete frame under a lock; `get_frame` copies it to
  the device once and rescales it there, bilinear
  (`ops.resize.resize_layer`, as `videojack.py:179-195`). With no new
  frame it serves the last layer again, with no copy at all.
- `VJackSink`, a playback `Sink`: RGBA32 frames cross to the host in one
  copy each and queue (16 frames, the oldest dropped); the process
  callback writes the oldest into the port buffer. The console's
  `play --sink vjack` builds one.
"""

from __future__ import annotations

import ctypes
import threading
from collections import deque

import numpy as np
import torch

from ..audio.jack import (JACK_DEFAULT_AUDIO_TYPE,  # noqa: F401 (re-export ctx)
                          JackPortIsInput, JackPortIsOutput, _proto,
                          load_libjack)
from ..constants import Palette
from ..layer import Layer
from ..player.sinks import Sink, host_planes

# jack/video.h (videojack fork) port type string
JACK_DEFAULT_VIDEO_TYPE = b"32 bit raw RGBA video"

_PROCESS_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_void_p)

_VIDEO_ENTRY_POINTS = ("jack_video_get_width", "jack_video_get_height",
                       "jack_video_set_width_and_height")


def load_vjack():
    """libjack WITH the videojack entry points, or None (gated: a stock
    libjack lacks jack_video_* and cannot carry video ports)."""
    lib = load_libjack()
    if lib is None:
        return None
    if not all(hasattr(lib, n) for n in _VIDEO_ENTRY_POINTS):
        return None
    return lib


class _VJackClientBase:
    """Shared client plumbing for one video port (in or out)."""

    def __init__(self, port_flags: int, port_name: bytes,
                 client_name: str, lib=None):
        self.lib = lib if lib is not None else load_vjack()
        if self.lib is None:
            raise RuntimeError("videojack libjack unavailable")
        lib = self.lib
        if isinstance(lib, ctypes.CDLL):
            _proto(lib, "jack_client_open", ctypes.c_void_p,
                   [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p])
            _proto(lib, "jack_client_close", ctypes.c_int,
                   [ctypes.c_void_p])
            _proto(lib, "jack_get_sample_rate", ctypes.c_uint32,
                   [ctypes.c_void_p])
            _proto(lib, "jack_port_register", ctypes.c_void_p,
                   [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.c_ulong, ctypes.c_ulong])
            _proto(lib, "jack_port_get_buffer", ctypes.c_void_p,
                   [ctypes.c_void_p, ctypes.c_uint32])
            _proto(lib, "jack_set_process_callback", ctypes.c_int,
                   [ctypes.c_void_p, _PROCESS_CB, ctypes.c_void_p])
            _proto(lib, "jack_activate", ctypes.c_int, [ctypes.c_void_p])
            _proto(lib, "jack_deactivate", ctypes.c_int,
                   [ctypes.c_void_p])
            _proto(lib, "jack_video_get_width", ctypes.c_uint32,
                   [ctypes.c_void_p, ctypes.c_void_p])
            _proto(lib, "jack_video_get_height", ctypes.c_uint32,
                   [ctypes.c_void_p, ctypes.c_void_p])
            _proto(lib, "jack_video_set_width_and_height", None,
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_uint32])
        self.client = lib.jack_client_open(client_name.encode(), 0, None)
        if not self.client:
            raise RuntimeError("jack_client_open failed")
        # videojack convention: the engine "sample rate" is the video
        # fps (vjack_rcv.c:300 sets PREFERRED_FPS from it)
        self.fps = float(int(lib.jack_get_sample_rate(self.client))
                         or 25)
        self.port = lib.jack_port_register(
            self.client, port_name, JACK_DEFAULT_VIDEO_TYPE,
            port_flags, 0)
        if not self.port:
            lib.jack_client_close(self.client)
            raise RuntimeError("no JACK video port available")
        # dispatch through the attribute so subclasses/owners may swap
        # the handler even after the ctypes thunk is registered
        self._cb = _PROCESS_CB(lambda nf, arg: self._process(nf, arg))
        lib.jack_set_process_callback(self.client, self._cb, None)
        lib.jack_activate(self.client)
        self._active = True

    def _port_geometry(self) -> tuple[int, int]:
        w = int(self.lib.jack_video_get_width(self.client, self.port))
        h = int(self.lib.jack_video_get_height(self.client, self.port))
        return w, h

    def _process(self, nframes: int, _arg) -> int:  # pragma: no cover
        return 0

    def close(self):
        if self._active:
            self.lib.jack_deactivate(self.client)
            self._active = False
        if self.client:
            self.lib.jack_client_close(self.client)
            self.client = None


class VJackSource(_VJackClientBase):
    """Clip-like live source fed by a JACK video input port
    (vjack_rcv.c generator role)."""

    def __init__(self, width: int = 640, height: int = 480,
                 client_name: str = "lives_tpu-vjack-rcv", lib=None, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._latest: np.ndarray | None = None   # (h, w, 4) u8, host
        self._last_layer: Layer | None = None    # bgbuf role (device)
        self.width, self.height = int(width), int(height)
        super().__init__(JackPortIsInput, b"video_in", client_name, lib)
        from ..utils.uid import stable_uid
        self.unique_id = stable_uid("vjack", client_name)
        self.frames = 1 << 30
        self.scrap_on_record = True

    # jack thread: latest complete frame wins (the reference drains its
    # ringbuffer to the newest frame anyway, vjack_rcv.c:336-339)
    def _process(self, nframes: int, _arg) -> int:
        try:
            w, h = self._port_geometry()
            if w <= 0 or h <= 0:
                return 0
            buf = self.lib.jack_port_get_buffer(self.port, nframes)
            if not buf:
                return 0
            addr = buf if isinstance(buf, int) else \
                ctypes.cast(buf, ctypes.c_void_p).value
            raw = ctypes.string_at(addr, w * h * 4)
            frame = np.frombuffer(raw, np.uint8).reshape(h, w, 4)
            with self._lock:
                self._latest = frame
            return 0
        except Exception:
            return 1

    def get_frame(self, n: int = 0) -> Layer:
        from ..ops.resize import resize_layer
        with self._lock:
            frame, self._latest = self._latest, None
        if frame is None:
            if self._last_layer is not None:
                return self._last_layer      # SMOOTH bgbuf hold
            frame = np.zeros((self.height, self.width, 4), np.uint8)
        lay = Layer(planes=(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(frame, -1, 0))).to(self.device),),
            palette=int(Palette.RGBA32))
        if frame.shape[:2] != (self.height, self.width):
            lay = resize_layer(lay, self.width, self.height,
                               method="bilinear")
        self._last_layer = lay
        return lay


class VJackSink(Sink):
    """Playback sink writing RGBA32 frames to a JACK video output port
    (vjack_output.c role)."""

    palette_list = (Palette.RGBA32,)
    fetches_frames = True

    def __init__(self, client_name: str = "lives_tpu-vjack-out",
                 lib=None, queue_frames: int = 16):
        self._rb: deque[bytes] = deque(maxlen=int(queue_frames))
        self._lock = threading.Lock()
        self._client = _VJackClientBase.__new__(_VJackClientBase)
        _VJackClientBase.__init__(self._client, JackPortIsOutput,
                                  b"video_out", client_name, lib)
        self._client._process = self._process  # drain on the jack thread
        self._geom: tuple[int, int] | None = None

    def init_screen(self, width: int, height: int, fps: float):
        self._client.lib.jack_video_set_width_and_height(
            self._client.client, self._client.port,
            int(width), int(height))
        with self._lock:
            # drop frames of the old geometry: _process must never
            # memmove a stale-sized frame into the re-sized port buffer
            self._rb.clear()
            self._geom = (int(width), int(height))

    def play_frame(self, layer: Layer, tc: float) -> bool:
        (arr,) = host_planes(layer.replace(planes=layer.planes[:1]))
        with self._lock:                           # (4, h, w) u8
            self._rb.append(np.moveaxis(arr, -3, -1).tobytes())
        return True

    def _process(self, nframes: int, _arg) -> int:
        try:
            with self._lock:
                frame = self._rb.popleft() if self._rb else None
                geom = self._geom
            if frame is None or geom is None:
                return 0
            if len(frame) != geom[0] * geom[1] * 4:
                # geometry raced a re-init: never overflow the port buffer
                return 0
            buf = self._client.lib.jack_port_get_buffer(
                self._client.port, nframes)
            if not buf:
                return 0
            addr = buf if isinstance(buf, int) else \
                ctypes.cast(buf, ctypes.c_void_p).value
            ctypes.memmove(addr, frame, len(frame))
            return 0
        except Exception:
            return 1

    def exit_screen(self):
        with self._lock:
            self._rb.clear()
        self._client.close()
