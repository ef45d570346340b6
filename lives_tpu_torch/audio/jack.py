"""JACK audio client and transport sync.

Counterpart of `lives_tpu/audio/jack.py:52-300` (reference `src/jack.c`:
client lifecycle, the pull-model process callback fed from clip audio,
transport master and slave, `jack_pb_start` wired into playback at
`src/player.c:2288`). The JAX module imports no framework; the port keeps
its own copy, so the values and the calls into libjack are the same.

ctypes binding, gated: `load_libjack()` returns None where no libjack
loads, and every class takes an injected `lib`, so the client and the
transport run against a mock (tests/test_torch_jack.py). The process
callback PULLS from `pull_fn` (`AudioPlayer.pull` reblocked); transport
master maps the player's start, stop and seek onto `jack_transport_start`,
`_stop` and `_locate` (`Player.transport`), and transport slave makes the
JACK transport clock the player's time source (`Player.time_source`
callable). Audio blocks are host float32 arrays, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional

import numpy as np

# jack_transport_state_t
JackTransportStopped = 0
JackTransportRolling = 1
JackTransportLooping = 2
JackTransportStarting = 3

JackPortIsInput = 0x1
JackPortIsOutput = 0x2
JACK_DEFAULT_AUDIO_TYPE = b"32 bit float mono audio"


class jack_position_t(ctypes.Structure):
    """Leading fields of jack_position_t (jack/types.h); trailing space
    reserved so libjack may scribble freely in its extended fields."""
    _fields_ = [
        ("unique_1", ctypes.c_uint64),
        ("usecs", ctypes.c_uint64),
        ("frame_rate", ctypes.c_uint32),
        ("frame", ctypes.c_uint32),
        ("valid", ctypes.c_int),
        ("_reserved", ctypes.c_uint8 * 480),
    ]


_PROCESS_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_void_p)


def load_libjack():
    """dlopen libjack; None when unavailable (gated feature)."""
    for name in ("libjack.so.0", "libjack.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _proto(lib, name, restype, argtypes) -> bool:
    """Best-effort prototype config (no-op for mock libs)."""
    try:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
        return True
    except (AttributeError, TypeError):
        return hasattr(lib, name)


class JackClient:
    """One JACK client: stereo output ports, pull-model process callback,
    transport control. `pull_fn(nframes) -> (nframes, 2) float32` supplies
    audio (typically AudioPlayer.pull rebloked); absent pull = silence."""

    def __init__(self, name: str = "lives_tpu",
                 pull_fn: Optional[Callable[[int], np.ndarray]] = None,
                 lib=None):
        self.lib = lib if lib is not None else load_libjack()
        if self.lib is None:
            raise RuntimeError("libjack unavailable")
        self.pull_fn = pull_fn
        self._lock = threading.Lock()
        lib = self.lib
        is_cdll = isinstance(lib, ctypes.CDLL)
        if is_cdll:
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
            _proto(lib, "jack_transport_start", None, [ctypes.c_void_p])
            _proto(lib, "jack_transport_stop", None, [ctypes.c_void_p])
            _proto(lib, "jack_transport_locate", ctypes.c_int,
                   [ctypes.c_void_p, ctypes.c_uint32])
            _proto(lib, "jack_transport_query", ctypes.c_int,
                   [ctypes.c_void_p, ctypes.POINTER(jack_position_t)])
        self.client = lib.jack_client_open(name.encode(), 0, None)
        if not self.client:
            raise RuntimeError("jack_client_open failed")
        self.sample_rate = int(lib.jack_get_sample_rate(self.client)) \
            or 48000
        self.ports = [
            lib.jack_port_register(self.client, b"out_L",
                                   JACK_DEFAULT_AUDIO_TYPE,
                                   JackPortIsOutput, 0),
            lib.jack_port_register(self.client, b"out_R",
                                   JACK_DEFAULT_AUDIO_TYPE,
                                   JackPortIsOutput, 0),
        ]
        # keep the callback object alive for the client's lifetime
        self._cb = _PROCESS_CB(self._process)
        lib.jack_set_process_callback(self.client, self._cb, None)
        self._active = False

    # -- process (pull model, jack.c audio_process_dummy role) -------------
    def _process(self, nframes: int, _arg) -> int:
        try:
            block = None
            if self.pull_fn is not None:
                block = np.asarray(self.pull_fn(int(nframes)), np.float32)
            if block is None or block.shape[0] < nframes:
                pad = np.zeros((int(nframes), 2), np.float32)
                if block is not None and len(block):
                    pad[: len(block), : block.shape[1]] = block[:, :2]
                block = pad
            for ch, port in enumerate(self.ports):
                buf = self.lib.jack_port_get_buffer(port, nframes)
                if not buf:
                    continue
                dst = (ctypes.c_float * int(nframes)).from_address(
                    buf if isinstance(buf, int) else
                    ctypes.cast(buf, ctypes.c_void_p).value)
                col = block[: int(nframes),
                            min(ch, block.shape[1] - 1)]
                dst[:] = np.ascontiguousarray(col, np.float32)
            return 0
        except Exception:
            return 1

    def activate(self):
        if not self._active:
            self.lib.jack_activate(self.client)
            self._active = True

    def deactivate(self):
        if self._active:
            self.lib.jack_deactivate(self.client)
            self._active = False

    def close(self):
        self.deactivate()
        if self.client:
            self.lib.jack_client_close(self.client)
            self.client = None

    # -- transport (jack.c transport master/slave) --------------------------
    def transport_start(self):
        self.lib.jack_transport_start(self.client)

    def transport_stop(self):
        self.lib.jack_transport_stop(self.client)

    def transport_locate(self, seconds: float):
        self.lib.jack_transport_locate(
            self.client, int(max(0.0, seconds) * self.sample_rate))

    def transport_query(self) -> tuple[int, float]:
        """(state, seconds)."""
        pos = jack_position_t()
        state = self.lib.jack_transport_query(self.client,
                                              ctypes.byref(pos))
        rate = pos.frame_rate or self.sample_rate
        return int(state), pos.frame / float(rate)


class JackTransport:
    """Bidirectional player<->JACK transport glue (jack_pb_start model,
    player.c:2288).

    master: player start/stop/seek drive the JACK transport so external
    apps follow. slave: the JACK transport clock becomes the player's
    time source — `attach()` installs a callable on `player.time_source`
    that maps transport seconds to the player clock, and playback
    starts/stops follow the transport state (poll()).
    """

    def __init__(self, client: JackClient, player, mode: str = "master"):
        if mode not in ("master", "slave"):
            raise ValueError(mode)
        self.client = client
        self.player = player
        self.mode = mode
        self._last_state = JackTransportStopped

    # -- master -------------------------------------------------------------
    def on_play(self):
        if self.mode == "master":
            st = self.player.state
            base = getattr(st.fg_clip, "fps", 25.0) or 25.0
            self.client.transport_locate(st.frame / base)
            self.client.transport_start()

    def on_stop(self):
        if self.mode == "master":
            self.client.transport_stop()

    def on_seek(self, seconds: float):
        if self.mode == "master":
            self.client.transport_locate(seconds)

    # -- slave ---------------------------------------------------------------
    def attach(self):
        """Install the transport clock as the player's time source."""
        if self.mode == "slave":
            self.player.time_source = self._transport_seconds

    def _transport_seconds(self) -> float:
        return self.client.transport_query()[1]

    def poll(self):
        """Follow external transport state changes (call periodically,
        e.g. from the player loop or a timer): rolling -> play,
        stopped -> stop."""
        if self.mode != "slave":
            return
        state, _secs = self.client.transport_query()
        if state != self._last_state:
            rolling = state in (JackTransportRolling,
                                JackTransportStarting,
                                JackTransportLooping)
            was = self._last_state in (JackTransportRolling,
                                       JackTransportStarting,
                                       JackTransportLooping)
            if rolling and not was:
                self.player.start()
            elif was and not rolling:
                self.player.stop()
            self._last_state = state


class JackAudioSink:
    """AudioSink adapter: AudioPlayer pushes blocks; the JACK process
    callback drains the ring (jack.c's output path for the push model)."""

    def __init__(self, name: str = "lives_tpu", lib=None):
        self._ring: list[np.ndarray] = []
        self._lock = threading.Lock()
        self._leftover: Optional[np.ndarray] = None
        self.client = JackClient(name, pull_fn=self._pull, lib=lib)
        self.client.activate()
        self.rate = self.client.sample_rate

    def _pull(self, nframes: int) -> np.ndarray:
        out = np.zeros((nframes, 2), np.float32)
        filled = 0
        with self._lock:
            while filled < nframes:
                if self._leftover is not None:
                    blk = self._leftover
                    self._leftover = None
                elif self._ring:
                    blk = self._ring.pop(0)
                else:
                    break
                take = min(len(blk), nframes - filled)
                out[filled: filled + take] = blk[:take, :2]
                filled += take
                if take < len(blk):
                    self._leftover = blk[take:]
        return out

    def write(self, block, rate):
        blk = np.asarray(block, np.float32)
        if blk.ndim == 1:
            blk = blk[:, None]
        if blk.shape[1] == 1:
            blk = np.repeat(blk, 2, 1)
        with self._lock:
            self._ring.append(blk)
            # bound the ring at ~1 s
            total = sum(len(b) for b in self._ring)
            while total > rate and len(self._ring) > 1:
                total -= len(self._ring.pop(0))

    def close(self):
        self.client.close()
