"""Audio effect host (reference `weed_apply_audio_instance`
effects-weed.c:2747, audio filter plugins, `audio_transition.c`,
`tone_gen.c`) and the realtime audio feeder loop (the jack/pulse driver
role, src/jack.c / src/pulse.c).

Counterpart of `lives_tpu/audio/fx.py:1-770`, copied (host numpy and
ctypes; importing it would import the JAX package). The filters compute
what the JAX ones compute, sample for sample. `best_audio_sink` prefers
the JACK sink (`audio/jack.py`, `fx.py:689-692`) where libjack loads. The ALSA
and PulseAudio sinks and the ALSA capture load their libraries through
ctypes and report `available()` False where the library is absent, as the
JAX ones do.

Audio filters process float32 (n, channels) blocks with explicit state,
mirroring the video Filter model; chains apply in sequence. The AudioPlayer
thread pulls clip audio velocity-matched to the video player's pb_fps
(scratching pitches audio like the reference) and feeds an AudioSink.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from .engine import to_channels, velocity_resample


@dataclass(frozen=True)
class AudioFilter:
    name: str
    process: Callable  # (block, params, state) -> (block, state[, outs])
    params: dict[str, float] = field(default_factory=dict)  # defaults
    description: str = ""
    # analyser out-parameters (weed out params; feed effects/data.py
    # connections so audio can drive video-filter knobs)
    out_params: tuple = ()


@dataclass
class AudioInstance:
    filter: AudioFilter
    values: dict[str, float] = field(default_factory=dict)
    state: Any = None
    enabled: bool = True
    # latest analyser outputs (read by DataConnections.chain_data)
    out_values: dict[str, float] = field(default_factory=dict)

    def apply(self, block: np.ndarray) -> np.ndarray:
        if not self.enabled:
            return block
        params = {**self.filter.params, **self.values}
        ret = self.filter.process(block, params, self.state)
        if len(ret) == 3:
            out, self.state, outs = ret
            self.out_values.update(outs)
        else:
            out, self.state = ret
        return out


_AUDIO_REGISTRY: dict[str, AudioFilter] = {}


def register_audio_filter(f: AudioFilter) -> AudioFilter:
    _AUDIO_REGISTRY[f.name] = f
    return f


def get_audio_filter(name: str) -> AudioFilter:
    return _AUDIO_REGISTRY[name]


def list_audio_filters() -> list[str]:
    return sorted(_AUDIO_REGISTRY)


def audio_instantiate(name: str, **values) -> AudioInstance:
    return AudioInstance(filter=get_audio_filter(name), values=values)


def apply_audio_chain(chain, block: np.ndarray) -> np.ndarray:
    """weed_apply_audio_effects_rt (effects-weed.c:3438)."""
    for inst in chain:
        block = inst.apply(block)
    return block


# -- builtin audio filters ----------------------------------------------------

def _gain(block, p, state):
    return np.clip(block * p["gain"], -1.0, 1.0), state


register_audio_filter(AudioFilter("gain", _gain, {"gain": 1.0},
                                  "volume"))


def _echo(block, p, state):
    """True feedback delay: out[n] = in[n] + fb * out[n - delay].
    Processed in delay-sized chunks so each chunk vectorises."""
    rate = int(p["rate"])
    delay = max(1, int(p["delay"] * rate))
    fb = p["feedback"]
    if state is None or state.shape != (delay, block.shape[1]):
        state = np.zeros((delay, block.shape[1]), np.float32)
    out = np.empty_like(block)
    i = 0
    while i < len(block):
        n = min(delay, len(block) - i)
        out[i: i + n] = block[i: i + n] + fb * state[:n]
        state = np.concatenate([state[n:], out[i: i + n]])
        i += n
    return np.clip(out, -1, 1), state


register_audio_filter(AudioFilter(
    "echo", _echo, {"delay": 0.25, "feedback": 0.4, "rate": 44100},
    "feedback delay"))


def _lowpass(block, p, state):
    """One-pole IIR, vectorised via scipy.signal.lfilter (a per-sample
    Python loop at 44.1 kHz would fight the video loop for the single
    host core — CLAUDE.md)."""
    from scipy.signal import lfilter
    a = min(max(p["cutoff"], 0.001), 1.0)
    y = state if state is not None else np.zeros(block.shape[1], np.float32)
    if np.shape(y) != (block.shape[1],):
        y = np.zeros(block.shape[1], np.float32)
    out = np.empty_like(block)
    for c in range(block.shape[1]):
        # y[n] = (1-a) y[n-1] + a x[n]
        zi = np.asarray([(1.0 - a) * y[c]], np.float64)
        out[:, c], zf = lfilter([a], [1.0, a - 1.0], block[:, c], zi=zi)
        y = np.asarray(y, np.float32)
        y[c] = out[-1, c]
    return out, y


register_audio_filter(AudioFilter("lowpass", _lowpass, {"cutoff": 0.2},
                                  "one-pole lowpass"))


def _compressor(block, p, state):
    env = state if state is not None else 0.0
    thr, ratio = p["threshold"], max(p["ratio"], 1.0)
    peak = float(np.abs(block).max()) if len(block) else 0.0
    env = max(peak, env * 0.95)
    gain = 1.0 if env <= thr else (thr + (env - thr) / ratio) / max(env, 1e-6)
    return block * gain, env


register_audio_filter(AudioFilter(
    "compressor", _compressor, {"threshold": 0.5, "ratio": 4.0},
    "peak compressor"))


def _crossfade(block, p, state):
    """audio_transition.c: equal-power crossfade of the two stereo halves
    (channels 0,1 = A; 2,3 = B) or simple A/B gain when 2ch."""
    amt = min(max(p["amount"], 0.0), 1.0)
    ga, gb = np.cos(amt * np.pi / 2), np.sin(amt * np.pi / 2)
    if block.shape[1] >= 4:
        a, b = block[:, :2], block[:, 2:4]
        return np.clip(a * ga + b * gb, -1, 1), state
    return np.clip(block * ga, -1, 1), state


register_audio_filter(AudioFilter(
    "audio_transition", _crossfade, {"amount": 0.0},
    "equal-power A/B crossfade (audio_transition.c)"))


def _highpass(block, p, state):
    """One-pole highpass: x - lowpass(x) (the LADSPA-universe staple)."""
    from scipy.signal import lfilter
    a = min(max(p["cutoff"], 0.001), 1.0)
    y = state if state is not None and np.shape(state) == \
        (block.shape[1],) else np.zeros(block.shape[1], np.float32)
    out = np.empty_like(block)
    for c in range(block.shape[1]):
        lp, zf = lfilter([a], [1.0, -(1.0 - a)], block[:, c],
                         zi=np.asarray([(1.0 - a) * y[c]]))
        out[:, c] = block[:, c] - lp
        y[c] = lp[-1] if len(lp) else y[c]
    return np.clip(out, -1, 1), y


register_audio_filter(AudioFilter("highpass", _highpass, {"cutoff": 0.1},
                                  "one-pole highpass"))


def _eq3(block, p, state):
    """3-band shelving EQ from two one-pole splits (low/mid/high gains)."""
    from scipy.signal import lfilter
    lo_c, hi_c = 0.02, 0.3
    if state is None or not (isinstance(state, np.ndarray)
                             and state.shape == (2, block.shape[1])):
        state = np.zeros((2, block.shape[1]), np.float32)
    out = np.empty_like(block)
    for c in range(block.shape[1]):
        lp1, z1 = lfilter([lo_c], [1.0, -(1.0 - lo_c)], block[:, c],
                          zi=np.asarray([(1.0 - lo_c) * state[0, c]]))
        lp2, z2 = lfilter([hi_c], [1.0, -(1.0 - hi_c)], block[:, c],
                          zi=np.asarray([(1.0 - hi_c) * state[1, c]]))
        low, mid, high = lp1, lp2 - lp1, block[:, c] - lp2
        out[:, c] = (low * p["low"] + mid * p["mid"] + high * p["high"])
        state[0, c] = lp1[-1] if len(lp1) else state[0, c]
        state[1, c] = lp2[-1] if len(lp2) else state[1, c]
    return np.clip(out, -1, 1), state


register_audio_filter(AudioFilter(
    "eq3", _eq3, {"low": 1.0, "mid": 1.0, "high": 1.0},
    "3-band shelving EQ"))


def _reverb(block, p, state):
    """Small Schroeder reverb: 4 parallel feedback combs + wet mix
    (block-wise vectorised like _echo)."""
    rate = int(p["rate"])
    room = min(max(p["room"], 0.05), 0.98)
    wet = min(max(p["wet"], 0.0), 1.0)
    delays = [int(rate * d) for d in (0.0297, 0.0371, 0.0411, 0.0437)]
    ch = block.shape[1]
    if state is None or len(state) != len(delays) \
            or state[0].shape[1] != ch:
        state = [np.zeros((d, ch), np.float32) for d in delays]
    acc = np.zeros_like(block)
    new_state = []
    for buf in state:
        d = len(buf)
        out = np.empty_like(block)
        i = 0
        b = buf
        while i < len(block):
            n = min(d, len(block) - i)
            out[i: i + n] = block[i: i + n] + room * b[:n]
            b = np.concatenate([b[n:], out[i: i + n]])
            i += n
        acc += out
        new_state.append(b)
    acc /= len(delays)
    return np.clip(block * (1 - wet) + acc * wet, -1, 1), new_state


register_audio_filter(AudioFilter(
    "reverb", _reverb, {"room": 0.7, "wet": 0.3, "rate": 44100},
    "Schroeder comb reverb"))


def _chorus(block, p, state):
    """Modulated-delay chorus (LFO over a short ring buffer)."""
    rate = int(p["rate"])
    depth = int(max(p["depth"], 0.001) * rate)      # max extra delay
    base = int(0.02 * rate)
    if state is None or not isinstance(state, tuple) \
            or state[0].shape[1] != block.shape[1]:
        state = (np.zeros((base + depth + len(block) + 1,
                           block.shape[1]), np.float32), 0.0)
    ring, phase = state
    hist = np.concatenate([ring[-(base + depth + 1):], block])
    t = phase + np.arange(len(block)) * (2 * np.pi * p["speed"] / rate)
    delay = base + (np.sin(t) * 0.5 + 0.5) * depth
    idx = (base + depth + 1) + np.arange(len(block)) - delay
    lo = np.clip(idx.astype(np.int64), 0, len(hist) - 1)
    hi = np.clip(lo + 1, 0, len(hist) - 1)
    frac = (idx - lo).astype(np.float32)[:, None]
    tap = hist[lo] * (1 - frac) + hist[hi] * frac
    out = np.clip(block * 0.7 + tap * 0.7 * p["mix"], -1, 1)
    return out, (hist, float(t[-1]) if len(t) else phase)


register_audio_filter(AudioFilter(
    "chorus", _chorus, {"depth": 0.004, "speed": 1.2, "mix": 0.6,
                        "rate": 44100}, "LFO modulated-delay chorus"))


def _noise_gate(block, p, state):
    """RMS gate with release smoothing."""
    env = state if isinstance(state, float) else 0.0
    rms = float(np.sqrt(np.mean(block ** 2))) if len(block) else 0.0
    env = max(rms, env * p.get("release", 0.9))
    g = 1.0 if env >= p["threshold"] else 0.0
    return block * g, env


register_audio_filter(AudioFilter(
    "noise_gate", _noise_gate, {"threshold": 0.02, "release": 0.9},
    "RMS noise gate"))


def tone_gen(n: int, freq: float = 440.0, rate: int = 44100,
             channels: int = 2, phase: float = 0.0,
             wave: str = "sine") -> tuple[np.ndarray, float]:
    """tone_gen.c: audio generator. Returns (block, next phase)."""
    t = phase + np.arange(n) * (2 * np.pi * freq / rate)
    if wave == "sine":
        sig = np.sin(t)
    elif wave == "square":
        sig = np.sign(np.sin(t))
    else:  # saw
        sig = 2.0 * ((t / (2 * np.pi)) % 1.0) - 1.0
    block = np.repeat(sig[:, None].astype(np.float32), channels, 1)
    return block, float(t[-1] + 2 * np.pi * freq / rate) if n else phase


class ToneSource:
    """Seekable tone generator with the audio-source protocol
    (`render_at(pos, n)` + `rate`) — tone_gen.c as a clip audio source;
    FourKLives (audio/fourklives.py) implements the same protocol."""

    def __init__(self, freq: float = 440.0, rate: int = 44100,
                 channels: int = 2, wave: str = "sine", vol: float = 0.5):
        self.freq, self.rate = float(freq), int(rate)
        self.channels, self.wave, self.vol = int(channels), wave, float(vol)

    def render_at(self, pos: int, n: int) -> np.ndarray:
        phase = 2 * np.pi * self.freq * pos / self.rate
        block, _ = tone_gen(n, self.freq, self.rate, self.channels,
                            phase, self.wave)
        return block * self.vol


# -- realtime audio feeder (jack/pulse callback-loop analogue) ---------------

class AudioSink:
    def write(self, block: np.ndarray, rate: int):  # pragma: no cover
        raise NotImplementedError

    def close(self):
        pass


class NullAudioSink(AudioSink):
    def __init__(self):
        self.frames = 0

    def write(self, block, rate):
        self.frames += len(block)


class WavAudioSink(AudioSink):
    def __init__(self, path: str):
        self.path = path
        self.blocks = []
        self.rate = 44100

    def write(self, block, rate):
        self.rate = rate
        self.blocks.append(np.asarray(block, np.float32))

    def close(self):
        from ..io.encoders import get_encoder
        if self.blocks:
            get_encoder("wav").encode(self.path, [], 0.0,
                                      np.concatenate(self.blocks), self.rate)


class AudioPlayer:
    """Pulls clip audio velocity-matched to the video player; applies the
    audio fx chain; pushes blocks to the sink. Runs as a thread (pull-model
    like the pulse driver)."""

    def __init__(self, player, sink: AudioSink | None = None,
                 rate: int = 44100, block: int = 1024):
        self.player = player
        self.sink = sink or NullAudioSink()
        self.rate = rate
        self.block = block
        self.chain: list[AudioInstance] = []
        self._pos = 0.0
        self._data: Optional[np.ndarray] = None
        self._gen = None  # audio-generator source (render_at/rate)
        self._src_rate = rate
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.muted = False
        self.volume = 1.0
        # A/V sync closure (reference video_sync_ready, src/player.c:120):
        # audio follows the video clock; small drift is corrected by
        # stretching the resample velocity, large drift hard-resyncs
        self.sync_tolerance = 0.08   # s: beyond this, jump (scratch/loop)
        self.sync_deadband = 0.012   # s: below this, leave alone
        self.sync_corrections = 0
        self.sync_resyncs = 0
        self.last_sync_delta = 0.0

    def load_clip_audio(self, clip):
        # audio-generator clips (reference: generator instances can carry
        # audio out-channels, e.g. fourKlives/tone_gen) stream from a
        # synth's pure render_at instead of a PCM buffer
        gen = getattr(clip, "audio_source", None)
        if gen is not None:
            self._gen = gen
            self._data = None
            self._src_rate = getattr(gen, "rate", self.rate) or self.rate
            self._pos = 0.0
            return
        self._gen = None
        self._data = clip.read_audio()
        self._src_rate = getattr(clip, "arate", self.rate) or self.rate
        self._pos = 0.0

    def pull(self) -> np.ndarray:
        """One callback's worth of audio (velocity-aware). Snapshots the
        shared source refs once: load_clip_audio from another thread may
        swap them mid-pull."""
        gen = getattr(self, "_gen", None)
        if gen is not None:
            return self._pull_generated(gen)
        data = self._data
        if data is None or not len(data):
            return np.zeros((self.block, 2), np.float32)
        st = self.player.state if self.player else None
        fps_ratio = 1.0
        if st is not None and st.fg_clip is not None:
            base = getattr(st.fg_clip, "fps", 25.0) or 25.0
            fps_ratio = st.pb_fps / base
        vel = fps_ratio * self._src_rate / self.rate
        # measure audio-clock vs video-frame delta and close the loop —
        # unless audio IS the master clock (player.time_source == "audio":
        # video derives its target frame from our position instead)
        audio_master = getattr(self.player, "time_source", "system") \
            == "audio"
        delta = None if audio_master else self.sync_delta()
        if delta is not None:
            self.last_sync_delta = delta
            if abs(delta) > self.sync_tolerance:
                # scratch / seek / loop wrap: jump to the video position
                self._pos = self._video_clip_time() * self._src_rate
                self.sync_resyncs += 1
            elif abs(delta) > self.sync_deadband:
                # gentle 5% velocity stretch toward the video clock
                vel -= np.sign(delta) * abs(vel) * 0.05
                self.sync_corrections += 1
        block, self._pos = velocity_resample(data, self._pos, vel,
                                             self.block)
        block = apply_audio_chain(self.chain, block)
        if self.muted:
            block = block * 0.0
        return np.clip(block * self.volume, -1, 1)

    def _pull_generated(self, gen) -> np.ndarray:
        """Velocity-aware pull from an audio GENERATOR (pure render_at):
        synthesize the exact source window the output block maps onto, then
        interpolate — scratching pitches the synth like clip audio."""
        st = self.player.state if self.player else None
        fps_ratio = 1.0
        if st is not None and st.fg_clip is not None:
            base = getattr(st.fg_clip, "fps", 25.0) or 25.0
            fps_ratio = st.pb_fps / base
        vel = fps_ratio * self._src_rate / self.rate
        idx = self._pos + vel * np.arange(self.block, dtype=np.float64)
        lo = int(np.floor(idx.min()))
        hi = int(np.floor(idx.max())) + 2
        if lo < 0:  # reverse past the start: free-run from 0
            idx = idx - lo
            self._pos -= lo
            lo, hi = 0, hi - lo
        data = gen.render_at(lo, hi - lo)
        rel = idx - lo
        i0 = rel.astype(np.int64)
        f = (rel - i0)[:, None].astype(np.float32)
        block = data[i0] * (1.0 - f) + data[np.minimum(i0 + 1,
                                                       len(data) - 1)] * f
        self._pos += vel * self.block
        block = apply_audio_chain(self.chain, block.astype(np.float32))
        if self.muted:
            block = block * 0.0
        return np.clip(block * self.volume, -1, 1)

    def _video_clip_time(self) -> float:
        """Video position in clip-time seconds."""
        st = self.player.state
        base = getattr(st.fg_clip, "fps", 25.0) or 25.0
        return st.frame / base

    def sync_delta(self) -> float | None:
        """audio minus video position, clip seconds; None when unknown
        (no clip / no audio loaded)."""
        if self.player is None or self._data is None:
            return None
        st = self.player.state
        if st.fg_clip is None or not len(self._data):
            return None
        return self._pos / self._src_rate - self._video_clip_time()

    def start(self):
        if self._running and self._thread is not None \
                and self._thread.is_alive():
            return  # double-start would spawn a second feeder at 2x speed
        self._running = True
        # time-based filter params follow the REAL stream rate (a filter's
        # default 44100 would mistime delays at other rates)
        for inst in self.chain:
            if "rate" in inst.filter.params:
                inst.values.setdefault("rate", self.rate)

        def loop():
            period = self.block / self.rate
            nxt = time.monotonic() + period
            while self._running:
                try:
                    self.sink.write(self.pull(), self.rate)
                except Exception:
                    # a transient mid-swap error must not kill the feeder
                    pass
                # absolute deadline: relative sleeps accumulate overshoot
                # and run audibly slow against a fixed-rate consumer
                now = time.monotonic()
                if nxt - now > 0:
                    time.sleep(nxt - now)
                    nxt += period
                else:  # fell behind: resync rather than burst
                    nxt = now + period

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        self.sink.close()


class PipeAudioSink(AudioSink):
    """Interleaved s16le to a pipe/FIFO/fd — feed `aplay -f cd`, a jackd
    bridge, or any pcm consumer. The always-available device path in this
    image (no sound server); the reference analogue is the fifo/"none"
    audio player fallback."""

    def __init__(self, path_or_fd):
        import os as _os
        if isinstance(path_or_fd, int):
            self._fd = path_or_fd
        else:
            self._fd = _os.open(str(path_or_fd),
                                _os.O_WRONLY | getattr(_os, "O_NONBLOCK", 0))
        self.frames = 0

    def write(self, block, rate):
        import os as _os
        pcm = np.clip(np.asarray(block, np.float32), -1.0, 1.0)
        data = (pcm * 32767.0).astype("<i2").tobytes()
        frame_bytes = 2 * pcm.shape[1] if pcm.ndim == 2 else 2
        sent = 0
        try:
            while sent < len(data):
                n = _os.write(self._fd, data[sent:])
                sent += n
                if n == 0:
                    break
        except BlockingIOError:
            # consumer not keeping up: drop the tail, but ONLY on a frame
            # boundary — a partial frame would channel-swap the stream
            rem = sent % frame_bytes
            if rem:
                _os.write(self._fd, data[sent: sent + frame_bytes - rem])
                sent += frame_bytes - rem
        self.frames += sent // frame_bytes

    def close(self):
        import os as _os
        try:
            _os.close(self._fd)
        except OSError:
            pass


class AlsaAudioSink(AudioSink):
    """ALSA pcm playback via ctypes libasound — the reference's
    device-output capability (src/pulse.c / src/jack.c class). Cleanly
    gated: raises RuntimeError when libasound is absent (this image has no
    sound stack); `available()` lets callers pick a fallback."""

    @staticmethod
    def available() -> bool:
        import ctypes.util
        return ctypes.util.find_library("asound") is not None

    def __init__(self, device: str = "default", rate: int = 44100,
                 channels: int = 2):
        import ctypes
        import ctypes.util
        lib = ctypes.util.find_library("asound")
        if lib is None:
            raise RuntimeError("libasound not available")
        a = ctypes.CDLL(lib)
        self._a = a
        self._pcm = ctypes.c_void_p()
        # SND_PCM_STREAM_PLAYBACK = 0, blocking mode
        if a.snd_pcm_open(ctypes.byref(self._pcm), device.encode(), 0, 0):
            raise RuntimeError(f"cannot open ALSA device {device!r}")
        # s16le interleaved; SND_PCM_FORMAT_S16_LE=2, ACCESS_RW_INTERLEAVED=3
        if a.snd_pcm_set_params(self._pcm, 2, 3, channels, rate, 1,
                                100000):  # 100 ms max latency
            raise RuntimeError("snd_pcm_set_params failed")
        self.channels = channels
        self.frames = 0

    def write(self, block, rate):
        import ctypes
        pcm = np.clip(np.asarray(block, np.float32), -1.0, 1.0)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if pcm.shape[1] != self.channels:
            # device frame = self.channels samples: a mono block passed
            # as-is would make snd_pcm_writei read past the buffer
            pcm = to_channels(pcm, self.channels)
        data = np.ascontiguousarray((pcm * 32767.0).astype("<i2"))
        n = len(data)
        r = self._a.snd_pcm_writei(
            self._pcm, data.ctypes.data_as(ctypes.c_void_p), n)
        if r < 0:
            self._a.snd_pcm_recover(self._pcm, r, 1)
        self.frames += n

    def close(self):
        if getattr(self, "_pcm", None):
            self._a.snd_pcm_close(self._pcm)
            self._pcm = None


class PulseAudioSink(AudioSink):
    """PulseAudio playback via ctypes libpulse-simple (the reference's
    pulse driver role, src/pulse.c:2324 — its pull-model callback loop
    collapses into the AudioPlayer feeder + this blocking-write sink).
    Gated: raises RuntimeError when libpulse-simple is absent; accepts an
    injected `lib` for mock tests."""

    @staticmethod
    def available() -> bool:
        import ctypes.util
        return ctypes.util.find_library("pulse-simple") is not None

    def __init__(self, app_name: str = "lives_tpu", rate: int = 44100,
                 channels: int = 2, lib=None):
        import ctypes
        import ctypes.util
        if lib is None:
            path = ctypes.util.find_library("pulse-simple")
            if path is None:
                raise RuntimeError("libpulse-simple not available")
            lib = ctypes.CDLL(path)
        self._p = lib
        if isinstance(lib, ctypes.CDLL):
            lib.pa_simple_new.restype = ctypes.c_void_p

        class SampleSpec(ctypes.Structure):
            _fields_ = [("format", ctypes.c_int),
                        ("rate", ctypes.c_uint32),
                        ("channels", ctypes.c_uint8)]
        ss = SampleSpec(3, rate, channels)  # PA_SAMPLE_S16LE = 3
        err = ctypes.c_int(0)
        # PA_STREAM_PLAYBACK = 1
        self._s = lib.pa_simple_new(None, app_name.encode(), 1, None,
                                    b"playback", ctypes.byref(ss), None,
                                    None, ctypes.byref(err))
        if not self._s:
            raise RuntimeError(f"pa_simple_new failed (err {err.value})")
        self.channels = channels
        self.frames = 0

    def write(self, block, rate):
        import ctypes
        pcm = np.clip(np.asarray(block, np.float32), -1.0, 1.0)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if pcm.shape[1] != self.channels:
            pcm = to_channels(pcm, self.channels)
        data = np.ascontiguousarray((pcm * 32767.0).astype("<i2"))
        err = ctypes.c_int(0)
        self._p.pa_simple_write(self._s,
                                data.ctypes.data_as(ctypes.c_void_p),
                                data.nbytes, ctypes.byref(err))
        self.frames += len(data)

    def close(self):
        import ctypes
        if getattr(self, "_s", None):
            err = ctypes.c_int(0)
            self._p.pa_simple_drain(self._s, ctypes.byref(err))
            self._p.pa_simple_free(self._s)
            self._s = None


def best_audio_sink(rate: int = 44100) -> AudioSink:
    """Pick the most real output available: JACK > PulseAudio > ALSA
    device > null (the reference's audio-player preference order,
    prefs->audio_player; `lives_tpu/audio/fx.py:686-696`)."""
    from .jack import load_libjack
    if load_libjack() is not None:
        try:
            from .jack import JackAudioSink
            return JackAudioSink()
        except RuntimeError:
            pass
    if PulseAudioSink.available():
        try:
            return PulseAudioSink(rate=rate)
        except RuntimeError:
            pass
    if AlsaAudioSink.available():
        try:
            return AlsaAudioSink(rate=rate)
        except RuntimeError:
            pass
    return NullAudioSink()


class AlsaAudioSource:
    """External audio capture (the reference's pulse/jack capture path,
    src/pulse.c external audio): pull s16 blocks from an ALSA capture
    device as float32 (n, chans). Cleanly gated on libasound presence —
    this image ships no sound stack, so `available()` is the guard."""

    @staticmethod
    def available() -> bool:
        import ctypes.util
        return ctypes.util.find_library("asound") is not None

    def __init__(self, device: str = "default", rate: int = 44100,
                 channels: int = 2):
        import ctypes
        import ctypes.util
        lib = ctypes.util.find_library("asound")
        if lib is None:
            raise RuntimeError("libasound not available")
        a = ctypes.CDLL(lib)
        self._a = a
        self._pcm = ctypes.c_void_p()
        # SND_PCM_STREAM_CAPTURE = 1
        if a.snd_pcm_open(ctypes.byref(self._pcm), device.encode(), 1, 0):
            raise RuntimeError(f"cannot open ALSA capture {device!r}")
        if a.snd_pcm_set_params(self._pcm, 2, 3, channels, rate, 1, 100000):
            raise RuntimeError("snd_pcm_set_params failed")
        self.rate = rate
        self.channels = channels

    def read(self, n: int = 1024) -> np.ndarray:
        import ctypes
        buf = np.zeros((n, self.channels), "<i2")
        got = self._a.snd_pcm_readi(
            self._pcm, buf.ctypes.data_as(ctypes.c_void_p), n)
        if got < 0:
            self._a.snd_pcm_recover(self._pcm, got, 1)
            return np.zeros((n, self.channels), np.float32)
        return buf[:got].astype(np.float32) / 32768.0

    def close(self):
        if getattr(self, "_pcm", None):
            self._a.snd_pcm_close(self._pcm)
            self._pcm = None


def _audio_volume(block, p, state):
    """audio_volume.c: independent left/right channel gains (the realtime
    per-track volume plugin; the multitrack mixer's avol role)."""
    out = block.copy()
    gains = (p["left"], p["right"])
    for ch in range(min(out.shape[1], 2)):
        out[:, ch] *= gains[ch]
    if out.shape[1] > 2:
        out[:, 2:] *= (gains[0] + gains[1]) / 2.0
    # no clamp: headroom must survive between chained gain stages
    # (audio_volume.c scales without clipping; the sink clips)
    return out, state


register_audio_filter(AudioFilter(
    "audio_volume", _audio_volume, {"left": 1.0, "right": 1.0},
    "per-channel volume (audio_volume.c)"))
