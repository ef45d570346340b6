"""fourKlives: the parametric tracker-synth audio generator.

Counterpart of `lives_tpu/audio/fourklives.py:1-209` (reference
`lives-plugins/weed-plugins/fourKlives.c`: `set_tempo` :60,
`set_base_freq` :66, `syna_play` :337). A tiny demoscene tracker renders
tune scripts (instruments with a waveform and an ADSR envelope, note
patterns per channel) into float audio at a tempo and base frequency.

Every block is a pure function of the absolute sample index, so a block
renders vectorised on the host and seeking is free: `render_at(pos, n)`
gives the block at any position without replaying history. `FourKLives`
has the audio-source protocol of `audio.fx.ToneSource` (`render_at` and
`rate`), so it is a clip's `audio_source` for `Player.attach_audio`. The
JAX module is numpy alone; the port keeps its own copy, sample for sample
the same.

Tune script format (the information of the reference's tunes/ syntax):

    tempo 120
    instr 0 wave=sqr a=0.005 d=0.08 s=0.5 r=0.05 vol=0.8
    pattern 0 c4 e4 g4 c5 g4 e4 c4 r
    chan 0 0 0            # channel 0 plays pattern 0 repeatedly
    chan 1 1 1

Notes are c..b with an optional '#' and an octave digit; 'r' or '-' is a
rest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

_NOTE_OFFSETS = {"c": 0, "d": 2, "e": 4, "f": 5, "g": 7, "a": 9, "b": 11}

DEFAULT_TUNE = """
tempo 125
instr 0 wave=sqr a=0.004 d=0.10 s=0.45 r=0.04 vol=0.55
instr 1 wave=saw a=0.002 d=0.06 s=0.30 r=0.03 vol=0.35
instr 2 wave=noise a=0.001 d=0.03 s=0.00 r=0.01 vol=0.30
pattern 0 c3 r g3 r a#3 r g3 r
pattern 1 c5 d#5 g5 c6 g5 d#5 c5 g4
pattern 2 r r c2 r r r c2 c2
chan 0 0 0 0 0
chan 1 1 1 1 1
chan 2 2 2 2 2
"""


def note_to_semitone(token: str) -> int | None:
    """'c4' -> semitone offset from c0; None = rest."""
    token = token.strip().lower()
    if not token or token in ("r", "-", "--"):
        return None
    base = _NOTE_OFFSETS.get(token[0])
    if base is None:
        return None
    i = 1
    if i < len(token) and token[i] == "#":
        base += 1
        i += 1
    octave = int(token[i:]) if token[i:] else 4
    return octave * 12 + base


@dataclass
class Instrument:
    wave: str = "sqr"      # sin | sqr | saw | noise
    attack: float = 0.005  # seconds
    decay: float = 0.08
    sustain: float = 0.5   # level 0..1
    release: float = 0.04
    vol: float = 0.6


@dataclass
class Tune:
    tempo: float = 120.0
    instruments: dict[int, Instrument] = field(default_factory=dict)
    patterns: dict[int, list[int | None]] = field(default_factory=dict)
    # channel -> (instrument id, sequence of pattern ids)
    channels: list[tuple[int, list[int]]] = field(default_factory=list)


def parse_tune(text: str) -> Tune:
    tune = Tune()
    for line in text.splitlines():
        # '#' is a comment only at line start / after whitespace (sharps
        # like d#5 contain it mid-token)
        if line.lstrip().startswith("#"):
            line = ""
        line = line.split(" #", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        kind = parts[0].lower()
        if kind == "tempo":
            tune.tempo = float(parts[1])
        elif kind == "instr":
            idx = int(parts[1])
            ins = Instrument()
            for kv in parts[2:]:
                k, _, v = kv.partition("=")
                if k == "wave":
                    ins.wave = v
                elif k in ("a", "d", "s", "r", "vol"):
                    setattr(ins, {"a": "attack", "d": "decay",
                                  "s": "sustain", "r": "release",
                                  "vol": "vol"}[k], float(v))
            tune.instruments[idx] = ins
        elif kind == "pattern":
            idx = int(parts[1])
            tune.patterns[idx] = [note_to_semitone(t) for t in parts[2:]]
        elif kind == "chan":
            chan = int(parts[1])
            seq = [int(t) for t in parts[2:]]
            while len(tune.channels) <= chan:
                tune.channels.append((len(tune.channels), []))
            tune.channels[chan] = (chan if chan in tune.instruments else 0,
                                   seq)
    return tune


def _wave(kind: str, phase: np.ndarray, t_abs: np.ndarray) -> np.ndarray:
    frac = phase - np.floor(phase)
    if kind == "sin":
        return np.sin(2 * np.pi * frac)
    if kind == "saw":
        return 2.0 * frac - 1.0
    if kind == "noise":
        # hash of the absolute sample index: deterministic, seek-free
        s = np.sin(t_abs.astype(np.float64) * 12.9898) * 43758.5453
        return ((s - np.floor(s)) * 2.0 - 1.0).astype(np.float64)
    return np.where(frac < 0.5, 1.0, -1.0)  # sqr


class FourKLives:
    """Tracker synth with block rendering. Thread-compatible with the
    AudioPlayer feeder: `render(n)` advances an internal position;
    `render_at(pos, n)` is the pure form."""

    def __init__(self, tune: str | Tune = DEFAULT_TUNE, rate: int = 44100,
                 channels: int = 2, base_freq: float = 440.0):
        self.tune = parse_tune(tune) if isinstance(tune, str) else tune
        self.rate = int(rate)
        self.channels = int(channels)
        self.base_freq = float(base_freq)
        self.pos = 0

    # reference set_tempo (fourKlives.c:60) / set_base_freq (:66)
    def set_tempo(self, tempo: float) -> None:
        self.tune.tempo = float(tempo)

    def set_base_freq(self, freq: float) -> None:
        self.base_freq = float(freq)

    @property
    def step_samples(self) -> int:
        # one row = a 16th note
        return max(1, int(self.rate * 60.0 / self.tune.tempo / 4.0))

    def _channel_block(self, instr: Instrument,
                       notes: list[int | None], pos: int,
                       n: int) -> np.ndarray:
        if not notes:
            return np.zeros(n)
        step = self.step_samples
        t = np.arange(pos, pos + n, dtype=np.int64)
        row = (t // step) % len(notes)
        offs = (t % step).astype(np.float64) / self.rate  # sec into row
        semis = np.array([(-1 if s is None else s) for s in notes],
                         np.int64)[row]
        active = semis >= 0
        # A4 = semitone 57 relative to c0; base_freq transposes the tune
        freq = self.base_freq * np.exp2((semis - 57) / 12.0)
        phase = offs * freq
        sig = _wave(instr.wave, phase, t)
        # ADSR over the row (retriggered each row, like the reference's
        # per-row instrument samples)
        a, d, s, r = instr.attack, instr.decay, instr.sustain, instr.release
        row_len = step / self.rate
        env = np.where(
            offs < a, offs / max(a, 1e-6),
            np.where(offs < a + d,
                     1.0 + (s - 1.0) * (offs - a) / max(d, 1e-6), s))
        env = np.where(offs > row_len - r,
                       env * np.maximum(row_len - offs, 0.0) / max(r, 1e-6),
                       env)
        return sig * env * instr.vol * active


    def render_at(self, pos: int, n: int) -> np.ndarray:
        """Pure block render: (n, channels) float32 at absolute sample pos."""
        mix = np.zeros(n, np.float64)
        for chan_idx, (instr_id, seq) in enumerate(self.tune.channels):
            instr = self.tune.instruments.get(
                instr_id, self.tune.instruments.get(0, Instrument()))
            # flatten the channel's pattern sequence into one note list
            notes: list[int | None] = []
            for pid in (seq or [0]):
                notes.extend(self.tune.patterns.get(pid, [None]))
            mix += self._channel_block(instr, notes, pos, n)
        mix = np.tanh(mix)  # soft clip the mix bus
        return np.repeat(mix[:, None], self.channels, 1).astype(np.float32)

    def render(self, n: int) -> np.ndarray:
        out = self.render_at(self.pos, n)
        self.pos += n
        return out
