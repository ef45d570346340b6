"""Audio analysers: FFT probe + beat detector (reference
`lives-plugins/weed-plugins/audio_fft.c`, `beat_detector.c`).

Counterpart of `lives_tpu/audio/analysers.py:1-108`, copied (host numpy);
the out-params equal the JAX ones for the same blocks.

These are audio filters whose OUT-parameters feed video-effect parameters
through data connections (effects/data.py pconx) — the canonical VJ
automation loop: music -> band energy / onsets -> any filter knob.

- `audio_fft`: mean spectral magnitude around a requested frequency
  (audio_fft.c:88-140: k = freq/rate*nsamps, |fft[k]| averaged over
  channels), normalised to ~0..1.
- `beat_detector`: the reference's scheme (beat_detector.c): slice the
  spectrum into NSLICES log-spaced bands (:25 freq table), keep ~1 s of
  per-band energy history (STIME), and flag a beat when enough bands
  exceed `varience` x their history average. Out-params `beat pulse`
  (1 only on the detecting block) and `beat hold` (sticky until read/
  reset, for slow consumers).

State is explicit (ring buffers in the instance state pytree), matching
the host's (block, params, state) contract.
"""

from __future__ import annotations

import numpy as np

from ..effects.host import Param
from .fx import AudioFilter, register_audio_filter

#: beat_detector.c:25 — band edges in Hz (NSLICES = 54)
FREQ_SLICES = np.array([
    25., 50., 75., 100., 150., 200., 250., 300., 400., 500., 600.,
    700., 800., 900., 1000., 1100., 1200., 1300., 1400.,
    1600., 1800., 2000., 2200., 2400., 2600., 2800., 3000.,
    3200., 3600., 4000., 4400., 4800., 5200., 5600., 6000., 6400., 6800.,
    7400., 8000., 8600., 9200., 9800., 10400., 11000., 11600.,
    12400., 13200., 14000., 14800., 15600., 16400., 17600., 18800., 20000.])

HIST_BLOCKS = 48  # ~1.1 s of 1024-sample blocks at 44.1k (STIME analogue)


def _mono(block: np.ndarray) -> np.ndarray:
    b = np.asarray(block, np.float32)
    return b.mean(axis=1) if b.ndim == 2 else b


def _fft_process(block, p, state):
    rate = int(p.get("rate", 44100))
    x = _mono(block)
    spec = np.abs(np.fft.rfft(x))
    k = int(round(p["freq"] / rate * len(x)))
    k = max(0, min(k, len(spec) - 1))
    # +/-1 bin mean, normalised by block length (bounded ~0..1 for
    # full-scale input)
    lo, hi = max(0, k - 1), min(len(spec), k + 2)
    val = float(spec[lo:hi].mean()) / (len(x) / 2)
    return block, None, {"value": min(val, 1.0)}


register_audio_filter(AudioFilter(
    name="audio_fft", process=_fft_process,
    params={"freq": 2000.0, "rate": 44100},
    out_params=(Param("value", "num", 0.0, 0.0, 1.0),),
    description="spectral magnitude at a frequency (audio_fft.c)"))


def _band_energies(x: np.ndarray, rate: int) -> np.ndarray:
    spec = np.abs(np.fft.rfft(x)) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / rate)
    idx = np.searchsorted(freqs, FREQ_SLICES)
    out = np.zeros(len(FREQ_SLICES), np.float64)
    lo = 0
    for i, hi in enumerate(idx):
        out[i] = spec[lo:hi].sum() if hi > lo else 0.0
        lo = hi
    return out


def _beat_process(block, p, state):
    rate = int(p.get("rate", 44100))
    x = _mono(block)
    if state is None:
        state = {"hist": np.zeros((HIST_BLOCKS, len(FREQ_SLICES))),
                 "n": 0, "hold": 0.0}
    e = _band_energies(x, rate)
    n = state["n"]
    hist = state["hist"]
    filled = min(n, HIST_BLOCKS)
    beat = 0.0
    if filled >= 8:
        avg = hist[:filled].mean(axis=0) + 1e-12
        over = (e > p["varience"] * avg)
        # reference: beat when enough low bands fire (bass-led onsets)
        need = max(1, int(p["sensitivity"] * len(FREQ_SLICES)))
        if over[: len(FREQ_SLICES) // 2].sum() >= need:
            beat = 1.0
    hist[n % HIST_BLOCKS] = e
    state["n"] = n + 1
    state["hold"] = max(state["hold"] * p["decay"], beat)
    return block, state, {"beat pulse": beat, "beat hold": state["hold"]}


register_audio_filter(AudioFilter(
    name="beat_detector", process=_beat_process,
    params={"varience": 1.5, "sensitivity": 0.1, "decay": 0.97,
            "rate": 44100},
    out_params=(Param("beat pulse", "num", 0.0, 0.0, 1.0),
                Param("beat hold", "num", 0.0, 0.0, 1.0)),
    description="band-energy onset detector (beat_detector.c)"))
