"""Clip audio editing — the reference's Audio menu, in-process.

Succeeds `src/callbacks.c` `on_fade_audio_activate`:11832 (fade in/out
over leading/trailing seconds or the frame selection),
`on_normalise_audio_activate`:11520 (peak-normalise to 0.95),
`on_trim_audio_activate`:11748 (trim/pad audio to the selection or to
[0, t]), `on_del_audio_activate`:11958 (delete selection / all / span),
`on_ins_silence_activate`:12416 (insert silence over the selection),
`on_append_audio_activate`:11577 (append audio from a file), plus the
"Adjust Audio Sync" offset shift. The reference shells these out to the
smogrify backend (`trim_audio`, `insert_silence`, `append_audio`); here
they are vectorised numpy over the clip's on-disk PCM
(`io/clips.py read_audio/write_audio`).

Every mutating op snapshots a one-slot audio undo on the clip
(`undo_audio`), mirroring the single-level undo of the reference's
audio menu items.

Counterpart of `lives_tpu/audioedit.py:1-201`, host numpy copied: clip
audio lives on the host in both packages, and the results are sample for
sample the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fade_in", "fade_out", "fade_span", "normalize", "voladj",
    "trim_pad", "delete_span", "insert_silence", "append_audio",
    "adjust_sync", "undo_audio",
]


def _rate(clip) -> int:
    r = int(getattr(clip, "arate", 0) or 0)
    if r <= 0:
        raise RuntimeError("clip has no audio rate")
    return r


def _snapshot(clip, a: np.ndarray):
    clip._audio_undo = (a.copy(), int(getattr(clip, "arate", 0)))


def _commit(clip, a: np.ndarray, rate: int | None = None):
    clip.write_audio(a, rate)
    if hasattr(clip, "save_header"):
        clip.save_header()


def undo_audio(clip) -> bool:
    """Restore the last snapshot (single-level, like the reference's
    audio-menu undo)."""
    snap = getattr(clip, "_audio_undo", None)
    if snap is None:
        return False
    a, rate = snap
    clip._audio_undo = None
    _commit(clip, a, rate or None)
    return True


def _span_samples(clip, start_s: float, end_s: float) -> tuple[int, int]:
    r = _rate(clip)
    s = max(0, int(round(float(start_s) * r)))
    e = max(s, int(round(float(end_s) * r)))
    return s, e


# -- gain ramps ---------------------------------------------------------


def fade_span(clip, start_s: float, end_s: float,
              from_gain: float, to_gain: float) -> None:
    """Linear gain ramp over [start_s, end_s] (the engine under both
    fade directions and the selection variant)."""
    a = clip.read_audio()
    s, e = _span_samples(clip, start_s, end_s)
    e = min(e, len(a))
    if e <= s:
        return
    _snapshot(clip, a)
    ramp = np.linspace(float(from_gain), float(to_gain), e - s,
                       dtype=np.float32)
    a = a.copy()
    a[s:e] *= ramp[:, None]
    _commit(clip, a)


def fade_in(clip, seconds: float) -> None:
    """0 -> 1 over the first `seconds` (callbacks.c type==0)."""
    fade_span(clip, 0.0, float(seconds), 0.0, 1.0)


def fade_out(clip, seconds: float) -> None:
    """1 -> 0 over the last `seconds` (callbacks.c type==1)."""
    a = clip.read_audio()
    total = len(a) / float(_rate(clip))
    fade_span(clip, max(0.0, total - float(seconds)), total, 1.0, 0.0)


def normalize(clip, target: float = 0.95) -> float:
    """Scale so the peak hits `target` (normalise_audio(..., .95)).
    Returns the gain applied."""
    a = clip.read_audio()
    peak = float(np.abs(a).max()) if len(a) else 0.0
    if peak <= 0.0:
        return 1.0
    _snapshot(clip, a)
    gain = float(target) / peak
    _commit(clip, a * gain)
    return gain


def voladj(clip, gain: float) -> None:
    """'Change clip volume...' — flat gain (clipped on write)."""
    a = clip.read_audio()
    _snapshot(clip, a)
    _commit(clip, a * float(gain))


# -- structural edits -----------------------------------------------------


def trim_pad(clip, start_s: float, end_s: float) -> None:
    """Audio becomes exactly [start_s, end_s]: trimmed when inside the
    existing audio, zero-padded when beyond it (trim_audio backend op;
    'Trim/Pad Audio to Selection')."""
    a = clip.read_audio()
    s, e = _span_samples(clip, start_s, end_s)
    _snapshot(clip, a)
    out = np.zeros((e - s, a.shape[1] if a.ndim == 2 else 1), np.float32)
    lo, hi = min(s, len(a)), min(e, len(a))
    out[lo - s:hi - s] = a[lo:hi]
    _commit(clip, out)


def delete_span(clip, start_s: float | None = None,
                end_s: float | None = None) -> None:
    """Delete audio over [start_s, end_s]; both None = delete all
    (on_del_audio type 1); the span variant removes the samples and
    closes the gap (type 0/2)."""
    a = clip.read_audio()
    _snapshot(clip, a)
    if start_s is None and end_s is None:
        _commit(clip, a[:0])
        return
    s, e = _span_samples(clip, start_s or 0.0,
                         end_s if end_s is not None
                         else len(a) / float(_rate(clip)))
    e = min(e, len(a))
    _commit(clip, np.concatenate([a[:s], a[e:]], axis=0))


def insert_silence(clip, start_s: float, end_s: float) -> None:
    """Insert (end_s - start_s) of silence at start_s, shifting the
    rest right (on_ins_silence over the selection). A clip with no
    audio yet gains a silent track at its arate (has_new_audio path)."""
    r = _rate(clip)
    a = clip.read_audio()
    s, e = _span_samples(clip, start_s, end_s)
    _snapshot(clip, a)
    ch = a.shape[1] if a.ndim == 2 and a.shape[1] else 1
    if len(a) < s:                      # pad up to the insert point
        a = np.concatenate([a, np.zeros((s - len(a), ch), np.float32)])
    gap = np.zeros((e - s, ch), np.float32)
    _commit(clip, np.concatenate([a[:s], gap, a[s:]], axis=0))


def append_audio(clip, data: np.ndarray, rate: int) -> None:
    """Append (n, ch) samples at `rate` to the end, resampling and
    channel-matching to the clip (on_append_audio_activate)."""
    from .audio.engine import resample, to_channels
    a = clip.read_audio()
    ch = a.shape[1] if len(a) else max(int(getattr(clip, "achans", 0)), 1)
    data = np.atleast_2d(np.asarray(data, np.float32))
    if data.shape[0] < data.shape[1]:
        data = data.T
    r = int(getattr(clip, "arate", 0)) or int(rate)
    if int(rate) != r:
        data = resample(data, float(rate), float(r))
    data = to_channels(data, ch)
    _snapshot(clip, a)
    if not len(a):
        _commit(clip, data, r)
    else:
        _commit(clip, np.concatenate([a, data], axis=0))


def adjust_sync(clip, offset_s: float) -> None:
    """'Adjust Audio Sync': positive offset delays the audio (silence
    prepended), negative advances it (samples cut from the start)."""
    r = _rate(clip)
    a = clip.read_audio()
    n = int(round(abs(float(offset_s)) * r))
    if n == 0:
        return
    _snapshot(clip, a)
    ch = a.shape[1] if a.ndim == 2 and a.shape[1] else 1
    if offset_s > 0:
        out = np.concatenate([np.zeros((n, ch), np.float32), a], axis=0)
    else:
        out = a[min(n, len(a)):]
    _commit(clip, out)
