"""Audio engine: conversion, resampling, mixing, event-list rendering.

Counterpart of `lives_tpu/audio/engine.py:1-435`, copied (host numpy; the
JAX module imports no framework, but importing it would import the JAX
package). Every function computes what the JAX one computes, sample for
sample. Successor of `src/audio.c` (`sample_move_*` :714-1393 —
S8/S16/float interleave/deinterleave/resample/reverse;
`render_audio_segment` :1686 — offline mix-down of per-track clip audio
with volumes & velocities).

Internally everything is float32 (n, channels) in [-1, 1]; conversions to
S8/S16 happen at IO edges. Velocity-aware resampling (trickplay scratching)
uses the same linear-interpolation policy as the reference's pulse/jack
feeders.
"""

from __future__ import annotations

import numpy as np


def sample_convert(raw: bytes | np.ndarray, sampsize: int = 16,
                   signed: bool = True, big_endian: bool = False,
                   channels: int = 2, interleaved: bool = True) -> np.ndarray:
    """Decode raw pcm -> float32 (n, channels)."""
    if isinstance(raw, (bytes, bytearray)):
        if sampsize == 16:
            dt = (">" if big_endian else "<") + ("i2" if signed else "u2")
            a = np.frombuffer(raw, dt).astype(np.float32)
            a = a / 32768.0 if signed else (a - 32768.0) / 32768.0
        elif sampsize == 8:
            if signed:
                a = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
            else:
                a = (np.frombuffer(raw, np.uint8).astype(np.float32)
                     - 128.0) / 128.0
        elif sampsize == 32:
            a = np.frombuffer(raw, ("<" if not big_endian else ">") + "f4")
            a = a.astype(np.float32)
        else:
            raise ValueError(f"sampsize {sampsize}")
    else:
        a = np.asarray(raw, np.float32).reshape(-1)
    n = len(a) // channels
    a = a[: n * channels]
    return a.reshape(n, channels) if interleaved \
        else a.reshape(channels, n).T


def sample_encode(data: np.ndarray, sampsize: int = 16,
                  signed: bool = True, big_endian: bool = False) -> bytes:
    """float32 (n, channels) -> raw interleaved pcm bytes."""
    d = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    if sampsize == 16:
        i = np.clip(d * 32767.0, -32768, 32767)
        if not signed:
            i = i + 32768.0
        dt = (">" if big_endian else "<") + ("i2" if signed else "u2")
        return i.astype(dt).tobytes()
    if sampsize == 8:
        if signed:
            return np.clip(d * 127.0, -128, 127).astype(np.int8).tobytes()
        return (np.clip(d * 127.0, -128, 127) + 128).astype(np.uint8).tobytes()
    if sampsize == 32:
        return d.astype(("<" if not big_endian else ">") + "f4").tobytes()
    raise ValueError(f"sampsize {sampsize}")


def resample(data: np.ndarray, from_rate: float, to_rate: float) -> np.ndarray:
    """Linear-interp resample (n, ch) (sample_move_d16_d16 policy)."""
    if from_rate == to_rate or len(data) == 0:
        return data
    n_out = int(round(len(data) * to_rate / from_rate))
    x = np.arange(n_out, dtype=np.float64) * (from_rate / to_rate)
    i0 = np.minimum(x.astype(np.int64), len(data) - 1)
    i1 = np.minimum(i0 + 1, len(data) - 1)
    f = (x - i0)[:, None].astype(np.float32)
    return data[i0] * (1.0 - f) + data[i1] * f


def velocity_resample(data: np.ndarray, pos: float, velocity: float,
                      n_out: int) -> tuple[np.ndarray, float]:
    """Pull n_out frames starting at fractional `pos` advancing `velocity`
    source-frames per output frame (may be negative — reverse scratch).
    Returns (samples, new position). The realtime feeder primitive
    (audio.c / pulse.c velocity-aware pull)."""
    if len(data) == 0:
        return np.zeros((n_out, 1), np.float32), pos
    idx = pos + velocity * np.arange(n_out, dtype=np.float64)
    idx_mod = np.mod(idx, len(data))
    i0 = idx_mod.astype(np.int64)
    i1 = (i0 + 1) % len(data)
    f = (idx_mod - i0)[:, None].astype(np.float32)
    out = data[i0] * (1.0 - f) + data[i1] * f
    return out, float(np.mod(pos + velocity * n_out, len(data)))


def to_channels(data: np.ndarray, channels: int) -> np.ndarray:
    """Up/down-mix channel count (simple average / duplicate)."""
    if data.shape[1] == channels:
        return data
    if channels == 1:
        return data.mean(1, keepdims=True)
    if data.shape[1] == 1:
        return np.repeat(data, channels, 1)
    out = np.zeros((len(data), channels), np.float32)
    out[:, : data.shape[1]] = data[:, :channels]
    return out


def gain_to_db(g: float) -> float:
    return 20.0 * np.log10(max(g, 1e-10))


def db_to_gain(db: float) -> float:
    return float(10.0 ** (db / 20.0))


def mix_tracks(tracks: list[np.ndarray], vols: list[float] | None = None,
               clip: bool = True) -> np.ndarray:
    """Mix N (n, ch) tracks with per-track volume (the avol filter,
    events.c:2636 add_track_to_avol_init)."""
    if not tracks:
        return np.zeros((0, 2), np.float32)
    n = max(len(t) for t in tracks)
    ch = max(t.shape[1] for t in tracks)
    acc = np.zeros((n, ch), np.float32)
    vols = vols or [1.0] * len(tracks)
    for t, v in zip(tracks, vols):
        t = to_channels(t, ch)
        acc[: len(t)] += t * v
    return np.clip(acc, -1.0, 1.0) if clip else acc


def _avol_envelope(el, track: int, times: np.ndarray) -> np.ndarray:
    """Per-track gain at absolute timeline seconds from the avol filter's
    keyframed multi-valued volume pchain (events.c:2636 model; consumed
    by render_audio_segment at audio.c:1686)."""
    from ..events.event_list import EventType, TICKS_PER_SECOND
    init = next((e for e in el.events
                 if e.type == EventType.FILTER_INIT
                 and e.props.get("filter") == "avol"), None)
    if init is None:
        return np.ones(len(times), np.float32)
    tracks = init.props.get("in_tracks", [])
    if track not in tracks:
        return np.ones(len(times), np.float32)
    idx = tracks.index(track)
    vols = init.props.get("values", {}).get("volume", [])
    base = float(vols[idx]) if idx < len(vols) else 1.0
    pts = [(init.tc, base)]
    for pc in el.pchain(init.event_id, "volume"):
        v = pc.props["value"]
        if isinstance(v, (list, tuple)) and idx < len(v):
            pts.append((pc.tc, float(v[idx])))
    if len(pts) == 1:
        return np.full(len(times), base, np.float32)
    xp = np.asarray([t / TICKS_PER_SECOND for t, _ in pts], np.float64)
    fp = np.asarray([v for _, v in pts], np.float64)
    keep = np.concatenate([xp[1:] > xp[:-1], [True]])
    return np.interp(times, xp[keep], fp[keep]).astype(np.float32)


def _clip_audio_cached(clips: dict, cache: dict, uid, arate: int):
    if uid not in cache:
        clip = clips.get(uid)
        if clip is None:
            cache[uid] = (np.zeros((0, 1), np.float32), arate)
        else:
            if hasattr(clip, "read_audio"):
                data = clip.read_audio()
            elif isinstance(clip, np.ndarray):
                data = np.asarray(clip, np.float32)
            else:
                data = np.zeros((0, 1), np.float32)  # video-only source
            if data.ndim == 1:
                data = data[:, None]
            cache[uid] = (data, getattr(clip, "arate", arate) or arate)
    return cache[uid]


def render_timeline_audio(event_list, clips: dict, arate: int = 44100,
                          channels: int = 2,
                          legacy_fallback: bool = True) -> np.ndarray:
    """Mix a multitrack timeline's audio from the sparse per-track
    transition state machine on FRAME events (audio_clips/audio_seeks
    pairs, events.c:1251) with per-track avol volume envelopes —
    render_audio_segment's successor (audio.c:1686). Velocity-aware
    (reverse/speed audio blocks render as performed); audio past a clip's
    end is silence (no looping, matching the reference)."""
    from ..events.event_list import (EventType, TICKS_PER_SECOND,
                                     get_audio_entry)
    transitions: dict[int, list] = {}   # track -> [(tc, clip, seek, vel)]
    for e in event_list.events:
        if e.type != EventType.FRAME:
            continue
        ac = e.props.get("audio_clips")
        if not ac:
            continue
        for i in range(0, len(ac) - 1, 2):
            ent = get_audio_entry(e, ac[i])
            transitions.setdefault(ac[i], []).append(
                (e.tc, ent[0], ent[1], ent[2]))
    if not transitions:
        if legacy_fallback:
            # legacy timelines (no audio events): clip-placement fallback
            return render_audio(event_list, clips, arate, channels)
        frames0 = event_list.frame_events()
        tpf0 = TICKS_PER_SECOND / (event_list.fps or 25.0)
        end0 = (frames0[-1].tc + tpf0) if frames0 else 0
        return np.zeros((int(np.ceil(end0 / TICKS_PER_SECOND * arate))
                         + 1, channels), np.float32)
    frames = event_list.frame_events()
    tpf = TICKS_PER_SECOND / (event_list.fps or 25.0)
    end_tc = (frames[-1].tc + tpf) if frames else 0
    n_out = int(np.ceil(end_tc / TICKS_PER_SECOND * arate)) + 1
    acc = np.zeros((n_out, channels), np.float32)
    cache: dict = {}
    per_track_fx, master_fx = _audio_fx_chains(event_list, arate)
    for track, trs in transitions.items():
        # tracks with audio-filter regions get a full-length buffer so
        # the chain (reverb tails etc.) runs over contiguous audio;
        # others accumulate segment-wise
        fx = per_track_fx.get(track)
        tbuf = np.zeros((n_out, channels), np.float32) if fx else None
        for k, (tc, clip, seek, vel) in enumerate(trs):
            if clip < 0 or vel == 0.0:
                continue
            t1_tc = trs[k + 1][0] if k + 1 < len(trs) else end_tc
            t0 = tc / TICKS_PER_SECOND
            t1 = t1_tc / TICKS_PER_SECOND
            o0, o1 = int(round(t0 * arate)), min(int(round(t1 * arate)),
                                                 n_out)
            if o1 <= o0:
                continue
            data, src_rate = _clip_audio_cached(clips, cache, clip, arate)
            if not len(data):
                continue
            rel = np.arange(o1 - o0, dtype=np.float64) / arate
            pos = (seek + rel * vel) * src_rate
            valid = (pos >= 0) & (pos <= len(data) - 1)
            idx = np.clip(pos, 0, len(data) - 1)
            lo = idx.astype(np.int64)
            hi = np.minimum(lo + 1, len(data) - 1)
            frac = (idx - lo).astype(np.float32)[:, None]
            seg = data[lo] * (1.0 - frac) + data[hi] * frac
            seg[~valid] = 0.0
            seg = to_channels(seg, channels)
            env = _avol_envelope(event_list, track, t0 + rel)
            if tbuf is not None:
                tbuf[o0:o1] += seg * env[:, None]
            else:
                acc[o0:o1] += seg * env[:, None]
        if tbuf is not None:
            acc += _apply_timeline_audio_fx(event_list, tbuf, fx, arate)
    if master_fx:
        acc = _apply_timeline_audio_fx(event_list, acc, master_fx, arate)
    return np.clip(acc, -1.0, 1.0)


def _audio_fx_chains(el, arate: int):
    """Timeline audio-filter regions (FILTER_INIT events tagged
    audio=True, excluding avol) resolved to AudioInstances — the
    weed_apply_audio_instance-during-render role (effects-weed.c:2747,
    applied by render_audio_segment). Returns
    (track -> [(inst, init, tc0, tc1)], master list for inits with no
    in_tracks)."""
    from ..events.event_list import EventType
    from .fx import audio_instantiate
    per_track: dict[int, list] = {}
    master: list = []
    deinits = {e.props.get("init_event"): e.tc for e in el.events
               if e.type == EventType.FILTER_DEINIT}
    for e in el.events:
        if e.type != EventType.FILTER_INIT or not e.props.get("audio") \
                or e.props.get("filter") == "avol":
            continue
        try:
            inst = audio_instantiate(e.props["filter"])
        except KeyError:
            continue
        static = {k: v for k, v in e.props.get("values", {}).items()
                  if isinstance(v, (int, float))}
        inst.values.update(static)
        if "rate" in inst.filter.params:
            inst.values["rate"] = arate
        item = (inst, e, e.tc, deinits.get(e.event_id, 1 << 62))
        tracks = e.props.get("in_tracks") or []
        if tracks:
            for t in tracks:
                per_track.setdefault(t, []).append(item)
        else:
            master.append(item)
    return per_track, master


def _apply_timeline_audio_fx(el, buf: np.ndarray, items, arate: int,
                             block: int = 2048) -> np.ndarray:
    """Run audio-filter regions over `buf` in blocks, interpolating
    keyframed params (pchains) at each block start — interpolate_params
    for audio (effects-weed.c:10448 role)."""
    from ..events.event_list import EventType, TICKS_PER_SECOND
    from .fx import apply_audio_chain
    for inst, init, tc0, tc1 in items:
        s0 = max(0, int(tc0 / TICKS_PER_SECOND * arate))
        s1 = min(int(tc1 / TICKS_PER_SECOND * arate), len(buf))
        # interpolate every param that has an init value OR a pchain (a
        # keyframe on a param never set at init time must still apply)
        pchain_names = {e.props["param"] for e in el.events
                        if e.type == EventType.PARAM_CHANGE
                        and e.props.get("init_event") == init.event_id}
        names = [p for p in
                 (set(init.props.get("values", {})) | pchain_names)
                 if p in inst.filter.params]
        for o in range(s0, s1, block):
            for pname in names:
                v = el.interp_param(init, pname,
                                    int(o / arate * TICKS_PER_SECOND))
                if isinstance(v, (int, float)):
                    inst.values[pname] = float(v)
            buf[o: o + block] = apply_audio_chain(
                [inst], buf[o: o + block])
    return buf


def render_audio(event_list, clips: dict, arate: int = 44100,
                 channels: int = 2,
                 vols: dict[int, float] | None = None) -> np.ndarray:
    """render_audio_segment successor (audio.c:1686): mix the audio of every
    clip appearing on the timeline, aligned to its first FRAME event,
    resampled to `arate`, with per-track volumes."""
    from ..events.event_list import EventType, TICKS_PER_SECOND
    dur_ticks = event_list.duration_ticks
    n_out = int(np.ceil(dur_ticks / TICKS_PER_SECOND * arate)) + 1
    acc = np.zeros((n_out, channels), np.float32)
    placed: set[int] = set()
    for e in event_list.events:
        if e.type != EventType.FRAME:
            continue
        for track, clip_id in enumerate(e.clips):
            if clip_id in placed or clip_id not in clips:
                continue
            placed.add(clip_id)
            clip = clips[clip_id]
            if hasattr(clip, "read_audio"):
                audio = clip.read_audio()
            elif isinstance(clip, np.ndarray):
                audio = np.asarray(clip, np.float32)
            else:
                continue  # video-only source (generator, mem clip)
            if len(audio) == 0:
                continue
            src_rate = getattr(clip, "arate", arate) or arate
            audio = resample(to_channels(audio, channels), src_rate, arate)
            start = int(e.tc / TICKS_PER_SECOND * arate)
            seg = audio[: max(0, n_out - start)]
            v = (vols or {}).get(track, 1.0)
            acc[start: start + len(seg)] += seg * v
    return np.clip(acc, -1.0, 1.0)


def render_audio_from_seeks(event_list, clips: dict, arate: int = 44100,
                            channels: int = 2) -> np.ndarray:
    """Audio re-render of a recorded performance from per-frame audio
    seeks (reference render_audio_segment consuming the recorder's
    audio_clips/audio_seeks): between consecutive FRAME events the clip's
    audio plays from seek_i to seek_{i+1} — scratching, reverse and speed
    changes reproduce exactly as performed. Falls back to `render_audio`
    when no seeks were recorded. Accepts both the reference pair schema
    ([track, clip] / [seek, vel], events.c:1251) and this project's
    pre-0.3 singleton recordings."""
    from ..events.event_list import EventType, TICKS_PER_SECOND

    def rec_entry(ev):
        ac = ev.props.get("audio_clips") or []
        asx = ev.props.get("audio_seeks") or []
        if len(ac) >= 2 and len(asx) >= 2:     # pair schema
            return ac[1], float(asx[0])
        if ac:                                  # legacy singleton
            return ac[0], float(asx[0]) if asx else 0.0
        return None, 0.0
    evs = [e for e in event_list.events
           if e.type == EventType.FRAME and e.props.get("audio_seeks")]
    if len(evs) < 2:
        return render_audio(event_list, clips, arate, channels)
    dur_ticks = event_list.duration_ticks
    n_out = int(np.ceil(dur_ticks / TICKS_PER_SECOND * arate)) + 1
    acc = np.zeros((n_out, channels), np.float32)
    audio_cache: dict[int, tuple[np.ndarray, int]] = {}

    def clip_audio(uid):
        if uid not in audio_cache:
            clip = clips.get(uid)
            data = clip.read_audio() if hasattr(clip, "read_audio") \
                else np.zeros((0, channels), np.float32)
            audio_cache[uid] = (data, getattr(clip, "arate", arate)
                                or arate)
        return audio_cache[uid]

    # synthesize a terminal pseudo-event so the LAST frame's audio (to the
    # timeline end) renders too, instead of being silently dropped
    end_tc = max(dur_ticks, evs[-1].tc + TICKS_PER_SECOND / 25.0) \
        if evs else 0
    pairs = list(zip(evs[:-1], evs[1:])) + ([(evs[-1], None)] if evs else [])
    for a, b in pairs:
        uid, _ = rec_entry(a)
        data, src_rate = clip_audio(uid)
        if not len(data):
            continue
        t0 = a.tc / TICKS_PER_SECOND
        t1 = (b.tc if b is not None else end_tc) / TICKS_PER_SECOND
        o0, o1 = int(t0 * arate), min(int(t1 * arate), n_out)
        if o1 <= o0:
            continue
        dur = (o1 - o0) / arate
        s0 = rec_entry(a)[1] * src_rate
        b_uid = rec_entry(b)[0] if b is not None else None
        same_clip = b_uid == uid
        if same_clip:
            s1 = rec_entry(b)[1] * src_rate
            # a seek jump that one frame interval cannot explain (clip
            # switch artefact / loop wrap) would sweep the whole file as a
            # chirp: extrapolate at nominal velocity instead
            if abs(s1 - s0) > dur * src_rate * 8.0:
                s1 = s0 + dur * src_rate
        else:
            # clip switched (or last event): extrapolate forward
            s1 = s0 + dur * src_rate
        pos = np.linspace(s0, s1, o1 - o0, endpoint=False)
        idx = np.clip(pos, 0, len(data) - 1)
        lo = np.floor(idx).astype(np.int64)
        hi = np.minimum(lo + 1, len(data) - 1)
        frac = (idx - lo).astype(np.float32)[:, None]
        span = data[lo] * (1.0 - frac) + data[hi] * frac
        if span.shape[1] != channels:
            span = np.repeat(span[:, :1], channels, 1) \
                if span.shape[1] == 1 else span[:, :channels]
        acc[o0:o1] += span
    return np.clip(acc, -1.0, 1.0)
