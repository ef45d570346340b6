"""The multitrack render driver: `lives_tpu_torch.events.renderer.
render_events` over a timeline drawn from the seed, pass after pass.

The traffic mix (`traffic/<name>.json`) says how the timeline is cut:

- `cut_every`: frames between cuts (0: one segment). At a cut every track
  gets a new block (clip id and frame offset from the seed), and with
  `rotate` the transitions move one track along, so the chain changes;
- `sample_stride`, `sample_per_chunk`, `sample_slots`: the window's
  chunks sampled for the check, frames kept from each, and the buffer
  (`harness.Sampler`);
- `trace_chunks`: chunks in the traced stretch; `min_compared`: the
  fewest frames a correct run compares.

The configuration (`configs/<name>.json`) gives the geometry, the tracks,
the transitions and effects with the range of each parameter, the
animated parameter's ranges, the chunk and the timeline's length.
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np
import torch

from cardbench import harness, trace, work
from cardbench.reference import render as ref
from cardbench.reference.render import Schedule


def _draw(rng, spec):
    lo, hi = spec
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def schedule(cfg: dict, traffic: dict, seed: int) -> Schedule:
    """The timeline's clips, frame numbers, segments and parameter values,
    drawn from the seed. Every seed draws the same sizes and cuts."""
    rng = np.random.default_rng(seed)
    F, T = int(cfg["frames"]), int(cfg["tracks"])
    trans = list(cfg["transitions"])
    values = {name: {k: _draw(rng, spec) for k, spec in params.items()}
              for name, params in cfg["params"].items()}
    anim = cfg["animate"]
    cut = int(traffic["cut_every"]) or F
    r0 = int(rng.integers(len(trans))) if traffic["rotate"] else 0
    lo, hi = cfg["clip_ids"]
    clips = np.empty((F, T), np.int64)
    fnums = np.empty((F, T), np.int64)
    segments, segment_of = [], np.empty(F, np.int64)
    for si, first in enumerate(range(0, F, cut)):
        stop = min(first + cut, F)
        ids = rng.integers(lo, hi, size=T)
        offs = rng.integers(0, int(cfg["frame_offsets"]), size=T)
        clips[first:stop] = ids
        fnums[first:stop] = offs + np.arange(stop - first)[:, None]
        arr = (r0 + si) % len(trans) if traffic["rotate"] else 0
        segments.append((first, stop, arr, _draw(rng, anim["from"]),
                         _draw(rng, anim["to"])))
        segment_of[first:stop] = si
    return Schedule(width=int(cfg["width"]), height=int(cfg["height"]),
                    fps=float(cfg["fps"]), transitions=trans,
                    effects=[list(e) for e in cfg["effects"]], values=values,
                    animate=(anim["filter"], anim["param"]), clips=clips,
                    fnums=fnums, segments=segments, segment_of=segment_of)


def event_list(sched: Schedule):
    """The schedule as the event list a LiVES user's timeline records:
    per segment the inits of its chain (in its arrangement), the filter
    map, the animated parameter's two changes, and the previous
    segment's deinits; a FRAME event a frame."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_deinit_event,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event,
                                                   param_change_event)
    el = EventList(fps=sched.fps, width=sched.width, height=sched.height)
    tpf = int(TICKS_PER_SECOND / sched.fps)
    anim_filter, anim_param = sched.animate
    prev = []
    for si, (first, stop, arr, a, b) in enumerate(sched.segments):
        tc = first * tpf
        for e in prev:
            el.insert(filter_deinit_event(tc, e.event_id))
        chain = [(sched.transition_at(t, arr), {}, [0, t])
                 for t in range(1, sched.n_tracks)]
        chain += [(name, static, [0]) for name, static in sched.effects]
        inits = []
        for k, (name, static, tracks) in enumerate(chain):
            vals = {**static, **sched.values[name]}
            if name == anim_filter:
                vals[anim_param] = a
            init = filter_init_event(tc, name, in_tracks=tracks,
                                     out_tracks=[0], values=vals)
            init.event_id = f"s{si}f{k}"
            el.insert(init)
            inits.append(init)
            if name == anim_filter:
                el.insert(param_change_event(tc, init.event_id, anim_param,
                                             a))
                el.insert(param_change_event((stop - 1) * tpf, init.event_id,
                                             anim_param, b))
        el.insert(filter_map_event(tc, [e.event_id for e in inits]))
        prev = inits
    for j in range(sched.n_frames):
        el.insert(frame_event(j * tpf, sched.clips[j].tolist(),
                              sched.fnums[j].tolist()))
    return el


class Cell:
    """One run's set-up, window, traced stretch and check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
        from lives_tpu_torch.events.renderer import render_events
        from lives_tpu_torch.graph import SinkSpec, fused_sweep
        from lives_tpu_torch.scenes import DeviceSyntheticSource
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.sched = schedule(cfg, traffic, seed)
        # the sample buffer first, before any of the program's objects
        self.sampler = harness.Sampler(
            seed, int(traffic["sample_slots"]),
            (3, self.sched.height, self.sched.width), device,
            int(traffic["sample_stride"]), int(traffic["sample_per_chunk"]))
        self.el = event_list(self.sched)
        self.chunk = int(cfg["chunk"])
        self.tpf = int(TICKS_PER_SECOND / self.sched.fps)
        self._render_events, self._k1 = render_events, fused_sweep
        self.src = DeviceSyntheticSource(self.sched.height, self.sched.width,
                                         device=device)
        self.sink = SinkSpec(self.sched.width, self.sched.height)
        # warm: one whole pass builds every plan and loads every kernel
        for tcs, lay in self._chunks():
            self.sampler.buf[0].copy_(lay.planes[0][0])
        harness.sync(device)

    def _chunks(self):
        return self._render_events(self.el, self.src, self.sink,
                                   batch_size=self.chunk)

    def _passes(self):
        """Chunks of the timeline, pass after pass, without end."""
        while True:
            yield from self._chunks()

    def window(self, seconds: float) -> dict:
        self.sampler.reset()
        k1 = self._k1.MODE_LAUNCHES["u8"]
        frames = chunks = 0
        harness.sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for tcs, lay in self._passes():
            if self.sampler.wants(chunks):
                self.sampler.offer(chunks, lay.planes[0],
                                   [tc // self.tpf for tc in tcs])
            frames += len(tcs)
            chunks += 1
            if time.perf_counter() >= deadline:
                break
        harness.sync(self.device)
        t1 = time.perf_counter()
        return {"t0": t0, "window_s": t1 - t0, "frames": frames,
                "chunks": chunks,
                "k1_u8_launches": self._k1.MODE_LAUNCHES["u8"] - k1}

    def traced(self) -> dict | None:
        """The traced stretch: `trace_chunks` chunks from a pass's start
        under the profiler, after a one-chunk profile that starts the
        profiler's device tracing."""
        n = int(self.traffic["trace_chunks"])
        with harness.traced(self.device):
            next(iter(self._chunks()))
            harness.sync(self.device)
        chunks = frames = 0
        with harness.traced(self.device) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                for tcs, _ in trace.spanned(self._passes(), "render_events"):
                    frames += len(tcs)
                    chunks += 1
                    if chunks >= n:
                        break
                with trace.span("synchronize"):
                    harness.sync(self.device)
        out = trace.reduce(prof)
        if out is None:
            return None
        s = self.sched
        ops, nbytes = work.render_frame(s.n_tracks, s.transitions, s.effects,
                                        s.width, s.height)
        out.update(units=chunks, frames=frames, ops=ops * frames,
                   bytes=nbytes * frames)
        return out

    def release(self):
        """Drop the program's objects; keep the samples and the
        schedule."""
        self.el = self.src = None
        self._render_events = self._k1 = None

    def reference(self, ids, dtype=torch.float32) -> torch.Tensor:
        return ref.frames(self.sched, ids, dtype, self.device)


def control(cfg: dict, traffic: dict, seed: int, n: int, device):
    """(frame ids, reference(ids, dtype)) for the control: `n` frames of
    the seed's timeline, drawn from the seed."""
    sched = schedule(cfg, traffic, seed)
    rng = np.random.default_rng([seed, 0xC0])
    ids = sorted(int(j) for j in rng.choice(
        sched.n_frames, size=min(n, sched.n_frames), replace=False))
    return ids, lambda js, dtype: ref.frames(sched, js, dtype, device)


@contextlib.contextmanager
def fault(kind: str):
    """The timed path broken where it produces its frames: each chunk
    `render_events` yields holds the previous chunk's frames ("stale"), has its
    second half left unrendered ("half"), or has one value of every frame
    altered ("altered")."""
    from lives_tpu_torch.events import renderer
    orig = renderer.render_events

    def broken(*args, **kw):
        prev = None
        for tcs, lay in orig(*args, **kw):
            x = lay.planes[0]
            if kind == "stale":
                x, prev = (x if prev is None else prev[
                    torch.arange(x.shape[0]) % prev.shape[0]]), x
            elif kind == "half":
                x = x.clone()
                x[x.shape[0] // 2:] = 0
            elif kind == "altered":
                x = x.clone()
                x[:, 0, 0, 0] ^= 0x10
            else:
                raise ValueError(kind)
            yield tcs, lay.replace(planes=(x,))
    with mock.patch.object(renderer, "render_events", broken):
        yield


FAULTS = ("stale", "half", "altered")
