"""Generator clips: a zero-input filter instance acting as a clip source.

Counterpart of `lives_tpu/io/genclip.py` (reference CLIP_TYPE_GENERATOR,
`weed_generator_start` effects-weed.c:7739): `GeneratorClip` with
`switch`, `cycle`, `maybe_autocycle`, `read_audio`, `version` and
`get_frame`, and `generate`, through which `FrameGraph.run` makes a
generator's frame in its slot.

A clip lives on one device, `device`, keyword-only and "cuda" by default:
it generates on the card unless the caller asks for the CPU, and nothing
falls back. `get_frame(n)` makes frame n at tc = n / fps as float32 and
frame n, with every traced parameter, in one (P+2, 1) float32 column, the
layout of `FrameGraph.run`'s; both generate through `generate`, so a
`GenSlot(clip, n)` there gives the same frame bit for bit. Frame numbers
ride as float32, exact to 2^24, as in the JAX package's packed live
path. A stateful
generator's state threads through `get_frame` under the clip's lock:
frames must be pulled in order for it to evolve. The frame is a one-frame
Layer with no batch axis, as the JAX package's.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..constants import Palette
from ..effects.host import (FILTER_STATEFUL, FrameContext, instantiate,
                            split_params)
from ..layer import Layer
from ..utils.transfer import pack_column
from ..utils.uid import stable_uid


class GeneratorClip:
    """Clip-like object backed by a generator filter; frames are functions
    of (frame number, params), generated on `device`."""

    def __init__(self, filter_name: str, width: int, height: int,
                 fps: float = 25.0, frames: int = 1 << 30,
                 audio_source=None, *, device="cuda", **values):
        self.inst = instantiate(filter_name, **values)
        if self.inst.filter.n_in != 0:
            raise ValueError(f"{filter_name} is not a generator")
        # switch() may run on a control thread while the player is inside
        # get_frame: the lock keeps the (filter, state) pair consistent
        self._lock = threading.Lock()
        self.width, self.height = width, height
        self.fps = fps
        self.frames = frames
        self.name = filter_name
        self.device = torch.device(device)
        self.version = 0
        # process-stable: recorded FRAME events reference this uid and must
        # resolve after a restart
        self.unique_id = stable_uid("gen", filter_name, width, height)
        self._state = None  # a stateful generator's state
        # an audio source: any object with render_at(pos, n) -> (n, ch)
        # float32 and .rate
        self.audio_source = audio_source
        self.arate = getattr(audio_source, "rate", 0) or 0
        self.achans = (getattr(audio_source, "channels", 2)
                       if audio_source is not None else 0)

    def switch(self, filter_name: str, **values):
        """Swap the backing generator filter in place (projectM preset
        switching): same clip slot, new program; the state restarts and
        `version` counts the switch."""
        inst = instantiate(filter_name, **values)
        if inst.filter.n_in != 0:
            raise ValueError(f"{filter_name} is not a generator")
        with self._lock:
            self.inst = inst
            self.name = filter_name
            self._state = None
            self.version += 1

    def cycle(self, step: int = 1) -> int:
        """Advance the preset playlist and switch in place. Returns the new
        position."""
        pl = getattr(self, "playlist", None)
        if not pl:
            raise RuntimeError("clip has no preset playlist")
        self.playlist_pos = (getattr(self, "playlist_pos", 0)
                             + int(step)) % len(pl)
        self.switch(pl[self.playlist_pos])
        return self.playlist_pos

    def maybe_autocycle(self, now: float) -> bool:
        """Time-based preset auto-switch: switches when `autocycle_secs` is
        set and has elapsed since the last switch. Returns True when a
        switch happened."""
        secs = getattr(self, "autocycle_secs", 0.0)
        if not secs or not getattr(self, "playlist", None):
            return False
        last = getattr(self, "_last_cycle", None)
        if last is None:
            self._last_cycle = now
            return False
        if now - last < secs:
            return False
        self._last_cycle = now
        self.cycle()
        return True

    def read_audio(self):
        """Clip-audio protocol. Unbounded generators (the frames=1<<30
        default) render one minute; finite clips their duration."""
        if self.audio_source is None:
            return np.zeros((0, 2), np.float32)
        dur = 60.0 if self.frames >= (1 << 29) else self.frames / self.fps
        return self.audio_source.render_at(0, int(dur * self.arate))

    def get_frame(self, n: int) -> Layer:
        """Frame n: a one-frame Layer, planes without a batch axis."""
        with self._lock:
            traced = split_params(self.inst)[1]
            names = sorted(traced)
            col = pack_column([traced[k] for k in names]
                              + [n / self.fps, n], self.device)
            out = self.generate(dict(zip(names, col)), col[-2], col[-1],
                                self.fps)
        return out.replace(planes=tuple(p[0] for p in out.planes))

    def generate(self, rows: dict, tc: torch.Tensor, frame: torch.Tensor,
                 fps: float) -> Layer:
        """The generator's frame at (tc, frame), float32 ``(1,)`` rows of a
        packed column, with `rows` (traced name -> row) over the static
        values and defaults; a one-frame batched Layer on the rows'
        device. `get_frame` and `FrameGraph.run` both generate through
        here, so a `GenSlot` gives `get_frame`'s frame bit for bit. A
        stateful generator's state threads through; the caller holds the
        lock where that matters."""
        filt = self.inst.filter
        params = {**{p.name: p.default for p in filt.params},
                  **split_params(self.inst)[0], **rows}
        ctx = FrameContext(tc=tc, frame=frame.to(torch.int32), fps=fps,
                           width=self.width, height=self.height,
                           device=tc.device)
        if not filt.flags & FILTER_STATEFUL:
            return filt.process([], params, ctx)
        if self._state is None and filt.init_state is not None:
            self._state = filt.init_state(self.width, self.height,
                                          int(Palette.RGB24), tc.device)
        out, self._state = filt.process([], params, ctx, self._state)
        return out
