"""The plain reference of a multitrack render: any frame of a timeline,
from the schedule the benchmark drew, computed afresh.

A frame of the timeline is: every track's synthetic clip frame; the
transitions folding tracks 1.. into track 0, in the order of the
segment's arrangement, each track t taking transition
`transitions[(t - 1 + arrangement) % n]`; then the effects; then the
sink's quantise. Parameters are constant but for the animated one, which
moves linearly from its segment's first frame to its last.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import ops


@dataclass
class Schedule:
    """A timeline as the benchmark drew it from the seed (host numpy)."""
    width: int
    height: int
    fps: float
    transitions: list      # names, in the arrangement-0 order
    effects: list          # [name, static values] each
    values: dict           # filter name -> {param: value}
    animate: tuple         # (filter name, param)
    clips: np.ndarray      # (F, T) int64 clip ids
    fnums: np.ndarray      # (F, T) int64 frame numbers
    segments: list         # [(first, stop, arrangement, a, b)], stop exclusive
    segment_of: np.ndarray  # (F,) segment index of each frame

    @property
    def n_frames(self) -> int:
        return self.clips.shape[0]

    @property
    def n_tracks(self) -> int:
        return self.clips.shape[1]

    def arrangement(self, j: int) -> int:
        return self.segments[self.segment_of[j]][2]

    def animated(self, j: int) -> float:
        """The animated parameter at frame j: a + (b - a) (j - first) /
        (last - first), in float64."""
        first, stop, _, a, b = self.segments[self.segment_of[j]]
        last = stop - 1
        return a if last == first else a + (b - a) * ((j - first)
                                                      / (last - first))

    def transition_at(self, track: int, arrangement: int) -> str:
        n = len(self.transitions)
        return self.transitions[(track - 1 + arrangement) % n]


def _params(sched: Schedule, name: str, js, dtype, device) -> dict:
    """{param: (N, 1, 1, 1)} for filter `name` at frames `js`, each value
    rounded to float32 first, as a parameter column carries it."""
    out = {}
    for k, v in sched.values[name].items():
        if (name, k) == tuple(sched.animate):
            col = np.asarray([sched.animated(j) for j in js], np.float32)
        else:
            col = np.full(len(js), v, np.float32)
        out[k] = torch.from_numpy(col).to(device).to(dtype).reshape(-1, 1, 1,
                                                                    1)
    return out


def frames(sched: Schedule, ids, dtype=torch.float32,
           device="cpu") -> torch.Tensor:
    """(N, 3, H, W) u8: timeline frames `ids`, computed in `dtype`."""
    ids = [int(j) for j in ids]
    out = torch.empty((len(ids), 3, sched.height, sched.width),
                      dtype=torch.uint8, device=device)
    groups: dict[int, list[int]] = {}
    for k, j in enumerate(ids):
        groups.setdefault(sched.arrangement(j), []).append(k)
    for arr, ks in groups.items():
        js = [ids[k] for k in ks]
        out[ks] = _frames_of(sched, js, arr, dtype, device)
    return out


def _frames_of(sched, js, arrangement, dtype, device):
    J = np.asarray(js)
    clips = torch.from_numpy(sched.clips[J]).to(device)
    fnums = torch.from_numpy(sched.fnums[J]).to(device)
    h, w = sched.height, sched.width

    def track(t):
        return ops.to_unit(ops.synthetic(clips[:, t], fnums[:, t], h, w),
                           dtype)
    comp = track(0)
    for t in range(1, sched.n_tracks):
        name = sched.transition_at(t, arrangement)
        comp = ops.TRANSITIONS[name](comp, track(t),
                                     _params(sched, name, js, dtype, device))
    for name, static in sched.effects:
        p = _params(sched, name, js, dtype, device)
        comp = (ops.gaussian_blur(comp, p, int(static["radius"]))
                if name == "gaussian_blur" else ops.EFFECTS[name](comp, p))
    return ops.quantise(comp)
