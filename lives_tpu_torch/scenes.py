"""The benchmark scene: a synthetic multitrack source and timeline.

Counterpart of `lives_tpu/scenes.py:22-142` (`DeviceSyntheticSource`,
`multitrack_timeline`, BASELINE.md config 4). The source's content formulas
are integer-exact with the JAX package's; the fused sweep kernel
(`csrc/fused_sweep.cu`, `gen`) evaluates the same formulas per pixel.
`traced_rows` generates a band of rows at clamped global rows, the
counterpart of `traced_tile` (`scenes.py:67`) for the band sweep's plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import Palette
from .events.event_list import (EventList, TICKS_PER_SECOND,
                                filter_init_event, filter_map_event,
                                frame_event, param_change_event)
from .layer import Layer


class DeviceSyntheticSource:
    """Deterministic per-(clip, frame) frames generated on `device`:
    clip-seeded gradients plus motion, integer arithmetic only."""

    def __init__(self, h: int, w: int, *, device: torch.device | str,
                 alpha: bool = False):
        self.h, self.w, self.alpha = h, w, alpha
        self.device = torch.device(device)

    @staticmethod
    def _channels(c, f, x, y):
        """int32 clip id `c`, frame `f`, pixel coords `x`/`y` (broadcastable
        int32 tensors) -> (r, g, b) int32 channels after the u8 wrap.

        `//` and `%` on torch integer tensors floor like JAX's (not like
        C's truncation), and int32 arithmetic wraps alike, so this is
        integer-exact with `lives_tpu/scenes.py:34`. A negative clip id is
        a blank track."""
        phase = c * 37 + f * 3
        blank = c < 0

        def chan(v):
            return torch.where(blank, 0, v & 0xFF)
        r = chan(x * (3 + c % 5) // 16 + phase)
        g = chan(y * (2 + c % 3) // 8 - phase * 2)
        b = chan((x + y) // 8 + phase * 5)
        return r, g, b

    def _make(self, clip_ids: torch.Tensor, frame_nums: torch.Tensor,
              y_lo: int = 0, y_hi: int | None = None) -> torch.Tensor:
        """(B,) clip ids and frame numbers -> (B, C, y_hi - y_lo, W) u8
        frames: rows [y_lo, y_hi) (all of them by default), each row index
        clamped to the frame."""
        w = self.w
        y_hi = self.h if y_hi is None else y_hi
        h = y_hi - y_lo
        B = clip_ids.shape[0]
        x = torch.arange(w, dtype=torch.int32, device=self.device)[None, None]
        y = torch.arange(y_lo, y_hi, dtype=torch.int32, device=self.device)
        if y_lo < 0 or y_hi > self.h:
            y = torch.clamp(y, 0, self.h - 1)
        y = y[None, :, None]
        c = clip_ids.to(device=self.device, dtype=torch.int32)[:, None, None]
        f = frame_nums.to(device=self.device, dtype=torch.int32)[:, None,
                                                                 None]
        chans = [v.to(torch.uint8).expand(B, h, w)
                 for v in self._channels(c, f, x, y)]
        if self.alpha:
            chans.append(torch.full((B, h, w), 255, dtype=torch.uint8,
                                    device=self.device))
        return torch.stack(chans, 1)

    def _palette(self) -> int:
        return int(Palette.RGBA32 if self.alpha else Palette.RGB24)

    def get_batch(self, clip_ids, frame_nums) -> Layer:
        """Host lists/arrays of clip ids and frame numbers -> one batched
        Layer (clip ids wrap to int32 like the JAX package's)."""
        c = torch.from_numpy(np.asarray(clip_ids).astype(np.int32))
        f = torch.from_numpy(np.asarray(frame_nums).astype(np.int32))
        return Layer(planes=(self._make(c, f),), palette=self._palette())

    def source_key(self):
        """Stable identity for plan caching."""
        return ("synthetic", self.h, self.w, self.alpha)

    def traced_layer(self, clip_ids: torch.Tensor,
                     frame_nums: torch.Tensor) -> Layer:
        """The plan's LOAD step: one track's batched Layer from device
        tensors (FrameGraph.run_batch source=...)."""
        return Layer(planes=(self._make(clip_ids, frame_nums),),
                     palette=self._palette())

    def traced_rows(self, clip_ids: torch.Tensor, frame_nums: torch.Tensor,
                    y_lo: int, y_hi: int) -> Layer:
        """Rows [y_lo, y_hi) of one track's frames as a batched Layer,
        (B, C, y_hi - y_lo, W); a row past the frame's edge repeats the
        edge row, as `traced_tile`'s clamped coordinates do."""
        if y_hi <= y_lo:
            raise ValueError(f"traced_rows: empty rows [{y_lo}, {y_hi})")
        return Layer(planes=(self._make(clip_ids, frame_nums, y_lo, y_hi),),
                     palette=self._palette())


def multitrack_timeline(n_tracks: int = 10, n_frames: int = 300,
                        width: int = 1920, height: int = 1080,
                        fps: float = 30.0) -> EventList:
    """n-track timeline: transitions folding tracks into track 0 + a
    per-frame fx chain, with an animated crossfade (BASELINE config 4).
    Event for event the same list as `lives_tpu/scenes.py:105` builds."""
    el = EventList(fps=fps, width=width, height=height)
    tpf = int(TICKS_PER_SECOND / fps)
    inits = []
    trans = ["crossfade", "blend_screen", "blend_overlay", "luma_key",
             "blend_add", "blend_multiply", "chroma_key", "blend_lighten",
             "blend_difference"]
    for t in range(1, n_tracks):
        name = trans[(t - 1) % len(trans)]
        vals = {"amount": 0.5} if name.startswith(("crossfade", "blend")) \
            else {}
        init = filter_init_event(0, name, in_tracks=[0, t], out_tracks=[0],
                                 values=vals)
        el.insert(init)
        inits.append(init)
    for name, vals in [("gaussian_blur", {"radius": 3, "amount": 0.6}),
                       ("colour_balance",
                        {"red": 1.1, "green": 1.0, "blue": 0.9}),
                       ("saturation", {"saturation": 1.3}),
                       ("vignette", {"amount": 0.7})]:
        init = filter_init_event(0, name, values=vals)
        el.insert(init)
        inits.append(init)
    el.insert(filter_map_event(0, [i.event_id for i in inits]))
    # animate the first crossfade over the timeline
    el.insert(param_change_event(0, inits[0].event_id, "amount", 0.0))
    el.insert(param_change_event((n_frames - 1) * tpf,
                                 inits[0].event_id, "amount", 1.0))
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, n_tracks + 1)),
                              [i] * n_tracks))
    return el
