"""The plain reference of the live path: frame n of a VJ set, from the
schedule the benchmark drew, computed afresh.

Frame n keys plasma (track 0, at tc = n / fps) over colour bars (track
1) by luma_key, then runs the chain the set has on at n: the chains take
turns every `toggle` frames in the seed's order. Both layers enter as u8
/ 255; the key and the chain run in [0, 1] and the frame is quantised
once at the end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import ops


@dataclass
class Schedule:
    width: int
    height: int
    fps: float
    chains: list       # effect names each
    order: list        # chain index a turn, in the seed's order
    toggle: int        # frames a turn
    plasma: dict       # plasma's {param: value}
    key: tuple         # (key filter name, {param: value})
    values: dict       # effect name -> {param: value}

    def chain_at(self, n: int) -> int:
        return self.order[(n // self.toggle) % len(self.order)]


def _col(vals, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(vals, np.float32)).to(device) \
        .to(dtype).reshape(-1, 1, 1, 1)


def frames(sched: Schedule, ids, dtype=torch.float32,
           device="cpu") -> torch.Tensor:
    """(N, 3, H, W) u8: frames `ids` of the set, computed in `dtype`."""
    h, w = sched.height, sched.width
    bars = ops.to_unit(ops.colour_bars(1, h, w, device), dtype)
    key_name, key_values = sched.key
    key = {k: _col([v], dtype, device) for k, v in key_values.items()}
    out = []
    for n in (int(i) for i in ids):
        tc = _col([np.float32(n / sched.fps)], dtype, device).reshape(1)
        p = {k: _col([v], dtype, device) for k, v in sched.plasma.items()}
        fg = ops.to_unit(ops.plasma(tc, p, h, w), dtype)
        x = ops.TRANSITIONS[key_name](fg, bars, key)
        for name in sched.chains[sched.chain_at(n)]:
            x = ops.EFFECTS[name](x, {k: _col([v], dtype, device) for k, v
                                      in sched.values[name].items()})
        out.append(ops.quantise(x))
    return torch.cat(out)
