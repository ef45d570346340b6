"""The live driver: `lives_tpu_torch.graph.FrameGraph.run` one frame at a
time in a closed loop, as a display sink waits for each frame.

Each frame is one `run` over the configuration's two generator layers
(bare `GeneratorClip`s generated on the set's clock), the first keyed
over the second by the configuration's key filter and then through the
chain on, ended by `torch.cuda.synchronize()`; the next starts when it
returns. The clock advances one frame (1 / fps) a frame, from a start
frame drawn from the seed, and the chain on shows the configuration's
chains in turns of `toggle_every` frames, in an order drawn from the
seed. Each frame's latency is its `run` call to the return of its
synchronise.

The traffic mix (`traffic/<name>.json`): `toggle_every`; `sample_stride`
and `sample_slots` (every stride-th frame offered to the check's sample,
from a phase the seed draws, and the buffer, `harness.Sampler`);
`trace_frames` (frames in the traced stretch);
`min_compared`.
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np
import torch

from cardbench import harness, trace, work
from cardbench.reference import live as ref
from cardbench.reference.live import Schedule

#: frames before the window's start that warm the loop up
WARM = 200


def _draw(rng, spec):
    lo, hi = spec
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def schedule(cfg: dict, traffic: dict, seed: int) -> tuple[Schedule, int]:
    """(the set, its first frame), drawn from the seed: the chains' order,
    the parameters, the start frame. Every seed plays every chain for the
    same share of frames."""
    rng = np.random.default_rng(seed)
    gen, gen_params = cfg["layers"][0]
    chains = [list(c) for c in cfg["chains"]]
    order = [int(i) for i in rng.permutation(len(chains))]
    plasma = {k: _draw(rng, spec) for k, spec in gen_params.items()}
    key_name, key_params = cfg["key"]
    key = (key_name, {k: _draw(rng, spec) for k, spec in key_params.items()})
    values = {name: {k: _draw(rng, spec) for k, spec in params.items()}
              for name, params in cfg["params"].items()}
    lo, hi = cfg["start_frame"]
    start = int(rng.integers(lo, hi))
    return Schedule(width=int(cfg["width"]), height=int(cfg["height"]),
                    fps=float(cfg["fps"]), chains=chains, order=order,
                    toggle=int(traffic["toggle_every"]), plasma=plasma,
                    key=key, values=values), start


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from lives_tpu_torch.effects.host import instantiate
        from lives_tpu_torch.graph import FrameGraph, SinkSpec
        from lives_tpu_torch.io.genclip import GeneratorClip
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.sched, self.start = schedule(cfg, traffic, seed)
        s = self.sched
        if self.start < WARM:
            raise ValueError(f"start frame {self.start} under {WARM}")
        # the sample buffer first, before any of the program's objects
        self.sampler = harness.Sampler(
            seed, int(traffic["sample_slots"]), (3, s.height, s.width),
            device, int(traffic["sample_stride"]))
        gen, _ = cfg["layers"][0]
        layers = [GeneratorClip(gen, s.width, s.height, fps=s.fps,
                                device=device, **s.plasma)]
        layers += [GeneratorClip(name, s.width, s.height, fps=s.fps,
                                 device=device, **values)
                   for name, values in cfg["layers"][1:]]
        self.layers = layers
        sink = SinkSpec(width=s.width, height=s.height)
        key_name, key_values = s.key
        self.graphs = [FrameGraph([instantiate(key_name, **key_values)]
                                  + [instantiate(n, **s.values[n]) for n in c],
                                  sink, fps=s.fps) for c in s.chains]
        # warm: every chain, then the loop itself over the frames before
        # the window's
        for g in self.graphs:
            g.run(self.layers, 0.0, 0)
        for n in range(self.start - WARM, self.start):
            self._frame(n)
            harness.sync(device)
        self.sampler.buf[0].copy_(self._frame(self.start - 1))
        harness.sync(device)

    def _frame(self, n: int) -> torch.Tensor:
        g = self.graphs[self.sched.chain_at(n)]
        return g.run(self.layers, n / self.sched.fps, n).planes[0]

    def window(self, seconds: float) -> dict:
        self.sampler.reset()
        lat = []
        i = 0
        harness.sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        now = t0
        while now < deadline:
            n = self.start + i
            ts = time.perf_counter()
            out = self._frame(n)
            harness.sync(self.device)
            now = time.perf_counter()
            lat.append((now - ts) * 1e3)
            if self.sampler.wants(i):
                self.sampler.offer(i, out[None], [n])
                harness.sync(self.device)
                now = time.perf_counter()
            i += 1
        t1 = time.perf_counter()
        self.next = self.start + i
        return {"t0": t0, "window_s": t1 - t0, "frames": i,
                "latencies_ms": lat}

    def traced(self) -> dict | None:
        """`trace_frames` frames after the window's, profiled, after a
        one-frame profile that starts the profiler's device tracing."""
        n_frames = int(self.traffic["trace_frames"])
        with harness.traced(self.device):
            self._frame(self.next)
            harness.sync(self.device)
        first = self.next + 1
        with harness.traced(self.device) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                for n in range(first, first + n_frames):
                    with trace.span("FrameGraph.run"):
                        self._frame(n)
                    with trace.span("synchronize"):
                        harness.sync(self.device)
        out = trace.reduce(prof)
        if out is None:
            return None
        s = self.sched
        costs = [work.live_frame(s.key[0], s.chains[s.chain_at(n)],
                                 s.width, s.height)
                 for n in range(first, first + n_frames)]
        out.update(units=n_frames, frames=n_frames,
                   ops=sum(c[0] for c in costs),
                   bytes=sum(c[1] for c in costs))
        return out

    def release(self):
        self.graphs = self.layers = None

    def reference(self, ids, dtype=torch.float32) -> torch.Tensor:
        return ref.frames(self.sched, ids, dtype, self.device)


def control(cfg: dict, traffic: dict, seed: int, n: int, device):
    """(frame numbers, reference(ids, dtype)) for the control: `n` frames
    of the seed's set, one in `sample_stride` from its start."""
    sched, start = schedule(cfg, traffic, seed)
    stride = int(traffic["sample_stride"])
    rng = np.random.default_rng([seed, 0xC0])
    ids = [start + i * stride + int(rng.integers(stride)) for i in range(n)]
    return ids, lambda js, dtype: ref.frames(sched, js, dtype, device)


@contextlib.contextmanager
def fault(kind: str):
    """The timed path broken where it produces its frames: each
    `FrameGraph.run` returns the previous call's frame ("stale") or its
    frame with one value altered ("altered"). The live frame is a batch of
    one, so no half of a batch can be left out."""
    from lives_tpu_torch.graph import nodemodel
    orig = nodemodel.FrameGraph.run
    prev = []

    def broken(self, *args, **kw):
        out = orig(self, *args, **kw)
        if kind == "stale":
            prev.append(out)
            return prev.pop(0) if len(prev) > 1 else out
        if kind == "altered":
            x = out.planes[0].clone()
            x[0, 0, 0] ^= 0x10
            return out.replace(planes=(x,))
        raise ValueError(kind)
    with mock.patch.object(nodemodel.FrameGraph, "run", broken):
        yield


FAULTS = ("stale", "altered")
