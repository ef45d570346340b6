"""What every driver shares: the clock's synchronise, the sample of the
window's frames kept for the check, the comparison that decides
`correct`, and the traced stretch.

`correct` compares frames the timed path produced, a sample drawn from the
seed, with the plain reference's frames computed afresh from the inputs
the benchmark made. Two numbers are compared, each against a limit the
configuration's file states (its `limits`, set from readings of the
program and of its lower-precision control):

- `max_lsb`: the widest gap, in u8 steps, of any channel of any compared
  frame;
- `differing_share`: the share of compared channel values that differ at
  all.

The count of frames compared has a floor of its own (`min_compared` of
the traffic mix), so a window that kept no sample is not correct.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """A seed-drawn sample of the frames a window produces, copied into a
    buffer on the device made before any of the program's objects: every
    `stride`-th unit (a chunk or a frame), from a phase drawn from the
    seed, `per_unit` of its frames drawn from the seed. Past `slots`
    frames a new one takes a slot drawn from the seed with the chance
    slots / frames offered (a reservoir), so the sample stays spread over
    the whole window whatever its length. `nbytes` is what the buffer
    adds to the device's allocated bytes, which `program_peak` takes out
    of the run's peak."""

    def __init__(self, seed: int, slots: int, shape, device, stride: int,
                 per_unit: int = 1):
        self.seed, self.slots, self.stride = seed, slots, stride
        self.per_unit = per_unit
        before = allocated(device)
        self.buf = torch.empty((slots, *shape), dtype=torch.uint8,
                               device=device)
        self.nbytes = allocated(device) - before
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng([self.seed, 0x5A])
        self.phase = int(self.rng.integers(self.stride))
        self.meta: list = [None] * self.slots
        self.n = 0

    def wants(self, unit: int) -> bool:
        """Whether unit `unit` of the window is sampled."""
        return (unit + self.phase) % self.stride == 0

    def offer(self, unit: int, frames: torch.Tensor, ids) -> None:
        """Unit `unit`'s frames ((B, ...) u8 on the device) and what
        identifies each (B entries), to sample from."""
        if not self.wants(unit):
            return
        k = min(self.per_unit, len(ids))
        for o in sorted(self.rng.choice(len(ids), size=k, replace=False)):
            slot = self.n if self.n < self.slots \
                else int(self.rng.integers(self.n + 1))
            self.n += 1
            if slot < self.slots:
                self.buf[slot].copy_(frames[int(o)])
                self.meta[slot] = ids[int(o)]

    def taken(self):
        """(frames, their ids) of the samples kept."""
        k = min(self.n, self.slots)
        return self.buf[:k], self.meta[:k]


def allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0


def program_peak(device: torch.device, sampler: Sampler) -> int:
    """The card's peak of allocated bytes over the run so far, less the
    sample buffer, which was made before the program's objects and held
    throughout: the program's own peak."""
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device) - sampler.nbytes


#: bytes of float32 frames the reference holds in one block of the check
BLOCK_BYTES = 1 << 29


def block_for(shape) -> int:
    """Frames a block of the check compares: as many float32 frames of
    `shape` as `BLOCK_BYTES` holds, 1 to 64."""
    return max(1, min(64, BLOCK_BYTES // (4 * int(np.prod(shape)))))


class Readings:
    """The comparison's numbers, accumulated block by block."""

    def __init__(self):
        self.max_lsb = 0
        self.differing = 0
        self.values = 0
        self.frames = 0
        self.frames_over = {}   # frame id -> its widest gap, where over

    def add(self, got: torch.Tensor, ref: torch.Tensor, ids, limit: int):
        if got.shape != ref.shape:
            raise ValueError(f"compared {tuple(got.shape)} with the "
                             f"reference's {tuple(ref.shape)}")
        d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        per = d.reshape(d.shape[0], -1).amax(1).tolist()
        self.max_lsb = max([self.max_lsb, *per])
        self.differing += int((d > 0).sum().item())
        self.values += d.numel()
        self.frames += d.shape[0]
        for i, m in zip(ids, per):
            if m > limit:
                self.frames_over[str(i)] = m

    def numbers(self) -> dict:
        return {"max_lsb": self.max_lsb,
                "differing_share": self.differing / max(self.values, 1),
                "frames_compared": self.frames}


def judge(numbers: dict, limits: dict, min_compared: int) -> tuple[bool,
                                                                  dict]:
    """(correct, checks): each number beside its limit."""
    checks = {
        "max_lsb": {"value": numbers["max_lsb"],
                    "limit": limits["max_lsb"], "at_most": True},
        "differing_share": {"value": numbers["differing_share"],
                            "limit": limits["differing_share"],
                            "at_most": True},
        "frames_compared": {"value": numbers["frames_compared"],
                            "limit": min_compared, "at_most": False},
    }
    ok = all((c["value"] <= c["limit"]) if c["at_most"]
             else (c["value"] >= c["limit"]) for c in checks.values())
    return ok, checks


def check(ref_fn, frames: torch.Tensor, ids, limits: dict) -> Readings:
    """Compare kept frames with `ref_fn(ids) -> u8 frames`, in blocks of
    `block_for` a frame's shape."""
    r = Readings()
    block = block_for(frames.shape[1:])
    for i in range(0, len(ids), block):
        got = frames[i:i + block]
        r.add(got, ref_fn(ids[i:i + block]).to(got.device), ids[i:i + block],
              limits["max_lsb"])
    return r


@contextlib.contextmanager
def traced(device: torch.device):
    """A profiler over the stretch, CUDA activity where the device is a
    card; yields the profiler, whose trace is complete once the block
    exits."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
