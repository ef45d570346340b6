"""Diagnostics: the host timers the player reads.

A copy of `lives_tpu/diagnostics.py:21-107` (`current_ticks`,
`FrameLadder`, `StepTimer`; reference `src/diagnostics.c:97`,
`frameloader.c:46`, the layers.h:78 status enum), which is host Python:
the per-frame timing ladder `Player.ladder` fills, and a plan-step timer.
Not ported yet (ROADMAP Queue 1 item 23): `run_startup_tests`,
`benchmark_memcpy` and `CostPredictor`.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

TICKS_PER_SECOND = 100_000_000


def current_ticks() -> int:
    """lives_get_current_ticks (timing.c:49)."""
    return int(time.monotonic() * TICKS_PER_SECOND)


# ---------------------------------------------------------------------------
# Per-frame timing ladder (layer status lifecycle, layers.h:78-85)
# ---------------------------------------------------------------------------

LADDER_STAGES = ("queued", "loaded", "converted", "applied", "displayed")


class FrameLadder:
    """Collects per-frame stage timestamps; aggregates p50/p99 per stage."""

    def __init__(self, keep: int = 512):
        self.keep = keep
        self.frames: list[dict[str, int]] = []
        self._cur: dict[str, int] | None = None

    def begin(self):
        self._cur = {"queued": current_ticks()}

    def mark(self, stage: str):
        if self._cur is not None:
            self._cur[stage] = current_ticks()

    def end(self):
        if self._cur is not None:
            self.frames.append(self._cur)
            self._cur = None
            if len(self.frames) > self.keep:
                self.frames = self.frames[-self.keep // 2:]

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for a, b in zip(LADDER_STAGES[:-1], LADDER_STAGES[1:]):
            deltas = [(f[b] - f[a]) / 1e5 for f in self.frames
                      if a in f and b in f]  # ms
            if deltas:
                arr = np.asarray(deltas)
                out[f"{a}->{b}"] = {
                    "mean_ms": float(arr.mean()),
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p99_ms": float(np.percentile(arr, 99)),
                }
        total = [(f.get("displayed", 0) - f["queued"]) / 1e5
                 for f in self.frames if "displayed" in f]
        if total:
            arr = np.asarray(total)
            out["total"] = {"mean_ms": float(arr.mean()),
                            "p50_ms": float(np.percentile(arr, 50)),
                            "p99_ms": float(np.percentile(arr, 99))}
        return out


# ---------------------------------------------------------------------------
# Plan-step timing (nodemodel extract_timedata :1510 analogue)
# ---------------------------------------------------------------------------

class StepTimer:
    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                timer.times[name].append(time.perf_counter() - self.t0)

        return _Ctx()

    def summary(self) -> dict[str, dict[str, float]]:
        return {k: {"mean_ms": float(np.mean(v) * 1e3),
                    "std_ms": float(np.std(v) * 1e3),
                    "n": len(v)}
                for k, v in self.times.items()}
