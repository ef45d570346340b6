"""The readings that several metrics share, each a function of a run's
record: a metric's reader in `metrics/` takes one of these as its
`read`, or computes its own. Each returns None where the record holds
nothing it reads."""

from __future__ import annotations

from cardbench import work


def frame_rate(rec: dict) -> float | None:
    """Frames over the whole window, the window ended by the card's
    synchronise after its last frame (host clock)."""
    if not rec.get("window_s"):
        return None
    return rec["frames"] / rec["window_s"]


def roofline(rec: dict) -> float | None:
    """The least time the traced stretch's work could take on the card
    (the trace's `ops` and `bytes`, counted by `work`: the larger of
    operations over 67 TFLOP/s and bytes over 3.35 TB/s), as a share of
    the device kernel time the trace holds, in percent."""
    t = rec.get("trace")
    if not t or t["kernel_s"] <= 0:
        return None
    return 100.0 * work.least_seconds(t["ops"], t["bytes"])[0] / t["kernel_s"]
