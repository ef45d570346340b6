"""device_idle_share.<cell or entry>: the share of the untimed window in
which the card ran nothing, in percent: one less the device's busy time
a frame in the traced stretch (every kernel, copy and set, as a union)
times the window's frames, over the window's length. The window runs
without the profiler, whose host cost would widen every gap between
launches."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not t["frames"] or not rec["window_s"]:
        return None
    busy = t["busy_s"] / t["frames"] * rec["frames"]
    return 100.0 * (1.0 - busy / rec["window_s"])
