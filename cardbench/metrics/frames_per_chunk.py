"""frames_per_chunk.<cell or entry>: frames rendered in the window over
the fused sweep's u8 launches in it (`graph/fused_sweep.MODE_LAUNCHES`),
a count of the program's. None where the sweep ran no launch."""


def read(rec):
    n = rec.get("k1_u8_launches")
    return rec["frames"] / n if n else None
