"""pageable_copies_per_chunk.<cell or entry>: host-to-device copies from
pageable memory the trace holds, over the chunks of the traced
stretch."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not t.get("units"):
        return None
    return t["pageable_htod"] / t["units"]
