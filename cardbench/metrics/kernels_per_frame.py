"""kernels_per_frame.<cell or entry>: kernels the trace holds over the
frames of the traced stretch."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not t["frames"]:
        return None
    return t["kernels"] / t["frames"]
