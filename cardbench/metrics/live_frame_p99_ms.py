"""live_frame_p99_ms: the 99th percentile of the same latencies as
live_frame_p95_ms (host clock)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    return float(np.percentile(lat, 99)) if lat else None
