"""live_frame_p95_ms: the 95th percentile, over every frame of the window,
of the time from the `FrameGraph.run` call to the return of its
synchronise (host clock)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
