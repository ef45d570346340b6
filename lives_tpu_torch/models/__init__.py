"""Model families — in a video framework, the "models" are compositing
pipeline configurations: (sources, effect chain, sink) triples compiled by
the FrameGraph plan compiler. The flagship model is the 10-track multitrack
composite (scenes.multitrack_timeline), which is also what `bench.py`
measures and `__graft_entry__.entry()` runs.

Counterpart of `lives_tpu/models/__init__.py:1-18` on the port's `scenes`
and `SinkSpec`: the synthetic source generates on `device` (default
"cuda"; without CUDA it raises).
"""

from ..graph.nodemodel import FrameGraph, SinkSpec
from ..scenes import DeviceSyntheticSource, multitrack_timeline
from ..utils.device import resolve_device


def flagship(n_tracks: int = 10, width: int = 1920, height: int = 1080,
             fps: float = 30.0, n_frames: int = 300, *, device="cuda"):
    """The flagship pipeline: timeline + synthetic source + sink spec."""
    el = multitrack_timeline(n_tracks, n_frames, width, height, fps)
    src = DeviceSyntheticSource(height, width,
                                device=resolve_device(device, "flagship"))
    sink = SinkSpec(width=width, height=height)
    return el, src, sink
