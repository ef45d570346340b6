"""Render an event list straight into an encoder.

Counterpart of `lives_tpu/transcode.py:70-93` (`render_to_encoder`;
reference `src/transcode.c` with events.c:4994, without the intermediate
clip). With an encoder that takes device frames (`Y4MEncoder`, and
`MJPEGDeviceEncoder`, the default "mjpeg": an MJPEG AVI through the
compressed lane), the rendered frames never cross to the host as raw RGB:
such an encoder gets each chunk whole, a (B, C, H, W) device tensor, and
converts or encodes it on the device. Any other encoder gets host frames
one at a time, as the JAX package hands them. `transcode` (a clip
through a chain into an encoder, `transcode.py:19-67`) is not ported yet
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from .graph.nodemodel import SinkSpec
from .io.encoders import get_encoder


def render_to_encoder(el, source, out_path: str, encoder: str = "mjpeg",
                      sink: SinkSpec | None = None,
                      batch_size: int = 32) -> bool:
    """Render `el` over `source` (on the source's device) into `encoder`
    at `out_path`."""
    from .events.renderer import render_events
    enc = get_encoder(encoder)
    dev_frames = getattr(enc, "accepts_device_frames", False)

    def frame_iter():
        for _, out in render_events(el, source, sink,
                                    batch_size=batch_size):
            p = out.planes[0]
            if dev_frames:
                yield p
            else:
                yield from p.cpu().numpy()

    return enc.encode(out_path, frame_iter(), el.fps)
