"""Fast transcode: a clip through the frame graph straight into an
encoder, and an event list rendered straight into an encoder.

Counterpart of `lives_tpu/transcode.py:19-93` (`transcode`,
`render_to_encoder`; reference `src/transcode.c`: stream layers to an
encoding playback plugin without intermediate rendering, and events.c:4994
without the intermediate clip).

`transcode` reads the clip a batch at a time with `io.clips.
read_rgb_batch` (a YUV4MPEG clip's batch: its planes stacked on the host
in pinned memory, one upload a plane and one K2 launch on the card), runs
`FrameGraph.run_batch` on the chosen device and hands the batch to the
encoder. An encoder that takes device frames (`Y4MEncoder`, whose K3 runs
once a batch; `MJPEGDeviceEncoder`) gets the (B, 3, H, W) batch on the
device; any other gets host frames one at a time, as the JAX package
hands them. The clip's audio goes through `WavEncoder` beside the video.
The JAX function converts each frame on the host, one `convert_layer` a
frame; the pixels are the same.

`render_to_encoder` hands an encoder that takes device frames each
rendered chunk whole, a (B, C, H, W) device tensor (the MJPEG AVI of
"mjpeg", the default, through the compressed lane), so the rendered
frames never cross to the host as raw RGB. A pass is the span
`lives.export` (`diagnostics.span`), the render and the encode inside it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .constants import Palette
from .diagnostics import span
from .effects.host import Instance
from .graph.nodemodel import FrameGraph, SinkSpec
from .io.clips import read_rgb_batch
from .io.encoders import get_encoder
from .layer import Layer
from .utils.device import resolve_device


def transcode(clip, out_path: str, encoder: str = "yuv4mpeg",
              chain: Sequence[Instance] = (),
              start: int = 0, end: int | None = None,
              batch_size: int = 32, width: int = 0, height: int = 0,
              include_audio: bool = True,
              progress_cb=None, *, device="cuda") -> bool:
    """Stream clip frames [start, end) (optionally through an fx chain /
    resize) into `encoder` at `out_path`, batched on `device`; frames never
    touch the clip store. `progress_cb(done, total)` is called once per
    emitted frame (the reference encode progress dialog's hook)."""
    dev = resolve_device(device, "transcode")
    end = clip.frames if end is None else min(end, clip.frames)
    sink = SinkSpec(width=width or clip.width, height=height or clip.height)
    graph = FrameGraph(list(chain), sink, fps=clip.fps)
    enc = get_encoder(encoder)
    dev_frames = getattr(enc, "accepts_device_frames", False)
    total = max(end - start, 1)

    def frame_iter():
        done = 0
        for ofs in range(start, end, batch_size):
            hi = min(ofs + batch_size, end)
            batch = Layer(planes=(read_rgb_batch(clip, range(ofs, hi), dev),),
                          palette=int(Palette.RGB24))
            tcs = np.arange(ofs, hi, dtype=np.float32) / clip.fps
            out = graph.run_batch([batch], tcs,
                                  np.arange(ofs, hi, dtype=np.int32))
            items = [out.planes[0]] if dev_frames \
                else out.planes[0].cpu().numpy()
            for item in items:
                yield item
                for _ in range(hi - ofs if dev_frames else 1):
                    done += 1
                    if progress_cb is not None:
                        progress_cb(done, total)

    audio = None
    arate = 44100
    if include_audio and getattr(clip, "achans", 0):
        audio = clip.read_audio()
        arate = clip.arate or 44100
    return enc.encode(out_path, frame_iter(), clip.fps, audio, arate)


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

    with span("lives.export"):
        return enc.encode(out_path, frame_iter(), el.fps)
