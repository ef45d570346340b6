"""Timeline -> compressed export demo: build a small multitrack timeline,
render it STRAIGHT into the MJPEG device-encode lane (no intermediate
clip, no raw pixels crossing to the host), then reopen the AVI through
the compressed ingest lane and play a few frames.

Counterpart of `examples/export_demo.py:1-55` over the port's
`Multitrack`, `DeviceSyntheticSource`, `render_to_encoder` (the "mjpeg"
encoder: the device coefficient stage, K3 before it) and `open_clip`, on
`--device` (`cuda` by default, which raises without CUDA). `export`
returns the AVI's path and the reopened frame.

The full round trip exercised here:
  multitrack model -> event list -> segmented renderer (device batches)
  -> device FDCT/quantise/sparse-pack -> host entropy encode -> AVI
  -> entropy decode -> device IDCT -> player.

Usage: python -m lives_tpu_torch.examples.export_demo [--device cuda]
"""

import argparse
import os
import sys
import tempfile


from ..utils.device import resolve_device


def timeline():
    """The demo's 3-track timeline with an effect region, 640x360."""
    from ..multitrack import Multitrack
    mt = Multitrack(n_tracks=3, width=640, height=360)
    mt.insert_block(0, clip=1, start=0, length=60)
    mt.insert_block(1, clip=2, start=15, length=30)
    mt.add_effect("vignette", [0], 10, 50)
    return mt


def export(device="cuda"):
    """The demo's timeline rendered on `device` into an MJPEG AVI in a new
    temporary directory. Returns (the AVI's path, the reopened clip, its
    middle frame as host RGB24)."""
    from ..io.clips import open_clip
    from ..scenes import DeviceSyntheticSource
    from ..transcode import render_to_encoder

    dev = resolve_device(device, "export_demo")
    mt = timeline()
    src = DeviceSyntheticSource(mt.el.height, mt.el.width, device=dev)

    tmp = tempfile.mkdtemp(prefix="lives_tpu_export_")
    out = os.path.join(tmp, "timeline.avi")
    assert render_to_encoder(mt.el, src, out, encoder="mjpeg")
    size = os.path.getsize(out)
    print(f"rendered {mt.n_frames} frames -> {out} ({size / 1024:.0f} KB)")

    # reopen through the compressed ingest lane and pull a frame
    clip = open_clip(out, tmp)
    frame = clip.get_frame(clip.frames // 2).planes[0].cpu().numpy()
    print(f"reopened: {clip.frames} frames @ {clip.fps} fps, "
          f"frame shape {frame.shape}, mean {frame.mean():.1f}")
    return out, clip, frame


def main(argv=None):
    from ..native import load_jpegcoef
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device, "export_demo")
    try:
        load_jpegcoef()
    except (OSError, RuntimeError) as e:
        print(f"jpegcoef bridge unavailable (libjpeg/g++ missing): {e}")
        return 1
    export(a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
