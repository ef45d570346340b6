#!/usr/bin/env python
"""Generate the JAX render golden the PyTorch/CUDA port is held against.

Renders a small multitrack timeline (4 tracks, 256x48, 8 frames at 25 fps:
the benchmark scene's chain of transitions, blur, colour balance,
saturation and vignette) with `lives_tpu` on the CPU through its float32
XLA path (LIVES_TPU_FUSED_SWEEP=0, LIVES_TPU_CHAIN_DTYPE=f32) and writes
`tests/fixtures/render_golden.npz`:

- `frames`: (8, 3, 48, 256) u8, the rendered RGB24 frames;
- `timeline`: the event list as `EventList.to_json()` text, so a reader
  renders exactly the same timeline (event ids included);
- `batch_size`: the chunk size of the render.

tests/test_torch_render.py checks that lives_tpu still reproduces the
frames exactly and that the port's plain path is within +/-1 LSB;
chip_smoke.py holds the port's CUDA kernel against them on the GPU.

    JAX_PLATFORMS=cpu python tools/gen_render_golden.py
"""

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "fixtures" / "render_golden.npz"
N_TRACKS, WIDTH, HEIGHT, N_FRAMES, FPS, BATCH = 4, 256, 48, 8, 25.0, 4


def render_golden(timeline_json: str) -> np.ndarray:
    """The lives_tpu f32 XLA-path render of a timeline at the golden's
    geometry."""
    os.environ["LIVES_TPU_FUSED_SWEEP"] = "0"
    os.environ["LIVES_TPU_CHAIN_DTYPE"] = "f32"
    from lives_tpu.events.event_list import EventList
    from lives_tpu.events.renderer import render_to_arrays
    from lives_tpu.graph import SinkSpec
    from lives_tpu.scenes import DeviceSyntheticSource
    frames, _ = render_to_arrays(
        EventList.from_json(timeline_json),
        DeviceSyntheticSource(HEIGHT, WIDTH), SinkSpec(WIDTH, HEIGHT),
        batch_size=BATCH)
    return np.asarray(frames)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    from lives_tpu.scenes import multitrack_timeline
    text = multitrack_timeline(n_tracks=N_TRACKS, n_frames=N_FRAMES,
                               width=WIDTH, height=HEIGHT,
                               fps=FPS).to_json()
    frames = render_golden(text)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, frames=frames, timeline=np.array(text),
                        batch_size=np.int32(BATCH))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, frames "
          f"{frames.shape} {frames.dtype})")


if __name__ == "__main__":
    main()
