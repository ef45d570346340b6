"""liblives-style embedding demo (mirrors liblives/examples/*.cpp):
open a clip, map effects to keys, play with trickplay, record the
performance, batch re-render it, and save the clip set.

Counterpart of `examples/embed_demo.py:1-110` over
`lives_tpu_torch.api.LiVESApp` on `--device` (`cuda` by default, which
raises without CUDA). `demo` returns the app's work directory, where the
take, the multitrack render and the saved set stay.

Usage: python -m lives_tpu_torch.examples.embed_demo [--device cuda]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from ..api import LiVESApp
from ..io.decoders import write_y4m
from ..osc.server import NOTIFY
from ..player import CollectSink
from ..utils.device import resolve_device


def make_demo_clip(path, n=50, w=320, h=176):
    frames = []
    for i in range(n):
        y = ((np.arange(h)[:, None] + np.arange(w)[None] + i * 4) % 220
             + 16).astype(np.uint8)
        u = np.full((h // 2, w // 2), 96 + (i % 64), np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        frames.append((y, u, v))
    write_y4m(path, frames, fps=25.0)


def demo(device="cuda", sleep=time.sleep) -> str:
    """The demo on `device`; `sleep` paces the performance's cycles.
    Returns the app's work directory."""
    dev = resolve_device(device, "embed_demo")
    tmp = tempfile.mkdtemp(prefix="lives_tpu_demo_")
    clip_path = os.path.join(tmp, "demo.y4m")
    make_demo_clip(clip_path)

    app = LiVESApp(workdir=os.path.join(tmp, "workdir"), sink=CollectSink(),
                   device=dev)
    app.add_callback(NOTIFY.CLIP_OPENED,
                     lambda d: print(f"  clip {d} opened"))

    clip = app.open_file(clip_path)
    print(f"opened {clip.name}: {clip.frames} frames "
          f"{clip.width}x{clip.height} @ {clip.fps}")

    # map effects to keys 0/1 (the ctrl-1/ctrl-2 hotkeys)
    app.effect_key_map[0].map("gaussian_blur")
    app.effect_key_map[1].map("vignette")

    # record a short performance with trickplay (liblives player surface)
    app.player.play()
    app.player.record_start()
    app.effect_key_map[0].set_enabled(True)
    for _ in range(12):                # ~0.5 s forward
        app.player.tick(1)
        sleep(0.04)
    app.effect_key_map[1].set_enabled(True)
    app.player.set_fps(-50.0)          # reverse scratch at 2x
    for _ in range(12):                # ~0.5 s scratching
        app.player.tick(1)
        sleep(0.04)
    el = app.player.record_stop()
    app.player.stop()
    print(f"recorded {len(el)} events; shown "
          f"{app.player._player.frames_shown} frames "
          f"(inst fps {app.player._player.stats()['inst_fps']:.0f})")

    # render the take to a new clip — the reference's post-record
    # render choice (deal_with_render_choice)
    take = app.player.render_recording()
    print(f"take rendered -> clip {take.number}: {take.raw().frames} "
          f"frames {take.raw().width}x{take.raw().height}")

    # -- multitrack through the API only (liblives.hpp:761-915 surface) --
    from ..multitrack import Gravity, InsertMode, Multitrack
    app.multitrack = Multitrack(width=clip.width, height=clip.height)
    mtk = app.get_multitrack()
    mtk.set_gravity(Gravity.NORMAL)
    mtk.set_insert_mode(InsertMode.NORMAL)

    mtk.set_current_track(0)
    mtk.set_current_time(0.0)
    b1 = mtk.insert_block(clip)                 # full clip on track 0
    clip.set_selection_start(10)
    clip.set_selection_end(25)
    mtk.set_current_track(1)
    mtk.set_current_time(0.5)
    b2 = mtk.insert_block(clip)                 # selection on track 1
    print(f"blocks: t{b1.track()} @{b1.start_time():.2f}s "
          f"len {b1.length():.2f}s | t{b2.track()} "
          f"@{b2.start_time():.2f}s len {b2.length():.2f}s")
    b2.move_to(1, 1.0)
    print(f"moved block 2 -> @{b2.start_time():.2f}s")

    # crossfade region + keyframed volume fade on track 0
    mt = mtk.model
    mt.add_effect("crossfade", [0, 1], 25, 15, values={"amount": 0.5})
    mt.set_track_volume(0, 1.0, frame=0)
    mt.set_track_volume(0, 0.2, frame=mt.n_frames - 1)

    rendered = mtk.render(render_audio=True)
    print(f"multitrack rendered -> clip {rendered.number}: "
          f"{rendered.frames} frames {rendered.width}x{rendered.height}")

    app.set.save("demo_set")
    print(f"set saved under {app.workdir}/sets/demo_set")
    app.quit()
    return str(app.workdir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    demo(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
