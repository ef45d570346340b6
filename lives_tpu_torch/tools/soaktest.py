"""Random OSC soak/fuzz driver — the autolives.pl successor
(reference `tools/autolives.pl`: drive a running instance over OSC,
randomly toggling effects/clips, as a robustness harness).

Counterpart of `tools/soaktest.py:1-166` with the same 62 paths (`PATHS`,
`:37-123`) and seed semantics (one `random.Random(seed)` picks each path
and its arguments). The self-hosted player runs on `--device` (`cuda` by
default, which raises without CUDA) at `--width` x `--height` (the JAX
tool's 256x128 by default). `soak` is the loop as a function; it also
reports `process_one`'s times.

Usage: python -m lives_tpu_torch.tools.soaktest [--seconds 15] [--seed 0]
    [--port P] [--rate 30] [--device cuda] [--width 256] [--height 128]
Starts its own player+OSC server unless --port points at a live one.
Exits nonzero if the engine stops responding.
"""

from __future__ import annotations

import argparse
import random
import socket
import sys
import time

from ..osc import build_message
from ..osc.protocol import OSCMessage

FILTERS = ["negate", "gaussian_blur", "vignette", "saturation", "sepia",
           "posterize", "pixelate", "crossfade", "feedback", "fire",
           "kaleidoscope", "solarize", "blend_screen",
           "warptv", "textfun", "dissolve", "iris_rectangle",
           "compositor", "scribbler", "template_tracker",
           "image_stabilizer", "data_counter", "nn_programmer"]

PATHS = [
    ("/video/play", lambda r: ()),
    ("/video/stop", lambda r: ()),
    ("/video/fps/set", lambda r: (r.uniform(-60, 60),)),
    ("/video/play/reverse", lambda r: ()),
    ("/video/loop/set", lambda r: (r.randint(0, 1),)),
    ("/video/pingpong/set", lambda r: (r.randint(0, 1),)),
    ("/clip/foreground/frame/set", lambda r: (r.randint(0, 500),)),
    ("/effect_key/map", lambda r: (r.randint(1, 9), r.choice(FILTERS))),
    ("/effect_key/toggle", lambda r: (r.randint(1, 9),)),
    ("/effect_key/enable", lambda r: (r.randint(1, 9),)),
    ("/effect_key/disable", lambda r: (r.randint(1, 9),)),
    ("/effect_key/mode/next", lambda r: (r.randint(1, 9),)),
    ("/record/toggle", lambda r: ()),
    ("/record/render", lambda r: ()),
    ("/record/discard", lambda r: ()),
    ("/omc/learn/start", lambda r: (r.choice(["blend", "fps", "play"]),)),
    ("/omc/feed_midi", lambda r: ("b0%02x%02x" % (r.randint(0, 30),
                                                  r.randint(0, 127)),)),
    ("/app/ping", lambda r: ()),
    # extended namespace (osc/namespace.py)
    ("/video/play/faster", lambda r: ()),
    ("/video/play/slower", lambda r: ()),
    ("/video/play/reset", lambda r: ()),
    ("/video/freeze/toggle", lambda r: ()),
    ("/video/fps/ratio/set", lambda r: (r.uniform(0.1, 4.0),)),
    ("/video/fps/ratio/get", lambda r: ()),
    ("/clip/background/fps/set", lambda r: (r.uniform(-60, 60),)),
    ("/clip/background/fps/faster", lambda r: ()),
    ("/clip/background/fps/reset", lambda r: ()),
    ("/clip/background/frame/get", lambda r: ()),
    ("/clip/retrigger", lambda r: ()),
    ("/clip/select_all", lambda r: ()),
    ("/effect_key/mode/set", lambda r: (r.randint(1, 9), 1)),
    ("/effect_key/parameter/count", lambda r: (r.randint(1, 9),)),
    ("/effect_key/parameter/name/get", lambda r: (r.randint(1, 9), 0)),
    ("/effect_key/parameter/value/set",
     lambda r: (r.randint(1, 9), 0, r.uniform(0, 1))),
    ("/effect_key/parameter/value/get", lambda r: (r.randint(1, 9), 0)),
    ("/effect_key/outparameter/count", lambda r: (r.randint(1, 9),)),
    ("/effect_key/inchannel/active/count", lambda r: (r.randint(1, 9),)),
    ("/effect_key/reset", lambda r: ()),
    ("/lives/status/get", lambda r: ()),
    ("/lives/mode/set", lambda r: (r.randint(0, 1),)),
    ("/lives/constant/value/get",
     lambda r: ("LIVES_STATUS_PLAYING",)),
    ("/rfx/list", lambda r: ()),
    ("/rfx/params/get", lambda r: (r.choice(["blur", "negate", "sepia"]),)),
    ("/output/fullscreen/enable", lambda r: ()),
    ("/output/nodrop/disable", lambda r: ()),
    ("/output/fps/set", lambda r: (r.uniform(1, 60),)),
    ("/audio/source/set", lambda r: (r.randint(0, 1),)),
    ("/mt/time/set", lambda r: (r.uniform(0, 60),)),
    ("/mt/ctrack/set", lambda r: (r.randint(0, 4),)),
    ("/block/count", lambda r: (r.randint(0, 4),)),
    ("/lives/methods/count", lambda r: ()),
    # round-3 surface: nervous/autotrans trickplay, prefs, mt editing
    ("/video/nervous/enable", lambda r: ()),
    ("/video/nervous/disable", lambda r: ()),
    ("/video/autotrans/set", lambda r: (r.randint(1, 9),
                                        r.uniform(0.1, 1.0))),
    ("/video/autotrans/disable", lambda r: ()),
    ("/pref/set", lambda r: (r.choice(["def_fps", "pb_quality",
                                       "screen_gamma"]),
                             r.uniform(0.5, 60))),
    ("/pref/get", lambda r: (r.choice(["def_fps", "encoder",
                                       "gui_theme"]),)),
    ("/mt/gravity/set", lambda r: (r.choice([0, 1, 2]),)),
    ("/mt/insert_mode/set", lambda r: (r.choice([0, 2, 4]),)),
    ("/mt/region/select", lambda r: (r.randint(0, 50),
                                     r.randint(51, 120), 0)),
    ("/mt/track/volume/set", lambda r: (r.choice([-1, 0, 1]),
                                        r.uniform(0, 1.2))),
    ("/mt/undo", lambda r: ()),
]


def self_host(device="cuda", width: int = 256, height: int = 128):
    """The JAX tool's self-hosted player (`:135-144`) on `device`: plasma
    over colour_bars, `async_compile` on, behind an `OSCServer` on port
    0. Returns (player, server)."""
    from ..io.genclip import GeneratorClip
    from ..osc.server import OSCServer
    from ..player import NullSink, Player
    from ..utils.device import resolve_device
    p = Player(sink=NullSink(), device=resolve_device(device, "soaktest"))
    p.state.fg_clip = GeneratorClip("plasma", width, height,
                                    device=p.device)
    p.state.bg_clip = GeneratorClip("colour_bars", width, height,
                                    device=p.device)
    p.async_compile = True
    srv = OSCServer(p, port=0)
    srv.start()
    return p, srv


def soak(port: int, seconds: float, seed: int = 0, rate: float = 30.0,
         player=None) -> dict:
    """Send `rate` random commands a second to 127.0.0.1:port for
    `seconds`, a `player.process_one()` after each when one is given.
    Returns {"sent", "cycle_s"}: the commands sent and each cycle's
    `process_one` seconds. Raises OSError when a send fails."""
    rng = random.Random(seed)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent, cycle_s = 0, []
    t_end = time.time() + seconds
    try:
        while time.time() < t_end:
            path, argfn = rng.choice(PATHS)
            sock.sendto(build_message(path, *argfn(rng)),
                        ("127.0.0.1", port))
            sent += 1
            if player is not None:
                t0 = time.perf_counter()
                player.process_one()
                cycle_s.append(time.perf_counter() - t0)
            time.sleep(1.0 / rate)
    finally:
        sock.close()
    return {"sent": sent, "cycle_s": cycle_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--rate", type=float, default=30.0,
                    help="commands per second")
    ap.add_argument("--device", default="cuda",
                    help="the self-hosted player's device")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    args = ap.parse_args(argv)

    owned = None
    if args.port is None:
        owned = self_host(args.device, args.width, args.height)
        args.port = owned[1].port

    try:
        got = soak(args.port, args.seconds, args.seed, args.rate,
                   owned[0] if owned else None)
    except OSError as e:
        print(f"send failed: {e}")
        return 2
    finally:
        if owned:
            p, srv = owned
            # liveness check: ping must still dispatch
            ok = srv.dispatch(OSCMessage("/app/ping", []))
            p.stop()
            srv.stop()
    if owned:
        print(f"soak: {got['sent']} commands, {p.frames_shown} frames "
              f"shown, engine {'alive' if ok else 'DEAD'}")
        return 0 if ok else 1
    print(f"soak: {got['sent']} commands sent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
