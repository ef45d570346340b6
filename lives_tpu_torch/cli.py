"""Headless VJ console: the terminal front-end.

Counterpart of `lives_tpu/cli.py:23-175,195-221,287-311` (`build_player`,
`run_interactive`, the `play`, `effects` and `rfx` subcommands). It opens
a clip, binds effect keys, starts playback with a live status line (inst
fps / p99 / effort) and takes single-key commands on stdin (the clip
editor's hotkey map). Also usable non-interactively:

    python -m lives_tpu_torch.cli play file.y4m --fx gaussian_blur,vignette --seconds 5
    python -m lives_tpu_torch.cli play --fx saturation --seconds 5   # plasma
    python -m lives_tpu_torch.cli effects
    python -m lives_tpu_torch.cli rfx sepia clipdir     # a rendered effect

Playback runs on `--device` (default `cuda`; without CUDA it raises, it
does not fall back): YUV4MPEG clips into a null, Y4M or PNG sink, or the
plasma generator without a clip; `rfx` applies a rendered-effect script
on `--device` (default `cuda`). Not ported yet, each raising
`NotImplementedError` naming its ROADMAP Queue 1 item: the stream, l2l,
sdl, vjack and av sinks and `--osc`, and the `render`, `selftest`,
`recover` and `webui` subcommands (item 23).

Keys: space=play/stop  0-8=toggle fx key  r=record  R=stop rec+save
      [ ]=fps down/up  v=reverse  p=ping-pong  q=quit
"""

from __future__ import annotations

import argparse
import select
import sys
import time

#: sink kinds `play --sink` names, and the item that ports each one not
#: ported yet
UNPORTED_SINKS = {"stream": 23, "l2l": 23, "sdl": 23,
                  "vjack": 23, "av": 23}
#: subcommands of the JAX console not ported yet, and their items
UNPORTED_COMMANDS = {
    "render": "multitrack/model.py layouts (ROADMAP Queue 1 item 23)",
    "selftest": "diagnostics.run_startup_tests (ROADMAP Queue 1 item 23)",
    "recover": "api.py and sets.py (ROADMAP Queue 1 item 23)",
    "webui": "webui.py and the OSC server (ROADMAP Queue 1 item 23)",
}


def build_player(uri: str | None, fx: list[str], width: int, height: int,
                 sink_kind: str, out: str | None, device="cuda"):
    from .graph.nodemodel import SinkSpec
    from .io.genclip import GeneratorClip
    from .player import NullSink, Player, Y4MSink

    if sink_kind in UNPORTED_SINKS:
        raise NotImplementedError(
            f"the {sink_kind} sink is not ported yet (ROADMAP Queue 1 item "
            f"{UNPORTED_SINKS[sink_kind]})")
    if sink_kind == "y4m":
        from .constants import Palette
        sink = Y4MSink(out or "out.y4m")
        spec = SinkSpec(width=width, height=height,
                        palette=int(Palette.YUV420P))
    elif sink_kind == "png":
        from .player.sinks import PNGSink
        sink = PNGSink(out or "frames")
        spec = SinkSpec(width=width, height=height)
    else:
        sink = NullSink()
        spec = SinkSpec(width=width, height=height)

    p = Player(sink=sink, sink_spec=spec, device=device)
    p.async_compile = True
    p.adaptive_quality = True
    if uri:
        import tempfile
        from .io.clips import open_clip
        clip = open_clip(uri, tempfile.mkdtemp(prefix="lives_tpu_cli_"))
        p.state.fg_clip = clip
        p.set_pb_fps(clip.fps or 25.0)
        # real media: overlap decode/upload with compute (the precache
        # worker feeds ahead; the pipelined sink hides the fetch), and
        # fetch displayed frames in groups of 4
        p.precache_depth = 4
        p.pipeline_depth = 2
        p.fetch_batch = 4
    else:
        p.state.fg_clip = GeneratorClip("plasma", width or 640,
                                        height or 360, device=p.device)
    for i, name in enumerate(fx):
        p.keymap.set_key(i, 0, name)
    return p


def run_interactive(p, seconds: float | None = None):
    import termios
    import tty
    fd = old = None
    try:
        fd = sys.stdin.fileno()   # a stdin that is no terminal: no keys
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        interactive = True
    except (termios.error, OSError):
        interactive = False
    p.start()
    t_end = time.monotonic() + seconds if seconds else None
    try:
        while True:
            p.process_one()
            st = p.stats()
            sys.stderr.write(
                f"\rframe {p.state.frame:6d}  fps {st['inst_fps']:7.1f}  "
                f"p99 {st['p99_ms']:6.2f}ms  effort {p.effort}  "
                f"{'REC' if p.record else '   '} ")
            sys.stderr.flush()
            if t_end and time.monotonic() > t_end:
                break
            if interactive and select.select([fd], [], [], 0.005)[0]:
                c = sys.stdin.read(1)
                if c == "q":
                    break
                elif c == " ":
                    if p.state.playing:
                        p.stop()
                    else:
                        p.start()
                elif c in "012345678":
                    p.key_toggle(int(c))
                elif c == "[":
                    p.set_pb_fps(p.state.pb_fps * 0.9)
                elif c == "]":
                    p.set_pb_fps(p.state.pb_fps * 1.1)
                elif c == "v":
                    p.set_pb_fps(-p.state.pb_fps)
                elif c == "p":
                    p.state.ping_pong = not p.state.ping_pong
                elif c == "r" and not p.record:
                    clip = p.state.fg_clip
                    p.record_start(getattr(clip, "width", 0),
                                   getattr(clip, "height", 0))
                elif c == "R" and p.record:
                    el = p.record_stop()
                    fname = f"recording_{int(time.time())}.json"
                    with open(fname, "w") as fh:
                        fh.write(el.to_json())
                    sys.stderr.write(f"\nsaved {fname}\n")
            elif not interactive:
                time.sleep(0.005)
    finally:
        p.stop()
        if old is not None:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stderr.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lives_tpu_torch",
                                 description="VJ console on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    play = sub.add_parser("play", help="play a clip (or plasma generator)")
    play.add_argument("uri", nargs="?", default=None)
    play.add_argument("--fx", default="", help="comma-separated filters "
                      "bound to keys 0..8")
    play.add_argument("--sink", default="null",
                      choices=["null", "y4m", "png", "stream", "l2l", "av",
                               "sdl", "vjack"])
    play.add_argument("--out", default=None)
    play.add_argument("--width", type=int, default=0)
    play.add_argument("--height", type=int, default=0)
    play.add_argument("--seconds", type=float, default=None)
    play.add_argument("--osc", type=int, default=None,
                      help="also serve OSC on this port (not ported)")
    play.add_argument("--device", default="cuda",
                      help="the device to play on (default cuda; no "
                           "fallback)")

    sub.add_parser("effects", help="list registered filters")

    rfx = sub.add_parser("rfx", help="list/apply rendered-effect scripts")
    rfx.add_argument("script", nargs="?", default=None,
                     help="script name (omit to list)")
    rfx.add_argument("clip", nargs="?", default=None,
                     help="media file / clip dir to apply to")
    rfx.add_argument("--param", action="append", default=[],
                     metavar="K=V", help="script parameter")
    rfx.add_argument("--start", type=int, default=0)
    rfx.add_argument("--end", type=int, default=None)
    rfx.add_argument("--device", default="cuda",
                     help="the device the script's pixel work runs on "
                          "(default cuda; no fallback)")
    for cmd in UNPORTED_COMMANDS:
        sub.add_parser(cmd, help="not ported yet").add_argument(
            "rest", nargs="*")

    args = ap.parse_args(argv)
    if args.cmd == "effects":
        from .effects import get_filter, list_filters
        for name in list_filters():
            if name.startswith("_"):
                continue
            print(f"{name:24s} {get_filter(name).description}")
        return 0
    if args.cmd == "rfx":
        return _rfx(args)
    if args.cmd in UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"`{args.cmd}` needs {UNPORTED_COMMANDS[args.cmd]}, not ported "
            "yet")
    if args.osc:
        raise NotImplementedError(
            "the OSC server is not ported yet (ROADMAP Queue 1 item 23)")
    fx = [f for f in args.fx.split(",") if f]
    p = build_player(args.uri, fx, args.width, args.height, args.sink,
                     args.out, device=args.device)
    run_interactive(p, args.seconds)
    return 0


def _rfx(args) -> int:
    """`rfx`: list the scripts, show a script's parameters, or apply it to
    a clip directory or a media file (`lives_tpu/cli.py:287-311`)."""
    from .rfx_scripts import (apply_script, get_script, list_scripts,
                              parse_param_value)
    if args.script is None:
        for name in list_scripts():
            print(f"{name:28s} {get_script(name).filter}")
        return 0
    if args.clip is None:
        for q in get_script(args.script).params_spec():
            print(f"{q['name']:20s} {q.get('kind', 'num'):12s} "
                  f"default={q.get('default')}")
        return 0
    import pathlib
    from .io.clips import Clip, open_clip
    path = pathlib.Path(args.clip)
    clip = Clip.load(path) if (path / "header.lives").is_file() \
        else open_clip(args.clip, path.parent)
    params = {}
    for kv in args.param:
        k, _, v = kv.partition("=")
        params[k] = parse_param_value(v)
    n = apply_script(clip, args.script, start=args.start, end=args.end,
                     device=args.device, **params)
    print(f"{args.script}: {n} frames -> {clip.clip_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
