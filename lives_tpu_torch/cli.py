"""Headless VJ console: the terminal front-end.

Counterpart of `lives_tpu/cli.py` (`build_player`, `run_interactive`,
the `play` subcommand with `--osc`, and the `effects`, `selftest`,
`recover`, `render`, `rfx` and `webui` subcommands). It opens a clip,
binds effect keys, starts playback with a live status line (inst fps /
p99 / effort) and takes single-key commands on stdin (the clip editor's
hotkey map). Also usable non-interactively:

    python -m lives_tpu_torch.cli play file.y4m --fx gaussian_blur,vignette --seconds 5
    python -m lives_tpu_torch.cli play --fx saturation --seconds 5   # plasma
    python -m lives_tpu_torch.cli play clip.y4m --sink l2l --out host:8888
    python -m lives_tpu_torch.cli effects
    python -m lives_tpu_torch.cli selftest
    python -m lives_tpu_torch.cli rfx sepia clipdir     # a rendered effect
    python -m lives_tpu_torch.cli render layout.lay --clip 1=a.avi --audio --out out.y4m
    python -m lives_tpu_torch.cli play clip.y4m --osc 49999   # + OSC server
    python -m lives_tpu_torch.cli recover workdir   # a crashed session
    python -m lives_tpu_torch.cli webui clip.y4m --port 8765  # browser UI

Playback runs on `--device` (default `cuda`; without CUDA it raises, it
does not fall back): YUV4MPEG clips or the plasma generator without a
clip into a null, Y4M or PNG sink, an LTPU (`stream`) or reference L2L
(`l2l`) UDP stream to `--out host:port`, or the libav lane (`av`, a file
or URL; it raises the bridge's own error where the bridge does not
load); with `--osc PORT` an `osc.OSCServer` on the player, its full
namespace answering on that UDP port. `selftest` runs
`diagnostics.run_startup_tests` on `--device`; `webui` serves the
browser UI (`webui.WebUI`) and OSC over a player on `--device`; `rfx`
applies a rendered-effect script on `--device`; `render` renders a
multitrack layout (`.json` or binary `.lay`) on `--device` over the
clips `--clip` maps, or the synthetic source, into a YUV4MPEG file, with
`--audio` its mixed audio as a WAV beside it; `recover` reopens a
crashed session's journaled clips in a `api.LiVESApp` on `--device` and
renders its autosaved take to a new clip there. `play --sink sdl` shows
the frames in an SDL2 window (`player.sdl.SDLSink`) and `--sink vjack`
sends them to a Video-JACK output port (`io.videojack.VJackSink`); both
raise where their library is absent. `render` writes YUV4MPEG for a
`.y4m` output and otherwise through the libav encoder where the bridge
loads, as the JAX console does.

Keys: space=play/stop  0-8=toggle fx key  r=record  R=stop rec+save
      [ ]=fps down/up  v=reverse  p=ping-pong  q=quit
"""

from __future__ import annotations

import argparse
import select
import sys
import time

#: sink kinds `play --sink` names that are not ported yet, and the item
#: that ports each one
UNPORTED_SINKS: dict[str, int] = {}
#: subcommands of the JAX console not ported yet, and their items
UNPORTED_COMMANDS: dict[str, str] = {}


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
    elif sink_kind == "stream":
        from .stream import StreamSender
        host, _, port = (out or "127.0.0.1:48888").partition(":")
        sink = StreamSender(host, int(port or 48888))
        spec = SinkSpec(width=width, height=height)
    elif sink_kind == "l2l":
        # reference LiVES-to-LiVES wire format: a real LiVES instance
        # can receive this (Advanced / Receive LiVES stream from...)
        from .stream import L2LSender
        host, _, port = (out or "127.0.0.1:8888").partition(":")
        sink = L2LSender(host, int(port or 8888))
        spec = SinkSpec(width=width, height=height)
    elif sink_kind == "sdl":
        from .player.sdl import SDLSink
        sink = SDLSink()
        spec = SinkSpec(width=width, height=height)
    elif sink_kind == "vjack":
        # videojack output port (vjack_output.c role; needs the
        # videojack libjack fork, errors cleanly otherwise)
        from .constants import Palette
        from .io.videojack import VJackSink
        sink = VJackSink(client_name=out or "lives_tpu-vjack-out")
        spec = SinkSpec(width=width, height=height,
                        palette=int(Palette.RGBA32))
    elif sink_kind == "av":
        # encode/stream through the libav bridge: file (mkv/mp4/ogv) or
        # network URL (udp://host:port mpegts, icecast://...)
        from .player.sinks import AVStreamSink
        sink = AVStreamSink(out or "out.mkv")
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
                      help="also serve OSC on this port")
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
    rend = sub.add_parser("render", help="batch-render an event list")
    rend.add_argument("layout", help=".json or binary .lay layout")
    rend.add_argument("--out", default="render.y4m")
    rend.add_argument("--clip", action="append", default=[],
                      metavar="UID=PATH",
                      help="map a timeline clip uid to a media file "
                           "(omit for the synthetic source)")
    rend.add_argument("--audio", action="store_true",
                      help="mix timeline audio into the output")
    rend.add_argument("--device", default="cuda",
                      help="the device to render on (default cuda; no "
                           "fallback)")
    rcv = sub.add_parser("recover", help="recover a crashed session: "
                         "reopen journaled clips and render the "
                         "autosaved recording")
    rcv.add_argument("workdir")
    rcv.add_argument("--no-audio", action="store_true")
    rcv.add_argument("--device", default="cuda",
                     help="the device the take renders on (default cuda; "
                          "no fallback)")
    diag = sub.add_parser("selftest", help="run startup diagnostics")
    diag.add_argument("--device", default="cuda",
                      help="the device the checks run on (default cuda; "
                           "no fallback)")
    web = sub.add_parser("webui", help="serve the browser UI + OSC")
    web.add_argument("uri", nargs="?", default=None)
    web.add_argument("--port", type=int, default=8765)
    web.add_argument("--osc", type=int, default=0)
    web.add_argument("--width", type=int, default=0)
    web.add_argument("--height", type=int, default=0)
    web.add_argument("--device", default="cuda",
                     help="the device to play on (default cuda; no "
                          "fallback)")
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
    if args.cmd == "selftest":
        from .diagnostics import run_startup_tests
        res = run_startup_tests(verbose=True, device=args.device)
        for k, v in res.items():
            print(f"{'PASS' if v else 'FAIL'} {k}")
        return 0 if all(res.values()) else 1
    if args.cmd == "webui":
        return _webui(args)
    if args.cmd == "rfx":
        return _rfx(args)
    if args.cmd == "render":
        return _render(args)
    if args.cmd == "recover":
        return _recover(args)
    if args.cmd in UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"`{args.cmd}` needs {UNPORTED_COMMANDS[args.cmd]}, not ported "
            "yet")
    fx = [f for f in args.fx.split(",") if f]
    p = build_player(args.uri, fx, args.width, args.height, args.sink,
                     args.out, device=args.device)
    srv = None
    if args.osc:
        from .osc.server import OSCServer
        srv = OSCServer(p, port=args.osc)
        srv.start()
    try:
        run_interactive(p, args.seconds)
    finally:
        if srv is not None:
            srv.stop()
    return 0


def _webui(args) -> int:
    """`webui` (`lives_tpu/cli.py:290-318`): a player on `--device` over
    the clip (or the plasma generator), an OSC server on it and the
    browser UI on `--port` (0 picks a free one), served until
    interrupted."""
    from .osc.server import OSCServer
    from .webui import WebUI
    p = build_player(args.uri, [], args.width, args.height, "null", None,
                     device=args.device)
    srv = OSCServer(p, port=args.osc)
    srv.start()
    ui = WebUI(srv, port=args.port).start()
    print(f"web ui: http://{ui.host}:{ui.port}/  (osc udp {srv.port})",
          flush=True)
    p.start()
    try:
        while True:
            p.process_one()
            time.sleep(0.001)
    except KeyboardInterrupt:
        pass
    finally:
        p.stop()
        ui.stop()
        srv.stop()
    return 0


def _recover(args) -> int:
    """`recover` (`lives_tpu/cli.py:227-240`): the journaled clips back into
    a `LiVESApp` on `--device` over the workdir, then its autosaved take
    rendered to a new clip there."""
    from .api import LiVESApp
    from .sets import recover_clips
    app = LiVESApp(workdir=args.workdir, device=args.device)
    n = recover_clips(app)
    print(f"recovered {n} journaled clip(s)")
    if not app.check_recording_recovery():
        print("no autosaved recording")
        return 0 if n else 1
    out = app.recover_recording(render_audio=not args.no_audio)
    if out is None:
        print("autosaved recording did not resolve (kept on disk)")
        return 1
    print(f"rendered take -> clip {out.number}: "
          f"{out.raw().frames} frames under {app.workdir}")
    return 0


def _render(args) -> int:
    """`render` (`lives_tpu/cli.py:243-285`): the layout's event list over
    the clips `--clip` maps (their MJPEG lanes through
    `MJPEGMultiClipSource`) or, with none, `DeviceSyntheticSource`, both on
    `--device`, rendered chunk by chunk into the YUV4MPEG encoder, which
    converts each chunk on the device, for a `.y4m` output, and else into
    the libav encoder frame by frame where the bridge loads (YUV4MPEG
    where it does not). `--audio` mixes the timeline's audio from the
    clips (`Multitrack.render_audio`) into the file, or a WAV beside a
    YUV4MPEG one."""
    import tempfile
    from .events.renderer import render_events
    from .io.clips import open_clip
    from .io.encoders import get_encoder, list_encoders
    from .multitrack import Multitrack
    from .utils.device import resolve_device
    device = resolve_device(args.device, "render")
    mt = Multitrack.load_layout(args.layout)   # .json OR binary .lay
    el = mt.el
    clips = {}
    for spec in args.clip:
        uid, _, path = spec.partition("=")
        clips[int(uid)] = open_clip(
            path, tempfile.mkdtemp(prefix="lives_tpu_render_"))
    if clips:
        from .io.jpeg_ingest import MJPEGMultiClipSource
        w = el.width or max(c.width for c in clips.values())
        h = el.height or max(c.height for c in clips.values())
        src = MJPEGMultiClipSource(clips, w, h, device=device)
    else:
        from .scenes import DeviceSyntheticSource
        src = DeviceSyntheticSource(el.height or 360, el.width or 640,
                                    device=device)

    ext = args.out.rsplit(".", 1)[-1].lower()
    if ext in ("y4m", "yuv4mpeg"):
        enc = "yuv4mpeg"
    else:
        enc = "av" if "av" in list_encoders() else "yuv4mpeg"

    def frames():
        for _, lay in render_events(el, src):
            if enc == "yuv4mpeg":
                yield lay.planes[0]          # a chunk, converted on device
            else:
                yield from lay.planes[0]     # frame by frame to libav
    audio = None
    if args.audio and clips:
        audio = mt.render_audio(
            {getattr(c, "unique_id", uid): c
             for uid, c in clips.items()} | clips)
    get_encoder(enc).encode(args.out, frames(), el.fps, audio=audio,
                            arate=44100)
    print(f"rendered -> {args.out} ({enc}"
          f"{', audio mixed' if audio is not None else ''})")
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
