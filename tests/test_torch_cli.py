"""The port's console (`lives_tpu_torch.cli`) against lives_tpu's, on the
CPU: `effects` lists the port's registered filters, `build_player` sets a
player up as the JAX console does, `play` runs a clip or the plasma
generator on the device it is given and, with no `--device`, refuses when
CUDA is absent instead of falling back; what is not ported raises naming
its ROADMAP item; `play --osc PORT` serves the OSC namespace on the
player and answers the queries the JAX console answers, with the same
replies; `recover` reopens a crashed session's journaled clips and
renders its autosaved take, printing what the JAX console prints, the
clip within 1 LSB of the JAX console's, and both refuse without CUDA
when no `--device` is given; `rfx` lists the rendered-effect scripts, shows a
script's parameters and applies it to a clip directory or a media file
on the device it is given, as the JAX console does (the frames within
the JAX script's tolerance, tests/test_torch_rfx.py); `render` renders a
`.lay` or `.json` layout over the synthetic source or MJPEG AVIs with a
WAV on the backing track: the Y4M frames within 1 LSB of the JAX
console's, the WAV beside it byte for byte the JAX console's and the
model's own mix, and without `--device` it refuses when CUDA is
absent."""

import numpy as np
import pytest
import torch

from lives_tpu import cli as jcli
from lives_tpu_torch import cli
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import get_filter, list_filters
from lives_tpu_torch.io.decoders import try_decoders, write_y4m
from lives_tpu_torch.player import NullSink, Y4MSink
from lives_tpu_torch.player.sinks import PNGSink


@pytest.fixture
def y4m_clip(tmp_path):
    """A 12-frame 32x16 YUV4MPEG clip at 30 fps."""
    rng = np.random.default_rng(3)
    path = tmp_path / "clip.y4m"
    write_y4m(str(path), [(rng.integers(16, 236, (16, 32), np.uint8),
                           rng.integers(16, 241, (8, 16), np.uint8),
                           rng.integers(16, 241, (8, 16), np.uint8))
                          for _ in range(12)], fps=30.0)
    return str(path)


def _listing(main, capsys):
    assert main(["effects"]) == 0
    return {ln[:24].strip(): ln[24:].strip()
            for ln in capsys.readouterr().out.splitlines()}


def test_effects_lists_the_ports_filters(capsys):
    got = _listing(cli.main, capsys)
    assert sorted(got) == [n for n in list_filters() if not n.startswith("_")]
    for name, desc in got.items():
        assert get_filter(name).description.strip() == desc
    # every filter the port registers is one the JAX console lists (a few
    # descriptions drop TPU wording: "MXU separable", cconx)
    assert set(got) <= set(_listing(jcli.main, capsys))


def test_effects_lists_every_jax_filter_but_the_deferred(capsys):
    """All 147 of the JAX console's builtins, puretext included, and
    nothing deferred (the JAX registry may also hold filters another test
    registered)."""
    from lives_tpu_torch.effects.host import DEFERRED
    got = _listing(cli.main, capsys)
    ref = _listing(jcli.main, capsys)
    assert len(got) == 147 and set(got) <= set(ref)
    assert {f"milk_{n}" for n in ("geometry", "pulse", "spin",
                                  "tunnel")} | {"puretext"} <= set(got)
    assert not DEFERRED


def test_build_player_matches_the_jax_console(y4m_clip, tmp_path):
    """A clip into a Y4M sink: the same sink spec and playback settings as
    the JAX console's build_player."""
    out = str(tmp_path / "out.y4m")
    p = cli.build_player(y4m_clip, ["negate", "saturation"], 0, 0, "y4m",
                         out, device="cpu")
    jp = jcli.build_player(y4m_clip, ["negate", "saturation"], 0, 0, "y4m",
                           out)

    def settings(q):
        return (q.precache_depth, q.pipeline_depth, q.fetch_batch,
                q.async_compile, q.adaptive_quality, int(q.sink_spec.palette),
                q.sink_spec.width, q.sink_spec.height, q.state.pb_fps,
                [q.keymap.current_filter(k) for k in range(3)])
    assert settings(p) == settings(jp)
    assert isinstance(p.sink, Y4MSink) and p.device == torch.device("cpu")
    assert int(p.sink_spec.palette) == int(Palette.YUV420P)


@pytest.mark.parametrize("sink", ["y4m", "null", "png"])
def test_build_player_plays_a_clip_on_the_cpu(y4m_clip, tmp_path, sink):
    out = str(tmp_path / ("out.y4m" if sink != "png" else "frames"))
    p = cli.build_player(y4m_clip, ["negate"], 0, 0, sink, out,
                         device="cpu")
    p.key_toggle(0, True)
    p.start()
    for k in range(6):
        p.state.frame = -1
        p.time_source = lambda k=k: (k + 0.5) / 30.0
        p.process_one()
    p.stop()
    assert p.frames_shown == 6
    if sink == "y4m":
        cd = try_decoders(out)
        assert (cd.nframes, cd.width, cd.height) == (6, 32, 16)
        cd.decoder.close()
    elif sink == "png":
        assert isinstance(p.sink, PNGSink) and p.sink.n == 6
        cd = try_decoders(out)
        assert (cd.decoder.name, cd.nframes, cd.width, cd.height) == \
            ("imageseq", 6, 32, 16)
    else:
        assert isinstance(p.sink, NullSink) and p.sink.count == 6


def test_build_player_without_a_clip_plays_plasma():
    p = cli.build_player(None, ["saturation"], 32, 16, "null", None,
                         device="cpu")
    assert p.state.fg_clip.name == "plasma"
    assert p.state.fg_clip.device == torch.device("cpu")
    p.start()
    assert p.process_one()
    p.stop()
    assert p.frames_shown == 1


def test_play_runs_for_its_seconds_on_the_cpu(y4m_clip, capsys):
    assert cli.main(["play", y4m_clip, "--fx", "gaussian_blur",
                     "--seconds", "0.3", "--device", "cpu"]) == 0
    assert "frame" in capsys.readouterr().err


def test_play_without_device_refuses_when_cuda_is_absent(y4m_clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["play", y4m_clip, "--seconds", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_player(None, [], 32, 16, "null", None)


#: the sinks `build_player` refused naming their ROADMAP item until the
#: gated backends were ported
FORMERLY_UNPORTED = {"sdl": 23, "vjack": 23}


@pytest.mark.parametrize("sink,item", sorted(FORMERLY_UNPORTED.items()))
def test_unported_sinks_raise_naming_their_item(sink, item, monkeypatch):
    """No sink is left unported: the sdl and vjack sinks build (over mock
    libraries) as the JAX console's do, with the same sink spec
    (`tests/test_torch_display_sinks.py`, `tests/test_torch_videojack.py`
    hold their frames)."""
    import lives_tpu.io.videojack as jvj
    import lives_tpu.player.sdl as jsdl
    import lives_tpu_torch.io.videojack as tvj
    import lives_tpu_torch.player.sdl as tsdl
    from test_torch_display_sinks import MockSDL
    from test_torch_videojack import FakeVJackLib
    assert sink not in cli.UNPORTED_SINKS
    for mod in (jsdl, tsdl):
        monkeypatch.setattr(mod, "load_libsdl2", lambda: MockSDL())
    for mod in (jvj, tvj):
        monkeypatch.setattr(mod, "load_vjack", lambda: FakeVJackLib())
    p = cli.build_player(None, [], 32, 16, sink, None, device="cpu")
    jp = jcli.build_player(None, [], 32, 16, sink, None)
    assert type(p.sink).__name__ == type(jp.sink).__name__
    assert (p.sink_spec.width, p.sink_spec.height, p.sink_spec.palette) \
        == (jp.sink_spec.width, jp.sink_spec.height, jp.sink_spec.palette)


#: the JAX console's subcommands (`lives_tpu/cli.py:152-210`)
JAX_COMMANDS = ["play", "effects", "render", "selftest", "recover", "rfx",
                "webui"]


@pytest.mark.parametrize("cmd", JAX_COMMANDS)
def test_every_jax_subcommand_is_ported(cmd, capsys):
    assert not cli.UNPORTED_COMMANDS
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    assert "not ported" not in capsys.readouterr().out


def test_selftest_passes_on_the_cpu_as_jax(capsys):
    assert cli.main(["selftest", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jcli.main(["selftest"]) == 0
    ref = capsys.readouterr().out.splitlines()
    assert got == ref and len(got) == 6
    assert all(ln.startswith("PASS ") for ln in got)


def test_selftest_without_device_refuses_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["selftest"])


def test_webui_serves_on_port_0_and_stops(monkeypatch, capsys):
    """`webui --port 0` on the CPU: the page and the state answer while
    it serves, and it stops on an interrupt, as from Ctrl-C."""
    import json
    import threading
    import urllib.request
    from lives_tpu_torch import webui
    from lives_tpu_torch.player import Player
    up, uis, interrupt = threading.Event(), [], threading.Event()
    start, process_one = webui.WebUI.start, Player.process_one

    def started(self):
        uis.append(start(self))
        up.set()
        return uis[-1]

    def processed(self):
        if interrupt.is_set():
            raise KeyboardInterrupt
        return process_one(self)
    monkeypatch.setattr(webui.WebUI, "start", started)
    monkeypatch.setattr(Player, "process_one", processed)
    rc = []
    th = threading.Thread(target=lambda: rc.append(cli.main(
        ["webui", "--device", "cpu", "--port", "0", "--width", "32",
         "--height", "16"])), daemon=True)
    th.start()
    assert up.wait(60), "the web UI did not start"
    base = f"http://{uis[0].host}:{uis[0].port}"
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        assert r.read() == webui._PAGE.encode()
    with urllib.request.urlopen(base + "/api/state", timeout=30) as r:
        state = json.loads(r.read())
    assert state["clips"] == [] and len(state["keys"]) == 9
    interrupt.set()
    th.join(timeout=60)
    assert not th.is_alive() and rc == [0]
    assert f"web ui: http://127.0.0.1:{uis[0].port}/" in \
        capsys.readouterr().out


@pytest.mark.parametrize("sink", ["stream", "l2l"])
def test_play_streams_to_a_receiver(y4m_clip, sink):
    """`play --sink stream|l2l --out host:port` on the CPU: the port's
    receiver on port 0 gets the clip's frames as RGB24."""
    import threading
    from lives_tpu_torch.stream import L2LReceiver, StreamReceiver
    rx = (StreamReceiver if sink == "stream" else L2LReceiver)(port=0)
    try:
        assert cli.main(["play", y4m_clip, "--sink", sink, "--out",
                         f"127.0.0.1:{rx.port}", "--seconds", "0.5",
                         "--device", "cpu"]) == 0
        ev = threading.Event()
        for _ in range(2000):
            if rx.received:
                break
            ev.wait(0.01)
        lay = rx.get_frame(0)
        assert rx.received >= 1
        assert (lay.width, lay.height, lay.palette) == \
            (32, 16, int(Palette.RGB24))
    finally:
        rx.close()


def test_play_av_sink_writes_through_the_bridge(y4m_clip, tmp_path):
    from lives_tpu_torch.io.av import load_avbridge
    if load_avbridge() is None:
        pytest.skip("no libav lane on this host")
    out = tmp_path / "out.mkv"
    p = cli.build_player(y4m_clip, [], 0, 0, "av", str(out), device="cpu")
    from lives_tpu_torch.player.sinks import AVStreamSink
    assert isinstance(p.sink, AVStreamSink) and p.sink.url == str(out)
    assert cli.main(["play", y4m_clip, "--sink", "av", "--out", str(out),
                     "--seconds", "0.3", "--device", "cpu"]) == 0
    assert out.stat().st_size > 0


def test_play_av_sink_raises_the_bridges_error_where_absent(y4m_clip,
                                                             tmp_path,
                                                             monkeypatch):
    """Without the libav bridge the console raises the bridge's own
    error when playback opens the sink, as the JAX console's sink does."""
    import lives_tpu.io.av as jav
    import lives_tpu_torch.io.av as tav
    monkeypatch.setattr(tav, "load_avbridge", lambda: None)
    monkeypatch.setattr(jav, "load_avbridge", lambda: None)
    out = str(tmp_path / "out.mkv")
    with pytest.raises(RuntimeError, match="no libav lane") as got:
        cli.main(["play", y4m_clip, "--sink", "av", "--out", out,
                  "--seconds", "0.3", "--device", "cpu"])
    # the JAX console's sink, as its `play` opens it
    jp = jcli.build_player(y4m_clip, [], 0, 0, "av", out)
    with pytest.raises(RuntimeError, match="avbridge unavailable") as ref:
        jp.sink.init_screen(32, 16, 30.0)
    assert type(got.value) is type(ref.value)


def _free_port():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _osc_session(main, argv, queries):
    """Run `main(argv)` (a `play --osc` console) on a thread and send it
    `queries` through the port's OSCClient, each retried until the server
    answers; returns the replies."""
    import threading
    import time
    from lives_tpu_torch.osc import OSCClient
    port = int(argv[argv.index("--osc") + 1])
    rc = []
    th = threading.Thread(target=lambda: rc.append(main(argv)), daemon=True)
    th.start()
    out = []
    with OSCClient(port=port, timeout=0.5) as c:
        deadline = time.monotonic() + 60.0
        for q in queries:
            while True:
                try:
                    out.append(c.query(*q))
                    break
                except OSError:
                    assert time.monotonic() < deadline, "no OSC answer"
    th.join(timeout=60)
    assert not th.is_alive() and rc == [0]
    return out


def test_play_osc_answers_like_the_jax_console(y4m_clip, monkeypatch,
                                               tmp_path):
    import sys
    # a stdin that is no terminal (both consoles then take no keys)
    null = open(tmp_path / "stdin", "w+")
    monkeypatch.setattr(sys, "stdin", null)
    queries = [("/ping",), ("/app/ping",), ("/app/name/get",),
               ("/clip/frame/count",), ("/clip/size/get",),
               ("/video/fps/get",), ("/effect_key/name/get", 1),
               ("/clip/fps/get",)]
    argv = ["play", y4m_clip, "--fx", "negate", "--seconds", "3"]
    port = _free_port()
    got = _osc_session(cli.main, argv + ["--osc", str(port), "--device",
                                         "cpu"], queries)
    assert got[0] == ["pong"]
    port = _free_port()
    ref = _osc_session(jcli.main, argv + ["--osc", str(port)], queries)
    null.close()
    assert got == ref


def test_play_osc_without_device_refuses_when_cuda_is_absent(y4m_clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["play", y4m_clip, "--osc", str(_free_port()),
                  "--seconds", "0.1"])


def _crashed_session(pkg, root, clip_path, monkeypatch, n=5):
    """A workdir a session left behind after a take it did not render:
    its clip journaled, its take autosaved by record_stop."""
    import random
    import chip_smoke as cs
    from test_torch_weed_binary import _Counter
    if pkg == "jax":
        import lives_tpu.api as api
        import lives_tpu.events.event_list as elmod
        import lives_tpu.io.clips as clips
        from lives_tpu.player import player as pmod
        kw = {}
    else:
        import lives_tpu_torch.api as api
        import lives_tpu_torch.events.event_list as elmod
        import lives_tpu_torch.io.clips as clips
        from lives_tpu_torch.player import player as pmod
        kw = {"device": "cpu"}
    clock = cs.ScriptedClock()
    monkeypatch.setattr(pmod, "time", clock)
    monkeypatch.setattr(elmod, "uuid", _Counter())
    monkeypatch.setattr(clips, "_handle_counter", 0)
    random.seed(5)
    app = api.LiVESApp(workdir=root, **kw)
    app.player._player.async_compile = False
    app.open_file(clip_path)
    app.effect_key_map[0].map("negate")
    app.player.play()
    app.player.record_start()
    for i in range(n):
        if i == 2:
            app.effect_key_map[0].set_enabled(True)
        p = app.player._player
        p.state.frame, p._clock0, p._frame0 = -1, clock.now, float(i)
        p.process_one()
        clock.now += 1 / 30.0
    app.player.record_stop()
    app.player.stop()
    app.quit()
    return root


def test_recover_prints_what_the_jax_console_prints(y4m_clip, tmp_path,
                                                    monkeypatch, capsys):
    from lives_tpu_torch.io.clips import Clip
    from test_torch_osc import assert_clips_within_1
    import lives_tpu.io.clips as jclips
    outs, made = {}, {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("torch", cli.main, ["--device", "cpu"])):
        wd = _crashed_session(pkg, tmp_path / pkg, y4m_clip, monkeypatch)
        capsys.readouterr()
        assert main(["recover", str(wd)] + extra) == 0
        outs[pkg] = capsys.readouterr().out.replace(str(wd), "<wd>")
        assert not (wd / "recording.autosave.json").exists()
        load = jclips.Clip.load if pkg == "jax" else Clip.load
        made[pkg] = load(sorted(d for d in wd.iterdir()
                                if (d / "header.lives").is_file())[-1])
        # a second run: the journal again, no autosave left
        assert main(["recover", str(wd), "--no-audio"] + extra) == 0
        outs[pkg] += capsys.readouterr().out.replace(str(wd), "<wd>")
    assert outs["torch"] == outs["jax"]
    assert "rendered take -> clip 2: 4 frames under <wd>" in outs["torch"]
    assert "no autosaved recording" in outs["torch"]
    assert_clips_within_1(made["jax"], made["torch"])


def test_recover_an_empty_workdir_like_jax(tmp_path, capsys):
    assert jcli.main(["recover", str(tmp_path / "j")]) == 1
    ref = capsys.readouterr().out
    assert cli.main(["recover", str(tmp_path / "t"), "--device",
                     "cpu"]) == 1
    assert capsys.readouterr().out == ref == (
        "recovered 0 journaled clip(s)\nno autosaved recording\n")


def test_recover_without_device_refuses_when_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["recover", str(tmp_path / "wd")])


def _out(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_rfx_lists_the_scripts_like_jax(capsys):
    got = _out(cli.main, ["rfx"], capsys)
    assert got == _out(jcli.main, ["rfx"], capsys)
    assert len(got.splitlines()) == 52 and "sepia" in got


@pytest.mark.parametrize("script", ["blur", "fade_in_out",
                                    "transition_fade", "textover"])
def test_rfx_shows_a_scripts_params_like_jax(capsys, script):
    assert _out(cli.main, ["rfx", script], capsys) == \
        _out(jcli.main, ["rfx", script], capsys)


@pytest.mark.parametrize("target", ["media_file", "clip_dir"])
def test_rfx_applies_a_script_like_jax(y4m_clip, tmp_path, capsys, target):
    """`rfx posterize <target> --param levels=3 --start 2 --end 9`: the
    frames the JAX console writes, byte for byte."""
    import shutil
    from lives_tpu.io.clips import Clip as JClip
    from lives_tpu_torch.io.clips import Clip, open_clip
    outs = {}
    for pkg, main in (("t", cli.main), ("j", jcli.main)):
        d = tmp_path / pkg
        d.mkdir()
        src = shutil.copy(y4m_clip, d / "clip.y4m")
        if target == "clip_dir":
            src = open_clip(str(src), d).clip_dir
        argv = ["rfx", "posterize", str(src), "--param", "levels=3",
                "--start", "2", "--end", "9"]
        out = _out(main, argv + (["--device", "cpu"] if pkg == "t" else []),
                   capsys)
        assert out.startswith("posterize: 7 frames -> ")
        cdir = out.strip().rsplit(" ", 1)[1]
        outs[pkg] = (Clip if pkg == "t" else JClip).load(cdir)
    t, j = outs["t"], outs["j"]
    assert [t.is_virtual_frame(n) for n in range(12)] == \
        [not 2 <= n < 9 for n in range(12)]
    for n in range(2, 9):
        assert t.image_path(n).read_bytes() == j.image_path(n).read_bytes()


def test_rfx_without_device_refuses_when_cuda_is_absent(y4m_clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["rfx", "sepia", y4m_clip])


# -- render ---------------------------------------------------------------------

def _y4m_frames(path):
    cd = try_decoders(str(path))
    out = [np.concatenate([np.asarray(p).reshape(-1) for p in
                           (cd.decoder.get_frame(n).planes)])
           for n in range(cd.nframes)]
    cd.decoder.close()
    return np.stack(out)


def _layout(tmp_path, suffix, n_frames=10, w=64, h=32, audio_uid=None,
            clip_frames=4):
    """Phase 22's model layout (`chip_smoke.config4_model`) at a small
    size, saved by the port."""
    import chip_smoke as cs
    from lives_tpu_torch.multitrack import Multitrack
    mt = cs.config4_model(Multitrack, n_frames, w, h, audio_uid=audio_uid,
                          clip_frames=clip_frames)
    path = tmp_path / f"layout{suffix}"
    mt.save_layout(str(path))
    return path


def _render_both(monkeypatch, tmp_path, argv, capsys):
    """`render` through both consoles into their own outputs: (port's Y4M,
    JAX's Y4M), the port's on the CPU."""
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    outs = {}
    for pkg, main in (("t", cli.main), ("j", jcli.main)):
        out = tmp_path / f"{pkg}.y4m"
        extra = ["--device", "cpu"] if pkg == "t" else []
        assert main(["render", *argv, "--out", str(out), *extra]) == 0
        assert capsys.readouterr().out.startswith(f"rendered -> {out}")
        outs[pkg] = out
    return outs["t"], outs["j"]


@pytest.mark.parametrize("suffix", [".lay", ".json"])
def test_render_synthetic_layout_matches_jax(monkeypatch, tmp_path, capsys,
                                             suffix):
    """A `.lay` or `.json` layout with no clip: the synthetic source, the
    frames within 1 LSB of the JAX console's."""
    lay = _layout(tmp_path, suffix)
    t, j = _render_both(monkeypatch, tmp_path, [str(lay)], capsys)
    a, b = _y4m_frames(t), _y4m_frames(j)
    assert a.shape == b.shape and len(a) == 10
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("suffix", ["mkv", "avi"])
def test_render_picks_the_encoder_the_jax_console_picks(monkeypatch,
                                                        tmp_path, capsys,
                                                        suffix):
    """A suffix other than `.y4m` renders through the libav encoder where
    the bridge loads, else YUV4MPEG, as the JAX console does
    (`lives_tpu/cli.py:272-276`): both print the same encoder, and where
    it is libav both files decode to the same frame count and geometry."""
    from lives_tpu_torch.io.av import load_avbridge
    from lives_tpu_torch.io.decoders import try_decoders
    from test_torch_bridges import jax_bridge
    if load_avbridge() is not None:
        jax_bridge("avbridge")
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    lay = _layout(tmp_path, ".lay", n_frames=4)
    said = {}
    for pkg, main in (("t", cli.main), ("j", jcli.main)):
        out = tmp_path / f"{pkg}.{suffix}"
        extra = ["--device", "cpu"] if pkg == "t" else []
        assert main(["render", str(lay), "--out", str(out), *extra]) == 0
        said[pkg] = capsys.readouterr().out.split("(")[1].split(")")[0]
    assert said["t"] == said["j"] == \
        ("av" if load_avbridge() is not None else "yuv4mpeg")
    if said["t"] == "av":
        t, j = (try_decoders(str(tmp_path / f"{p}.{suffix}"))
                for p in "tj")
        assert (t.nframes, t.width, t.height) == \
            (j.nframes, j.width, j.height)
        assert t.nframes == 4


def test_render_clips_and_audio_match_jax(monkeypatch, tmp_path, capsys):
    """Ten MJPEG AVIs (`chip_smoke.write_mjpeg_clips`) and a 48 kHz WAV on
    the backing track: the frames within 1 LSB of the JAX console's; the
    WAV beside the output byte for byte the JAX console's, and the mix
    `Multitrack.render_audio` gives called directly."""
    import chip_smoke as cs
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.encoders import get_encoder
    from lives_tpu_torch.multitrack import Multitrack
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    from test_torch_bridges import jax_bridge
    jax_bridge("jpegcoef")
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 32)
    cs.write_mjpeg_clips(str(tmp_path), DeviceSyntheticSource(
        32, 64, device="cpu"), 10, 4)
    wav = tmp_path / "audio.wav"
    assert get_encoder("wav").encode(str(wav), [], 30.0,
                                     cs.editor_audio(0.5), 48000)
    lay = _layout(tmp_path, ".lay", audio_uid=11)
    argv = [str(lay), "--audio", "--clip", f"11={wav}"] + [
        a for c in range(1, 11)
        for a in ("--clip", f"{c}={tmp_path / f'clip{c}.avi'}")]
    t, j = _render_both(monkeypatch, tmp_path, argv, capsys)
    a, b = _y4m_frames(t), _y4m_frames(j)
    assert a.shape == b.shape and len(a) == 10 and a.std() > 10
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    tw, jw = t.with_suffix(".wav").read_bytes(), \
        j.with_suffix(".wav").read_bytes()
    assert tw == jw
    direct = Multitrack.load_layout(str(lay)).render_audio(
        {11: open_clip(str(wav), tmp_path / "w")})
    assert np.abs(direct).max() > 0.05
    ref = tmp_path / "direct.wav"
    assert get_encoder("wav").encode(str(ref), [], 30.0, direct, 44100)
    assert ref.read_bytes() == tw


def test_render_without_device_refuses_when_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    lay = _layout(tmp_path, ".lay", n_frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", str(lay), "--out", str(tmp_path / "o.y4m")])
    assert not (tmp_path / "o.y4m").exists()
