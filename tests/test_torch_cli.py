"""The port's console (`lives_tpu_torch.cli`) against lives_tpu's, on the
CPU: `effects` lists the port's registered filters, `build_player` sets a
player up as the JAX console does, `play` runs a clip or the plasma
generator on the device it is given and, with no `--device`, refuses when
CUDA is absent instead of falling back; what is not ported raises naming
its ROADMAP item; `rfx` lists the rendered-effect scripts, shows a
script's parameters and applies it to a clip directory or a media file
on the device it is given, as the JAX console does (the frames within
the JAX script's tolerance, tests/test_torch_rfx.py)."""

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
    """142 of the JAX console's 147 builtins: all but puretext and the
    four milkdrop presets, each of which `DEFERRED` names with its item
    (the JAX registry may also hold filters another test registered)."""
    from lives_tpu_torch.effects.host import DEFERRED
    got = _listing(cli.main, capsys)
    ref = _listing(jcli.main, capsys)
    assert len(got) == 142 and set(got) <= set(ref)
    assert sorted(DEFERRED) == ["milk_geometry", "milk_pulse", "milk_spin",
                                "milk_tunnel", "puretext"]
    assert set(DEFERRED) <= set(ref) - set(got)
    assert all("ROADMAP" in why for why in DEFERRED.values())


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


@pytest.mark.parametrize("sink,item", sorted(cli.UNPORTED_SINKS.items()))
def test_unported_sinks_raise_naming_their_item(sink, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        cli.build_player(None, [], 32, 16, sink, None, device="cpu")


@pytest.mark.parametrize("cmd", sorted(cli.UNPORTED_COMMANDS))
def test_unported_subcommands_raise_naming_their_item(cmd):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        cli.main([cmd])


def test_osc_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 23"):
        cli.main(["play", "--osc", "9000", "--device", "cpu"])


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
