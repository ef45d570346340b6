"""The display sinks of lives_tpu_torch (`player/gl.py`, `player/sdl.py`,
`player/sinks.VLoopbackSink`) against lives_tpu's, over the same mock
libraries.

The mocks are `tests/test_gl_sink.py`'s and `tests/test_sdl_sink.py`'s,
copied. Each scenario plays the same seeded frames through both packages'
sinks; the calls the mocks record and the uploaded bytes must be equal
(u8, exact: the sink converts to RGB24 on the frame's device and uploads
what it fetched).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lives_tpu.player.gl as jgl
import lives_tpu.player.sdl as jsdl
import lives_tpu.player.sinks as jsinks
import lives_tpu_torch.player.gl as tgl
import lives_tpu_torch.player.sdl as tsdl
import lives_tpu_torch.player.sinks as tsinks
from lives_tpu.constants import Palette as JPalette
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.layer import Layer

GL = {"jax": jgl, "torch": tgl}
SDL = {"jax": jsdl, "torch": tsdl}


class MockEGL:
    def __init__(self):
        self.calls = []
        self.swaps = 0

    def __getattr__(self, name):
        def fn(*args, _name=name):
            self.calls.append((_name, args))
            if _name == "eglSwapBuffers":
                self.swaps += 1
            if _name == "eglChooseConfig":
                # write count=1 through the num_config pointer
                args[4]._obj.value = 1
                return 1
            if _name in ("eglGetDisplay", "eglCreatePbufferSurface",
                         "eglCreateContext"):
                return 1234
            return 1
        return fn


class MockGL:
    def __init__(self):
        self.calls = []
        self.tex_uploads = []

    def __getattr__(self, name):
        def fn(*args, _name=name):
            self.calls.append((_name, args))
            if _name == "glGenTextures":
                args[1]._obj.value = 7
            if _name == "glTexSubImage2D":
                w, h = args[4], args[5]
                buf = ctypes.cast(
                    args[8], ctypes.POINTER(ctypes.c_ubyte * (w * h * 3)))
                self.tex_uploads.append(
                    np.frombuffer(bytes(buf.contents), np.uint8)
                    .reshape(h, w, 3).copy())
            return 1
        return fn


class MockSDL:
    def __init__(self):
        self.calls = []
        self.textures = {}
        self.quit_pending = False

    def SDL_Init(self, flags):
        self.calls.append("init")
        return 0

    def SDL_CreateWindow(self, title, x, y, w, h, flags):
        self.calls.append(("window", title, x, y, w, h, flags))
        return 1

    def SDL_CreateRenderer(self, win, idx, flags):
        self.calls.append(("renderer", idx, flags))
        return 2

    def SDL_CreateTexture(self, ren, fmt, access, w, h):
        self.calls.append(("texture", fmt, access, w, h))
        self.textures[3] = (w, h, None)
        return 3

    def SDL_UpdateTexture(self, tex, rect, pixels, pitch):
        w, h, _ = self.textures[3]
        self.calls.append(("update", pitch))
        buf = ctypes.string_at(pixels, pitch * h)
        self.textures[3] = (w, h, np.frombuffer(buf, np.uint8
                                                ).reshape(h, w, 3).copy())
        return 0

    def SDL_RenderClear(self, ren):
        return 0

    def SDL_RenderCopy(self, ren, tex, a, b):
        self.calls.append("copy")
        return 0

    def SDL_RenderPresent(self, ren):
        self.calls.append("present")

    def SDL_PollEvent(self, ev):
        if self.quit_pending:
            self.quit_pending = False
            ctypes.memmove(ev, jsdl.SDL_QUIT_EVENT.to_bytes(4, "little"), 4)
            return 1
        return 0

    def SDL_DestroyTexture(self, t):
        self.calls.append("dtex")

    def SDL_DestroyRenderer(self, r):
        self.calls.append("dren")

    def SDL_DestroyWindow(self, w):
        self.calls.append("dwin")

    def SDL_Quit(self):
        self.calls.append("quit")


def frame(pkg, h, w, seed, pal=Palette.RGB24):
    """A seeded frame of palette `pal` as `pkg`'s Layer (YUV420P: three
    planes)."""
    rng = np.random.default_rng(seed)
    if pal == Palette.YUV420P:
        arrs = [rng.integers(16, 236, s, np.uint8)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    else:
        c = 4 if pal == Palette.RGBA32 else 3
        arrs = [rng.integers(0, 256, (c, h, w), np.uint8)]
    if pkg == "jax":
        return JLayer(planes=tuple(jnp.asarray(a) for a in arrs),
                      palette=int(pal))
    return Layer(planes=tuple(torch.from_numpy(a) for a in arrs),
                 palette=int(pal))


def canon(calls):
    """Calls with ctypes arguments read out, comparable across packages."""
    out = []
    for name, args in calls:
        vals = []
        for a in args:
            if hasattr(a, "_obj"):
                a = ("ref", type(a._obj).__name__)
            elif isinstance(a, ctypes.Array):
                a = ("array", tuple(a))
            elif isinstance(a, (ctypes.c_float, ctypes.c_int,
                                ctypes.c_uint)):
                a = a.value
            elif isinstance(a, ctypes.c_void_p):
                a = "ptr"
            vals.append(a)
        out.append((name, tuple(vals)))
    return out


def gl_session(pkg, frames, init=True):
    egl, gl = MockEGL(), MockGL()
    sink = GL[pkg].GLSink(libs=(egl, gl))
    if init:
        sink.init_screen(frames[0].width, frames[0].height, 25.0)
    for i, f in enumerate(frames):
        assert sink.play_frame(f, i / 25.0)
    shown = sink.frames_shown
    sink.exit_screen()
    sink.exit_screen()
    return {"egl": canon(egl.calls), "gl": canon(gl.calls),
            "uploads": gl.tex_uploads, "swaps": egl.swaps, "shown": shown}


@pytest.mark.parametrize("pal", [Palette.RGB24, Palette.RGBA32,
                                 Palette.YUV420P])
@pytest.mark.parametrize("init", [True, False])
def test_gl_sink_session_matches_jax(pal, init):
    """init (or the lazy init of the first frame), three frames, exit: the
    same EGL and GL calls, the same texture bytes (RGB24 interleaved,
    converted from the frame's palette), the same swaps."""
    res = {pkg: gl_session(pkg, [frame(pkg, 12, 16, s, pal)
                                 for s in range(3)], init)
           for pkg in GL}
    t, j = res["torch"], res["jax"]
    assert t["egl"] == j["egl"] and t["gl"] == j["gl"]
    assert t["swaps"] == j["swaps"] == t["shown"] == 3
    assert len(t["uploads"]) == 3
    for a, b in zip(t["uploads"], j["uploads"]):
        np.testing.assert_array_equal(a, b)


def test_gl_constants_and_gate_match_jax(monkeypatch):
    for name in dir(jgl):
        if name.startswith(("GL_", "EGL_")):
            assert getattr(tgl, name) == getattr(jgl, name), name
    assert tgl.GLSink.palette_list == tuple(jgl.GLSink.palette_list)
    for mod in GL.values():
        monkeypatch.setattr(mod, "load_libgl", lambda: None)
        with pytest.raises(RuntimeError, match="EGL/GL unavailable"):
            mod.GLSink()


def test_gl_sink_uploads_the_pixels_of_a_device_layer():
    """The upload is the frame's own pixels, HWC, whatever device the
    frame was on (one copy to the host)."""
    lay = frame("torch", 8, 10, 9)
    res = gl_session("torch", [lay])
    np.testing.assert_array_equal(
        res["uploads"][0], lay.planes[0].permute(1, 2, 0).numpy())


def sdl_session(pkg, frames, init=True, quit_at=None):
    mock = MockSDL()
    s = SDL[pkg].SDLSink(lib=mock)
    if init:
        s.init_screen(frames[0].width, frames[0].height, 25.0)
    shown, oks = [], []
    for i, f in enumerate(frames):
        mock.quit_pending = i == quit_at
        oks.append(s.play_frame(f, i / 25.0))
        shown.append(mock.textures[3][2])
    s.exit_screen()
    return {"calls": mock.calls, "shown": shown, "oks": oks,
            "count": s.frames_shown}


@pytest.mark.parametrize("pal", [Palette.RGB24, Palette.YUV420P])
@pytest.mark.parametrize("init", [True, False])
def test_sdl_sink_session_matches_jax(pal, init):
    res = {pkg: sdl_session(pkg, [frame(pkg, 8, 16, s + 4, pal)
                                  for s in range(3)], init)
           for pkg in SDL}
    t, j = res["torch"], res["jax"]
    assert t["calls"] == j["calls"] and t["oks"] == j["oks"] == [True] * 3
    assert t["count"] == j["count"] == 3
    for a, b in zip(t["shown"], j["shown"]):
        np.testing.assert_array_equal(a, b)
    assert "quit" in t["calls"] and "dwin" in t["calls"]


def test_sdl_quit_event_stops_playback_like_jax():
    res = {pkg: sdl_session(pkg, [frame(pkg, 8, 16, s) for s in range(3)],
                            quit_at=1)
           for pkg in SDL}
    assert res["torch"]["oks"] == res["jax"]["oks"] == [True, False, True]


def test_sdl_constants_and_gate_match_jax(monkeypatch):
    for name in dir(jsdl):
        if name.startswith("SDL_"):
            assert getattr(tsdl, name) == getattr(jsdl, name), name
    assert (tsdl.load_libsdl2() is None) == (jsdl.load_libsdl2() is None)
    for mod in SDL.values():
        monkeypatch.setattr(mod, "load_libsdl2", lambda: None)
        with pytest.raises(RuntimeError, match="SDL2 unavailable"):
            mod.SDLSink()


def test_sdl_fullscreen_and_vsync_flags_match_jax():
    res = {}
    for pkg, mod in SDL.items():
        mock = MockSDL()
        s = mod.SDLSink(title="t", fullscreen=True, vsync=False, lib=mock)
        s.init_screen(32, 16, 30.0)
        res[pkg] = mock.calls
    assert res["torch"] == res["jax"]


@pytest.fixture
def fake_v4l2_node(tmp_path, monkeypatch):
    """A regular file standing in for /dev/videoN, and `fcntl.ioctl`
    recording VIDIOC_S_FMT in place of the v4l2loopback module."""
    import fcntl
    node = tmp_path / "video10"
    node.write_bytes(b"")
    seen = []

    def ioctl(fd, req, arg, *rest):
        seen.append((req, bytes(arg)))
        return 0
    monkeypatch.setattr(fcntl, "ioctl", ioctl)
    return node, seen


def test_vloopback_sink_writes_what_jax_writes(fake_v4l2_node):
    """`VLoopbackSink` (`lives_tpu/player/sinks.py:190-233`): the same
    VIDIOC_S_FMT and the same raw RGB24 bytes, frame after frame."""
    node, seen = fake_v4l2_node
    out = {}
    for pkg, mod in (("jax", jsinks), ("torch", tsinks)):
        node.write_bytes(b"")
        s = mod.VLoopbackSink(str(node))
        s.init_screen(16, 8, 25.0)
        for i in range(3):
            assert s.play_frame(frame(pkg, 8, 16, 20 + i), i / 25.0)
        s.exit_screen()
        s.exit_screen()
        out[pkg] = (node.read_bytes(), s.frames, seen[-1])
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]) == 3 * 8 * 16 * 3
    assert tsinks.VLoopbackSink.palette_list == \
        tuple(jsinks.VLoopbackSink.palette_list)


def test_vloopback_sink_is_gated_on_its_device(tmp_path):
    for mod in (jsinks, tsinks):
        with pytest.raises(RuntimeError, match="v4l2loopback not loaded"):
            mod.VLoopbackSink(str(tmp_path / "no-such-video"))


def test_console_sdl_sink_builds_like_jax(monkeypatch):
    """`play --sink sdl` builds an `SDLSink` and the default sink spec,
    as the JAX console does (`lives_tpu/cli.py:51-52`); without SDL2 both
    raise its RuntimeError."""
    from lives_tpu import cli as jcli
    from lives_tpu_torch import cli
    assert not cli.UNPORTED_SINKS
    for mod in SDL.values():
        monkeypatch.setattr(mod, "load_libsdl2", lambda: MockSDL())
    p = cli.build_player(None, [], 32, 16, "sdl", None, device="cpu")
    jp = jcli.build_player(None, [], 32, 16, "sdl", None)
    assert isinstance(p.sink, tsdl.SDLSink) and \
        isinstance(jp.sink, jsdl.SDLSink)
    assert (p.sink_spec.width, p.sink_spec.height, p.sink_spec.palette) \
        == (jp.sink_spec.width, jp.sink_spec.height, jp.sink_spec.palette)
    for mod in SDL.values():
        monkeypatch.setattr(mod, "load_libsdl2", lambda: None)
    with pytest.raises(RuntimeError, match="SDL2 unavailable"):
        cli.build_player(None, [], 32, 16, "sdl", None, device="cpu")


def test_player_plays_into_the_gl_sink_like_jax(monkeypatch):
    """A player on a seeded clip under a key into `GLSink`: the uploads
    are the JAX player's within 1 LSB (its chain's float math)."""
    import chip_smoke as cs
    import lives_tpu.player.player as j_player_mod
    import lives_tpu_torch.player.player as t_player_mod
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.player import Player
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")

    class Clip:
        width, height, fps, frames = 24, 12, 25.0, 8

        def __init__(self, pkg):
            self.pkg = pkg

        def get_frame(self, n):
            return frame(self.pkg, 12, 24, 40 + n)
    ups = {}
    for pkg, P, mod in (("jax", JPlayer, j_player_mod),
                        ("torch", Player, t_player_mod)):
        clock = cs.ScriptedClock()
        monkeypatch.setattr(mod, "time", clock)
        gl = MockGL()
        sink = GL[pkg].GLSink(libs=(MockEGL(), gl))
        p = P(sink=sink) if pkg == "jax" else P(sink=sink, device="cpu")
        p.async_compile = False
        p.state.fg_clip = Clip(pkg)
        p.keymap.set_key(0, 0, "saturation")
        p.key_toggle(0, True)
        p.start()
        for i in (0, 4, 7):
            p.state.frame = -1
            p._clock0, p._frame0 = clock.now, float(i)
            assert p.process_one()
        p.stop()
        ups[pkg] = gl.tex_uploads
    assert len(ups["torch"]) == len(ups["jax"]) == 3
    for a, b in zip(ups["torch"], ups["jax"]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_player_exports_the_gl_sink():
    import lives_tpu.player as jp
    import lives_tpu_torch.player as tp
    assert set(jp.__dict__) >= {"GLSink", "PNGSink"}
    assert tp.GLSink is tgl.GLSink and tp.PNGSink is tsinks.PNGSink
    assert os.path.basename(tgl.__file__) == "gl.py"
