"""Video-JACK receive and send of lives_tpu_torch (`io/videojack.py`)
against lives_tpu's, over the same fake videojack libjack.

The fake is `tests/test_videojack.py`'s, copied. Each scenario feeds the
same seeded RGBA frames to both packages' `VJackSource` or plays them into
both `VJackSink`s; frames, port buffers and the library's state must
agree: u8 exact where the frame keeps its geometry, within 1 LSB where the
source resizes it (bilinear, on the frame's device).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lives_tpu.io.videojack as jvj
import lives_tpu_torch.io.videojack as tvj
from lives_tpu.constants import Palette as JPalette
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.layer import Layer

VJ = {"jax": jvj, "torch": tvj}


class FakeVJackLib:
    """In-process videojack libjack: one client, per-port geometry, the
    process callback captured and fired from the test (standing in for
    the JACK thread)."""

    def __init__(self, fps=30):
        self.fps = fps
        self.cb = None
        self.ports = {}
        self._next = 1
        self.active = False
        self.closed = False
        self._buf = None

    def jack_client_open(self, name, opts, ptr):
        return 0xC11E47

    def jack_client_close(self, client):
        self.closed = True
        return 0

    def jack_get_sample_rate(self, client):
        return self.fps

    def jack_port_register(self, client, name, ptype, flags, bufsz):
        h = self._next
        self._next += 1
        self.ports[h] = {"name": bytes(name), "type": bytes(ptype),
                         "flags": int(flags), "w": 0, "h": 0}
        return h

    def jack_set_process_callback(self, client, cb, arg):
        self.cb = cb
        return 0

    def jack_activate(self, client):
        self.active = True
        return 0

    def jack_deactivate(self, client):
        self.active = False
        return 0

    def jack_video_get_width(self, client, port):
        return self.ports[port]["w"]

    def jack_video_get_height(self, client, port):
        return self.ports[port]["h"]

    def jack_video_set_width_and_height(self, client, port, w, h):
        self.ports[port]["w"], self.ports[port]["h"] = int(w), int(h)

    def jack_port_get_buffer(self, port, nframes):
        return ctypes.addressof(self._buf) if self._buf is not None else 0

    def feed_frame(self, port, rgba_hw4: np.ndarray):
        """Place a frame on the port and fire the process callback."""
        h, w = rgba_hw4.shape[:2]
        self.jack_video_set_width_and_height(None, port, w, h)
        self._buf = ctypes.create_string_buffer(rgba_hw4.tobytes(),
                                                h * w * 4)
        assert self.cb(1, None) == 0

    def drain_frame(self, port):
        """Provide an output buffer and fire the callback (sink side)."""
        w, h = self.ports[port]["w"], self.ports[port]["h"]
        self._buf = ctypes.create_string_buffer(h * w * 4)
        assert self.cb(1, None) == 0
        return np.frombuffer(bytes(self._buf), np.uint8)[: h * w * 4] \
            .reshape(h, w, 4)


def host(lay):
    p = lay.planes[0]
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def rgba(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


def source(pkg, lib, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return VJ[pkg].VJackSource(lib=lib, **kw)


def test_constants_and_gate_match_jax(monkeypatch):
    assert tvj.JACK_DEFAULT_VIDEO_TYPE == jvj.JACK_DEFAULT_VIDEO_TYPE
    assert tvj._VIDEO_ENTRY_POINTS == jvj._VIDEO_ENTRY_POINTS

    class PlainJack:   # a stock libjack: audio only
        jack_client_open = None

    for mod in VJ.values():
        monkeypatch.setattr(mod, "load_libjack", lambda: PlainJack())
        assert mod.load_vjack() is None
        monkeypatch.setattr(mod, "load_libjack", lambda: None)
        assert mod.load_vjack() is None
        with pytest.raises(RuntimeError, match="videojack libjack"):
            mod.VJackSource()


@pytest.mark.parametrize("geom", [(16, 32), (9, 14)])
def test_source_receives_and_holds_like_jax(geom):
    """A frame at the source's own geometry: exact; no new frame serves
    the same layer again; the port registered alike."""
    h, w = geom
    res = {}
    for pkg in VJ:
        lib = FakeVJackLib(fps=30)
        src = source(pkg, lib, width=w, height=h)
        first = host(src.get_frame(0))          # black before a frame
        lib.feed_frame(src.port, rgba(h, w, 7))
        lay = src.get_frame(0)
        again = src.get_frame(1)
        res[pkg] = (first, host(lay), again is lay, lay.palette, src.fps,
                    src.unique_id, lib.ports, src.frames,
                    src.scrap_on_record)
        src.close()
        assert lib.closed and not lib.active
    t, j = res["torch"], res["jax"]
    np.testing.assert_array_equal(t[0], j[0])
    assert not t[0].any()
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(np.moveaxis(t[1], 0, -1), rgba(h, w, 7))
    assert t[2:] == j[2:]
    assert t[2] is True and t[3] == int(Palette.RGBA32)


@pytest.mark.parametrize("port_geom,out_geom", [((16, 32), (32, 64)),
                                                ((24, 40), (12, 20)),
                                                ((7, 9), (10, 16))])
def test_source_resizes_on_its_device_like_jax(port_geom, out_geom):
    """A frame at a foreign geometry is resized to the source's, bilinear
    (`lives_tpu/io/videojack.py:179-195`): within 1 LSB of JAX."""
    outs = {}
    for pkg in VJ:
        lib = FakeVJackLib()
        src = source(pkg, lib, width=out_geom[1], height=out_geom[0])
        lib.feed_frame(src.port, rgba(*port_geom, 11))
        outs[pkg] = host(src.get_frame(0))
        if pkg == "torch":
            assert src.get_frame(0).planes[0].device.type == "cpu"
    assert outs["torch"].shape == (4, *out_geom)
    d = np.abs(outs["torch"].astype(np.int16) - outs["jax"].astype(np.int16))
    assert d.max() <= 1, d.max()


def test_source_takes_the_newest_frame_like_jax():
    res = {}
    for pkg in VJ:
        lib = FakeVJackLib()
        src = source(pkg, lib, width=8, height=4)
        for s in range(3):
            lib.feed_frame(src.port, rgba(4, 8, 30 + s))
        res[pkg] = host(src.get_frame(0))
    np.testing.assert_array_equal(res["torch"], res["jax"])
    np.testing.assert_array_equal(np.moveaxis(res["torch"], 0, -1),
                                  rgba(4, 8, 32))


def play(pkg, sink, arr, tc):
    if pkg == "jax":
        lay = JLayer(planes=(jnp.asarray(arr),), palette=int(JPalette.RGBA32))
    else:
        lay = Layer(planes=(torch.from_numpy(arr),),
                    palette=int(Palette.RGBA32))
    return sink.play_frame(lay, tc)


@pytest.mark.parametrize("queue", [1, 3, 16])
def test_sink_queues_and_drains_like_jax(queue):
    """Five frames into a ring of `queue`: the oldest drop; the port
    buffers drained in order are the JAX sink's."""
    res = {}
    for pkg in VJ:
        lib = FakeVJackLib(fps=25)
        sink = VJ[pkg].VJackSink(lib=lib, queue_frames=queue)
        sink.init_screen(8, 4, 25.0)
        for i in range(5):
            assert play(pkg, sink,
                        np.moveaxis(rgba(4, 8, 50 + i), -1, 0).copy(),
                        i / 25.0)
        got = [lib.drain_frame(sink._client.port) for _ in range(6)]
        sink.exit_screen()
        res[pkg] = (got, lib.ports, lib.closed)
    for a, b in zip(res["torch"][0], res["jax"][0]):
        np.testing.assert_array_equal(a, b)
    assert res["torch"][1:] == res["jax"][1:]
    kept = min(queue, 5)
    np.testing.assert_array_equal(res["torch"][0][0], rgba(4, 8, 55 - kept))
    assert not res["torch"][0][kept].any()


def test_sink_reinit_drops_stale_geometry_like_jax():
    res = {}
    for pkg in VJ:
        lib = FakeVJackLib(fps=25)
        sink = VJ[pkg].VJackSink(lib=lib, queue_frames=4)
        sink.init_screen(8, 4, 25.0)
        big = np.full((4, 4, 8), 7, np.uint8)
        play(pkg, sink, big, 0.0)
        sink.init_screen(4, 2, 25.0)
        a = lib.drain_frame(sink._client.port)
        small = np.full((4, 2, 4), 9, np.uint8)
        play(pkg, sink, small, 0.1)
        b = lib.drain_frame(sink._client.port)
        sink._rb.append(big.tobytes())        # a stale frame raced in
        c = lib.drain_frame(sink._client.port)
        sink.exit_screen()
        res[pkg] = (a, b, c)
    for x, y in zip(res["torch"], res["jax"]):
        np.testing.assert_array_equal(x, y)
    assert not res["torch"][0].any() and not res["torch"][2].any()


def test_sink_is_a_player_sink_with_the_jax_palettes():
    from lives_tpu_torch.player.sinks import Sink
    assert issubclass(tvj.VJackSink, Sink)
    assert tvj.VJackSink.palette_list == tuple(jvj.VJackSink.palette_list)
    assert tvj.VJackSink.fetches_frames == jvj.VJackSink.fetches_frames


def test_osc_open_vjack_route_like_jax(monkeypatch):
    """`/clip/open/vjack` opens a `VJackSource` at the asked geometry on
    the player's device, as the JAX route does (`namespace.py:235-248`)."""
    from lives_tpu.osc.protocol import OSCMessage as JMsg
    from lives_tpu.osc.server import OSCServer as JServer
    from lives_tpu.player import CollectSink as JCollect
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.osc.protocol import OSCMessage
    from lives_tpu_torch.osc.server import OSCServer
    from lives_tpu_torch.player import CollectSink, Player
    for mod in VJ.values():
        monkeypatch.setattr(mod, "load_vjack", lambda: FakeVJackLib())
    jsrv = JServer(player=JPlayer(sink=JCollect()))
    tsrv = OSCServer(player=Player(sink=CollectSink(), device="cpu"))
    jsrv.dispatch(JMsg("/clip/open/vjack", [32, 16]))
    tsrv.dispatch(OSCMessage("/clip/open/vjack", [32, 16]))
    (j,) = [c for c in jsrv.clips.values() if isinstance(c, jvj.VJackSource)]
    (t,) = [c for c in tsrv.clips.values() if isinstance(c, tvj.VJackSource)]
    assert (t.width, t.height) == (j.width, j.height) == (32, 16)
    assert t.device == torch.device("cpu")
    assert tsrv.player.state.fg_clip is t
    np.testing.assert_array_equal(host(t.get_frame(0)), host(j.get_frame(0)))


def test_console_vjack_sink_builds_like_jax(monkeypatch):
    """`play --sink vjack --out name` builds a `VJackSink` with an RGBA32
    sink spec, as the JAX console does (`lives_tpu/cli.py:54-60`)."""
    from lives_tpu import cli as jcli
    from lives_tpu_torch import cli
    for mod in VJ.values():
        monkeypatch.setattr(mod, "load_vjack", lambda: FakeVJackLib())
    p = cli.build_player(None, [], 32, 16, "vjack", "out-port", device="cpu")
    jp = jcli.build_player(None, [], 32, 16, "vjack", "out-port")
    assert isinstance(p.sink, tvj.VJackSink)
    assert (p.sink_spec.width, p.sink_spec.height, p.sink_spec.palette) \
        == (jp.sink_spec.width, jp.sink_spec.height, jp.sink_spec.palette)
    assert p.sink_spec.palette == int(Palette.RGBA32)
