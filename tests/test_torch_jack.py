"""The JACK client, transport and audio sink of lives_tpu_torch
(`audio/jack.py`) against lives_tpu's, over the same mock libjack.

The mock is `tests/test_jack.py`'s, copied. Each scenario runs once a
package on the same seeded blocks; the port buffers, the calls the mock
records and the players' clocks must be equal (audio exact: both are host
numpy). `best_audio_sink` and the player's `transport` glue are held to the
JAX package's (`lives_tpu/audio/fx.py:686-696`,
`lives_tpu/player/player.py:298-300,886-893`).
"""

import ctypes

import numpy as np
import pytest

import lives_tpu.audio.fx as jfx
import lives_tpu.audio.jack as jjack
import lives_tpu_torch.audio.fx as tfx
import lives_tpu_torch.audio.jack as tjack
from lives_tpu.layer import layer_blank as j_layer_blank
from lives_tpu.player import NullSink as JNullSink
from lives_tpu.player import Player as JPlayer
from lives_tpu_torch.layer import layer_blank
from lives_tpu_torch.player import NullSink, Player

JACK = {"jax": jjack, "torch": tjack}


class MockJack:
    """Callable-compatible stand-in for libjack (`tests/test_jack.py`)."""

    def __init__(self, rate=48000):
        self.rate = rate
        self.calls = []
        self.transport_state = 0
        self.transport_frame = 0
        self._buffers = {}
        self._cb = None

    def jack_client_open(self, name, options, status):
        self.calls.append(("open", name))
        return 0xC0FFEE

    def jack_client_close(self, client):
        self.calls.append(("close",))
        return 0

    def jack_get_sample_rate(self, client):
        return self.rate

    def jack_port_register(self, client, name, ptype, flags, bufsz):
        self.calls.append(("port", name, ptype, flags))
        port = 100 + len(self._buffers)
        self._buffers[port] = (ctypes.c_float * 4096)()
        return port

    def jack_port_get_buffer(self, port, nframes):
        return ctypes.addressof(self._buffers[port])

    def jack_set_process_callback(self, client, cb, arg):
        self._cb = cb
        return 0

    def jack_activate(self, client):
        self.calls.append(("activate",))
        return 0

    def jack_deactivate(self, client):
        self.calls.append(("deactivate",))
        return 0

    def jack_transport_start(self, client):
        self.calls.append(("t_start",))
        self.transport_state = 1

    def jack_transport_stop(self, client):
        self.calls.append(("t_stop",))
        self.transport_state = 0

    def jack_transport_locate(self, client, frame):
        self.calls.append(("t_locate", int(frame)))
        self.transport_frame = int(frame)
        return 0

    def jack_transport_query(self, client, pos_ref):
        pos = pos_ref._obj
        pos.frame_rate = self.rate
        pos.frame = self.transport_frame
        return self.transport_state

    def run_process(self, nframes):
        assert self._cb is not None
        return self._cb(nframes, None)

    def port_audio(self, idx, nframes):
        return np.frombuffer(self._buffers[100 + idx], np.float32,
                             count=nframes).copy()


def blocks(seed, n, lengths):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (k, 2)).astype(np.float32) for k in lengths]


def both(scenario):
    """{pkg: scenario(pkg, fresh mock)}."""
    return {pkg: scenario(pkg, MockJack()) for pkg in JACK}


def test_constants_and_position_struct_match_jax():
    for name in ("JackTransportStopped", "JackTransportRolling",
                 "JackTransportLooping", "JackTransportStarting",
                 "JackPortIsInput", "JackPortIsOutput",
                 "JACK_DEFAULT_AUDIO_TYPE"):
        assert getattr(tjack, name) == getattr(jjack, name), name
    assert ctypes.sizeof(tjack.jack_position_t) == \
        ctypes.sizeof(jjack.jack_position_t)
    assert [f[0] for f in tjack.jack_position_t._fields_] == \
        [f[0] for f in jjack.jack_position_t._fields_]


@pytest.mark.parametrize("nframes", [64, 256, 1000])
def test_client_process_pulls_audio_like_jax(nframes):
    """The pull callback's blocks reach both ports (channel 1 from the
    second column), exact; a short block pads with silence."""
    def scenario(pkg, mock):
        src = blocks(3, 1, [nframes])[0]
        got = []

        def pull(n):
            got.append(n)
            return src[: n - 7]          # short: the tail is silence
        c = JACK[pkg].JackClient(pull_fn=pull, lib=mock)
        c.activate()
        rc = mock.run_process(nframes)
        out = (mock.port_audio(0, nframes), mock.port_audio(1, nframes))
        c.close()
        return rc, got, out, mock.calls, c.sample_rate
    r = both(scenario)
    assert r["torch"][0] == r["jax"][0] == 0
    assert r["torch"][1] == r["jax"][1] == [nframes]
    for a, b in zip(r["torch"][2], r["jax"][2]):
        np.testing.assert_array_equal(a, b)
    assert not r["torch"][2][0][-7:].any()
    assert r["torch"][3] == r["jax"][3]
    assert r["torch"][4] == r["jax"][4] == 48000


def test_process_without_pull_is_silence_and_errors_return_1():
    def scenario(pkg, mock):
        c = JACK[pkg].JackClient(lib=mock)
        silent = (mock.run_process(128), mock.port_audio(0, 128).any())
        c.pull_fn = lambda n: 1 / 0
        return silent, mock.run_process(128)
    r = both(scenario)
    assert r["torch"] == r["jax"] == ((0, False), 1)


def test_sink_ring_and_reblocking_match_jax():
    """`JackAudioSink`: blocks pushed, the ring drained by the process
    callback across periods, the leftover carried, silence after."""
    def scenario(pkg, mock):
        s = JACK[pkg].JackAudioSink(lib=mock)
        for blk in blocks(5, 3, [300, 300, 129]):
            s.write(blk, 48000)
        s.write(np.full(40, 0.5, np.float32), 48000)   # mono: repeated
        out = []
        for _ in range(3):
            mock.run_process(512)
            out.append(np.stack([mock.port_audio(0, 512),
                                 mock.port_audio(1, 512)]))
        s.close()
        return out, mock.calls, s.rate
    r = both(scenario)
    for a, b in zip(r["torch"][0], r["jax"][0]):
        np.testing.assert_array_equal(a, b)
    assert r["torch"][1:] == r["jax"][1:]


def test_sink_ring_bounds_itself_at_a_second():
    def scenario(pkg, mock):
        s = JACK[pkg].JackAudioSink(lib=mock)
        for blk in blocks(6, 5, [20000, 20000, 20000, 20000]):
            s.write(blk, 48000)
        return [len(b) for b in s._ring]
    r = both(scenario)
    assert r["torch"] == r["jax"]
    assert sum(r["torch"]) <= 48000


def clip(pkg, frames=100):
    class Clip:
        fps, width, height = 25.0, 32, 16

        def get_frame(self, n):
            return (j_layer_blank(32, 16, 1) if pkg == "jax" else
                    layer_blank(32, 16, 1, device="cpu"))
    c = Clip()
    c.frames = frames
    return c


def player(pkg):
    return JPlayer(sink=JNullSink()) if pkg == "jax" else \
        Player(sink=NullSink(), device="cpu")


@pytest.mark.parametrize("start_frame", [0, 50, 99])
def test_transport_master_start_stop_locate_match_jax(start_frame):
    """A master transport on the player: `start` locates to the playhead
    and starts, `stop` stops, `on_seek` locates, the same calls in the
    same order in both packages."""
    def scenario(pkg, mock):
        c = JACK[pkg].JackClient(lib=mock)
        p = player(pkg)
        p.state.fg_clip = clip(pkg)
        p.state.frame = start_frame
        p.transport = JACK[pkg].JackTransport(c, p, mode="master")
        p.start()
        p.stop()
        p.transport.on_seek(1.0)
        return [k for k in mock.calls if k[0].startswith("t_")]
    r = both(scenario)
    assert r["torch"] == r["jax"]
    assert r["torch"] == [("t_locate", start_frame * 48000 // 25),
                          ("t_start",), ("t_stop",), ("t_locate", 48000)]


def test_transport_slave_clock_and_state_match_jax():
    """A slave transport: the JACK position is the player's clock (seconds
    to clip frames at the clip's rate), and rolling and stopped edges
    start and stop the player."""
    def scenario(pkg, mock):
        c = JACK[pkg].JackClient(lib=mock)
        p = player(pkg)
        p.state.fg_clip = clip(pkg, 200)
        tr = JACK[pkg].JackTransport(c, p, mode="slave")
        tr.attach()
        seen = []
        for secs in (0.0, 1.5, 4.0, 7.96):
            mock.transport_frame = int(secs * 48000)
            seen.append(p._target_frame_f())
        states = []
        for st in (1, 1, 3, 0, 2, 0):
            mock.transport_state = st
            tr.poll()
            states.append(p.state.playing)
        tr.on_play()             # a slave never drives the transport
        tr.on_stop()
        return seen, states, [k for k in mock.calls if k[0][:2] == "t_"]
    r = both(scenario)
    assert r["torch"] == r["jax"]
    assert r["torch"][0] == pytest.approx([0.0, 37.5, 100.0, 199.0])
    assert r["torch"][1] == [True, True, True, False, True, False]
    assert r["torch"][2] == []


def test_transport_rejects_an_unknown_mode():
    for pkg in JACK:
        with pytest.raises(ValueError):
            JACK[pkg].JackTransport(None, None, mode="both")


def test_player_has_no_transport_by_default():
    assert Player(sink=NullSink(), device="cpu").transport is None
    assert JPlayer(sink=JNullSink()).transport is None


def test_gated_load_matches_jax(monkeypatch):
    """Without libjack the loaders return None and a client without an
    injected lib raises RuntimeError, in both packages."""
    assert (tjack.load_libjack() is None) == (jjack.load_libjack() is None)
    for pkg in JACK:
        monkeypatch.setattr(JACK[pkg], "load_libjack", lambda: None)
        with pytest.raises(RuntimeError, match="libjack unavailable"):
            JACK[pkg].JackClient()


@pytest.mark.parametrize("libjack", [True, False])
def test_best_audio_sink_picks_what_jax_picks(monkeypatch, libjack):
    """JACK first where libjack loads (here a mock behind the loader),
    else the next real sink: the same class name in both packages."""
    for pkg, mod in JACK.items():
        monkeypatch.setattr(mod, "load_libjack",
                            (lambda: MockJack()) if libjack else
                            (lambda: None))
    t, j = tfx.best_audio_sink(), jfx.best_audio_sink()
    assert type(t).__name__ == type(j).__name__
    if libjack:
        assert isinstance(t, tjack.JackAudioSink)
        assert t.rate == j.rate == 48000
    for s in (t, j):
        s.close()


def test_jack_sink_carries_the_feeders_blocks_like_jax():
    """The player's realtime feeder (`attach_audio`) into `JackAudioSink`:
    a tone clip's pulled blocks written, the ports drained; exact."""
    from lives_tpu.audio.fx import ToneSource as JTone
    from lives_tpu_torch.audio.fx import ToneSource

    def scenario(pkg, mock):
        s = JACK[pkg].JackAudioSink(lib=mock)
        p = player(pkg)
        c = clip(pkg)
        c.audio_source = (JTone if pkg == "jax" else ToneSource)(
            330.0, rate=48000)
        p.state.fg_clip = c
        feeder = p.attach_audio(sink=s, rate=48000)
        feeder.load_clip_audio(c)
        out = []
        for _ in range(4):
            s.write(feeder.pull(), 48000)
            mock.run_process(1024)
            out.append(mock.port_audio(0, 1024))
        return np.stack(out)
    r = both(scenario)
    np.testing.assert_array_equal(r["torch"], r["jax"])
    assert np.abs(r["torch"]).max() > 0.1

