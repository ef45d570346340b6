"""The port's audio (`lives_tpu_torch.audio`: `engine`, `fx`, `analysers`)
against lives_tpu's, on the CPU. Every function and filter takes the same
numpy inputs, made from a seed, in both packages and must give the same
samples, bit for bit (`np.array_equal`, float32 in both), the same filter
states and the same analyser out-params: the audio is host numpy in both,
copied. The sinks write the same bytes (WAV, pipe, a mocked libpulse); the
ALSA sink and capture and `best_audio_sink` are gated on the libraries as
in the JAX package. The JAX package's own cases
(`tests/test_audio.py`, `test_audio_fx.py`, `test_audio_analysers.py`)
are mirrored: each runs through both packages and its assertions hold on
the port's result."""

import ctypes
import os

import numpy as np
import pytest

import lives_tpu.audio as ja
import lives_tpu.audio.engine as je
import lives_tpu.audio.fx as jfx
import lives_tpu_torch.audio as ta
import lives_tpu_torch.audio.engine as te
import lives_tpu_torch.audio.fx as tfx
from lives_tpu.events import event_list as j_elmod
from lives_tpu.io import clips as j_clips
from lives_tpu_torch.events import event_list as t_elmod
from lives_tpu_torch.io import clips as t_clips

RATE = 44100
BLOCK = 1024
PKG = {"j": (ja, je, jfx, j_elmod, j_clips),
       "t": (ta, te, tfx, t_elmod, t_clips)}


def same(a, b):
    """Sample-exact: equal shapes, dtypes and values (NaN nowhere)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def both(fn):
    """fn(pkg) for both packages; the port's result equals the JAX one's
    and is returned."""
    j, t = fn("j"), fn("t")
    if isinstance(t, tuple):
        assert len(j) == len(t)
        for x, y in zip(j, t):
            if isinstance(x, (np.ndarray, list)):
                same(x, y)
            else:
                assert x == y
    else:
        same(j, t)
    return t


def sine(n=4410, f=440.0, rate=RATE, ch=2):
    t = np.arange(n) / rate
    return np.stack([np.sin(2 * np.pi * f * t)] * ch, 1).astype(np.float32)


def noise(n, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, ch), np.float32) * 2 - 1) * 0.8


# -- engine: conversions ------------------------------------------------------

FORMATS = [(16, True, False), (16, True, True), (16, False, False),
           (8, True, False), (8, False, False), (32, True, False),
           (32, True, True)]


@pytest.mark.parametrize("sampsize,signed,big", FORMATS)
def test_sample_encode_and_convert(sampsize, signed, big):
    """`sample_encode` bytes and `sample_convert` samples, interleaved and
    planar; a round trip stays within the format's step."""
    a = noise(777) * 1.2          # past full scale: the clip runs
    raw = both(lambda p: np.frombuffer(PKG[p][1].sample_encode(
        a, sampsize, signed, big), np.uint8))
    for inter in (True, False):
        b = both(lambda p: PKG[p][1].sample_convert(
            raw.tobytes(), sampsize, signed, big, channels=2,
            interleaved=inter))
        if inter:
            step = 2.0 / (1 << sampsize) if sampsize < 32 else 1e-6
            assert np.abs(np.clip(a, -1, 1) - b).max() < 2 * step + 1e-6


def test_sample_convert_array_and_bad_size():
    arr = noise(301, 1).reshape(-1)
    both(lambda p: PKG[p][1].sample_convert(arr, channels=2))
    for p in PKG:
        with pytest.raises(ValueError):
            PKG[p][1].sample_convert(b"\0" * 8, 24)
        with pytest.raises(ValueError):
            PKG[p][1].sample_encode(arr[:, None], 24)


@pytest.mark.parametrize("rates", [(44100, 48000), (44100, 22050),
                                   (48000, 44100), (8000, 8000)])
def test_resample(rates):
    a = sine(4410)
    out = both(lambda p: PKG[p][1].resample(a, *rates))
    assert abs(len(out) - round(4410 * rates[1] / rates[0])) <= 1


@pytest.mark.parametrize("pos,vel,n", [(0.0, 1.0, 500), (999.0, -1.0, 500),
                                       (0.0, 2.0, 100), (10.25, 0.37, 300),
                                       (3.0, -2.5, 700)])
def test_velocity_resample(pos, vel, n):
    a = sine(1000, ch=1)
    out = both(lambda p: PKG[p][1].velocity_resample(a, pos, vel, n))
    if (pos, vel) == (0.0, 1.0):
        np.testing.assert_allclose(out[0][:, 0], a[:500, 0], atol=1e-5)
        assert out[1] == 500.0
    if vel == -1.0:
        np.testing.assert_allclose(out[0][:, 0], a[999:499:-1, 0],
                                   atol=1e-5)
    both(lambda p: PKG[p][1].velocity_resample(
        np.zeros((0, 2), np.float32), pos, vel, n))


@pytest.mark.parametrize("src_ch,dst_ch", [(1, 2), (2, 1), (2, 2), (3, 2),
                                           (2, 4), (1, 1)])
def test_to_channels(src_ch, dst_ch):
    out = both(lambda p: PKG[p][1].to_channels(noise(100, src_ch), dst_ch))
    assert out.shape == (100, dst_ch)


def test_gain_db():
    for g in (0.0, 1e-12, 0.5, 1.0, 3.0):
        assert te.gain_to_db(g) == je.gain_to_db(g)
    for db in (-120.0, -6.0, 0.0, 12.5):
        assert te.db_to_gain(db) == je.db_to_gain(db)


def test_mix_tracks():
    a = np.full((100, 2), 0.5, np.float32)
    b = np.full((50, 2), 0.5, np.float32)
    c = noise(80, 1, seed=3)
    m = both(lambda p: PKG[p][1].mix_tracks([a, b], [1.0, 0.5]))
    np.testing.assert_allclose(m[:50], 0.75, atol=1e-6)
    both(lambda p: PKG[p][1].mix_tracks([a, a, c]))          # hard clip
    both(lambda p: PKG[p][1].mix_tracks([a, a, c], clip=False))
    both(lambda p: PKG[p][1].mix_tracks([]))


# -- engine: event-list audio ------------------------------------------------

def _clip_with_audio(pkg, tmp_path, data, arate=RATE):
    clip = PKG[pkg][4].create_clip(tmp_path / pkg, 8, 8)
    clip.write_audio(data, arate=arate)
    return clip


def test_render_audio_from_event_list(tmp_path):
    """The legacy placement mix: a 1 s tone on a 2 s timeline."""
    def run(p):
        m = PKG[p][3]
        clip = _clip_with_audio(p, tmp_path, sine(44100))
        el = m.EventList(fps=25.0)
        tpf = m.TICKS_PER_SECOND // 25
        for i in range(50):
            el.insert(m.frame_event(i * tpf, [1], [i]))
        return PKG[p][1].render_audio(el, {1: clip}, arate=RATE)
    out = both(run)
    assert np.abs(out[:44100]).max() > 0.5
    assert np.abs(out[44200:]).max() < 1e-6


def test_render_audio_resamples_and_weights(tmp_path):
    """Two clips at 48 and 22.05 kHz placed at their first frames, with
    per-track volumes, mixed at 44.1 kHz in mono."""
    def run(p):
        m = PKG[p][3]
        c1 = _clip_with_audio(p, tmp_path / "1", noise(48000, 2, 1), 48000)
        c2 = _clip_with_audio(p, tmp_path / "2", noise(9000, 1, 2), 22050)
        el = m.EventList(fps=30.0)
        tpf = m.TICKS_PER_SECOND // 30
        for i in range(40):
            el.insert(m.frame_event(i * tpf, [1, 2 if i >= 7 else -1],
                                    [i, i]))
        return PKG[p][1].render_audio(el, {1: c1, 2: c2}, arate=RATE,
                                      channels=1, vols={1: 0.5})
    both(run)


class RampClip:
    arate, achans, frames, fps = 8000, 1, 100, 25.0

    def read_audio(self):
        return np.linspace(0, 1, 8000 * 2, dtype=np.float32).reshape(-1, 1)


def test_render_audio_from_seeks_reproduces_scratch():
    """A recorded forward run then a reverse scratch re-render as played
    (legacy singleton seeks), and the pair schema of a player take."""
    def run(p, pairs):
        m = PKG[p][3]
        el = m.EventList(fps=25.0)
        for t, seek in [(0.0, 0.0), (0.5, 0.5), (0.75, 0.25), (0.8, 0.3)]:
            kw = (dict(audio_clips=[-1, 7], audio_seeks=[seek, 1.0])
                  if pairs else dict(audio_clips=[7], audio_seeks=[seek]))
            el.insert(m.frame_event(int(t * m.TICKS_PER_SECOND), [7], [0],
                                    **kw))
        return PKG[p][1].render_audio_from_seeks(el, {7: RampClip()},
                                                 arate=8000, channels=1)
    for pairs in (False, True):
        out = both(lambda p: run(p, pairs))
        assert abs(out[int(0.25 * 8000), 0] - 0.125) < 0.01
        seg = out[int(0.55 * 8000): int(0.7 * 8000), 0]
        assert seg[0] > seg[-1]
        assert abs(out[int(0.6 * 8000), 0] - 0.2) < 0.02


def test_seek_render_clip_switch_no_chirp():
    """A clip switch between FRAME events extrapolates the old clip at
    nominal velocity instead of sweeping it (`test_audio_fx.py:323`)."""
    class C:
        def __init__(self, uid, val):
            self.unique_id, self._v = uid, val
            self.arate, self.achans = 8000, 1

        def read_audio(self):
            return np.full((8000, 1), self._v, np.float32)

    def run(p):
        m = PKG[p][3]
        el = m.EventList(fps=25.0, width=8, height=8)
        tpf = int(m.TICKS_PER_SECOND / 25.0)
        for k, (c, seek) in enumerate([(1, 0.9), (1, 0.94), (2, 0.0),
                                       (2, 0.04)]):
            el.insert(m.frame_event(k * tpf, [c], [k % 2],
                                    audio_clips=[c], audio_seeks=[seek]))
        return PKG[p][1].render_audio_from_seeks(
            el, {1: C(1, 0.25), 2: C(2, -0.25)}, arate=8000, channels=1)
    out = both(run)
    assert abs(out[int(1.5 * 8000 / 25), 0] - 0.25) < 1e-3
    assert abs(out[int(2.5 * 8000 / 25), 0] + 0.25) < 1e-3
    assert abs(out[-2, 0] + 0.25) < 1e-3


def test_render_audio_from_seeks_falls_back(tmp_path):
    """Fewer than two seeks: the placement mix."""
    def run(p):
        m = PKG[p][3]
        clip = _clip_with_audio(p, tmp_path, sine(8000))
        el = m.EventList(fps=25.0)
        el.insert(m.frame_event(0, [1], [0], audio_clips=[1],
                                audio_seeks=[0.0]))
        el.insert(m.frame_event(4_000_000, [1], [1]))
        return PKG[p][1].render_audio_from_seeks(el, {1: clip})
    both(run)


def test_render_timeline_audio_without_transitions():
    """No audio transitions: the placement fallback, or silence of the
    timeline's length."""
    def run(p, legacy):
        m = PKG[p][3]
        el = m.EventList(fps=25.0)
        for i in range(10):
            el.insert(m.frame_event(i * 4_000_000, [1], [i]))
        return PKG[p][1].render_timeline_audio(
            el, {1: sine(20000)}, legacy_fallback=legacy)
    both(lambda p: run(p, True))
    assert both(lambda p: run(p, False)).shape == (17641, 2)


# -- fx: the registry and every filter ---------------------------------------

def test_registry_lists_the_jax_filters():
    assert ta.list_audio_filters() == ja.list_audio_filters()
    for name in ta.list_audio_filters():
        f, g = tfx.get_audio_filter(name), jfx.get_audio_filter(name)
        assert (f.params, f.description) == (g.params, g.description)
        assert [(q.name, q.kind, q.default, q.min, q.max)
                for q in f.out_params] == \
            [(q.name, q.kind, q.default, q.min, q.max) for q in g.out_params]
    for n in ("gain", "echo", "lowpass", "compressor", "audio_fft",
              "beat_detector"):
        assert n in ta.list_audio_filters()


FILTER_CASES = {
    "gain": {"gain": 0.5},
    "echo": {"delay": 0.01, "feedback": 0.5, "rate": 8000},
    "lowpass": {"cutoff": 0.05},
    "highpass": {"cutoff": 0.05},
    "compressor": {"threshold": 0.3, "ratio": 6.0},
    "audio_transition": {"amount": 0.3},
    "eq3": {"low": 1.5, "mid": 0.7, "high": 0.2},
    "reverb": {"room": 0.8, "wet": 0.6, "rate": 8000},
    "chorus": {"depth": 0.003, "speed": 2.0, "mix": 0.9, "rate": 8000},
    "noise_gate": {"threshold": 0.3},
    "audio_volume": {"left": 0.4, "right": 1.7},
    "audio_fft": {"freq": 440.0, "rate": 8000},
    "beat_detector": {"rate": 8000, "varience": 1.2},
}


def _state_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _state_equal(x, y)
    elif isinstance(a, np.ndarray):
        same(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(FILTER_CASES))
@pytest.mark.parametrize("channels", [1, 2, 4])
def test_filter_matches_jax(name, channels):
    """Six blocks of seeded noise (the sizes vary, a tone rides in them)
    through one instance of each package: the same samples, states and
    out-params after every block."""
    vals = FILTER_CASES[name]
    ji, ti = (jfx.audio_instantiate(name, **vals),
              tfx.audio_instantiate(name, **vals))
    rng = np.random.default_rng(len(name) * 10 + channels)
    for k, n in enumerate((512, 1024, 37, 2048, 1024, 700)):
        blk = noise(n, channels, seed=int(rng.integers(1 << 30)))
        blk += sine(n, 200.0 + 100 * k, 8000, channels) * 0.5
        if k == 4:
            blk *= 0.01        # a quiet block: gates close, beats rest
        same(ji.apply(blk.copy()), ti.apply(blk.copy()))
        _state_equal(ji.state, ti.state)
        assert ji.out_values == ti.out_values


def test_chain_and_disabled_instance():
    blk = noise(1000, 2, 5)
    chains = {p: [PKG[p][2].audio_instantiate("echo", delay=0.005,
                                              rate=8000),
                  PKG[p][2].audio_instantiate("gain", gain=0.7),
                  PKG[p][2].audio_instantiate("reverb", rate=8000)]
              for p in PKG}
    chains["j"][1].enabled = chains["t"][1].enabled = False
    for _ in range(3):
        same(jfx.apply_audio_chain(chains["j"], blk),
             tfx.apply_audio_chain(chains["t"], blk))


def test_echo_survives_channel_change():
    def run(p):
        inst = PKG[p][2].audio_instantiate("echo", delay=0.01, rate=8000)
        inst.apply(noise(64, 2))
        return inst.apply(noise(64, 1, seed=4))
    assert both(run).shape == (64, 1)


def test_filter_properties():
    """The JAX package's filter checks on the port's filters: gain,
    echo's tail, the compressor's ceiling, highpass's DC, eq3's bands,
    reverb's tail, chorus, the gate."""
    g = tfx.audio_instantiate("gain", gain=0.5)
    np.testing.assert_allclose(g.apply(np.full((100, 2), 0.5, np.float32)),
                               0.25, atol=1e-6)
    e = tfx.audio_instantiate("echo", delay=0.1, feedback=0.5, rate=1000)
    imp = np.zeros((1000, 1), np.float32)
    imp[0] = 1.0
    assert e.apply(imp)[0, 0] == pytest.approx(1.0)
    assert e.apply(np.zeros((1000, 1), np.float32)).max() > 0
    c = tfx.audio_instantiate("compressor", threshold=0.5, ratio=100.0)
    assert c.apply(np.ones((512, 2), np.float32)).max() < 0.55
    h = tfx.audio_instantiate("highpass", cutoff=0.05)
    out = noise(4096) * 0.5 + 0.5
    for _ in range(6):
        out = h.apply(out)
    assert abs(float(out[-1024:].mean())) < 0.05
    blk = noise(4096) * 0.5
    eq = tfx.audio_instantiate("eq3", low=1.0, mid=1.0, high=0.0)
    assert np.abs(eq.apply(blk)).mean() < np.abs(blk).mean()
    r = tfx.audio_instantiate("reverb", room=0.8, wet=1.0)
    imp = np.zeros((8192, 2), np.float32)
    imp[0] = 1.0
    assert np.abs(r.apply(imp)[1200:]).max() > 0.1
    assert np.abs(r.apply(np.zeros((8192, 2), np.float32))).max() > 0.01
    ch = tfx.audio_instantiate("chorus", mix=1.0)
    tone = sine(8192)
    assert not np.allclose(ch.apply(tone)[4096:], tone[4096:] * 1.4,
                           atol=0.2)
    gate = tfx.audio_instantiate("noise_gate", threshold=0.1)
    assert np.abs(gate.apply(np.full((1024, 2), 0.01, np.float32))).max() \
        == 0.0


# -- fx: generators -------------------------------------------------------------

@pytest.mark.parametrize("wave", ["sine", "square", "saw"])
def test_tone_gen(wave):
    b1, ph = both(lambda p: PKG[p][2].tone_gen(1000, 440, RATE, 2, 0.0,
                                               wave))
    b2, _ = both(lambda p: PKG[p][2].tone_gen(1000, 440, RATE, 2, ph, wave))
    if wave == "sine":
        joined = np.concatenate([b1[:, 0], b2[:, 0]])
        assert abs(joined[1000] - joined[999]) < 0.07
    both(lambda p: PKG[p][2].tone_gen(0, 440, RATE, 1, 1.5, wave))


@pytest.mark.parametrize("wave", ["sine", "square", "saw"])
def test_tone_source(wave):
    for pos, n in ((0, 512), (44100 * 3 + 17, 300)):
        both(lambda p: PKG[p][2].ToneSource(523.25, 48000, 1, wave,
                                            0.3).render_at(pos, n))


# -- fx: sinks and sources ----------------------------------------------------

def test_null_and_wav_sinks(tmp_path):
    """NullAudioSink counts frames; WavAudioSink writes the JAX package's
    file byte for byte, nothing when it got nothing."""
    data = {}
    for p in PKG:
        sink = PKG[p][2].WavAudioSink(str(tmp_path / f"{p}.wav"))
        for k in range(3):
            sink.write(noise(300 + k, 2, k), 22050)
        sink.close()
        data[p] = (tmp_path / f"{p}.wav").read_bytes()
        null = PKG[p][2].NullAudioSink()
        null.write(noise(77), RATE)
        assert null.frames == 77
        empty = PKG[p][2].WavAudioSink(str(tmp_path / f"{p}_empty.wav"))
        empty.close()
        assert not (tmp_path / f"{p}_empty.wav").exists()
    assert data["t"] == data["j"] and data["t"][:4] == b"RIFF"


def test_pipe_audio_sink_writes_s16():
    got = {}
    for p in PKG:
        r, w = os.pipe()
        os.set_blocking(r, False)
        sink = PKG[p][2].PipeAudioSink(w)
        blk, _ = PKG[p][2].tone_gen(256, 1000.0)
        sink.write(blk, RATE)
        got[p] = os.read(r, 1 << 20)
        assert sink.frames == 256
        sink.close()
        os.close(r)
    assert got["t"] == got["j"]
    pcm = np.frombuffer(got["t"], "<i2")
    assert len(pcm) == 512 and np.abs(pcm).max() > 20000


class MockPulse:
    def __init__(self):
        self.written = b""
        self.freed = False

    def pa_simple_new(self, *a):
        return 0xBEEF

    def pa_simple_write(self, s, data, nbytes, err):
        self.written += ctypes.string_at(data, nbytes)
        return 0

    def pa_simple_drain(self, s, err):
        return 0

    def pa_simple_free(self, s):
        self.freed = True


def test_pulse_sink_mock():
    """The same s16 bytes reach an injected libpulse-simple, mono blocks
    widened to the stream's channels."""
    mocks = {}
    for p in PKG:
        mocks[p] = MockPulse()
        s = PKG[p][2].PulseAudioSink(lib=mocks[p])
        s.write(np.full((100, 2), 0.5, np.float32), RATE)
        s.write(noise(50, 1), RATE)
        assert s.frames == 150
        s.close()
        assert mocks[p].freed
    assert mocks["t"].written == mocks["j"].written
    assert abs(int(np.frombuffer(mocks["t"].written, "<i2")[0]) - 16383) \
        <= 1


def test_device_audio_gated_as_in_jax():
    """ALSA and PulseAudio report availability as the JAX package's; where
    libasound is absent the sink and the capture raise RuntimeError, and
    `best_audio_sink` picks what the JAX one picks."""
    assert tfx.AlsaAudioSink.available() == jfx.AlsaAudioSink.available()
    assert tfx.PulseAudioSink.available() == jfx.PulseAudioSink.available()
    assert tfx.AlsaAudioSource.available() == \
        jfx.AlsaAudioSource.available()
    if not tfx.AlsaAudioSink.available():
        with pytest.raises(RuntimeError):
            tfx.AlsaAudioSink()
        with pytest.raises(RuntimeError):
            tfx.AlsaAudioSource()
    if not tfx.PulseAudioSink.available():
        with pytest.raises(RuntimeError):
            tfx.PulseAudioSink()
    t, j = tfx.best_audio_sink(), jfx.best_audio_sink()
    assert type(t).__name__ == type(j).__name__
    t.close()
    j.close()


def test_best_audio_sink_refuses_jack(monkeypatch):
    """Where libjack loads, both packages play through their JACK sink
    (the port's refused with its ROADMAP item until `audio/jack.py` was
    ported): a mock libjack behind both loaders."""
    import lives_tpu.audio.jack as jjack
    import lives_tpu_torch.audio.jack as tjack
    from test_torch_jack import MockJack
    for mod in (jjack, tjack):
        monkeypatch.setattr(mod, "load_libjack", lambda: MockJack())
    t, j = tfx.best_audio_sink(), jfx.best_audio_sink()
    assert isinstance(t, tjack.JackAudioSink)
    assert isinstance(j, jjack.JackAudioSink)
    assert t.rate == j.rate == 48000
    t.close()
    j.close()


# -- analysers ----------------------------------------------------------------

def _beat_track(seconds=2.0, bpm=120):
    """Silence with loud 50 ms low-frequency bursts on the beat."""
    n = int(seconds * RATE)
    x = np.zeros(n, np.float32)
    period = int(RATE * 60 / bpm)
    for s in range(0, n, period):
        dur = int(0.05 * RATE)
        t = np.arange(min(dur, n - s))
        x[s: s + len(t)] += 0.9 * np.sin(2 * np.pi * 80 * t / RATE) \
            * np.exp(-t / (0.02 * RATE))
    return np.stack([x, x], -1)


def test_audio_fft_tracks_tone_frequency():
    def run(p, freq):
        fft = PKG[p][2].audio_instantiate("audio_fft", freq=freq, rate=RATE)
        blk, _ = PKG[p][2].tone_gen(4096, freq=440.0, rate=RATE)
        fft.apply(blk)
        return (fft.out_values["value"],)
    on = both(lambda p: run(p, 440.0))[0]
    off = both(lambda p: run(p, 8000.0))[0]
    assert on > 10 * max(off, 1e-6)


def test_beat_detector_fires_on_beats_only():
    x = _beat_track()

    def run(p):
        det = PKG[p][2].audio_instantiate("beat_detector", rate=RATE)
        pulses, holds = [], []
        for i in range(0, len(x) - BLOCK, BLOCK):
            det.apply(x[i: i + BLOCK])
            pulses.append(det.out_values.get("beat pulse", 0.0))
            holds.append(det.out_values.get("beat hold", 0.0))
        return np.asarray(pulses), np.asarray(holds)
    pulses, _ = both(run)
    assert 2 <= pulses.sum() <= 12
    assert pulses[len(pulses) // 2 + 2: len(pulses) // 2 + 8].sum() == 0


def test_audio_package_exports():
    """`lives_tpu_torch.audio` exports `lives_tpu/audio/__init__.py`'s names,
    and importing it registers the two analysers."""
    names = [n for n in dir(ja) if not n.startswith("_")
             and n not in ("jack", "ladspa", "fourklives")]
    for n in names:
        assert hasattr(ta, n), n
    assert {"audio_fft", "beat_detector"} <= set(ta.list_audio_filters())
