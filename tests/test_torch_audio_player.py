"""The port's realtime audio feeder (`audio.fx.AudioPlayer`) and the
player's audio (`Player.attach_audio`, `time_source="audio"`, the audio of a
recorded frame) against lives_tpu's, on the CPU.

The feeder is pulled by hand (or by its thread where a case is about the
thread): the same clip audio, the same video clock and the same pulls give
the same blocks, positions, sync deltas and corrections in both packages,
bit for bit. Players run on `chip_smoke.ScriptedClock` (monkeypatch), with
the feeder's thread replaced by pulls the script makes, so the audio clock
and the recorded `audio_clips`/`audio_seeks` are equal, and so are their
re-rendered audio (`render_audio_from_seeks`). The JAX package's own cases
(`tests/test_audio_fx.py`, `test_audio_analysers.py`) are mirrored here;
the OSC volume control of `test_player_audio_integration` is not, since the
OSC server is not ported (ROADMAP Queue 1 item 23)."""

import time

import numpy as np
import pytest

import lives_tpu.audio.engine as je
import lives_tpu.audio.fx as jfx
import lives_tpu_torch.audio.engine as te
import lives_tpu_torch.audio.fx as tfx
from lives_tpu.effects import data as jd
from lives_tpu_torch.effects import data as td
from test_torch_player import (MemClip, canon, make_player, run_both,
                               same_frames, scripted)

RATE, FPS = 44100, 25.0
FX = {"jax": jfx, "torch": tfx}
ENGINE = {"jax": je, "torch": te}


class AudioClip(MemClip):
    """MemClip frames with seeded stereo audio (`read_audio`)."""

    def __init__(self, pkg, seconds=4.0, arate=RATE, **kw):
        super().__init__(pkg, **kw)
        self.arate, self.achans = arate, 2
        self.seconds = seconds

    def read_audio(self):
        rng = np.random.default_rng(self.unique_id)
        n = int(self.seconds * self.arate)
        t = np.arange(n) / self.arate
        tone = np.sin(2 * np.pi * 330 * self.unique_id * t) * 0.5
        return (np.stack([tone, -tone], 1)
                + rng.normal(0, 0.05, (n, 2))).astype(np.float32)


class _State:
    pass


class VideoClock:
    """A stand-in for a player: `state` with fg_clip, pb_fps and frame."""

    def __init__(self, clip, fps=FPS):
        self.state = _State()
        self.state.fg_clip, self.state.pb_fps, self.state.frame = \
            clip, fps, 0
        self.time_source = "system"


def feeders(make_clip, rate=RATE, block=1024):
    out = {}
    for pkg in FX:
        clip = make_clip(pkg)
        vc = VideoClock(clip)
        ap = FX[pkg].AudioPlayer(vc, FX[pkg].NullAudioSink(), rate=rate,
                                 block=block)
        ap.load_clip_audio(clip)
        out[pkg] = (vc, ap)
    return out


def test_audio_player_velocity():
    """Blocks equal; double speed advances the position twice as fast
    (`test_audio_fx.py:61`)."""
    got = {}
    for pkg, (vc, ap) in feeders(lambda pkg: AudioClip(pkg), block=512)\
            .items():
        b1 = ap.pull()
        assert b1.shape == (512, 2) and np.abs(b1).max() > 0.1
        vc.state.pb_fps = 50.0
        pos0 = ap._pos
        b2 = ap.pull()
        assert ap._pos - pos0 == pytest.approx(1024, abs=2)
        got[pkg] = (b1, b2, ap._pos)
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src_rate,out_rate", [(48000, 44100),
                                               (22050, 48000)])
def test_scratch_playback_sync_matches_jax(src_rate, out_rate):
    """60 simulated seconds of scratching (random rates incl. reverse, loop
    wraps): the same blocks, positions, deltas and corrections in both
    packages, and the drift bounded (`test_audio_fx.py:224`)."""
    res = {}
    for pkg, (vc, ap) in feeders(
            lambda pkg: AudioClip(pkg, seconds=60.0, arate=src_rate,
                                  n=int(60 * FPS)),
            rate=out_rate).items():
        st = vc.state
        rng = np.random.default_rng(11)
        dt = ap.block / out_rate
        vfrac, deltas, blocks = 0.0, [], []
        for i in range(int(30.0 / dt)):
            if i % 100 == 50:
                st.pb_fps = float(rng.choice([-50, -25, 12.5, 25, 50, 75]))
            vfrac += st.pb_fps * dt
            st.frame = int(vfrac) % st.fg_clip.frames
            blocks.append(ap.pull())
            d = ap.sync_delta()
            if i > 20 and d is not None:
                deltas.append(abs(d))
        res[pkg] = (np.concatenate(blocks), np.asarray(deltas),
                    ap.sync_corrections, ap.sync_resyncs)
    j, t = res["jax"], res["torch"]
    np.testing.assert_array_equal(j[0], t[0])
    np.testing.assert_array_equal(j[1], t[1])
    assert (j[2], j[3]) == (t[2], t[3])
    assert np.percentile(t[1], 95) < 0.08 + 0.05 and t[2] > 0


def test_sync_survives_jitter_and_an_xrun():
    """Jittered callback periods, a 0.5 s stall, a consumer 10 % slow
    (`test_audio_fx.py:478`): the same corrections and resyncs, the same
    deltas, in both packages."""
    res = {}
    for pkg, (vc, ap) in feeders(
            lambda pkg: AudioClip(pkg, seconds=40.0, n=int(40 * FPS)))\
            .items():
        st, nominal = vc.state, ap.block / RATE
        rng = np.random.default_rng(7)
        vtime, trace = [0.0], []

        def callback(period):
            vtime[0] += period
            st.frame = int(vtime[0] * FPS) % st.fg_clip.frames
            ap.pull()
            trace.append(ap.sync_delta())
            return trace[-1]
        for _ in range(int(10.0 / nominal)):
            callback(nominal * rng.uniform(0.7, 1.3))
        assert ap.sync_resyncs == 0 and ap.sync_corrections > 0
        callback(0.5)
        assert ap.sync_resyncs >= 1
        for _ in range(int(5.0 / nominal)):
            callback(nominal * 1.1)
        res[pkg] = (trace, ap.sync_corrections, ap.sync_resyncs)
    assert res["jax"] == res["torch"]


def test_generator_audio_pull_matches_jax():
    """A clip whose audio is a generator (`audio_source`, here `ToneSource`)
    is synthesised over the window a block maps onto, reverse past the start
    free-running from 0."""
    got = {}
    for pkg in FX:
        clip = MemClip(pkg)
        clip.audio_source = FX[pkg].ToneSource(440.0, 48000, 2, "saw", 0.4)
        vc = VideoClock(clip)
        ap = FX[pkg].AudioPlayer(vc, FX[pkg].NullAudioSink(), rate=RATE,
                                 block=700)
        ap.chain.append(FX[pkg].audio_instantiate("lowpass", cutoff=0.3))
        ap.load_clip_audio(clip)
        blocks = []
        for fps in (25.0, 25.0, -50.0, -50.0, -50.0, 12.5):
            vc.state.pb_fps = fps
            blocks.append(ap.pull())
        ap.volume, ap.muted = 0.5, False
        blocks.append(ap.pull())
        ap.muted = True
        blocks.append(ap.pull())
        got[pkg] = (np.concatenate(blocks), ap._pos)
    np.testing.assert_array_equal(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_audio_player_thread_runs():
    """The feeder's thread writes blocks to its sink until stopped."""
    sink = tfx.NullAudioSink()
    ap = tfx.AudioPlayer(None, sink, rate=RATE, block=441)
    ap._data = AudioClip("torch").read_audio()
    ap.start()
    deadline = time.monotonic() + 5.0
    while sink.frames <= 441 and time.monotonic() < deadline:
        time.sleep(0.02)
    ap.stop()
    assert sink.frames > 441 and not ap._running


def test_audio_player_double_start_and_rate_injection():
    class _P:
        state = type("S", (), {"pb_fps": 25.0, "fg_clip": None,
                               "frame": 0})()
        time_source = "system"

    ap = tfx.AudioPlayer(_P, tfx.NullAudioSink(), rate=48000, block=480)
    ap.chain.append(tfx.audio_instantiate("echo", delay=0.01))
    ap.start()
    t1 = ap._thread
    ap.start()
    assert ap._thread is t1
    assert ap.chain[0].values["rate"] == 48000
    ap.stop()


# -- the player's audio ----------------------------------------------------------

def audio_player(monkeypatch, pkg, clip_kw=None):
    """A player of `pkg` on a scripted clock with an AudioClip fg and an
    attached feeder whose thread never starts (the script pulls)."""
    clock = scripted(monkeypatch, pkg)
    p, sink = make_player(pkg)
    p.state.fg_clip = AudioClip(pkg, **(clip_kw or {}))
    p.async_compile = False
    ap = p.attach_audio(FX[pkg].NullAudioSink(), rate=RATE)
    assert ap is p.audio and ap.player is p
    ap.start = lambda: None
    return p, sink, ap, clock


def test_attach_audio_and_audio_clock(monkeypatch):
    """`time_source="audio"`: the frame comes from the feeder's position
    (`test_audio_fx.py:283`), in both packages alike."""
    got = {}
    for pkg in FX:
        p, sink, ap, clock = audio_player(monkeypatch, pkg,
                                          {"seconds": 10.0, "n": 250})
        p.time_source = "audio"
        p.start()
        assert ap._data is not None      # start loaded the fg's audio
        shown, pulls = [], int(0.37 * RATE / ap.block)
        for k in range(6):
            for _ in range(pulls):
                ap.pull()
            clock.now += 0.37
            p.process_one()
            shown.append((p._target_frame_f(), p.state.frame))
        assert abs(shown[-1][1] - 6 * pulls * ap.block / RATE * FPS) <= 1
        got[pkg] = (shown, sink.frames)
        p.stop()
    assert got["jax"][0] == got["torch"][0]
    same_frames(got["jax"][1], got["torch"][1])


def test_audio_clock_needs_loaded_audio(monkeypatch):
    """With no audio loaded the audio time source falls back to the system
    clock, as in the JAX player."""
    got = {}
    for pkg in FX:
        clock = scripted(monkeypatch, pkg)
        p, _ = make_player(pkg)
        p.attach_audio(FX[pkg].NullAudioSink())
        p.time_source = "audio"
        p._clock0, p._frame0 = 0.0, 3.0
        clock.now = 0.4
        got[pkg] = p._target_frame_f()
    assert got["jax"] == got["torch"] == 13.0


def test_recorded_frames_carry_audio_seeks(monkeypatch):
    """A take with the feeder attached: every FRAME carries [-1, uid] and
    [seek, velocity], equal in both packages, through trickplay; its audio
    re-renders from the seeks alike, as long as the take."""
    from lives_tpu.events.event_list import TICKS_PER_SECOND
    takes, audio = {}, {}
    for pkg in FX:
        p, sink, ap, clock = audio_player(monkeypatch, pkg)
        p.record_start(48, 24)
        p.start()
        for k in range(30):
            if k == 12:
                p.set_pb_fps(-25.0)
            if k == 20:
                p.set_pb_fps(50.0)
            for _ in range(2):
                ap.pull()
            clock.now += 1 / FPS
            p.process_one()
        el = p.record_stop()
        p.stop()
        frames = el.frame_events()
        assert len(frames) == p.frames_shown >= 25
        for e in frames:
            assert e.props["audio_clips"] == [-1, 1]
            assert len(e.props["audio_seeks"]) == 2
        takes[pkg] = el
        audio[pkg] = ENGINE[pkg].render_audio_from_seeks(
            el, {1: p.state.fg_clip}, arate=RATE)
        n_take = int(np.ceil(el.duration_ticks / TICKS_PER_SECOND * RATE))
        assert len(audio[pkg]) == n_take + 1
        assert np.abs(audio[pkg]).max() > 0.1
    assert canon(takes["jax"]) == canon(takes["torch"])
    np.testing.assert_array_equal(audio["jax"], audio["torch"])


def test_autotransition_switch_loads_the_new_clips_audio(monkeypatch):
    """A clip switch under an autotransition hands the feeder the new
    clip's audio."""
    got = {}
    for pkg in FX:
        p, sink, ap, clock = audio_player(monkeypatch, pkg)
        p.keymap.set_key(3, 0, "crossfade")
        p.set_autotrans(3, 0.2)
        p.start()
        first = ap._data
        new = AudioClip(pkg, uid=2)
        p.switch_fg(new)
        assert ap._data is not first
        got[pkg] = ap._data
        p.stop()
    np.testing.assert_array_equal(got["jax"], got["torch"])


def test_stop_stops_the_feeder_and_writes_the_wav(tmp_path):
    """`start` loads the fg's audio and starts the thread; `stop` stops it
    and closes the sink (a WAV of what was fed)."""
    p, _ = make_player("torch")
    p.state.fg_clip = AudioClip("torch")
    path = tmp_path / "out.wav"
    ap = p.attach_audio(tfx.WavAudioSink(str(path)), rate=RATE)
    p.start()
    deadline = time.monotonic() + 5.0
    while not ap.sink.blocks and time.monotonic() < deadline:
        p.process_one()
        time.sleep(0.01)
    p.stop()
    assert not ap._running and path.read_bytes()[:4] == b"RIFF"


def test_beat_drives_video_param_over_both_players(monkeypatch):
    """A beat track through beat_detector, its `beat hold` driving
    brightness_contrast's brightness by pconx with autoscale
    (`test_audio_analysers.py:57`): the same values and frames within
    1 LSB in both players."""
    from test_torch_audio import BLOCK, _beat_track
    x = _beat_track(seconds=1.5)
    DATA = {"jax": jd, "torch": td}

    def script(p, sink, clock, pkg):
        p.keymap.set_key(0, 0, "brightness_contrast")
        p.key_toggle(0, True)
        vid = p.keymap.instances[0]
        det = FX[pkg].audio_instantiate("beat_detector", rate=RATE)
        dc = DATA[pkg].DataConnections()
        dc.add(det, "beat hold", vid, "brightness", autoscale=True)
        p.datacons = dc
        p.start()
        bright = []
        for i in range(0, len(x) - BLOCK, BLOCK):
            det.apply(x[i: i + BLOCK])
            p.state.frame = -1
            p._clock0 = clock.now
            p._frame0 = float(i // BLOCK % 10)
            p.process_one()
            bright.append(float(vid.values.get("brightness", 0.0)))
        return bright
    res = run_both(monkeypatch, script)
    bright = np.asarray(res["torch"][2])
    assert bright.max() > 0.5 and bright.min() < bright.max()
    np.testing.assert_allclose(bright, res["jax"][2], rtol=0, atol=1e-6)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
