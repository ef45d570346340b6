"""The fourKlives tracker synth of lives_tpu_torch (`audio/fourklives.py`)
against lives_tpu's: tunes parsed alike, blocks sample-exact at any
position, tempo and base frequency, and the synth as a clip's audio
source through both players' realtime feeders (exact: host numpy both).
"""

import numpy as np
import pytest

import lives_tpu.audio.fourklives as j4k
import lives_tpu_torch.audio.fourklives as t4k

TUNE = """
# a comment line
tempo 96
instr 0 wave=sin a=0.01 d=0.2 s=0.6 r=0.1 vol=0.7
instr 1 wave=noise a=0.001 d=0.02 s=0.0 r=0.01 vol=0.4  # trailing
instr 3 wave=saw vol=0.5
pattern 0 c4 - e4 g#4 r b3 c#5 --
pattern 1 c2 c2 r c2
pattern 2 a6 g6 f#6
chan 0 0 2
chan 1 1
chan 3 2 0 1
"""


@pytest.mark.parametrize("token", ["c4", "C#3", "a", "b9", "r", "-", "--",
                                   "x4", "", "e#2", "g#0"])
def test_note_to_semitone_matches_jax(token):
    assert t4k.note_to_semitone(token) == j4k.note_to_semitone(token)


@pytest.mark.parametrize("text", [t4k.DEFAULT_TUNE, TUNE])
def test_parse_tune_matches_jax(text):
    t, j = t4k.parse_tune(text), j4k.parse_tune(text)
    assert t.tempo == j.tempo
    assert {k: v.__dict__ for k, v in t.instruments.items()} == \
        {k: v.__dict__ for k, v in j.instruments.items()}
    assert t.patterns == j.patterns and t.channels == j.channels


@pytest.mark.parametrize("tune", ["default", "custom"])
@pytest.mark.parametrize("rate,channels", [(44100, 2), (48000, 1),
                                           (22050, 3)])
@pytest.mark.parametrize("pos", [0, 1234, 10 ** 7 + 17])
def test_render_at_is_sample_exact(tune, rate, channels, pos):
    text = t4k.DEFAULT_TUNE if tune == "default" else TUNE
    t = t4k.FourKLives(text, rate=rate, channels=channels)
    j = j4k.FourKLives(text, rate=rate, channels=channels)
    a, b = t.render_at(pos, 3000), j.render_at(pos, 3000)
    assert a.dtype == b.dtype == np.float32 and a.shape == (3000, channels)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 0


def test_render_steps_tempo_and_base_freq_match_jax():
    t, j = t4k.FourKLives(TUNE), j4k.FourKLives(TUNE)
    out = {"t": [], "j": []}
    for step, (tempo, freq) in enumerate([(None, None), (140.0, None),
                                          (None, 220.0), (60.0, 880.0)]):
        for s in (t, j):
            if tempo:
                s.set_tempo(tempo)
            if freq:
                s.set_base_freq(freq)
        out["t"].append(t.render(777 + step))
        out["j"].append(j.render(777 + step))
        assert t.pos == j.pos and t.step_samples == j.step_samples
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(a, b)


def test_a_tune_object_and_an_empty_channel_match_jax():
    tt, jt = t4k.parse_tune(TUNE), j4k.parse_tune(TUNE)
    tt.channels.append((0, [9]))          # a pattern the tune lacks
    jt.channels.append((0, [9]))
    np.testing.assert_array_equal(t4k.FourKLives(tt).render_at(50, 500),
                                  j4k.FourKLives(jt).render_at(50, 500))


@pytest.mark.parametrize("pb_fps", [25.0, 50.0, -25.0])
def test_synth_feeds_the_player_like_jax(pb_fps):
    """FourKLives as a clip's `audio_source` (`ToneSource`'s protocol):
    both players' feeders pull the same velocity-matched blocks, forward,
    doubled and reversed."""
    from lives_tpu.audio.fx import AudioPlayer as JFeeder
    from lives_tpu.player import NullSink as JNull
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.audio.fx import AudioPlayer
    from lives_tpu_torch.player import NullSink, Player

    class Clip:
        frames, fps, width, height = 100, 25.0, 8, 8

    blocks = {}
    for pkg, P, F, mod in (("jax", JPlayer, JFeeder, j4k),
                           ("torch", Player, AudioPlayer, t4k)):
        p = P(sink=JNull()) if pkg == "jax" else \
            P(sink=NullSink(), device="cpu")
        c = Clip()
        c.audio_source = mod.FourKLives(rate=48000)
        p.state.fg_clip = c
        p.state.pb_fps = pb_fps
        f = F(p, rate=44100, block=512)
        f.load_clip_audio(c)
        if pb_fps < 0:
            f._pos = 30000.0
        blocks[pkg] = np.stack([f.pull() for _ in range(6)])
    np.testing.assert_array_equal(blocks["torch"], blocks["jax"])
    assert np.abs(blocks["torch"]).max() > 0
