"""The port's OMC learner (`lives_tpu_torch.omc`, reference
`src/omc-learn.c`) against lives_tpu's, on the CPU: MIDI and joystick
bytes parse into the same events, the learn workflow binds and
dispatches the same macros on each package's player (the port's with
`device="cpu"`), and device maps are the same JSON text both ways.
Inputs are seeded random byte streams; everything is compared exactly.
"""

import json
import struct

import numpy as np
import pytest

import lives_tpu.omc as j_omc
import lives_tpu_torch.omc as t_omc
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import Player as JPlayer
from lives_tpu_torch.player import CollectSink as TCollectSink
from lives_tpu_torch.player import Player as TPlayer


def events(evs):
    return [(e.key.etype, e.key.channel, e.key.index, e.value) for e in evs]


def midi_stream(rng, n):
    """`n` MIDI messages of every kind the parser knows (note on with and
    without velocity, note off, CC, pitch bend, program change), with
    stray data bytes and unknown status bytes between them."""
    out = bytearray()
    for _ in range(n):
        kind = int(rng.choice([0x90, 0x80, 0xB0, 0xE0, 0xC0, 0xF0, 0xA0]))
        ch = int(rng.integers(0, 16))
        data = rng.integers(0, 128, 2).tolist()
        if kind == 0x90 and rng.random() < 0.3:
            data[1] = 0
        if rng.random() < 0.1:
            out.append(int(rng.integers(0, 128)))   # a stray data byte
        out += bytes([kind | ch] + data[:1 if kind == 0xC0 else 2])
    if rng.random() < 0.5:
        out.append(0x90)                            # a truncated tail
    return bytes(out)


def js_stream(rng, n):
    return b"".join(struct.pack(
        "<IhBB", int(rng.integers(0, 2**32)),
        int(rng.integers(-32768, 32768)),
        int(rng.choice([0x01, 0x02, 0x81, 0x82, 0x00])),
        int(rng.integers(0, 16))) for _ in range(n)) + bytes(
        int(rng.integers(0, 8)))


@pytest.mark.parametrize("seed", range(6))
def test_midi_and_joystick_parse_like_jax(seed):
    rng = np.random.default_rng(seed)
    data = midi_stream(rng, 40)
    assert events(t_omc.parse_midi(data)) == events(j_omc.parse_midi(data))
    js = js_stream(rng, 30)
    assert events(t_omc.parse_js(js)) == events(j_omc.parse_js(js))
    assert events(t_omc.parse_midi(data))


def drive(omc, player, tmp, tag):
    """The learn workflow on one package: learn, dispatch, persist,
    reload; returns what it observed."""
    obs = []
    lrn = omc.OMCLearner(player)
    obs.append(sorted(lrn.macros))
    with pytest.raises(KeyError):
        lrn.start_learn("no_such_macro")
    for macro, msg in (("blend", "b0077f"), ("fps", "b10a40"),
                       ("key3_toggle", "903c64"), ("nervous", "c005"),
                       ("fps_reverse", "e00040")):
        lrn.start_learn(macro)
        obs.append(lrn.learning)
        obs.append(lrn.feed_midi(bytes.fromhex(msg)))
        obs.append(lrn.learning)
    for msg in ("b00740", "b10a7f", "903c7f", "c005", "e00040", "b00940"):
        obs.append(lrn.feed_midi(bytes.fromhex(msg)))
        st = player.state
        obs.append((st.blend_amount, st.pb_fps, st.nervous,
                    list(player.keymap.active[:4])))
    lrn.add_macro("custom", lambda v: obs.append(("custom", v)), True)
    lrn.start_learn("custom")
    obs.append(omc.feed_js(lrn, struct.pack("<IhBB", 0, 16384, 0x02, 3)))
    lrn.mappings[omc.EventKey(omc.JS_AXIS, 0, 3)].scale = 2.0
    lrn.mappings[omc.EventKey(omc.JS_AXIS, 0, 3)].offset = -0.5
    obs.append(omc.feed_js(lrn, struct.pack("<IhBB", 0, -32767, 0x02, 3)
                           + struct.pack("<IhBB", 0, 1, 0x81, 3)))
    path = tmp / f"{tag}.json"
    lrn.save_map(path)
    text = path.read_text()
    lrn.mappings.clear()
    lrn.load_map(path)
    obs.append([(k.etype, k.channel, k.index, m.macro, m.scale, m.offset)
                for k, m in lrn.mappings.items()])
    return obs, text


def test_learner_and_device_map_match_jax(tmp_path):
    jp = JPlayer(sink=JCollectSink())
    tp = TPlayer(sink=TCollectSink(), device="cpu")
    for p in (jp, tp):
        p.keymap.set_key(2, 0, "negate")
    j_obs, j_text = drive(j_omc, jp, tmp_path, "j")
    t_obs, t_text = drive(t_omc, tp, tmp_path, "t")
    assert t_obs == j_obs
    assert t_text == j_text
    assert len(json.loads(t_text)) == 6
    # each package reads the other's map
    for omc, p, path in ((t_omc, tp, "j.json"), (j_omc, jp, "t.json")):
        lrn = omc.OMCLearner(p)
        lrn.load_map(tmp_path / path)
        assert len(lrn.mappings) == 6


def test_learner_without_player_has_no_macros():
    for omc in (t_omc, j_omc):
        lrn = omc.OMCLearner()
        assert lrn.macros == {}
        assert lrn.feed_midi(bytes.fromhex("b0077f")) == 0


def test_joystick_reader_is_gated_on_its_device(tmp_path):
    for omc in (t_omc, j_omc):
        with pytest.raises(RuntimeError, match="absent"):
            omc.JoystickReader(omc.OMCLearner(),
                               str(tmp_path / "no_js0"))


def test_joystick_reader_feeds_the_learner(tmp_path):
    """A FIFO stands in for /dev/input/js0: the reader's thread feeds the
    learner what is written to it."""
    import os
    import time
    fifo = tmp_path / "js0"
    os.mkfifo(fifo)
    tp = TPlayer(sink=TCollectSink(), device="cpu")
    lrn = t_omc.OMCLearner(tp)
    lrn.mappings[t_omc.EventKey(t_omc.JS_AXIS, 0, 1)] = t_omc.Mapping(
        t_omc.EventKey(t_omc.JS_AXIS, 0, 1), "blend")
    rd = t_omc.JoystickReader(lrn, str(fifo))
    wfd = os.open(fifo, os.O_RDWR | os.O_NONBLOCK)
    rd.start()
    os.write(wfd, struct.pack("<IhBB", 0, 32767, 0x02, 1))
    deadline = time.monotonic() + 10.0
    while tp.state.blend_amount != 1.0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tp.state.blend_amount == 1.0
    os.close(wfd)
    rd.stop()
