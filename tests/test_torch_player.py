"""The realtime player of lives_tpu_torch against lives_tpu's (ROADMAP
Queue 1 item 20): `KeyMap`, the clock and trickplay, the precache, the
sinks, recording and the re-render, on the CPU.

The same in-memory clip frames (numpy, seeded) feed the JAX `Player` and
the port's `Player(device="cpu")` through a `CollectSink`: frames agree
within +/-1 LSB (torch's and XLA's float kernels differ by an ulp), and
the recorded event lists hold the same events (types, timecodes, clips,
frames, filters, parameter values; event ids are uuid4 draws, so events
refer to each other by position here). Where timecodes must match, both
player modules' `time` is a `chip_smoke.ScriptedClock` (pytest's
monkeypatch); frames are targeted by setting `_clock0`/`_frame0` on that
clock. No test asserts a wall-clock duration: they assert order, counts
and states.

Phase 16 of `chip_smoke.py` holds the port's player on the card to the
JAX package's own player-vs-re-render gap, measured here
(`test_jax_player_vs_its_rerender`): 1 LSB over the Y, U and V planes on
phase 16's performance at 64x36.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from lives_tpu.constants import Palette as JPalette
from lives_tpu.events import EventList as JEventList
from lives_tpu.events.renderer import render_recording as j_render_recording
from lives_tpu.graph import SinkSpec as JSinkSpec
from lives_tpu.io.clips import open_clip as j_open_clip
from lives_tpu.layer import Layer as JLayer
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import KeyMap as JKeyMap
from lives_tpu.player import Player as JPlayer
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch import diagnostics
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.events import EventList
from lives_tpu_torch.events.event_list import EventType
from lives_tpu_torch.events.renderer import render_recording
from lives_tpu_torch.graph import FrameGraph, SinkSpec
from lives_tpu_torch.io.clips import open_clip
from lives_tpu_torch.io.decoders import try_decoders
from lives_tpu_torch.io.genclip import GeneratorClip
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.ops.colorspace import convert_layer
from lives_tpu_torch.player import CollectSink, KeyMap, NullSink, Player
from lives_tpu_torch.player import Y4MSink
from lives_tpu_torch.player import player as t_player_mod
from lives_tpu_torch.player import sinks as t_sinks
from lives_tpu_torch.scenes import DeviceSyntheticSource

REPO = Path(__file__).resolve().parents[1]
PKGS = ("jax", "torch")
MODS = {"jax": j_player_mod, "torch": t_player_mod}


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def frame_array(uid, n, h, w):
    rng = np.random.default_rng(uid * 7919 + n)
    return rng.integers(0, 256, (3, h, w), np.uint8)


class MemClip:
    """In-memory clip of deterministic frames, as either package's
    Layers."""

    def __init__(self, pkg, n=20, h=24, w=48, uid=1):
        self.pkg = pkg
        self.frames = n
        self.fps = 25.0
        self.width, self.height = w, h
        self.unique_id = uid

    def frame_array(self, n):
        return frame_array(self.unique_id, n, self.height, self.width)

    def get_frame(self, n):
        a = self.frame_array(n)
        if self.pkg == "jax":
            return JLayer(planes=(jnp.asarray(a),),
                          palette=int(JPalette.RGB24))
        return Layer(planes=(torch.from_numpy(a),),
                     palette=int(Palette.RGB24))


def make_player(pkg, sink=None, fps=25.0, **clip_kw):
    if pkg == "jax":
        sink = sink or JCollectSink()
        p = JPlayer(sink=sink, sink_spec=JSinkSpec(), fps=fps)
    else:
        sink = sink or CollectSink()
        p = Player(sink=sink, sink_spec=SinkSpec(), fps=fps, device="cpu")
    p.state.fg_clip = MemClip(pkg, **clip_kw)
    return p, sink


def scripted(monkeypatch, pkg):
    """A ScriptedClock in place of the player module's `time`."""
    clock = cs.ScriptedClock()
    monkeypatch.setattr(MODS[pkg], "time", clock)
    return clock


def show(p, frame, clock=None):
    """Show `frame`: the clock based at it, the current frame forgotten."""
    import time
    p.state.frame = -1
    p._clock0 = clock.now if clock is not None else time.monotonic()
    p._frame0 = float(frame)
    return p.process_one()


def run_both(monkeypatch, script, sync=True, **kw):
    """{pkg: (player, sink, script's result)} of `script(p, sink, clock,
    pkg)` on a fresh player of each package, each on its own scripted clock
    from 0. `sync` pins the synchronous chain rebuild in both."""
    out = {}
    for pkg in PKGS:
        clock = scripted(monkeypatch, pkg)
        p, sink = make_player(pkg, **kw)
        if sync:
            p.async_compile = False
        out[pkg] = (p, sink, script(p, sink, clock, pkg))
        p.stop()
    return out


def within_1(a, b):
    a = np.asarray(a).astype(np.int16)
    b = np.asarray(b).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def same_frames(jf, tf):
    assert len(jf) == len(tf) and len(tf) > 0
    for a, b in zip(jf, tf):
        within_1(a, b)


def canon(el):
    """An event list's events with ids replaced by their order of first
    appearance: [(tc, type, id, props)]."""
    ids = {}
    for e in el.events:
        ids.setdefault(e.event_id, len(ids))

    def ref(i):
        return ids.setdefault(i, len(ids))
    out = []
    for e in el.events:
        props = json.loads(json.dumps(e.props))
        if "init_event" in props:
            props["init_event"] = ref(props["init_event"])
        if "init_events" in props:
            props["init_events"] = [ref(i) for i in props["init_events"]]
        out.append((e.tc, int(e.type), ids[e.event_id], props))
    return out


def same_events(jel, tel):
    assert canon(jel) == canon(tel)


# -- clock, clamp, trickplay ------------------------------------------------

CLAMP_MODES = {
    "loop": dict(loop=True),
    "ping_pong": dict(ping_pong=True),
    "no_loop": dict(loop=False),
    "selection_loop": dict(loop=True, sel_start=5, sel_end=9),
    "selection_ping_pong": dict(ping_pong=True, sel_start=3, sel_end=11),
    "selection_no_loop": dict(loop=False, sel_start=4, sel_end=12),
}


@pytest.mark.parametrize("mode", sorted(CLAMP_MODES))
def test_clamp_frame_matches_jax(mode):
    got = {}
    for pkg in PKGS:
        p, _ = make_player(pkg)
        for k, v in CLAMP_MODES[mode].items():
            setattr(p.state, k, v)
        got[pkg] = [p.clamp_frame(f) for f in np.arange(-45.0, 45.0, 0.75)]
    assert got["torch"] == got["jax"]


def test_clamp_modes():
    p, _ = make_player("torch")
    p.state.loop = True
    assert p.clamp_frame(22) == 2
    p.state.ping_pong = True
    assert p.clamp_frame(21) == 18  # bounce back
    p.state.ping_pong = False
    p.state.loop = False
    assert p.clamp_frame(50) == 19
    p.state.sel_start, p.state.sel_end = 5, 9
    p.state.loop = True
    assert p.clamp_frame(10) == 5


@pytest.mark.parametrize("fps", [-25.0, -12.5, 37.5])
def test_trickplay_clock_matches_jax(monkeypatch, fps):
    """set_pb_fps rebases the clock (continuous scratching); negative and
    fractional rates walk the clip the same way in both packages."""
    def script(p, sink, clock, pkg):
        p.start()
        shown = []
        for k in range(12):
            if k == 4:
                p.set_pb_fps(fps)
            clock.now = (k + 0.5) / 25.0
            p.process_one()
            shown.append(p.state.frame)
        return shown
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2]
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
    assert res["torch"][0].state.pb_fps == fps


def test_trickplay_reverse():
    p, _ = make_player("torch")
    p.set_pb_fps(-25.0)
    assert p.state.pb_fps == -25.0
    assert p.clamp_frame(-3.0) == 17  # wraps backwards


def test_time_source_callable_matches_jax(monkeypatch):
    """An external transport clock (seconds) drives the frame at the clip's
    base rate."""
    def script(p, sink, clock, pkg):
        t = [0.0]
        p.time_source = lambda: t[0]
        p.start()
        shown = []
        for k in range(6):
            t[0] = 0.13 * k
            p.process_one()
            shown.append(p.state.frame)
        return shown
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2] == [0, 3, 6, 9, 13, 16]


@pytest.mark.parametrize("bg_fps", [0.0, 12.5, -50.0])
def test_bg_frame_mapping_matches_jax(bg_fps):
    got = {}
    for pkg in PKGS:
        p, _ = make_player(pkg)
        p.state.bg_clip = MemClip(pkg, n=7, uid=2)
        p.state.bg_pb_fps = bg_fps
        got[pkg] = [p._bg_frame(t) for t in range(-5, 30)]
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("jump", [2, 5, 9])
def test_frame_drop_accounting_matches_jax(monkeypatch, jump):
    def script(p, sink, clock, pkg):
        p.start()
        p.process_one()
        # the clock jumps `jump` frames ahead: jump - 1 dropped
        p._clock0 = clock.now
        p._frame0 = float(p.state.frame + jump)
        p.process_one()
        return p.frames_dropped
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2] == jump - 1


def test_stats():
    p, sink = make_player("torch")
    p.start()
    p.process_one()
    st = p.stats()
    assert st["frames_shown"] == 1 and st["frames_dropped"] == 0
    assert st["inst_fps"] > 0 and st["p99_ms"] > 0
    p.stop()


def test_stats_on_a_frozen_clock():
    """Every cycle took no time by the clock: the rate reads 0, never a
    division by zero."""
    p, _ = make_player("torch")
    p._frame_times = [0.0] * 4
    assert p.stats()["inst_fps"] == 0.0


def test_ping_pong_playback_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.state.ping_pong = True
        p.start()
        shown = []
        for k in range(45):
            clock.now = (k + 0.5) / 25.0
            p.process_one()
            shown.append(p.state.frame)
        return shown
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2]
    assert max(res["torch"][2]) == 19 and res["torch"][2][-1] < 19
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


# -- keys -------------------------------------------------------------------

def test_keymap_ops_match_jax():
    ops = [("set_key", 0, 0, "negate"), ("set_key", 0, 1, "saturation"),
           ("set_key", 5, 2, "vignette"), ("toggle", 0, None),
           ("toggle", 5, True), ("next_mode", 0), ("toggle", 0, True),
           ("prev_mode", 5), ("toggle", 5, False), ("toggle", 9, True),
           ("next_mode", 5), ("toggle", 5, None)]
    seen = {}
    for pkg, km in (("jax", JKeyMap()), ("torch", KeyMap())):
        trace = []
        for op, *args in ops:
            r = getattr(km, op)(*args)
            trace.append((r, list(km.mode[:10]), list(km.active[:10]),
                          [km.current_filter(k) for k in range(10)],
                          [(k, name) for k, name, _ in km.chain_key()],
                          [i.filter.name for i in km.active_chain()]))
        seen[pkg] = trace
    assert seen["torch"] == seen["jax"]


def test_chain_key_matches_active_chain():
    p, _ = make_player("torch")
    p.keymap.set_key(0, 0, "negate")
    p.keymap.set_key(0, 1, "sepia")
    p.key_toggle(0, True)
    k1 = p.keymap.chain_key()
    assert len(k1) == 1
    p.keymap.next_mode(0)          # instance dropped, key still active
    assert p.keymap.active_chain() == []
    assert p.keymap.chain_key() == ()
    p.key_toggle(0, False)
    p.key_toggle(0, True)          # new instance (sepia)
    k2 = p.keymap.chain_key()
    assert len(k2) == 1 and k2 != k1


def test_per_key_fx_defaults_persist(tmp_path):
    """fxdefs.perkey analogue: per-(key,mode) param defaults apply on
    instantiation and survive keymap save/load."""
    p, _ = make_player("torch")
    p.keymap.set_key(2, 0, "brightness_contrast")
    p.keymap.set_key_defaults(2, 0, brightness=0.4, contrast=2.0)
    p.key_toggle(2, True)
    inst = p.keymap.instances[2]
    assert inst.values["brightness"] == 0.4
    assert inst.values["contrast"] == 2.0
    path = tmp_path / "map.json"
    p.keymap.save(path)
    q, _ = make_player("torch")
    q.keymap.load(path)
    q.key_toggle(2, True)
    assert q.keymap.instances[2].values["brightness"] == 0.4


def _filled(km):
    km.set_key(0, 0, "negate")
    km.set_key(0, 1, "saturation")
    km.set_key(3, 0, "gaussian_blur")
    km.set_key(63, 4, "vignette")
    km.set_key_defaults(3, 0, radius=5, amount=0.75)
    km.set_key_defaults(0, 1, saturation=1.5)
    return km


@pytest.mark.parametrize("writer", PKGS)
def test_keymap_file_byte_identical_both_ways(tmp_path, writer):
    """A keymap saved by one package loads in the other, which saves the
    same bytes; both packages write the same file from the same map."""
    first = tmp_path / "first.json"
    again = tmp_path / "again.json"
    _filled(JKeyMap() if writer == "jax" else KeyMap()).save(first)
    reader = KeyMap() if writer == "jax" else JKeyMap()
    reader.load(first)
    reader.save(again)
    assert again.read_bytes() == first.read_bytes()
    other = tmp_path / "other.json"
    _filled(KeyMap() if writer == "jax" else JKeyMap()).save(other)
    assert other.read_bytes() == first.read_bytes()


def test_load_refuses_a_file_that_is_no_keymap(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError):
        KeyMap().load(path)


def test_reference_keymap_import(tmp_path):
    """The reference's default.keymap lines map onto the filters the port
    registers; the JAX package maps the same lines onto its own
    registry."""
    path = tmp_path / "default.keymap"
    path.write_text("1|negate\n2|blurfilter\n3|ccorrect\n4|nosuchthing\n"
                    "x|negate\n70|negate\n5|simple_blend chroma blend\n")
    km = KeyMap()
    assert km.load_reference_keymap(path) == 4
    assert [km.current_filter(k) for k in range(5)] == [
        "negate", "gaussian_blur", "colour_balance", "", "crossfade"]
    jkm = JKeyMap()
    jkm.load_reference_keymap(path)
    assert [jkm.current_filter(k) for k in range(5)] == \
        [km.current_filter(k) for k in range(5)]


def test_rte_key_chain_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.keymap.set_key(0, 0, "negate")
        p.start()
        show(p, 0, clock)
        p.key_toggle(0, True)
        show(p, 0, clock)
        p.keymap.set_key(0, 1, "greyscale")
        p.keymap.next_mode(0)
        return p.keymap.current_filter(0)
    res = run_both(monkeypatch, script)
    clean, fx = res["torch"][1].frames
    np.testing.assert_array_equal(fx, 255 - clean)
    assert res["torch"][2] == res["jax"][2] == "greyscale"
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


@pytest.mark.parametrize("blend", [0.0, 0.3, 1.0])
def test_fg_bg_blend_matches_jax(monkeypatch, blend):
    def script(p, sink, clock, pkg):
        p.state.bg_clip = MemClip(pkg, uid=2)
        p.state.blend_amount = blend
        p.start()
        for f in (0, 3, 7):
            show(p, f, clock)
    res = run_both(monkeypatch, script)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
    if blend == 0.0:   # the crossfade weights the fg: 0 = all bg
        np.testing.assert_array_equal(res["torch"][1].frames[0],
                                      frame_array(2, 0, 24, 48))


def test_bg_clip_select_after_cache_reblends_matches_jax(monkeypatch):
    """The graph cache key holds bg presence: selecting a bg after the
    chain's graph was cached applies the crossfade, the live blend factor
    follows the state without a new graph, clearing it goes back to one
    track."""
    def script(p, sink, clock, pkg):
        p.start()
        show(p, 1, clock)
        p.state.bg_clip = MemClip(pkg, uid=2)
        p.state.blend_amount = 0.0
        show(p, 2, clock)
        p.state.blend_amount = 1.0
        show(p, 3, clock)
        p.state.bg_clip = None
        show(p, 4, clock)
        return len(p._graphs)
    res = run_both(monkeypatch, script)
    f = res["torch"][1].frames
    assert not np.array_equal(f[1], frame_array(1, 2, 24, 48))
    within_1(f[2], frame_array(1, 3, 24, 48))
    np.testing.assert_array_equal(f[3], frame_array(1, 4, 24, 48))
    assert res["torch"][2] == res["jax"][2] == 2
    same_frames(res["jax"][1].frames, f)


def test_set_key_param_records_and_renders_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.keymap.set_key(1, 0, "saturation")
        p.key_toggle(1, True)
        p.record_start(48, 24)
        p.start()
        for k, s in enumerate((0.5, 0.5, 1.7, 0.2)):
            p.set_key_param(1, "saturation", s)
            clock.now = k / 25.0
            show(p, k, clock)
        p.set_key_param(7, "saturation", 2.0)   # no instance: ignored
        return p.record_stop()
    res = run_both(monkeypatch, script)
    same_events(res["jax"][2], res["torch"][2])
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
    pcs = [e for e in res["torch"][2].events
           if e.type == EventType.PARAM_CHANGE]
    assert [e.props["value"] for e in pcs] == [0.5, 0.5, 1.7, 0.2]


# -- async rebuild ----------------------------------------------------------

def test_async_compile_serves_old_graph_then_swaps():
    p, sink = make_player("torch")
    p.prewarm_compile = False
    p.keymap.set_key(0, 0, "negate")
    p.start()
    show(p, 0)                 # establishes the empty chain's graph
    base = sink.frames[-1]
    p.key_toggle(0, True)
    show(p, 0)
    th = p._compile_thread
    if th is not None:
        th.join(timeout=60)
        assert not th.is_alive()
    assert p._served_key == p._chain_cache_key()
    show(p, 0)
    np.testing.assert_array_equal(sink.frames[-1], 255 - base)
    p.stop()


def test_toggle_never_blocks_serving_loop(monkeypatch):
    """A key toggle must not stall process_one: while the new chain's
    warm-up is held on its thread, the serving loop shows frames with the
    old graph; once it lands, the new chain serves."""
    release, entered = threading.Event(), threading.Event()
    run = FrameGraph.run

    def held_run(self, layers, *a, **kw):
        if threading.current_thread() is not threading.main_thread():
            entered.set()
            assert release.wait(timeout=60), "warm-up never released"
        return run(self, layers, *a, **kw)
    monkeypatch.setattr(FrameGraph, "run", held_run)
    p, sink = make_player("torch")
    p.prewarm_compile = False
    p.keymap.set_key(0, 0, "negate")
    p.start()
    show(p, 0)
    base = sink.frames[-1]
    old_key = p._served_key
    p.key_toggle(0, True)
    show(p, 0)
    assert entered.wait(timeout=60)
    for f in (0, 0):          # the warm-up is still held: the old graph
        show(p, f)
        np.testing.assert_array_equal(sink.frames[-1], base)
        assert p._served_key == old_key
    assert p._compile_thread.is_alive()
    release.set()
    p._compile_thread.join(timeout=60)
    show(p, 0)
    np.testing.assert_array_equal(sink.frames[-1], 255 - base)
    p.stop()


def test_prewarm_warms_one_toggle_away():
    """Safe-point pre-warm (player.c:2655): after a frame the mapped but
    inactive key's chain is warm, so the toggle applies on the very next
    frame."""
    p, sink = make_player("torch")
    p.keymap.set_key(0, 0, "negate")
    p.start()
    show(p, 0)                 # the safe point starts the pre-warm
    th = p._compile_thread
    assert th is not None
    th.join(timeout=60)
    assert p.warm_landed.is_set() and p.warm_failures == 0, p.warm_error
    assert len(p._graphs) == 2
    base = sink.frames[-1]
    p.key_toggle(0, True)
    show(p, 0)
    np.testing.assert_array_equal(sink.frames[-1], 255 - base)
    p.stop()


def test_failed_warm_up_is_counted(monkeypatch):
    """A warm-up that raises is counted and kept (`warm_failures`,
    `warm_error`), its landing still signalled; the toggle then builds
    the chain on the serving thread."""
    run = FrameGraph.run

    def failing(self, layers, *a, **kw):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("warm-up failed")
        return run(self, layers, *a, **kw)
    monkeypatch.setattr(FrameGraph, "run", failing)
    p, sink = make_player("torch")
    p.keymap.set_key(0, 0, "negate")
    p.start()
    show(p, 0)
    assert p.warm_landed.wait(timeout=60)
    assert p.warm_failures == 1
    assert str(p.warm_error) == "warm-up failed"
    base = sink.frames[-1]
    p.key_toggle(0, True)
    show(p, 0)
    show(p, 0)
    np.testing.assert_array_equal(sink.frames[-1], 255 - base)
    p.stop()


def test_warm_up_leaves_states_untouched():
    """The warm-up runs with mirror_state=False: a stateful chain's
    instance does not consume a phantom frame."""
    p, sink = make_player("torch")
    p.keymap.set_key(0, 0, "rgb_delay")
    p.start()
    show(p, 0)
    p._compile_thread.join(timeout=60)
    assert p.keymap.instances[0] is not None
    assert p.keymap.instances[0].state is None
    p.stop()


# -- precache and fetch -----------------------------------------------------

def test_precache_prefetches_frames():
    p, _ = make_player("torch")
    p.precache_depth = 3
    p.start()
    show(p, 0)
    # the worker fills the window on its own thread: wait for it by
    # condition, with a bound only against a hang
    import time
    for _ in range(3000):
        if all(p._ck(p.state.fg_clip, f) in p._precache for f in range(4)):
            break
        time.sleep(0.01)
    assert all(p._ck(p.state.fg_clip, f) in p._precache for f in range(4))
    p.stop()
    assert not p._precache_thread.is_alive()


def test_precache_is_lru_and_version_keyed():
    p, _ = make_player("torch")
    clip = p.state.fg_clip
    p.precache_depth = 2
    marker = clip.get_frame(3)
    p._precache[p._ck(clip, 3)] = marker
    assert p._pull(clip, 3) is marker
    assert p._pull(clip, 3) is marker          # still cached after a hit
    clip.version = 1                           # simulated content edit
    assert p._pull(clip, 3) is not marker      # stale entry not served


@pytest.mark.parametrize("depth", [1, 4])
def test_precached_playback_matches_jax(monkeypatch, depth):
    """Frames served through the precache (and inline decodes on a miss)
    are the JAX player's."""
    def script(p, sink, clock, pkg):
        p.precache_depth = depth
        p.drop_on_miss = False
        p.state.bg_clip = MemClip(pkg, n=13, uid=2)
        p.start()
        for k in range(30):
            clock.now = (k + 0.5) / 25.0
            p.process_one()
        return p.frames_shown
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2] == 30
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


def test_precache_miss_drops_the_frame():
    """A miss on a frame the worker is decoding drops it (the clock moves
    on) and counts one drop for it."""
    p, sink = make_player("torch")
    p.precache_depth = 2
    p.start()
    show(p, 0)
    key = p._ck(p.state.fg_clip, 5)
    p._precache.pop(key, None)
    p._inflight = {key}
    p._pc_stop = True          # keep the worker from clearing it
    p._precache_thread.join(timeout=60)
    before = p.frames_dropped
    p.state.frame = 4
    p.time_source = lambda: 5.5 / 25.0     # the clock at frame 5
    p.process_one()
    assert p.frames_dropped == before + 1 and p.state.frame == 4
    assert len(sink.frames) == 1
    p.stop()


@pytest.mark.parametrize("fetch", [2, 3, 4])
def test_fetch_batch_delivers_identical_frames(monkeypatch, fetch):
    """Groups of K frames fetched in one copy deliver the same frames, in
    order, with the same timecodes, as the per-frame path and as the JAX
    player's."""
    def drive(pkg, k):
        clock = scripted(monkeypatch, pkg)
        p, sink = make_player(pkg)
        p.state.bg_clip = MemClip(pkg, uid=2)
        p.pipeline_depth, p.fetch_batch = 2, k
        p.start()
        for i in range(10):
            show(p, i, clock)
        p.stop()   # drains the pipeline
        return [np.asarray(f) for f in sink.frames], sink.tcs
    base, base_tcs = drive("torch", 0)
    batched, tcs = drive("torch", fetch)
    assert len(batched) == len(base) == 10 and tcs == base_tcs
    for a, b in zip(base, batched):
        np.testing.assert_array_equal(a, b)
    jax_frames, jax_tcs = drive("jax", fetch)
    assert jax_tcs == tcs
    same_frames(jax_frames, batched)


def test_fetch_batch_mixed_shapes_pass_through():
    p, _ = make_player("torch")
    a = Layer(planes=(torch.zeros((3, 8, 16), dtype=torch.uint8),))
    b = Layer(planes=(torch.zeros((3, 4, 16), dtype=torch.uint8),))
    out = p._fetch_host_layers([(a, 0.0), (b, 0.1)])
    assert out[0][0] is a and out[1][0] is b


def test_fetch_splits_yuv_planes():
    """A group of YUV420P frames (three planes of two sizes) comes back as
    the same planes, frame by frame."""
    p, _ = make_player("torch")
    rng = np.random.default_rng(5)
    group = [(Layer(planes=tuple(torch.from_numpy(
        rng.integers(0, 256, s, np.uint8)) for s in
        ((6, 8), (3, 4), (3, 4))), palette=int(Palette.YUV420P)), t)
        for t in (0.0, 0.1, 0.2)]
    out = p._fetch_host_layers(group)
    for (o, t), (g, tg) in zip(out, group):
        assert t == tg and o.palette == g.palette
        for a, b in zip(o.planes, g.planes):
            assert torch.equal(a, b)


# -- recording ---------------------------------------------------------------

def test_recording_produces_event_list_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.keymap.set_key(0, 0, "negate")
        p.record_start(width=48, height=24)
        p.start()
        p.process_one()
        p.key_toggle(0, True)
        clock.now = 0.04
        show(p, 3, clock)
        clock.now = 0.08
        p.key_toggle(0, False)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    el = res["torch"][2]
    types = [e.type.name for e in el.events]
    assert "FRAME" in types and "FILTER_INIT" in types \
        and "FILTER_DEINIT" in types
    assert len(EventList.from_json(el.to_json())) == len(el)
    same_events(res["jax"][2], el)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


def test_record_start_snapshots_active_chain_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.keymap.set_key(0, 0, "negate")
        p.keymap.set_key(4, 0, "saturation")
        p.key_toggle(4, True)
        p.key_toggle(0, True)
        p.record_start(width=32, height=16)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    inits = [e for e in res["torch"][2].events
             if e.type == EventType.FILTER_INIT]
    assert [e.props["filter"] for e in inits] == ["negate", "saturation"]
    same_events(res["jax"][2], res["torch"][2])


def test_idempotent_toggle_records_once_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.keymap.set_key(0, 0, "negate")
        p.record_start(width=32, height=16)
        for on in (True, True, True, False, False):
            p.key_toggle(0, on)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    el = res["torch"][2]
    assert sum(e.type == EventType.FILTER_INIT for e in el.events) == 1
    assert sum(e.type == EventType.FILTER_DEINIT for e in el.events) == 1
    same_events(res["jax"][2], el)


def test_nervous_mode_records_deterministically_matches_jax(monkeypatch):
    """The jittered frames are what is shown and recorded, drawn from the
    player's own numpy generator: the same seed jitters both packages the
    same way."""
    def script(p, sink, clock, pkg):
        p._nervous_rng = np.random.default_rng(123)
        p.state.nervous = True
        p.record_start(width=48, height=24)
        p.start()
        shown = []
        for k in range(8):
            clock.now = k / 25.0
            show(p, k, clock)
            shown.append(p.state.frame)
        return shown, p.record_stop()
    res = run_both(monkeypatch, script)
    shown, el = res["torch"][2]
    rec = [e.frames[0] for e in el.events if e.type == EventType.FRAME]
    assert rec == shown and rec != list(range(8))
    assert shown == res["jax"][2][0]
    same_events(res["jax"][2][1], el)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


def test_nervous_respects_can_reverse():
    p, _ = make_player("torch")
    p.state.fg_clip.can_reverse = False
    p._nervous_rng = np.random.default_rng(1)
    p.state.nervous = True
    p.start()
    show(p, 5)
    assert p.state.frame == 5     # jitter suppressed
    p.stop()


def test_autotransition_matches_jax(monkeypatch):
    """Switching fg during playback rides a crossfade: the old clip lands
    on the bg track, the transition key engages, the blend ramps over the
    duration on the clock, then the bg track and key release."""
    def script(p, sink, clock, pkg):
        old = p.state.fg_clip
        new = MemClip(pkg, uid=2)
        p.keymap.set_key(3, 0, "crossfade")
        p.set_autotrans(3, duration=0.2)
        p.record_start(48, 24)
        p.start()
        p.process_one()
        p.switch_fg(new)
        states = [(p.state.fg_clip is new, p.state.bg_clip is old,
                   p.keymap.active[3], p.state.blend_amount)]
        for k in range(1, 8):
            clock.now = k * 0.04
            show(p, k, clock)
            states.append((p.state.bg_clip is not None,
                           p.keymap.active[3], p.state.blend_amount))
        return states, p.record_stop()
    res = run_both(monkeypatch, script)
    states, el = res["torch"][2]
    assert states[0] == (True, True, True, 0.0)
    assert states[1][0] and states[1][1] and 0 < states[1][2] < 1
    assert states[-1] == (False, False, 0.5)    # released
    assert states == res["jax"][2][0]
    same_events(res["jax"][2][1], el)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


def test_switch_fg_hard_cut_without_autotrans():
    p, _ = make_player("torch")
    new = MemClip("torch", uid=3)
    p.start()
    p.switch_fg(new)
    assert p.state.fg_clip is new and p.state.bg_clip is None
    p.stop()


def test_recording_captures_bg_blend_matches_jax(monkeypatch):
    """The fg/bg auto-mix is recorded (crossfade init + amount pchain) and
    survives the re-render; removing the bg records the deinit."""
    def script(p, sink, clock, pkg):
        p.state.bg_clip = MemClip(pkg, uid=2)
        p.record_start(width=48, height=24)
        p.start()
        for i, blend in enumerate((0.2, 0.2, 0.9, 0.9)):
            if i == 3:
                p.state.bg_clip = None
            p.state.blend_amount = blend
            clock.now = i / 25.0
            show(p, i, clock)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    el = res["torch"][2]
    inits = [e for e in el.events if e.type == EventType.FILTER_INIT
             and e.props["filter"] == "crossfade"]
    assert len(inits) == 1 and inits[0].props["in_tracks"] == [0, 1]
    assert inits[0].props["values"]["amount"] == pytest.approx(0.2)
    pcs = [e for e in el.events if e.type == EventType.PARAM_CHANGE]
    assert len(pcs) == 1 and pcs[0].props["value"] == pytest.approx(0.9)
    assert sum(e.type == EventType.FILTER_DEINIT for e in el.events) == 1
    same_events(res["jax"][2], el)
    clips = {1: MemClip("torch"), 2: MemClip("torch", uid=2)}
    frames, _ = render_recording(el, clips, fps=25.0, batch_size=8,
                                 device="cpu")
    fg0 = frame_array(1, 0, 24, 48).astype(float)
    bg0 = frame_array(2, 0, 24, 48).astype(float)
    assert np.abs(frames[0] - fg0).mean() > 2.0
    assert np.abs(frames[0] - (fg0 * 0.2 + bg0 * 0.8)).mean() < 3.0
    jframes, _ = j_render_recording(
        res["jax"][2], {1: MemClip("jax"), 2: MemClip("jax", uid=2)},
        fps=25.0, batch_size=8)
    same_frames(list(np.asarray(jframes)), list(frames))


def test_chaotic_recording_rerenders_deterministically(monkeypatch):
    """A recorded performance under random trickplay (key toggles, fps
    scratching, nervous mode, bg blending, param tweaks) re-renders to the
    same pixels twice and from its JSON; its events and its re-render are
    the JAX player's."""
    import random

    def script(p, sink, clock, pkg):
        rng = random.Random(4)
        p._nervous_rng = np.random.default_rng(7)
        p.state.bg_clip = MemClip(pkg, uid=2)
        p.keymap.set_key(0, 0, "negate")
        p.keymap.set_key(1, 0, "saturation")
        p.record_start(width=48, height=24)
        p.start()
        for i in range(25):
            op = rng.random()
            if op < 0.2:
                p.key_toggle(rng.randrange(2))
            elif op < 0.3:
                p.set_pb_fps(rng.choice([25.0, -50.0, 12.5]))
            elif op < 0.4:
                p.state.nervous = not p.state.nervous
            elif op < 0.5:
                p.state.blend_amount = rng.random()
            elif op < 0.6:
                p.set_key_param(1, "saturation", rng.uniform(0.5, 2.0))
            clock.now = i / 25.0
            show(p, i % 20, clock)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    el = res["torch"][2]
    same_events(res["jax"][2], el)
    clips = {1: MemClip("torch"), 2: MemClip("torch", uid=2)}
    f1, t1 = render_recording(el, clips, fps=25.0, batch_size=8,
                              device="cpu")
    f2, t2 = render_recording(el, clips, fps=25.0, batch_size=8,
                              device="cpu")
    assert t1 == t2 and len(f1) >= 1
    np.testing.assert_array_equal(f1, f2)
    f3, _ = render_recording(EventList.from_json(el.to_json()), clips,
                             fps=25.0, batch_size=8, device="cpu")
    np.testing.assert_array_equal(f1, f3)
    jf, jt = j_render_recording(
        res["jax"][2], {1: MemClip("jax"), 2: MemClip("jax", uid=2)},
        fps=25.0, batch_size=8)
    assert jt == t1
    same_frames(list(np.asarray(jf)), list(f1))


def test_double_record_stop_keeps_last_take(monkeypatch):
    clock = scripted(monkeypatch, "torch")
    p, _ = make_player("torch")
    p.start()
    p.record_start(32, 16)
    for i in range(3):
        clock.now = i / 25.0
        show(p, i, clock)
    el = p.record_stop()
    assert p.last_recording is el and len(el.events)
    assert p.record_stop() is None          # stray second stop
    assert p.last_recording is el           # take survives
    p.stop()


def test_record_toggle_storm_never_kills_serving_loop():
    """record_start/record_stop hammered from another thread while the
    serving loop pumps and toggles a key: the loop never dies on the event
    list being swapped out mid-section. Counts, not durations: 300 record
    swaps against a loop that shows frames throughout."""
    p, _ = make_player("torch", sink=NullSink())
    p.async_compile = False
    p.keymap.set_key(0, 0, "negate")
    p.start()
    errors, stop = [], threading.Event()
    shown = []

    def pump():
        i = 0
        while not stop.is_set():
            try:
                show(p, i % 20)
                p.key_toggle(0, i % 2 == 0)
                i += 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
        shown.append(i)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=pump)
    try:
        t.start()
        for _ in range(300):
            p.record_start(32, 16)
            p.record_stop()
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert not errors, f"serving loop died: {errors[0]!r}"
    assert shown and shown[0] > 0 and p.frames_shown > 0
    p.stop()


def test_render_recording_bridge_matches_jax(monkeypatch):
    def script(p, sink, clock, pkg):
        p.record_start(48, 24)
        p.start()
        p.process_one()
        clock.now = 0.08
        show(p, 2, clock)
        return p.record_stop()
    res = run_both(monkeypatch, script)
    el = res["torch"][2]
    clip = MemClip("torch")
    frames, tcs = render_recording(
        el, {clip.unique_id: clip}, SinkSpec(width=48, height=24),
        fps=25.0, batch_size=8, device="cpu")
    assert frames.shape[1:] == (3, 24, 48) and len(frames) >= 1
    jframes, jtcs = j_render_recording(
        res["jax"][2], {1: MemClip("jax")},
        JSinkSpec(width=48, height=24), fps=25.0, batch_size=8)
    assert jtcs == tcs
    same_frames(list(np.asarray(jframes)), list(frames))


def test_render_last_recording_its_batches_and_preview(monkeypatch):
    """render_last_recording on the player's device; its chunked form
    yields the same frames; the paced preview shows each through the sink
    (on the real clock)."""
    p, sink = make_player("torch")
    clip = p.state.fg_clip
    p.keymap.set_key(0, 0, "negate")
    p.key_toggle(0, True)
    p.record_start(48, 24)
    p.start()
    for i in range(4):
        show(p, i)
    p.record_stop()
    p.stop()
    uid_map = p.recording_uid_map([clip])
    assert uid_map == {1: clip}
    frames, tcs = p.render_last_recording(uid_map, batch_size=3)
    chunks = list(p.render_last_recording_batches(uid_map, batch_size=3))
    np.testing.assert_array_equal(
        np.concatenate([c for _, c in chunks]), frames)
    assert [t for ts, _ in chunks for t in ts] == tcs
    np.testing.assert_array_equal(frames[0], 255 - clip.frame_array(0))
    preview = CollectSink()
    p.sink = preview
    assert p.preview_last_recording(uid_map, batch_size=3) == len(frames)
    np.testing.assert_array_equal(np.stack(preview.frames), frames)
    p.state.playing = True
    with pytest.raises(RuntimeError):
        p.preview_last_recording(uid_map)


def test_jsonl_autosave_matches_jax(monkeypatch, tmp_path):
    """The JSONL autosave: a header line, the events appended as they are
    recorded, then the whole take at record_stop (tmp + replace); each
    package's file loads in the other with the same events."""
    def script(p, sink, clock, pkg):
        path = tmp_path / f"{pkg}.jsonl"
        p.keymap.set_key(0, 0, "negate")
        p.record_start(48, 24, backup_path=path, backup_every=0.05)
        p.start()
        appended = []
        for i in range(6):
            if i == 2:
                p.key_toggle(0, True)
            clock.now = i * 0.04
            show(p, i, clock)
            appended.append(len(path.read_text().splitlines()))
        el = p.record_stop()
        return appended, path.read_text(), el
    res = run_both(monkeypatch, script)
    appended, text, el = res["torch"][2]
    jappended, jtext, jel = res["jax"][2]
    assert appended == jappended and appended[-1] > appended[0] > 0
    same_events(EventList.from_autosave(text), el)
    same_events(JEventList.from_autosave(text), jel)
    same_events(EventList.from_autosave(jtext), el)


def test_append_backup_jsonl_lines_load_as_the_take(monkeypatch, tmp_path):
    clock = scripted(monkeypatch, "torch")
    p, _ = make_player("torch")
    path = tmp_path / "take.jsonl"
    p.record_start(48, 24, backup_path=path, backup_every=1e9)
    p.start()
    for i in range(5):
        clock.now = i / 25.0
        show(p, i, clock)
    p._append_backup(p.event_list)
    lines = path.read_text().splitlines()
    assert json.loads(lines[0])["format"] == "lives_tpu_event_list_jsonl"
    same_events(EventList.from_autosave(path.read_text()), p.event_list)
    assert p.discard_recording() and not path.exists()


def test_discard_recording_removes_take_and_autosave(tmp_path):
    p, _ = make_player("torch")
    path = tmp_path / "take.jsonl"
    p.record_start(48, 24, backup_path=path)
    p.start()
    show(p, 0)
    p.record_stop()
    assert path.exists() and p.last_recording is not None
    assert p.discard_recording()
    assert not path.exists() and p.last_recording is None
    assert not p.discard_recording()
    p.stop()


# -- sinks ------------------------------------------------------------------

def test_y4m_sink_writes_the_frames(tmp_path):
    """A Y4MSink under a YUV420P SinkSpec (as the console sets it up) writes
    the frames the chain made, readable by the decoder."""
    path = str(tmp_path / "out.y4m")
    p = Player(Y4MSink(path), SinkSpec(palette=int(Palette.YUV420P)),
               fps=25.0, device="cpu")
    p.state.fg_clip = MemClip("torch", h=24, w=48)
    p.keymap.set_key(0, 0, "negate")
    p.key_toggle(0, True)
    p.pipeline_depth, p.fetch_batch = 1, 2
    p.start()
    for i in range(5):
        show(p, i)
    p.stop()
    cd = try_decoders(path)
    assert (cd.nframes, cd.width, cd.height, cd.fps) == (5, 48, 24, 25.0)
    for i in range(5):
        want = convert_layer(Layer(planes=(torch.from_numpy(
            255 - p.state.fg_clip.frame_array(i)),)), Palette.YUV420P)
        got = cd.decoder.get_frame(i)
        for a, b in zip(got.planes, want.planes):
            assert torch.equal(a, b)
    cd.decoder.close()


def test_null_sink_counts_host_frames():
    s = NullSink(sync_every=2)
    lay = Layer(planes=(torch.zeros((3, 2, 2), dtype=torch.uint8),))
    for _ in range(5):
        assert s.play_frame(lay, 0.0)
    s.exit_screen()
    assert s.count == 5


def test_host_planes_of_a_host_layer_are_views():
    planes = (torch.arange(6, dtype=torch.uint8).reshape(2, 3),
              torch.ones((1, 1), dtype=torch.uint8))
    out = t_sinks.host_planes(Layer(planes=planes))
    assert [o.tolist() for o in out] == [p.tolist() for p in planes]


# -- generators -------------------------------------------------------------

def test_generator_fg_rides_as_genslot_matches_jax(monkeypatch):
    """A stateless generator clip is generated inside the run on the clip's
    own clock (GenSlot): the frames are the JAX player's."""
    from lives_tpu.io.genclip import GeneratorClip as JClip

    def script(p, sink, clock, pkg):
        p.state.fg_clip = (JClip("plasma", 48, 24, fps=25.0) if pkg == "jax"
                           else GeneratorClip("plasma", 48, 24, fps=25.0,
                                              device="cpu"))
        p.keymap.set_key(0, 0, "saturation")
        p.key_toggle(0, True)
        p.start()
        for i in (0, 7, 3):
            show(p, i, clock)
    res = run_both(monkeypatch, script)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


# -- what the slice leaves out ----------------------------------------------

LEFT_OUT = {
    "attach_audio": (lambda: make_player("torch")[0].attach_audio(), 23),
    "time_source_audio": (
        lambda: setattr(make_player("torch")[0], "time_source", "audio"),
        23),
    "av_stream_sink": (lambda: t_sinks.AVStreamSink("udp://x:1"), 23),
    "vloopback_sink": (lambda: t_sinks.VLoopbackSink(), 23),
}


@pytest.mark.parametrize("feature", sorted(LEFT_OUT))
def test_left_out_features_raise_naming_their_item(feature):
    fn, item = LEFT_OUT[feature]
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        fn()


def test_datacons_wire_the_served_graph():
    """Data connections, refused until they were ported, wire the served
    chain: the channel connection between two active keys is the graph's
    cconx and part of its cache key, and each cycle pushes connected
    out-values before the run."""
    from lives_tpu_torch.effects.data import DataConnections
    p, sink = make_player("torch")
    p.async_compile = False
    for k, name in enumerate(("motion_mask", "mask_overlay", "vignette")):
        p.keymap.set_key(k, 0, name)
        p.key_toggle(k, True)
    i = p.keymap.instances
    i[1].in_tracks = (0, 0)
    dc = DataConnections()
    dc.add_channel(i[0], "mask", i[1], 0)
    dc.add(i[0], "motion", i[2], "amount", autoscale=True)
    i[0].out_values = {"motion": torch.tensor(0.5)}
    p.datacons = dc
    p.start()
    show(p, 0)
    show(p, 1)
    g = p._graphs[p._served_key]
    assert g.cconx == ((0, "mask", 1, 0),)
    assert p._served_key[-1] == ((0, "mask", 1, 0),)
    assert float(i[2].values["amount"]) == 0.5
    assert len(sink.frames) == 2
    p.stop()


def test_batched_device_decode_lane_is_absent():
    p, _ = make_player("torch")
    assert p._decode_frames_batched(p.state.fg_clip, [0, 1]) is None


def test_player_refuses_cuda_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        Player()
    with pytest.raises(ValueError):
        Player(device="meta")


def test_port_package_never_imports_jax_or_lives_tpu():
    """Every module of lives_tpu_torch (run as a `__main__` or not) imports
    neither jax nor anything of lives_tpu."""
    code = (
        "import importlib, pkgutil, sys, lives_tpu_torch\n"
        "for m in pkgutil.walk_packages(lives_tpu_torch.__path__, "
        "'lives_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from lives_tpu_torch.effects.host import list_filters\n"
        "list_filters()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'lives_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'lives_tpu_torch.player.player' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# -- diagnostics --------------------------------------------------------------

def test_frame_ladder_and_step_timer_match_jax(monkeypatch):
    from lives_tpu import diagnostics as jdiag
    ticks = iter(range(0, 10**9, 37_000))
    monkeypatch.setattr(diagnostics, "current_ticks", lambda: next(ticks))
    ladders = []
    for mod in (diagnostics, jdiag):
        lad = mod.FrameLadder(keep=4)
        for _ in range(7):
            lad.begin()
            for stage in ("loaded", "converted", "applied", "displayed"):
                lad.mark(stage)
            lad.end()
        ladders.append(lad)
    # the same frames fed to both: the same aggregates
    ladders[1].frames = [dict(f) for f in ladders[0].frames]
    assert ladders[0].stats() == ladders[1].stats()
    assert len(ladders[0].frames) <= 4
    t = diagnostics.StepTimer()
    for _ in range(3):
        with t.time("run"):
            pass
    assert t.summary()["run"]["n"] == 3


def test_player_fills_its_ladder():
    p, _ = make_player("torch")
    p.ladder = diagnostics.FrameLadder()
    p.start()
    for i in range(3):
        show(p, i)
    # the player marks loaded, applied and displayed (no conversion stage)
    assert set(p.ladder.stats()) == {"queued->loaded", "applied->displayed",
                                     "total"}
    assert len(p.ladder.frames) == 3


@pytest.mark.parametrize("load", [0.5, 1.0, 2.0])
def test_effort_ladder_matches_jax(load):
    """Frame times over the budget climb the effort ladder (resize method,
    letterbox, precache paused), times well under it climb down: the same
    steps as the JAX player."""
    seen = {}
    for pkg in PKGS:
        p, _ = make_player(pkg)
        p.precache_depth = 3
        p.sink_spec = (JSinkSpec if pkg == "jax" else SinkSpec)(
            letterbox=True)
        steps = []
        for k in range(6):
            p._frame_times.append(load / 25.0 if k < 4 else 0.001)
            p._update_effort()
            steps.append((p.effort, p.sink_spec.method,
                          p.sink_spec.letterbox, p.precache_depth))
        seen[pkg] = steps
    assert seen["torch"] == seen["jax"]


# -- phase 16 of chip_smoke.py at 64x36 ---------------------------------------

def _phase16(monkeypatch, tmp_path, pkg):
    """Phase 16's pass A (chip_smoke.perform on its ScriptedClock) at 64x36
    into a CollectSink; the Y4M clips written by chip_smoke.write_clips.
    Returns (shown RGB frames, the take, the re-rendered RGB frames)."""
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 36)
    clip_dir = tmp_path / "clips"
    if not clip_dir.exists():
        clip_dir.mkdir()
        cs.write_clips(str(clip_dir), DeviceSyntheticSource(36, 64,
                                                            device="cpu"),
                       2, cs.PLAYER_CLIP_FRAMES)
    clips = []
    for c in (1, 2):
        path = str(clip_dir / f"clip{c}.y4m")
        clip = j_open_clip(path, tmp_path / "jw") if pkg == "jax" \
            else open_clip(path, tmp_path / "tw")
        clip.unique_id = c
        if pkg == "jax":
            # plain file reads: the native prefetch cache's seek path
            # waits seconds on a nervous jump
            clip.cdata.decoder._cache = None
        clips.append(clip)
    clock = scripted(monkeypatch, pkg)
    sink = JCollectSink() if pkg == "jax" else CollectSink()
    p = JPlayer(sink=sink, fps=cs.FPS) if pkg == "jax" else \
        Player(sink=sink, fps=cs.FPS, device="cpu")
    p.async_compile = False
    p.drop_on_miss = False
    cs.player_setup(p, clips, cs.FPS, cs.PLAYER_EVERY)
    p._frame0 += 0.5
    cs.perform(p, clips, cs.FPS, cs.PLAYER_CYCLES, cs.PLAYER_EVERY,
               clock=clock)
    el = p.record_stop()
    p.stop()
    frames, _ = p.render_last_recording(p.recording_uid_map(clips),
                                        batch_size=32)
    for c in clips:
        c.close()
    return [np.asarray(f) for f in sink.frames], el, np.asarray(frames)


def _yuv(frames):
    return [convert_layer(Layer(planes=(torch.from_numpy(np.array(f)),)),
                          Palette.YUV420P).planes for f in frames]


def test_jax_player_vs_its_rerender(monkeypatch, tmp_path):
    """Phase 16's performance at 64x36 on both packages' players: the JAX
    player against its own re-render is 1 LSB apart over the Y, U and V
    planes (chip_smoke.PLAYER_RERENDER_BOUND, which phase 16 holds the
    port's player on the card to, plus 1 LSB); the port's player here is as
    close to its own re-render, shows the JAX player's frames within
    1 LSB and records the same events."""
    jshown, jel, jrend = _phase16(monkeypatch, tmp_path, "jax")
    tshown, tel, trend = _phase16(monkeypatch, tmp_path, "torch")
    assert len(jshown) == len(tshown) == cs.PLAYER_CYCLES
    idx = cs.rerender_index(jel, cs.FPS)
    assert idx == cs.rerender_index(tel, cs.FPS)
    jax_gap = cs.yuv_gap(_yuv(jshown), _yuv(jrend), idx)
    assert jax_gap == cs.PLAYER_RERENDER_BOUND == 1
    assert cs.yuv_gap(_yuv(tshown), _yuv(trend), idx) <= jax_gap + 1
    same_frames(jshown, tshown)
    same_events(jel, tel)
    inits = {e.props["filter"] for e in tel.events
             if e.type == EventType.FILTER_INIT}
    assert inits == {"gaussian_blur", "colour_balance", "vignette",
                     "crossfade"}


def test_player_script_keeps_key_order():
    """Phase 16's script turns a key on only above every key that is on
    (so the live chain's key order is the recorded filter map's), and its
    autotransition overlaps key releases only."""
    for cycles, every in ((cs.PLAYER_CYCLES, cs.PLAYER_EVERY), (96, 10)):
        acts = cs.player_script(cycles, every)
        on = {0}
        trans = range(round(2.88 * every), round(2.88 * every)
                      + round(1.2 * every) + 1)
        toggles = 0
        for c in sorted(acts):
            for act in acts[c]:
                if act[0] != "toggle":
                    continue
                k = act[1]
                toggles += 1
                if k in on:
                    on.remove(k)
                else:
                    assert all(j < k for j in on), (c, k, on)
                    assert c not in trans, (c, k)
                    on.add(k)
        assert toggles == 9


@pytest.mark.parametrize("fps", [30.0, 25.0])
def test_rerender_index_follows_the_grid(fps):
    """FRAME events recorded on a clock that steps 1/fps land each on its
    own slot of the re-render's grid (quantise), a skipped cycle leaving a
    held slot."""
    from lives_tpu_torch.events.event_list import frame_event
    el = EventList(fps=fps)
    cycles = [0, 1, 2, 4, 5, 9, 10, 11]
    for k in cycles:
        el.insert(frame_event(int(k / fps * 100_000_000), [1], [k]))
    idx = cs.rerender_index(el, fps)
    assert idx == cycles
    q = el.quantise(fps)
    frames = [e.frames[0] for e in q.frame_events()]
    assert [frames[g] for g in idx] == cycles
