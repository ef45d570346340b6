"""cconx (alpha-channel data connections) through the port's
`FrameGraph`, renderer and player, and the two wired compounds, against
lives_tpu.

Covers `FrameGraph(cconx=)` (validation, the plan key, `run` and
`run_batch` against the JAX graph, tests/test_cconx.py:200-270), the
routes (a cconx graph takes none of the kernels' routes), the renderer
re-applying recorded cconx props, the player's live wired session with
its recording and re-render (tests/test_cconx.py:301-360) on both
packages, and image_stabilizer and neural_net
(tests/test_dataplugins.py:283-316).

Tolerances: frames +/-1 LSB (the JAX chains run in float32,
LIVES_TPU_CHAIN_DTYPE=f32); recorded events and their `cconx` props
equal; re-renders bit for bit deterministic; compound out-values and
states within 1e-5."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects import data as jd
from lives_tpu.effects.host import instantiate as j_inst
from lives_tpu.events import EventList as JEventList
from lives_tpu.events.event_list import filter_init_event as j_init_event
from lives_tpu.events.event_list import filter_map_event as j_map_event
from lives_tpu.events.event_list import frame_event as j_frame_event
from lives_tpu.events.renderer import render_recording as j_render_recording
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.graph.nodemodel import SinkSpec as JSink
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects import data as td
from lives_tpu_torch.effects.host import instantiate as t_inst
from lives_tpu_torch.events import EventList
from lives_tpu_torch.events.event_list import EventType
from lives_tpu_torch.events.renderer import render_recording
from lives_tpu_torch.graph import nodemodel
from lives_tpu_torch.graph.nodemodel import FrameGraph as TGraph
from lives_tpu_torch.graph.nodemodel import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.scenes import DeviceSyntheticSource
from test_torch_alpha import close, jax_step, port_step, same_state
from test_torch_player import (MemClip, make_player, run_both, same_frames,
                               show, within_1)

H, W = 48, 128
EDGE = [(0, "mask", 1, 0)]


@pytest.fixture(autouse=True)
def f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")


def _frames(n, seed=42, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, h, w),
                                                np.uint8)


def _chain(pkg, first="motion_mask", **vals):
    inst = j_inst if pkg == "jax" else t_inst
    src = inst(first, **vals)
    mo = inst("mask_overlay")
    mo.in_tracks = (0, 0)
    return [src, mo]


# -- FrameGraph(cconx=) -------------------------------------------------------

@pytest.mark.parametrize("edge,err", [
    ((1, "mask", 0, 0), ValueError),        # backward
    ((0, "nope", 1, 0), KeyError),          # no such out-channel
    ((0, "mask", 1, 2), IndexError)])       # no such slot
def test_framegraph_validates_edges_as_jax(edge, err):
    for graph, pkg in ((JGraph, "jax"), (TGraph, "torch")):
        chain = _chain(pkg)
        if edge[0] == 1:
            chain = chain[::-1]
        with pytest.raises(err):
            graph(chain, cconx=[edge])


@pytest.mark.parametrize("first,vals", [
    ("motion_mask", {"threshold": 0.02}),
    ("fg_bg_removal", {"threshold": 0.3}),
    ("farneback_analyser", {})])
def test_framegraph_run_matches_jax(first, vals):
    """`run` frame by frame with the channel wired in the graph, one plan
    for every frame, against the JAX graph's jitted template."""
    fr = _frames(4)
    edge = [(0, "flow_x" if first == "farneback_analyser" else "mask", 1,
             0)]
    jg = JGraph(_chain("jax", first, **vals), JSink(), cconx=edge)
    tg = TGraph(_chain("torch", first, **vals), TSink(), cconx=edge)
    for i, f in enumerate(fr):
        ref = jg.run([JLayer(planes=(jnp.asarray(f),), palette=4)],
                     tc=i / 25.0, frame=i)
        got = tg.run([TLayer(planes=(torch.from_numpy(f),),
                             palette=int(Palette.RGB24))], tc=i / 25.0,
                     frame=i)
        within_1(got.planes[0].numpy(), ref.planes[0])
    assert len(tg.stats) == 1 and len(jg.stats) == 1
    assert tg.cconx == tuple(map(tuple, edge))
    # the wiring engaged: without it the chain renders something else
    plain = TGraph(_chain("torch", first, **vals), TSink())
    outs = [plain.run([TLayer(planes=(torch.from_numpy(f),),
                              palette=int(Palette.RGB24))], frame=i)
            for i, f in enumerate(fr)]
    assert not np.array_equal(outs[-1].planes[0].numpy(),
                              got.planes[0].numpy())


def test_run_batch_cconx_matches_jax_and_run():
    """run_batch (the frame loop over the whole chain) equals run frame by
    frame and the JAX scan path, states carried across two chunks."""
    fr = _frames(6)
    tcs = np.arange(6, dtype=np.float32) / 25.0
    jg = JGraph(_chain("jax", threshold=0.02), JSink(), cconx=EDGE)
    tg = TGraph(_chain("torch", threshold=0.02), TSink(), cconx=EDGE)
    got, ref = [], []
    for lo, hi in ((0, 4), (4, 6)):
        ref.append(np.asarray(jg.run_batch(
            [JLayer(planes=(jnp.asarray(fr[lo:hi]),), palette=4)],
            tcs[lo:hi], np.arange(lo, hi, dtype=np.int32)).planes[0]))
        got.append(tg.run_batch(
            [TLayer(planes=(torch.from_numpy(fr[lo:hi]),),
                    palette=int(Palette.RGB24))],
            tcs[lo:hi], np.arange(lo, hi)).planes[0].numpy())
    within_1(np.concatenate(got), np.concatenate(ref))
    seq = TGraph(_chain("torch", threshold=0.02), TSink(), cconx=EDGE)
    one = np.stack([seq.run([TLayer(planes=(torch.from_numpy(f),),
                                    palette=int(Palette.RGB24))],
                            tc=float(tcs[i]), frame=i).planes[0].numpy()
                    for i, f in enumerate(fr)])
    within_1(np.concatenate(got), one)


def test_cconx_keys_the_plan_and_keeps_the_kernels_off(monkeypatch):
    """The wiring joins every plan key; a cconx graph takes none of the
    kernels' routes (`nodemodel.py:436,488`): no fused sweep over a
    traceable source, no composite prefix, no prefix/suffix sweeps or
    fused stateful sweep around the frame loop."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "1")
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "1")
    monkeypatch.setenv("LIVES_TPU_FUSED_STATEFUL", "1")
    chain = [t_inst("fg_bg_removal"), t_inst("mask_overlay"),
             t_inst("saturation"), t_inst("vignette")]
    chain[1].in_tracks = (0, 0)
    g = TGraph(chain, TSink(), cconx=EDGE)
    plain = TGraph(chain, TSink())
    assert g._route(2) == (0, 0, False)
    assert plain._route(2) != (0, 0, False)
    u8 = [TLayer(planes=(torch.zeros((2, 3, 8, 16), dtype=torch.uint8),),
                 palette=int(Palette.RGB24))]
    stateless = [t_inst("crossfade"), t_inst("blend_add"),
                 t_inst("blend_screen"), t_inst("alpha_means")]
    for i in stateless[:3]:
        i.in_tracks = (0, 1)
    assert TGraph(stateless, TSink())._composite_len(u8 * 2) == 3
    wired = TGraph([t_inst("motion_mask")] + stateless, TSink(),
                   cconx=[(0, "mask", 4, 0)])
    assert wired._composite_len(u8 * 2) == 0
    # over a traceable source: the frame loop, every op in plain torch
    src = DeviceSyntheticSource(16, 32, device="cpu")
    ids = (np.ones((1, 3), np.int64), np.arange(3)[None])
    before = set(nodemodel._PLANS)
    g.run_batch([], np.zeros(3, np.float32), np.arange(3), source=src,
                src_args=ids)
    new = [nodemodel._PLANS[k] for k in set(nodemodel._PLANS) - before]
    assert len(new) == 1 and new[0] == nodemodel.StatefulRoute()
    key = next(iter(set(nodemodel._PLANS) - before))
    assert tuple(map(tuple, EDGE)) in key


# -- the renderer -------------------------------------------------------------

def _wired_timeline(pkg, n=6):
    from lives_tpu_torch.events.event_list import (filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    mk = (j_init_event, j_map_event, j_frame_event) if pkg == "jax" else \
        (filter_init_event, filter_map_event, frame_event)
    el = (JEventList if pkg == "jax" else EventList)(fps=25.0, width=48,
                                                     height=24)
    mm = mk[0](0, "motion_mask", values={"threshold": 0.02})
    mo = mk[0](0, "mask_overlay", in_tracks=[0, 0], out_tracks=[0])
    mo.props["cconx"] = [[mm.event_id, "mask", 0]]
    for e in (mm, mo):
        el.insert(e)
    el.insert(mk[1](0, [mm.event_id, mo.event_id]))
    for i in range(n):
        el.insert(mk[2](i * 4_000_000, [1], [i]))
    return el


def test_renderer_reapplies_recorded_cconx():
    """A recorded destination's `cconx` props become the segment graph's
    wiring: the render equals the JAX package's, is deterministic, and
    differs from the same list without the props."""
    el = _wired_timeline("torch")
    clips = {1: MemClip("torch")}
    f1, t1 = render_recording(el, clips, fps=25.0, batch_size=4,
                              device="cpu")
    f2, _ = render_recording(EventList.from_json(el.to_json()), clips,
                             fps=25.0, batch_size=4, device="cpu")
    np.testing.assert_array_equal(f1, f2)
    jf, jt = j_render_recording(_wired_timeline("jax"),
                                {1: MemClip("jax")}, fps=25.0, batch_size=4)
    assert jt == t1
    same_frames(list(np.asarray(jf)), list(f1))
    for e in el.events:
        e.props.pop("cconx", None)
    f3, _ = render_recording(el, clips, fps=25.0, batch_size=4,
                             device="cpu")
    assert not np.array_equal(f1, f3)


# -- the player: a live wired session, recorded and re-rendered ---------------

def _canon_cconx(el):
    """Each init's `cconx` props with event ids as positions."""
    pos = {e.event_id: k for k, e in enumerate(el.events)}
    return [(pos[e.event_id], [[pos[s], n, slot] for s, n, slot in
                               e.props["cconx"]])
            for e in el.events if e.props.get("cconx")]


def _session(p, sink, clock, pkg, wire=True, record=True, n=8):
    d = jd if pkg == "jax" else td
    p.keymap.set_key(0, 0, "motion_mask")
    p.keymap.set_key(1, 0, "mask_overlay")
    p.keymap.set_key(2, 0, "alpha_means")
    p.keymap.set_key(3, 0, "vignette")
    for k in range(4):
        p.key_toggle(k, True)
    p.keymap.instances[1].in_tracks = (0, 0)
    if wire:
        dc = d.DataConnections()
        i = p.keymap.instances
        dc.add_channel(i[0], "mask", i[1], 0)
        dc.add_channel(i[0], "mask", i[2], 0)
        dc.add(i[2], "mean_r", i[3], "amount", autoscale=True)
        p.datacons = dc
    if record:
        p.record_start(width=48, height=24)
    p.start()
    for i in range(n):
        clock.now = i / 25.0
        show(p, i, clock)
    return p.record_stop() if record else None


def test_player_live_cconx_matches_jax(monkeypatch):
    res = run_both(monkeypatch, _session)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
    p = res["torch"][0]
    assert p._cconx_sig() == ((0, "mask", 1, 0), (0, "mask", 2, 0))
    plain = run_both(monkeypatch, lambda *a: _session(*a, wire=False))
    assert not np.array_equal(plain["torch"][1].frames[-1],
                              res["torch"][1].frames[-1])


def test_player_cconx_recorded_and_rerenders(monkeypatch):
    res = run_both(monkeypatch, _session)
    el, jel = res["torch"][2], res["jax"][2]
    inits = [e for e in el.events if e.type == EventType.FILTER_INIT]
    src = next(e for e in inits if e.props["filter"] == "motion_mask")
    for name in ("mask_overlay", "alpha_means"):
        dst = next(e for e in inits if e.props["filter"] == name)
        assert dst.props["cconx"] == [[src.event_id, "mask", 0]]
    assert _canon_cconx(el) == _canon_cconx(jel)
    assert json.loads(el.to_json())["events"] is not None
    clips = {1: MemClip("torch")}
    f1, t1 = render_recording(el, clips, fps=25.0, batch_size=4,
                              device="cpu")
    f2, t2 = render_recording(el, clips, fps=25.0, batch_size=4,
                              device="cpu")
    assert t1 == t2
    np.testing.assert_array_equal(f1, f2)
    f3, _ = render_recording(EventList.from_json(el.to_json()), clips,
                             fps=25.0, batch_size=4, device="cpu")
    np.testing.assert_array_equal(f1, f3)
    jf, jt = j_render_recording(jel, {1: MemClip("jax")}, fps=25.0,
                                batch_size=4)
    assert jt == t1
    same_frames(list(np.asarray(jf)), list(f1))
    for e in el.events:
        e.props.pop("cconx", None)
    f4, _ = render_recording(el, clips, fps=25.0, batch_size=4,
                             device="cpu")
    assert not all(np.array_equal(x, y) for x, y in zip(f1, f4))


def test_player_cconx_edit_is_a_new_graph(monkeypatch):
    """A channel connection made or dropped mid-session changes the graph
    cache key, and the next frame serves the new wiring."""
    def script(p, sink, clock, pkg):
        _session(p, sink, clock, pkg, wire=False, record=False, n=2)
        key0 = p._chain_cache_key()
        d = jd if pkg == "jax" else td
        dc = d.DataConnections()
        c = dc.add_channel(p.keymap.instances[0], "mask",
                           p.keymap.instances[1], 0)
        p.datacons = dc
        assert p._chain_cache_key() != key0
        clock.now = 2 / 25.0
        show(p, 2, clock)
        dc.remove(c)
        assert p._chain_cache_key() == key0
        clock.now = 3 / 25.0
        show(p, 3, clock)
        return len(p._graphs)
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2] == 2
    same_frames(res["jax"][1].frames, res["torch"][1].frames)


def test_player_pconx_pushes_device_values(monkeypatch):
    """The player pushes connected out-values into the active chain before
    each run, on their device (JAX player.py:1442-1444)."""
    clock = __import__("chip_smoke").ScriptedClock()
    monkeypatch.setattr(__import__("lives_tpu_torch.player.player",
                                   fromlist=["x"]), "time", clock)
    p, sink = make_player("torch")
    p.async_compile = False
    p.keymap.set_key(0, 0, "alpha_means")
    p.keymap.set_key(1, 0, "vignette")
    p.key_toggle(0, True)
    p.key_toggle(1, True)
    dc = td.DataConnections()
    dc.add(p.keymap.instances[0], "mean_r", p.keymap.instances[1],
           "amount", autoscale=True)
    p.datacons = dc
    p.keymap.instances[0].out_values = {"mean_r": torch.tensor([0.25])}
    p.start()
    show(p, 0, clock)
    assert p.keymap.instances[1].values["amount"].tolist() == [0.25]
    p.stop()


# -- the wired compounds ------------------------------------------------------

def test_compounds_registered_as_jax():
    from lives_tpu.effects.host import get_filter as j_get
    from lives_tpu_torch.effects.host import DEFERRED, get_filter as t_get
    for name in ("image_stabilizer", "neural_net"):
        jf, tf = j_get(name), t_get(name)
        assert (tf.hashname, tf.flags, tf.description) == \
            (jf.hashname, jf.flags, jf.description)
        assert [(p.name, p.kind, p.default, p.min, p.max)
                for p in tf.params] == [(p.name, p.kind, p.default, p.min,
                                         p.max) for p in jf.params]
        assert [p.name for p in tf.out_params] == \
            [p.name for p in jf.out_params]
        assert name not in DEFERRED


def _square(x, h=64, w=128):
    a = np.zeros((3, h, w), np.uint8)
    a[:, 24:40, x:x + 16] = 255
    return a


def test_image_stabilizer_matches_jax():
    """A square moving 8 px a frame: frames +/-1 LSB, the analyser's and
    integrator's states within 1e-5, and the counter-shift steadies the
    output as the JAX test asks (tests/test_dataplugins.py:283-307)."""
    xs = list(range(20, 68, 8))
    ins = [np.stack([_square(x) for x in xs])]
    vals = {"strength": np.ones(len(xs), np.float32)}
    t_state = j_state = None
    prev = raw_prev = None
    d_stab, d_raw = [], []
    for b in range(len(xs)):
        got, inst = port_step("image_stabilizer", ins, vals,
                              slice(b, b + 1), [b], [b / 25.0],
                              state=t_state)
        t_state = inst.state
        ref, j_state, _, _ = jax_step("image_stabilizer", ins, vals, b, b,
                                      b / 25.0, state=j_state)
        within_1(got[0], ref)
        same_state(t_state, j_state)
        out, raw = got[0].astype(int), ins[0][b].astype(int)
        if prev is not None and b >= 3:
            d_stab.append(np.abs(out - prev).mean())
            d_raw.append(np.abs(raw - raw_prev).mean())
        prev, raw_prev = out, raw
    assert np.mean(d_stab) < np.mean(d_raw) * 0.8


def test_neural_net_matches_jax():
    ins = [np.random.default_rng(60).integers(0, 256, (4, 3, 24, 40),
                                              np.uint8)]
    vals = {k: np.random.default_rng(61).uniform(-1, 1, 4).astype(
        np.float32) for k in "abcd"}
    vals["fitness"] = np.array([1.0, 0.5, 0.0, 0.9], np.float32)
    t_state = j_state = None
    for b in range(4):
        got, inst = port_step("neural_net", ins, vals, slice(b, b + 1),
                              [b], [0.0], state=t_state)
        t_state = inst.state
        ref, j_state, ov, _ = jax_step("neural_net", ins, vals, b, b, 0.0,
                                       state=j_state)
        np.testing.assert_array_equal(got[0], ref)
        assert set(inst.out_values) == set(ov) and len(ov) == 8
        for k, v in ov.items():
            close(inst.out_values[k].numpy(), v)
            assert 0.0 <= float(v) <= 1.0
        same_state(t_state, j_state)


# -- phase 20c's performance at a small size ----------------------------------

#: phase 20c's script, shortened: the reversed and the nervous spans
#: fall inside 48 cycles at a period of 5
CYCLES, EVERY = 48, 5


def _phase20c(monkeypatch, tmp_path, pkg):
    """chip_smoke's phase 20c at 64x36 on one package's player (scripted
    clock, the connections through datacons.map) into a CollectSink:
    (shown RGB frames, the take, the re-rendered RGB frames, the map's
    bytes)."""
    import chip_smoke as cs
    from lives_tpu.io.clips import open_clip as j_open_clip
    from lives_tpu.player import CollectSink as JCollectSink
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.player import CollectSink, Player
    from test_torch_player import scripted
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
            clip.cdata.decoder._cache = None
        clips.append(clip)
    clock = scripted(monkeypatch, pkg)
    sink = JCollectSink() if pkg == "jax" else CollectSink()
    p = JPlayer(sink=sink, fps=cs.FPS) if pkg == "jax" else \
        Player(sink=sink, fps=cs.FPS, device="cpu")
    p.async_compile = False
    p.drop_on_miss = False
    map_path = tmp_path / f"{pkg}.map"
    cs.data_setup(p, clips, map_path, data=jd if pkg == "jax" else td)
    p._frame0 += 0.5
    cs.perform(p, clips, cs.FPS, CYCLES, EVERY, clock=clock,
               script=cs.data_script)
    el = p.record_stop()
    p.stop()
    frames, _ = p.render_last_recording(p.recording_uid_map(clips),
                                        batch_size=32)
    for c in clips:
        c.close()
    return ([np.asarray(f) for f in sink.frames], el, np.asarray(frames),
            map_path.read_bytes())


def test_phase20c_performance_matches_jax(monkeypatch, tmp_path):
    """Phase 20c at 64x36: the port's wired player shows the JAX player's
    frames within 1 LSB, records the same events and the same `cconx`
    props, writes the same datacons.map, and re-renders within
    chip_smoke.PLAYER_RERENDER_BOUND of what it showed, as the JAX player
    does."""
    import chip_smoke as cs
    from test_torch_player import _yuv, same_events
    jshown, jel, jrend, jmap = _phase20c(monkeypatch, tmp_path, "jax")
    tshown, tel, trend, tmap = _phase20c(monkeypatch, tmp_path, "torch")
    assert tmap == jmap
    assert len(jshown) == len(tshown) == CYCLES
    same_frames(jshown, tshown)
    assert _canon_cconx(tel) == _canon_cconx(jel) and _canon_cconx(tel)
    bare = []
    for el in (jel, tel):   # the events but for the ids inside cconx
        el = type(el).from_json(el.to_json())
        for e in el.events:
            e.props.pop("cconx", None)
        bare.append(el)
    same_events(*bare)
    idx = cs.rerender_index(tel, cs.FPS)
    assert idx == cs.rerender_index(jel, cs.FPS)
    jax_gap = cs.yuv_gap(_yuv(jshown), _yuv(jrend), idx)
    assert jax_gap <= cs.PLAYER_RERENDER_BOUND
    assert cs.yuv_gap(_yuv(tshown), _yuv(trend), idx) <= \
        cs.PLAYER_RERENDER_BOUND


def test_player_pconx_from_a_graph_analyser_is_inert_as_jax(monkeypatch):
    """An analyser inside the served graph reports into the graph's own
    per-run instances in both players, so its keymap instance holds no
    out-value and a pconx from it pushes nothing (ROADMAP Queue 3)."""
    def script(p, sink, clock, pkg):
        d = jd if pkg == "jax" else td
        p.keymap.set_key(0, 0, "alpha_means")
        p.keymap.set_key(1, 0, "vignette")
        p.key_toggle(0, True)
        p.key_toggle(1, True)
        dc = d.DataConnections()
        dc.add(p.keymap.instances[0], "mean_r", p.keymap.instances[1],
               "amount", autoscale=True)
        p.datacons = dc
        p.start()
        for i in range(3):
            clock.now = i / 25.0
            show(p, i, clock)
        return (dict(p.keymap.instances[0].out_values),
                dict(p.keymap.instances[1].values))
    res = run_both(monkeypatch, script)
    assert res["torch"][2] == res["jax"][2] == ({}, {})
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
