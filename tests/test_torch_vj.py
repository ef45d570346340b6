"""The VJ filters of lives_tpu_torch against lives_tpu on the same seeded
inputs: the stateful EffecTV filters (blurzoom, onedtv, nervous, feedback,
vertigo) and the stateful compound vhs frame by frame, their states
carried between the packages both ways; `make_compound`'s exports,
extra params and connections; `FrameGraph.run_batch` of chip_smoke's
phase-17b chain against the JAX scan path; the reference keymap import;
and phase 17c's performance at 64x36 against the JAX `Player`.

Tolerances: frames +/-1 LSB (u8) or 1e-5 (f32), and exact where the
filter only copies stored frames (nervous); float32 states within 1e-5,
u8 and integer states exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.layer import Layer as JLayer
from lives_tpu.player import KeyMap as JKeyMap
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects import compound
from lives_tpu_torch.effects import host as t_host
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import (Filter, Instance, Param,
                                          apply_instance, instantiate)
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.graph import nodemodel
from lives_tpu_torch.graph.nodemodel import (StatefulRoute,
                                             states_from_numpy,
                                             states_to_numpy)
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.player import KeyMap
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
from test_torch_player import _yuv, same_events, same_frames, scripted
from test_torch_stateful import SCAN, _with_env

H, W, N = 24, 48, 6
STATEFUL = ["blurzoom", "onedtv", "nervous", "feedback", "vertigo", "vhs"]


def _np_state(st):
    """A JAX state as host numpy (dicts and tuples kept)."""
    if st is None:
        return None
    if isinstance(st, dict):
        return {k: _np_state(v) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(_np_state(v) for v in st)
    return np.asarray(st)


def _jnp_state(st):
    if st is None:
        return None
    if isinstance(st, dict):
        return {k: _jnp_state(v) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(_jnp_state(v) for v in st)
    return jnp.asarray(st)


def assert_state_equal(got, ref, ring_lsb=0, atol=1e-5):
    """Port state (host numpy, states_to_numpy) against a JAX one: float32
    within `atol`, integers exact, u8 within `ring_lsb` (a ring stores
    frames: exact for the filter alone, +/-1 LSB after a chain whose
    frames agree to 1 LSB)."""
    if ref is None:
        assert got is None
        return
    if isinstance(ref, (dict, tuple)):
        items = ref.items() if isinstance(ref, dict) else enumerate(ref)
        assert len(got) == len(ref)
        for k, r in items:
            assert_state_equal(got[k], r, ring_lsb, atol)
        return
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if ref.dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    elif ref.dtype == np.uint8:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= ring_lsb
    else:
        np.testing.assert_array_equal(got, ref)


def _seeded(name, rng):
    """A random JAX-contract state for `name` at (H, W)."""
    if name == "onedtv":
        return {"row": np.int32(5), "acc": rng.random((3, H, W), np.float32)}
    if name == "nervous":
        return {"ring": rng.integers(0, 256, (8, 3, H, W), dtype=np.uint8),
                "head": np.int32(6)}
    if name == "blurzoom":
        return rng.random((H, W), np.float32) * 3
    if name == "vhs":
        return ({"ring": rng.integers(0, 256, (16, 3, H, W), dtype=np.uint8),
                 "head": np.int32(11)}, None, None)
    return rng.random((3, H, W), np.float32)


@pytest.mark.parametrize("start", ["init", "seeded"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_filter_matches_jax_frame_by_frame(name, dtype, start):
    """Six frames, each package threading its own state over frames 0-2;
    at frame 3 each takes the other's state (states_to_numpy and
    states_from_numpy) and goes on: frames and states every frame."""
    rng = np.random.default_rng(sum(map(ord, name + dtype + start)))
    jf, tf = j_get_filter(name), t_host.get_filter(name)
    assert tf.hashname == jf.hashname and tf.flags == jf.flags
    assert [(p.name, p.kind, p.default, p.min, p.max) for p in tf.params] \
        == [(p.name, p.kind, p.default, p.min, p.max) for p in jf.params]
    frames = rng.random((N, 3, H, W), np.float32)
    if dtype == "u8":
        frames = np.floor(frames * 255.0 + 0.5).astype(np.uint8)
    pal = int(Palette.RGB24 if dtype == "u8" else Palette.RGBFLOAT)
    params = {p.name: rng.uniform(p.min, p.max, N).astype(np.float32)
              for p in jf.params}
    inst = Instance(filter=tf)
    if start == "seeded":
        jstate = _seeded(name, rng)
        inst.state = states_from_numpy([inst], [jstate], "cpu")[0]
        jstate = _jnp_state(jstate)
    else:
        jstate = jf.init_state(W, H, pal)
    for b in range(N):
        if b == 3:   # trade states
            theirs = _np_state(jstate)
            jstate = _jnp_state(states_to_numpy([inst.state])[0])
            inst.state = states_from_numpy([inst], [theirs], "cpu")[0]
        jout, jstate = jf.process(
            [JLayer(planes=(jnp.asarray(frames[b]),), palette=pal)],
            {k: jnp.asarray(v[b]) for k, v in params.items()},
            JContext(tc=jnp.float32(b / 25), frame=jnp.int32(b + 40),
                     fps=25.0, width=W, height=H), jstate)
        inst.values = {k: torch.from_numpy(v[b:b + 1])
                       for k, v in params.items()}
        tout = apply_instance(
            inst, [TLayer(planes=(torch.from_numpy(frames[b:b + 1]),),
                          palette=pal)],
            TContext(tc=torch.tensor([b / 25]), frame=torch.tensor([b + 40]),
                     fps=25.0, width=W, height=H))[0]
        got, ref = tout.planes[0][0].numpy(), np.asarray(jout.planes[0])
        if name == "nervous":
            np.testing.assert_array_equal(got, ref)
        elif dtype == "u8":
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert_state_equal(states_to_numpy([inst.state])[0],
                           _np_state(jstate))


def test_edge_and_blurzoom_wrap():
    """edge and blurzoom read their neighbours with roll, which wraps: a
    lone bright pixel in the last column lights the first column."""
    a = torch.zeros(1, 3, 8, 10)
    a[0, :, 3, 9] = 1.0
    lay = TLayer(planes=(a,), palette=int(Palette.RGBFLOAT))
    p = {"gain": 2.0, "amount": 1.0, "red": 1.0, "green": 1.0, "blue": 1.0}
    out = t_host.get_filter("edge").process([lay], p, TContext())
    assert float(out.planes[0][0, 0, 3, 0]) > 0
    inst = instantiate("blurzoom", amount=1.0)
    apply_instance(inst, [TLayer(planes=(a.clone(),),
                                 palette=int(Palette.RGBFLOAT))])
    assert float(inst.state.sum()) > 0


def test_registry_is_a_subset_of_jax():
    """142 of the JAX package's 147 filters (117 before data connections
    were ported), each with the JAX hashname, flags, params, out-params
    and alpha channel templates."""
    from lives_tpu.effects.host import list_filters as j_list_filters
    names = t_host.list_filters()
    assert len(names) == 142 and set(names) <= set(j_list_filters())
    for name in names:
        jf, tf = j_get_filter(name), t_host.get_filter(name)
        assert (tf.hashname, tf.flags) == (jf.hashname, jf.flags), name
        assert [p.name for p in tf.out_params] == \
            [p.name for p in jf.out_params], name
        for side in ("alpha_ins", "alpha_outs"):
            assert [(t.name, t.palettes, t.optional)
                    for t in getattr(tf, side)] == \
                [(t.name, tuple(int(p) for p in t.palettes), t.optional)
                 for t in getattr(jf, side)], (name, side)
        assert [(p.name, p.kind, p.default, p.min, p.max, p.choices)
                for p in tf.params] == [(p.name, p.kind, p.default, p.min,
                                         p.max, p.choices)
                                        for p in jf.params], name


# -- compounds ----------------------------------------------------------------

def test_compound_registry_matches_jax():
    """The six compounds as the JAX package registers them (image_stabilizer
    and neural_net, deferred until data connections were ported,
    included)."""
    for name in ("dream", "night_vision", "comic", "vhs", "image_stabilizer",
                 "neural_net"):
        jf, tf = j_get_filter(name), t_host.get_filter(name)
        assert (tf.hashname, tf.flags, tf.description) == \
            (jf.hashname, jf.flags, jf.description)
        assert [(p.name, p.kind, p.default, p.min, p.max)
                for p in tf.params] == [(p.name, p.kind, p.default, p.min,
                                         p.max) for p in jf.params]
    for name in ("image_stabilizer", "neural_net"):
        assert name in t_host.list_filters()
        assert name not in t_host.DEFERRED


@pytest.fixture
def scratch_registry(monkeypatch):
    """Filters a test registers vanish with it."""
    monkeypatch.setattr(t_host, "_REGISTRY", dict(t_host._REGISTRY))
    return t_host._REGISTRY


def _probe_filter():
    """A stateful filter that reports its frame's mean as an out-param."""
    def process(ins, p, ctx, state):
        a = ins[0].planes[0]
        n = 0 if state is None else state
        return ins[0], n + 1, {"level": a.float().mean() * p["gain"]}
    return Filter(name="probe", process=process, params=(
        Param("gain", "num", 1.0, 0.0, 4.0),), out_params=(
        Param("level", "num", 0.0, 0.0, 1.0),), flags=t_host.FILTER_STATEFUL)


def test_make_compound_exports_extra_params_and_connections(
        scratch_registry):
    """An exported sub-param and a compound-level extra param reach their
    steps; a connection carries the probe's out-param, through its
    transform, into the next step's param; the state is the steps'
    tuple and the final step's out-params are re-exported."""
    t_host.register_filter(_probe_filter())
    f = compound.make_compound(
        "probe_then_tint",
        [("probe", {"gain": compound.Export("probe_gain")}),
         ("tint", {"red": 1.0, "green": 0.0, "blue": 0.0}),
         ("probe", {})],
        connections=[(0, "level", 1, "amount",
                      lambda v, p, c: v * p["scale"])],
        extra_params=(Param("scale", "num", 1.0, 0.0, 2.0),))
    assert [p.name for p in f.params] == ["probe_gain", "scale"]
    assert [p.name for p in f.out_params] == ["level"]
    a = torch.full((1, 3, 4, 4), 0.5)
    inst = Instance(filter=f, values={"probe_gain": 2.0, "scale": 0.5})
    out = apply_instance(inst, [TLayer(planes=(a,),
                                       palette=int(Palette.RGBFLOAT))])
    # tint amount = mean 0.5 * gain 2 * scale 0.5 = 0.5: halfway to red
    ref = t_host.get_filter("tint").process(
        [TLayer(planes=(a,), palette=int(Palette.RGBFLOAT))],
        {"red": 1.0, "green": 0.0, "blue": 0.0, "amount": 0.5}, TContext())
    torch.testing.assert_close(out[0].planes[0], ref.planes[0])
    assert inst.state == (1, None, 1)
    assert set(inst.out_values) == {"level"}
    with pytest.raises(ValueError, match="feed forward"):
        compound.make_compound("bad", [("probe", {}), ("tint", {})],
                               connections=[(1, "level", 0, "gain")])
    with pytest.raises(ValueError, match="no out-param"):
        compound.make_compound("bad", [("tint", {}), ("probe", {})],
                               connections=[(0, "level", 1, "gain")])


def test_deferred_compound_raises_naming_its_item(monkeypatch):
    """A timeline naming image_stabilizer (deferred until data connections
    were ported) renders as the JAX package renders it; one naming a
    filter still deferred (a milkdrop preset) raises through the
    renderer's deferral lookup, naming its item."""
    from lives_tpu.events import renderer as jr
    from lives_tpu.events.event_list import EventList as JEventList
    from lives_tpu_torch.events import renderer as tr
    from lives_tpu_torch.events.event_list import (EventList,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")

    def timeline(name, n):
        el = EventList(fps=25.0, width=32, height=16)
        init = filter_init_event(0, name, values={"strength": 2.0}
                                 if name == "image_stabilizer" else {})
        el.insert(init)
        el.insert(filter_map_event(0, [init.event_id]))
        for i in range(n):
            el.insert(frame_event(i * 4_000_000, [1], [i]))
        return el
    el = timeline("image_stabilizer", 5)
    got, _ = tr.render_to_arrays(el, TSource(16, 32, device="cpu"),
                                 TSink(32, 16), batch_size=3)
    ref, _ = jr.render_to_arrays(JEventList.from_json(el.to_json()),
                                 JSource(16, 32), JSink(32, 16),
                                 batch_size=3)
    assert np.abs(got.astype(int) - np.asarray(ref).astype(int)).max() <= 1
    with pytest.raises(NotImplementedError, match="item 21"):
        list(tr.render_events(timeline("milk_spin", 1),
                              TSource(8, 16, device="cpu")))


# -- phase 17b's chain through run_batch --------------------------------------

VJ_H, VJ_W, VJ_B = 32, 128, 5
NERVOUS_AT = [f for f, _, _ in cs.CONFIGS["VJ"][1]].index("nervous")


def _vj_chain(make):
    n_tracks, specs = cs.CONFIGS["VJ"]
    out = []
    for name, vals, tracks in specs:
        inst = make(name, **vals)
        inst.in_tracks = tuple(tracks)
        out.append(inst)
    return out


def _vj_chunk(k):
    n_tracks = cs.CONFIGS["VJ"][0]
    ids = np.zeros((2, n_tracks, VJ_B), np.int32)
    for t in range(n_tracks):
        ids[0, t] = t + 1
    ids[1] = np.arange(VJ_B) + k * VJ_B
    fr = (np.arange(VJ_B) + k * VJ_B).astype(np.int32)
    return ids, fr.astype(np.float32) / 30.0, fr


def test_vj_chain_run_batch_matches_jax(monkeypatch):
    """The 9 transitions as K1's comp-out prefix, vertigo, blurzoom, nervous
    and feedback in the frame loop, saturation and vignette as the comp-in
    suffix (the route the JAX package picks), over two chunks with the
    state carried, against the JAX scan path; then a port graph seeded
    with the JAX graph's state after chunk 0."""
    def go():
        g = JGraph(_vj_chain(j_instantiate), JSink(VJ_W, VJ_H), fps=30.0)
        out = []
        for k in range(2):
            ids, tcs, fr = _vj_chunk(k)
            o = g.run_batch([], tcs, fr, source=JSource(VJ_H, VJ_W),
                            src_args=ids)
            out.append((np.asarray(o.planes[0]),
                        [_np_state(s) for s in g.states]))
        return out
    ref = _with_env(SCAN, go)
    monkeypatch.setenv("LIVES_TPU_FUSED_STATEFUL", "0")
    nodemodel._PLANS.clear()
    src = TSource(VJ_H, VJ_W, device="cpu")

    def chunk(g, k):
        ids, tcs, fr = _vj_chunk(k)
        return g.run_batch([], tcs, fr, source=src,
                           src_args=ids).planes[0].numpy()
    from lives_tpu.graph.pallas_composite import sweep_prefix_len
    from lives_tpu.graph.pallas_composite import sweep_suffix_len
    jchain = _vj_chain(j_instantiate)
    assert (sweep_prefix_len(jchain), sweep_suffix_len(jchain)) == (9, 2)
    g = TGraph(_vj_chain(instantiate), TSink(VJ_W, VJ_H), fps=30.0)
    assert g._route(10) == (9, 2, 0)
    for k in range(2):
        got = chunk(g, k)
        assert np.abs(got.astype(int) - ref[k][0].astype(int)).max() <= 1
        # nervous's ring holds frames that agree to 1 LSB; feedback, after
        # it, blends them into its float state: within 1/255 there
        for i, (st, r) in enumerate(zip(states_to_numpy(g.states),
                                        ref[k][1])):
            assert_state_equal(st, r, ring_lsb=1,
                               atol=1 / 255 if i > NERVOUS_AT else 1e-5)
    (route,) = [r for r in nodemodel._PLANS.values()
                if isinstance(r, StatefulRoute)]
    assert (route.npre, route.nsuf, route.sf) == (9, 2, None)
    g2 = TGraph(_vj_chain(instantiate), TSink(VJ_W, VJ_H), fps=30.0)
    g2.states = states_from_numpy(g2.chain, ref[0][1], "cpu")
    got = chunk(g2, 1)
    assert np.abs(got.astype(int) - ref[1][0].astype(int)).max() <= 1


# -- the reference keymap -----------------------------------------------------

def test_reference_keymap_every_fragment_maps_as_jax(tmp_path):
    """A keymap with a line for every fragment of REF_FILTER_MAP, loaded
    into both packages: the first fragment a hashname holds decides its
    line in both; the port's slot is the JAX one wherever the port
    registers that filter and empty where it does not; the count is the
    lines the port mapped. A reference blurzoom line maps to blurzoom, and
    the text and wall lines (puretext, textfun, scribbler, videowall) map
    in both packages: every line maps."""
    frags = list(KeyMap.REF_FILTER_MAP)
    assert frags == list(JKeyMap.REF_FILTER_MAP)
    path = tmp_path / "default.keymap"
    path.write_text("".join(f"{k + 1}|{f}\n" for k, f in enumerate(frags)))
    km, jkm = KeyMap(), JKeyMap()
    n = km.load_reference_keymap(path)
    jn = jkm.load_reference_keymap(path)
    have = set(t_host.list_filters())
    mapped = 0
    for k in range(len(frags)):
        want = jkm.current_filter(k)
        got = km.current_filter(k)
        if want in have:
            assert got == want, (frags[k], got, want)
            mapped += 1
        else:
            assert got == "", (frags[k], got)
    assert n == mapped and jn == len(frags)
    assert km.current_filter(frags.index("blurzoom")) == "blurzoom"
    for frag, name in (("puretext", "livetext"), ("textfun", "textfun"),
                       ("scribbler", "scribbler"),
                       ("videowall", "videowall")):
        k = frags.index(frag)
        assert km.current_filter(k) == jkm.current_filter(k) == name
    assert n == len(frags)


def test_vj_keymap_maps_every_line(tmp_path):
    """Phase 17c's keymap: each line to its filter, in both packages."""
    path = tmp_path / "vj.keymap"
    cs.write_vj_keymap(path)
    km, jkm = KeyMap(), JKeyMap()
    assert km.load_reference_keymap(path) == len(cs.VJ_KEYMAP)
    jkm.load_reference_keymap(path)
    for k, _, name in cs.VJ_KEYMAP:
        assert km.current_filter(k - 1) == jkm.current_filter(k - 1) == name


def test_vj_script_keeps_key_order():
    """Phase 17c's toggles play every played key, turn a key on only above
    every key that is on, release only inside the autotransition, and
    keep each stateful key on for one span between two toggles with no
    other change of the filter map inside it."""
    acts = cs.vj_script(cs.PLAYER_CYCLES, cs.PLAYER_EVERY)
    every = cs.PLAYER_EVERY
    t0 = round(2.88 * every)
    trans = range(t0, t0 + round(1.2 * every) + 1)
    on = set(cs.VJ_ON_AT_START)
    played, spans = set(on), {k: [0] for k in on}
    changes = [0, t0, t0 + round(1.2 * every)]
    for c in sorted(acts):
        for act in acts[c]:
            if act[0] != "toggle":
                continue
            k = act[1]
            changes.append(c)
            spans.setdefault(k, []).append(c)
            if k in on:
                on.remove(k)
            else:
                assert all(j < k for j in on) and c not in trans, (c, k)
                on.add(k)
                played.add(k)
    assert played == set(range(cs.VJ_PLAYED))
    for k in cs.VJ_STATEFUL_KEYS:
        (a, b) = spans[k]
        assert not [c for c in changes if a < c < b], (k, a, b)


# -- phase 17c at 64x36 -------------------------------------------------------

def _phase17c(monkeypatch, tmp_path, pkg):
    """Phase 17c's performance on `pkg`'s player at 64x36 into a
    CollectSink: (shown RGB frames, the take, its re-rendered frames,
    the mapped count)."""
    from lives_tpu.io.clips import open_clip as j_open_clip
    from lives_tpu.player import CollectSink as JCollectSink
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.player import CollectSink, Player
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 36)
    clip_dir = tmp_path / "clips"
    if not clip_dir.exists():
        clip_dir.mkdir()
        cs.write_clips(str(clip_dir), TSource(36, 64, device="cpu"), 2,
                       cs.PLAYER_CLIP_FRAMES)
        cs.write_vj_keymap(clip_dir / "vj.keymap")
    clips = []
    for c in (1, 2):
        path = str(clip_dir / f"clip{c}.y4m")
        clip = j_open_clip(path, tmp_path / "jw") if pkg == "jax" \
            else open_clip(path, tmp_path / "tw")
        clip.unique_id = c
        if pkg == "jax":
            clip.cdata.decoder._cache = None   # plain reads (nervous seeks)
        clips.append(clip)
    clock = scripted(monkeypatch, pkg)
    sink = JCollectSink() if pkg == "jax" else CollectSink()
    p = JPlayer(sink=sink, fps=cs.FPS) if pkg == "jax" else \
        Player(sink=sink, fps=cs.FPS, device="cpu")
    p.async_compile = False
    p.drop_on_miss = False
    n = cs.vj_setup(p, clips, cs.FPS, cs.PLAYER_EVERY,
                    clip_dir / "vj.keymap")
    p._frame0 += 0.5
    cs.perform(p, clips, cs.FPS, cs.PLAYER_CYCLES, cs.PLAYER_EVERY,
               clock=clock, script=cs.vj_script)
    el = p.record_stop()
    p.stop()
    frames, _ = p.render_last_recording(p.recording_uid_map(clips),
                                        batch_size=32)
    for c in clips:
        c.close()
    return [np.asarray(f) for f in sink.frames], el, np.asarray(frames), n


def test_vj_performance_matches_jax_player(monkeypatch, tmp_path):
    """Both players show the same frames (within 1 LSB) and record the same
    events; each re-renders its take within PLAYER_RERENDER_BOUND (+1 for
    the port, the bound phase 17c holds on the card)."""
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    jshown, jel, jrend, jn = _phase17c(monkeypatch, tmp_path, "jax")
    tshown, tel, trend, tn = _phase17c(monkeypatch, tmp_path, "torch")
    assert jn == tn == len(cs.VJ_KEYMAP)
    assert len(jshown) == len(tshown) == cs.PLAYER_CYCLES
    same_frames(jshown, tshown)
    same_events(jel, tel)
    idx = cs.rerender_index(jel, cs.FPS)
    jax_gap = cs.yuv_gap(_yuv(jshown), _yuv(jrend), idx)
    assert jax_gap <= cs.PLAYER_RERENDER_BOUND
    assert cs.yuv_gap(_yuv(tshown), _yuv(trend), idx) <= \
        cs.PLAYER_RERENDER_BOUND + 1
    inits = {e.props["filter"] for e in tel.events
             if e.type.name == "FILTER_INIT"}
    assert inits == {name for _, _, name in cs.VJ_KEYMAP[:cs.VJ_PLAYED]} \
        | {"crossfade"}
