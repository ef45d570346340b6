"""The slice of text and titles as a whole, lives_tpu_torch against
lives_tpu: chip_smoke's phase-18b chain (the titled edit) through both
packages' `FrameGraph.run_batch` on the composite route, and phase 18c's
performance (the reference keymap's text keys on the player, recorded and
re-rendered) at 64x36 on both players.

Tolerances: frames +/-1 LSB; each player's re-render within
`PLAYER_RERENDER_BOUND` (+1 for the port, the bound phase 18c holds on the
card)."""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.effects.host import instantiate as t_instantiate
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer


def test_titled_edit_chain_matches_jax(monkeypatch):
    """chip_smoke's titled-edit chain over five u8 tracks at 256x32 (the
    JAX composite kernel's tile rule), under LIVES_TPU_PALLAS_COMPOSITE=1
    on both sides: the composite takes the three transitions (the JAX
    kernel in interpret mode), the eager tail push, deinterlace,
    photo_censor, scribbler, toonz_paraffin, saturation and vignette;
    +/-1 LSB."""
    from jax.experimental.pallas import tpu as pltpu
    import lives_tpu.graph.pallas_composite as jpc
    from lives_tpu_torch.graph import composite, nodemodel
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "1")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    monkeypatch.setattr(jpc, "supported", lambda h, w: True)
    h, w, n = 32, 256, 4
    rng = np.random.default_rng(18)
    tracks = [rng.integers(0, 256, (n, 3, h, w), np.uint8) for _ in range(5)]
    tcs = np.arange(n, dtype=np.float32) / 30.0
    fr = np.arange(n, dtype=np.int32)

    def chain(make):
        out = []
        for name, vals, tr in cs.TITLED_CHAIN:
            inst = make(name, **vals)
            inst.in_tracks = tuple(tr)
            out.append(inst)
        return out
    params = [{p.name: np.full(n, vals.get(p.name, p.default), np.float32)
               for p in t_get_filter(name).params if p.kind == "num"}
              for name, vals, _ in cs.TITLED_CHAIN]
    params[cs.TITLED_ANIMATE]["amount"] = np.linspace(0, 1, n,
                                                      dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = JGraph(chain(j_instantiate), JSink(), fps=30.0).run_batch(
            [JLayer(planes=(jnp.asarray(t),), palette=int(JPalette.RGB24))
             for t in tracks], tcs, fr, params)
    nodemodel._PLANS.clear()
    g = TGraph(chain(t_instantiate), TSink(), fps=30.0)
    lays = [TLayer(planes=(torch.from_numpy(t),), palette=int(Palette.RGB24))
            for t in tracks]
    assert g._composite_len(lays) == 3
    got = g.run_batch(lays, tcs, fr, params)
    (plan,) = nodemodel._PLANS.values()
    assert isinstance(plan, composite.CompositePlan)
    d = np.abs(got.planes[0].numpy().astype(int)
               - np.asarray(ref.planes[0]).astype(int))
    assert d.max() <= 1, d.max()


# -- phase 18c's player at 64x36 ------------------------------------------------

def test_titles_keymap_maps_as_jax(tmp_path):
    """Phase 18c's reference-format keymap: every line maps, to the filter
    the JAX KeyMap maps it to (puretext's fragment to livetext)."""
    from lives_tpu.player import KeyMap as JKeyMap
    from lives_tpu_torch.player import KeyMap
    path = tmp_path / "titles.keymap"
    cs.write_titles_keymap(path)
    km, jkm = KeyMap(), JKeyMap()
    assert km.load_reference_keymap(path) == \
        jkm.load_reference_keymap(path) == len(cs.TITLES_KEYMAP)
    for k, _, name in cs.TITLES_KEYMAP:
        assert km.current_filter(k - 1) == jkm.current_filter(k - 1) == name


def test_titles_script_keeps_key_order():
    """Phase 18c's toggles play keys 0-2, turn a key on only above every
    key that is on, and release only inside the autotransition."""
    every = cs.PLAYER_EVERY
    acts = cs.titles_script(cs.PLAYER_CYCLES, every)
    t0 = round(2.88 * every)
    trans = range(t0, t0 + round(1.2 * every) + 1)
    on = set(cs.TITLES_ON_AT_START)
    played = set(on)
    for c in sorted(acts):
        for act in acts[c]:
            if act[0] != "toggle":
                continue
            k = act[1]
            if k in on:
                on.remove(k)
            else:
                assert all(j < k for j in on) and c not in trans, (c, k)
                on.add(k)
                played.add(k)
    assert played == {0, 1, 2}


#: phase 18c's first 120 cycles: the four toggles of keys 1 and 2 and the
#: fg switch's autotransition (its reverse and nervous spans come later)
TITLES_CYCLES = 120


def _phase18c(monkeypatch, tmp_path, pkg):
    """Phase 18c's performance on `pkg`'s player at 64x36 into a
    CollectSink: (shown RGB frames, the take, its re-rendered frames)."""
    from lives_tpu.io.clips import open_clip as j_open_clip
    from lives_tpu.player import CollectSink as JCollectSink
    from lives_tpu.player import Player as JPlayer
    from lives_tpu.player import player as j_player_mod
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.player import CollectSink, Player
    from lives_tpu_torch.player import player as t_player_mod
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 36)
    clip_dir = tmp_path / "clips"
    if not clip_dir.exists():
        clip_dir.mkdir()
        cs.write_clips(str(clip_dir), TSource(36, 64, device="cpu"), 2,
                       cs.PLAYER_CLIP_FRAMES)
        cs.write_titles_keymap(clip_dir / "titles.keymap")
    clips = []
    for c in (1, 2):
        path = str(clip_dir / f"clip{c}.y4m")
        clip = j_open_clip(path, tmp_path / "jw") if pkg == "jax" \
            else open_clip(path, tmp_path / "tw")
        clip.unique_id = c
        if pkg == "jax":
            clip.cdata.decoder._cache = None   # plain reads (nervous seeks)
        clips.append(clip)
    clock = cs.ScriptedClock()
    monkeypatch.setattr(j_player_mod if pkg == "jax" else t_player_mod,
                        "time", clock)
    sink = JCollectSink() if pkg == "jax" else CollectSink()
    p = JPlayer(sink=sink, fps=cs.FPS) if pkg == "jax" else \
        Player(sink=sink, fps=cs.FPS, device="cpu")
    p.async_compile = False
    p.drop_on_miss = False
    cs.titles_setup(p, clips, cs.FPS, cs.PLAYER_EVERY,
                    clip_dir / "titles.keymap")
    p._frame0 += 0.5
    cs.perform(p, clips, cs.FPS, TITLES_CYCLES, cs.PLAYER_EVERY,
               clock=clock, script=cs.titles_script)
    el = p.record_stop()
    p.stop()
    frames, _ = p.render_last_recording(p.recording_uid_map(clips),
                                        batch_size=32)
    for c in clips:
        c.close()
    return [np.asarray(f) for f in sink.frames], el, np.asarray(frames)


def test_titles_performance_matches_jax_player(monkeypatch, tmp_path):
    """Both players show the same frames (within 1 LSB) with livetext,
    scribbler and videowall keyed in and out over phase 18c's first 120
    cycles; each re-renders its take within PLAYER_RERENDER_BOUND (+1 for
    the port, phase 18c's bound)."""
    from test_torch_player import same_events, same_frames
    from test_torch_vj import _yuv
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    jshown, jel, jrend = _phase18c(monkeypatch, tmp_path, "jax")
    tshown, tel, trend = _phase18c(monkeypatch, tmp_path, "torch")
    assert len(jshown) == len(tshown) == TITLES_CYCLES
    same_frames(jshown, tshown)
    same_events(jel, tel)
    idx = cs.rerender_index(jel, cs.FPS)
    assert cs.yuv_gap(_yuv(jshown), _yuv(jrend), idx) <= \
        cs.PLAYER_RERENDER_BOUND
    assert cs.yuv_gap(_yuv(tshown), _yuv(trend), idx) <= \
        cs.PLAYER_RERENDER_BOUND + 1
    inits = {e.props["filter"] for e in tel.events
             if e.type.name == "FILTER_INIT"}
    assert {"scribbler", "videowall", "livetext"} <= inits


def test_text_chain_over_a_source_runs_run_chain(monkeypatch):
    """A stateless chain holding a text filter over a traceable source: no
    sweep plan in either package (scribbler is in neither op table), so
    the port generates the tracks and runs `run_chain`; frames +/-1 LSB of
    the JAX package's."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.graph import nodemodel
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    h, w, n = 32, 128, 4
    specs = [("crossfade", {"amount": 0.4}, (0, 1)),
             ("scribbler", {"text": "over a source", "size": 12, "mode": 2},
              (0,)),
             ("vignette", {"amount": 0.5}, (0,))]

    def chain(make):
        out = []
        for name, vals, tr in specs:
            inst = make(name, **vals)
            inst.in_tracks = tr
            out.append(inst)
        return out
    ids = np.stack([np.array([[1] * n, [2] * n]),
                    np.tile(np.arange(n), (2, 1))]).astype(np.int32)
    tcs = np.arange(n, dtype=np.float32) / 30.0
    fr = np.arange(n, dtype=np.int32)
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    ref = JGraph(chain(j_instantiate), JSink(w, h), fps=30.0).run_batch(
        [], tcs, fr, source=JSource(h, w), src_args=ids)
    nodemodel._PLANS.clear()
    before = nodemodel.PLAIN_CHUNKS
    got = TGraph(chain(t_instantiate), TSink(w, h), fps=30.0).run_batch(
        [], tcs, fr, source=TSource(h, w, device="cpu"), src_args=ids)
    assert nodemodel.PLAIN_CHUNKS == before + 1
    assert list(nodemodel._PLANS.values()) == [None]
    d = np.abs(got.planes[0].numpy().astype(int)
               - np.asarray(ref.planes[0]).astype(int))
    assert d.max() <= 1, d.max()
