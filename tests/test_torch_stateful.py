"""Stateful-chain rendering of lives_tpu_torch against lives_tpu.

The EffecTV filters frame by frame, the route rules, `FrameGraph.run_batch`
over two chunks (the 3-phase route and the fused stateful sweep's route)
and `render_events`, each on the same seeded inputs as the JAX package.
The reference is the JAX package's float32 scan path
(`LIVES_TPU_FUSED_SWEEP=0`, `LIVES_TPU_CHAIN_DTYPE=f32`) or its Pallas
route in interpret mode, set as tests/test_stateful_fused.py:68-111 sets
it. On the CPU every kernel of the port runs its plain version.

Tolerances: frames +/-1 LSB (torch's and XLA's exp and summation orders
differ by an ulp); f32 states atol 1e-5; life's u8 cells exact; rgb_delay's
ring holds u8 frames, so +/-1 LSB like them, its head exact."""

import os

import numpy as np
import pytest
import torch

from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.events import renderer as jr
from lives_tpu.events.event_list import (EventList, TICKS_PER_SECOND,
                                         filter_init_event, filter_map_event,
                                         frame_event)
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.graph.pallas_composite import sweep_prefix_len as j_prefix
from lives_tpu.graph.pallas_composite import sweep_suffix_len as j_suffix
from lives_tpu.graph.pallas_stateful import _stateful_table as j_table
from lives_tpu.graph.pallas_stateful import stateful_sweep_len as j_sf_len
from lives_tpu.layer import Layer as JLayer
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import Instance, apply_instance, instantiate
from lives_tpu_torch.events import renderer as tr
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.graph import fused_sweep, nodemodel, stateful_sweep
from lives_tpu_torch.graph.nodemodel import (StatefulRoute,
                                             states_from_numpy,
                                             states_to_numpy)
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
from test_torch_cuda import TRANSITIONS, config_chain

H, W, B, T = 32, 128, 5, 3

def assert_states_match(got, ref, ring_lsb=1):
    """Port states (torch) against JAX states (numpy after np.asarray).
    `ring_lsb`: rgb_delay's ring holds u8 frames, +/-1 LSB after a chain
    that runs exp; exact (0) for the filter on its own."""
    assert len(got) == len(ref)
    for g, r in zip(states_to_numpy(got), ref):
        assert (g is None) == (r is None)
        if r is None:
            continue
        if isinstance(r, dict):  # rgb_delay: the ring, its head exact
            assert int(g["head"]) == int(r["head"])
            d = np.abs(g["ring"].astype(int) - np.asarray(r["ring"], int))
            assert d.max() <= ring_lsb, d.max()
            continue
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        if r.dtype == np.uint8:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)


def assert_frames_match(got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1, d.max()


# -- the filters, frame by frame ---------------------------------------------

def _seeded_state(name, rng):
    if name == "rgb_delay":
        return {"ring": rng.integers(0, 256, (16, 3, H, W), dtype=np.uint8),
                "head": np.int32(7)}
    if name == "fire":
        return rng.random((H, W), np.float32)
    if name == "life":
        return (rng.random((H, W)) < 0.3).astype(np.uint8)
    return rng.random((3, H, W), np.float32)


@pytest.mark.parametrize("start", ["init", "seeded"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("name", ["rgb_delay", "fire", "life",
                                  "alien_overlay"])
def test_filter_matches_jax_frame_by_frame(name, dtype, start):
    import jax.numpy as jnp
    from lives_tpu.effects.host import get_filter as j_get_filter
    from lives_tpu_torch.effects.host import get_filter as t_get_filter
    rng = np.random.default_rng(sum(map(ord, name + dtype + start)))
    jf, tf = j_get_filter(name), t_get_filter(name)
    assert tf.hashname == jf.hashname
    assert [(p.name, p.kind, p.default, p.min, p.max) for p in tf.params] \
        == [(p.name, p.kind, p.default, p.min, p.max) for p in jf.params]
    frames = rng.random((B, 3, H, W), np.float32)
    if dtype == "u8":
        frames = np.floor(frames * 255.0 + 0.5).astype(np.uint8)
    pal = int(Palette.RGB24 if dtype == "u8" else Palette.RGBFLOAT)
    params = {p.name: rng.uniform(p.min, p.max, B).astype(np.float32)
              for p in jf.params}
    jstate = None
    inst = Instance(filter=tf)
    if start == "seeded":
        jstate = _seeded_state(name, rng)
        inst.state = states_from_numpy([inst], [jstate], "cpu")[0]
    else:
        jstate = jf.init_state(W, H, pal)
    for b in range(B):
        jout, jstate = jf.process(
            [JLayer(planes=(jnp.asarray(frames[b]),), palette=pal)],
            {k: jnp.asarray(v[b]) for k, v in params.items()},
            JContext(tc=jnp.float32(b / 25), frame=jnp.int32(b), fps=25.0,
                     width=W, height=H), jstate)
        inst.values = {k: torch.from_numpy(v[b:b + 1])
                       for k, v in params.items()}
        tout = apply_instance(
            inst, [TLayer(planes=(torch.from_numpy(frames[b:b + 1]),),
                          palette=pal)],
            TContext(tc=torch.tensor([b / 25]), frame=torch.tensor([b]),
                     fps=25.0, width=W, height=H))[0]
        got, ref = tout.planes[0][0].numpy(), np.asarray(jout.planes[0])
        if dtype == "u8":
            assert_frames_match(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert_states_match([inst.state], [jstate], ring_lsb=0)


def test_stateful_filter_takes_one_frame():
    inst = instantiate("fire")
    lay = TLayer(planes=(torch.zeros(2, 3, 8, 16, dtype=torch.uint8),))
    with pytest.raises(ValueError, match="one frame at a time"):
        apply_instance(inst, [lay])


# -- the route rules -----------------------------------------------------------

KINDS = ["A", "B", "C", "fire_led", "alien", "life", "multi",
         "stencil_after", "life_blur", "alien_blur", "stencil_before",
         "sandwich", "disabled"]


@pytest.mark.parametrize("kind", KINDS)
def test_route_rules_match_jax(kind):
    jchain = config_chain(j_instantiate, kind, n_tracks=10)
    tchain = config_chain(instantiate, kind, n_tracks=10)
    assert fused_sweep.sweep_prefix_len(tchain) == j_prefix(jchain)
    assert fused_sweep.sweep_suffix_len(tchain) == j_suffix(jchain)
    assert stateful_sweep.stateful_sweep_len(tchain) == j_sf_len(jchain)
    assert stateful_sweep._stateful_table() == j_table()


# -- run_batch over two chunks -------------------------------------------------

SCAN = {"LIVES_TPU_FUSED_SWEEP": "0", "LIVES_TPU_CHAIN_DTYPE": "f32"}
INTERPRET = {"LIVES_TPU_PALLAS_INTERPRET": "1", "LIVES_TPU_FUSED_SWEEP": "1",
             "LIVES_TPU_CHAIN_DTYPE": "f32", "LIVES_TPU_SWEEP_TILE": "8"}


def _chunk(k, n_tracks=T):
    ids = np.zeros((2, n_tracks, B), np.int32)
    for t in range(n_tracks):
        ids[0, t] = t + 1
    ids[1] = np.arange(B) + k * B
    return (ids, (np.arange(B) + k * B).astype(np.float32) / 30.0,
            (np.arange(B) + k * B).astype(np.int32))


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_JAX_RUNS: dict = {}


class _UsedKeys(dict):
    """A graph's template cache that records the keys it is asked for."""
    used: set

    def get(self, key, default=None):
        self.used.add(key)
        return super().get(key, default)


def jax_run(cfg, env):
    """Frames of each chunk, states after each chunk and the template keys'
    (pre_n, suf_n, sf_eligible) of the JAX graph over two chunks."""
    key = (cfg, tuple(sorted(env.items())))
    if key not in _JAX_RUNS:
        def go():
            g = JGraph(config_chain(j_instantiate, cfg), JSink(W, H),
                       fps=30.0)
            g._templates = _UsedKeys(g._templates)
            g._templates.used = set()
            frames, states = [], []
            for k in range(2):
                ids, tcs, fr = _chunk(k)
                out = g.run_batch([], tcs, fr, source=JSource(H, W),
                                  src_args=ids)
                frames.append(np.asarray(out.planes[0]))
                states.append([None if s is None else
                               {n: np.asarray(v) for n, v in s.items()}
                               if isinstance(s, dict) else np.asarray(s)
                               for s in g.states])
            routes = {(k[5], k[6], k[11]) for k in g._templates.used}
            return frames, states, routes
        _JAX_RUNS[key] = _with_env(env, go)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("reference", ["scan", "interpret"])
@pytest.mark.parametrize("fused_stateful", ["0", "1"])
@pytest.mark.parametrize("cfg", ["A", "B", "C", "multi", "life",
                                 "stencil_before", "sandwich", "disabled"])
def test_run_batch_matches_jax(cfg, fused_stateful, reference, monkeypatch):
    """Configs A, B and C, and chains where the halo and route rules bite:
    the port's two chunks against the JAX package's, then a port graph
    seeded with the JAX graph's state after chunk 0."""
    env = dict(SCAN if reference == "scan" else INTERPRET,
               LIVES_TPU_FUSED_STATEFUL=fused_stateful)
    ref_frames, ref_states, ref_routes = jax_run(cfg, env)
    monkeypatch.setenv("LIVES_TPU_FUSED_STATEFUL", fused_stateful)
    nodemodel._PLANS.clear()
    before = (fused_sweep.LAUNCHES, stateful_sweep.LAUNCHES)
    src = TSource(H, W, device="cpu")

    def chunk(g, k):
        ids, tcs, fr = _chunk(k)
        return g.run_batch([], tcs, fr, source=src,
                           src_args=ids).planes[0].numpy()

    # the port's own two chunks, its state carried across
    g = TGraph(config_chain(instantiate, cfg), TSink(W, H), fps=30.0)
    for k in range(2):
        assert_frames_match(chunk(g, k), ref_frames[k])
        assert_states_match(g.states, ref_states[k])
        assert [inst.state for inst in g.chain] == g.states
    # seeded from the JAX graph's state after chunk 0
    g2 = TGraph(config_chain(instantiate, cfg), TSink(W, H), fps=30.0)
    g2.states = states_from_numpy(g2.chain, ref_states[0], "cpu")
    assert_frames_match(chunk(g2, 1), ref_frames[1])
    assert_states_match(g2.states, ref_states[1])

    # the route: the JAX package's choice, and the plans it implies
    (key, route), = nodemodel._PLANS.items()
    pre_n, suf_n, sf = key[-1]
    if reference == "interpret":
        assert ref_routes == {(pre_n, suf_n, sf)}
    assert isinstance(route, StatefulRoute)
    assert (route.sf is not None) == bool(sf)
    if route.sf is None:
        assert (route.npre, route.nsuf) == (pre_n, suf_n)
    if cfg in ("A", "B", "C"):
        assert bool(sf) == (cfg == "C" and fused_stateful == "1")
        assert (pre_n, suf_n) == {"A": (0, 2 + T - 1), "B": (2, 0),
                                  "C": (0, 2 + T - 1)}[cfg]
    # CPU tensors: plain versions, no kernel launch
    assert (fused_sweep.LAUNCHES, stateful_sweep.LAUNCHES) == before


def test_states_from_numpy_refuses_state_on_stateless():
    chain = [instantiate("saturation")]
    with pytest.raises(ValueError, match="holds no state"):
        states_from_numpy(chain, [np.zeros((H, W), np.float32)], "cpu")


# -- render_events ---------------------------------------------------------------

def _stateful_timeline(n_frames=8):
    """Config C as recorded init events: 3 tracks at 32x128, 30 fps."""
    el = EventList(fps=30.0, width=W, height=H)
    tpf = int(TICKS_PER_SECOND / 30.0)
    inits = [filter_init_event(0, "fire", values={"threshold": 0.6}),
             filter_init_event(0, "alien_overlay")]
    inits += [filter_init_event(0, TRANSITIONS[t - 1], in_tracks=[0, t],
                                out_tracks=[0], values={"amount": 0.5})
              for t in range(1, T)]
    inits += [filter_init_event(0, "saturation", values={"saturation": 1.2}),
              filter_init_event(0, "vignette", values={"amount": 0.5})]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, T + 1)), [i] * T))
    return el


class _Materialised:
    """The synthetic source without its LOAD step: run_batch gets layers
    and runs the frame loop over the whole chain."""

    def __init__(self, src):
        self.get_batch = src.get_batch


@pytest.mark.parametrize("source", ["traced", "materialised"])
@pytest.mark.parametrize("fused_stateful", ["0", "1"])
def test_render_events_matches_jax(fused_stateful, source, monkeypatch):
    el = _stateful_timeline()
    ref, ref_tcs = _with_env(SCAN, lambda: jr.render_to_arrays(
        el, JSource(H, W), JSink(W, H), batch_size=5))
    monkeypatch.setenv("LIVES_TPU_FUSED_STATEFUL", fused_stateful)
    src = TSource(H, W, device="cpu")
    got, tcs = tr.render_to_arrays(TEventList.from_json(el.to_json()),
                                   src if source == "traced"
                                   else _Materialised(src), TSink(W, H),
                                   batch_size=5)
    assert tcs == ref_tcs
    assert_frames_match(got, np.asarray(ref))
