"""Stateful chains over row bands (`lives_tpu_torch.parallel.
spatial_stateful_fn`) against lives_tpu's, on conftest's 8 virtual CPU
devices (float32 path, `LIVES_TPU_CHAIN_DTYPE=f32`) and an 8-entry CPU
mesh, on the chains of tests/test_spatial_stateful.py:20-44.

Tolerances: frames +/-1 LSB (torch's and XLA's `exp` and summation orders
differ by an ulp); states through `states_to_numpy`, f32 within 1e-5,
life's u8 cells and rgb_delay's head exact, rgb_delay's ring +/-1 LSB since
it stores frames (against the JAX package; exact against the port's own
run_batch); the port against itself (1 entry vs 8, one call vs two) bit
for bit."""

import numpy as np
import pytest
import torch

from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.graph import FrameGraph as JGraph
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.parallel import chain_band_halo_stateful as j_halo
from lives_tpu.parallel import frame_mesh as j_frame_mesh
from lives_tpu.parallel import spatial_stateful_fn as j_spatial_stateful_fn
from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.graph import FrameGraph, SinkSpec
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.parallel import (BAND_SAFE_STATEFUL,
                                      chain_band_halo_stateful, frame_mesh,
                                      spatial_stateful_fn)
from test_torch_spatial import assert_within_1, make_chain, tracks
from test_torch_stateful import assert_states_match

CPU8 = ["cpu"] * 8
H, W, B = 64, 256, 6
LEADS = {"fire": [("fire", {"threshold": 0.4, "cooling": 0.2}, None)],
         "bench": [("fire", {"threshold": 0.5}, None),
                   ("rgb_delay", {"delay_r": 0.0, "delay_g": 1.0,
                                  "delay_b": 2.0}, None)],
         "life": [("life", {"threshold": 0.15, "amount": 0.5}, None)],
         "nervous": [("nervous", {}, None)]}


@pytest.fixture(autouse=True)
def jax_f32(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def spec_of(kind, n_tracks=2):
    return (LEADS[kind]
            + [("crossfade", {"amount": 0.5}, (0, t))
               for t in range(1, n_tracks)]
            + [("saturation", {"saturation": 1.2}, None),
               ("vignette", {"amount": 0.5}, None)])


def graph(kind, make=instantiate, graph_cls=FrameGraph, sink_cls=SinkSpec):
    return graph_cls(make_chain(make, spec_of(kind)),
                     sink_cls(width=W, height=H))


def port_run(kind, n, layers, tcs, frames):
    g = graph(kind)
    out = spatial_stateful_fn(g, frame_mesh(["cpu"] * n))(layers, tcs,
                                                         frames)
    return g, out.planes[0]


@pytest.mark.parametrize("kind,halo", [("fire", 1), ("bench", 1),
                                       ("life", 1)])
def test_matches_jax_and_run_batch(kind, halo):
    jl, tl = tracks(2, B, H, W, seed=11)
    tcs, frames = np.arange(B) / 25.0, np.arange(B)
    jg = graph(kind, j_instantiate, JGraph, JSink)
    assert chain_band_halo_stateful(graph(kind)) == j_halo(jg) == halo
    ref = np.asarray(j_spatial_stateful_fn(jg, j_frame_mesh(8))(
        jl, tcs, frames).planes[0])
    g, out = port_run(kind, 8, tl, tcs, frames)
    assert_within_1(out, ref)
    assert_states_match(g.states, [None if s is None else
                                   {k: np.asarray(v) for k, v in s.items()}
                                   if isinstance(s, dict) else np.asarray(s)
                                   for s in jg.states], ring_lsb=1)
    # and the port's own whole-frame frame loop, frames and state
    g1 = graph(kind)
    assert_within_1(out, g1.run_batch(tl, tcs, frames).planes[0])
    for a, b in zip(g.states, g1.states):
        if isinstance(a, dict):
            assert torch.equal(a["head"], b["head"])
            assert torch.equal(a["ring"], b["ring"])
        elif a is not None:
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=1e-5)


def test_one_entry_vs_eight_bitwise():
    _, tl = tracks(2, B, H, W, seed=11)
    tcs, frames = np.arange(B) / 25.0, np.arange(B)
    g1, out1 = port_run("bench", 1, tl, tcs, frames)
    g8, out8 = port_run("bench", 8, tl, tcs, frames)
    assert torch.equal(out1, out8)
    assert torch.equal(g1.states[0], g8.states[0])
    assert torch.equal(g1.states[1]["ring"], g8.states[1]["ring"])


def test_state_carries_across_calls():
    """Two 3-frame calls equal one 6-frame call: the state carries through
    graph.states between calls, run_batch's contract."""
    _, tl = tracks(2, B, H, W, seed=11)
    tcs, frames = np.arange(B) / 25.0, np.arange(B)
    _, whole = port_run("bench", 8, tl, tcs, frames)
    g = graph("bench")
    run = spatial_stateful_fn(g, frame_mesh(CPU8))
    halves = [run([Layer(planes=(l.planes[0][s],), palette=l.palette)
                   for l in tl], tcs[s], frames[s]).planes[0]
              for s in (slice(0, 3), slice(3, 6))]
    assert torch.equal(torch.cat(halves), whole)
    # rgb_delay's head advanced once a frame, not once a band
    assert int(g.states[1]["head"]) == B
    assert g.chain[1].state is g.states[1]


@pytest.mark.parametrize("case", ["stencil", "warp", "nervous", "sink",
                                  "rows"])
def test_refusals(case):
    g = graph("fire")
    _, tl = tracks(2, B, H, W)
    tcs, frames = np.arange(B) / 25.0, np.arange(B)
    if case == "stencil":
        g.chain.append(instantiate("gaussian_blur", radius=2))
        g.states.append(None)
        with pytest.raises(ValueError, match="stencils"):
            chain_band_halo_stateful(g)
    elif case == "warp":
        # the global warps stay refused, as in the JAX package
        for name in ("feedback", "vertigo", "blurzoom"):
            gw = graph("fire")
            gw.chain.insert(0, instantiate(name))
            gw.states.insert(0, None)
            with pytest.raises(ValueError, match="band-safe"):
                spatial_stateful_fn(gw, frame_mesh(CPU8))
    elif case == "nervous":
        # band-safe (radius 0) and ported: held to the JAX package's
        # spatial_stateful_fn over the 8-entry mesh, its ring exact (it
        # stores the input frames) and its slots the JAX package's
        assert BAND_SAFE_STATEFUL["nervous"] == 0
        jg = graph("nervous", j_instantiate, JGraph, JSink)
        assert chain_band_halo_stateful(graph("nervous")) == j_halo(jg) == 0
        jl, tl = tracks(2, B, H, W, seed=11)
        frames = np.arange(B) + 7
        ref = j_spatial_stateful_fn(jg, j_frame_mesh(8))(jl, tcs, frames)
        g, out = port_run("nervous", 8, tl, tcs, frames)
        assert_within_1(out, np.asarray(ref.planes[0]))
        assert_states_match(g.states, [
            None if s is None else {k: np.asarray(v) for k, v in s.items()}
            for s in jg.states], ring_lsb=0)
    elif case == "sink":
        g.sink = SinkSpec(width=W // 2, height=H // 2)
        with pytest.raises(ValueError, match="same-geometry"):
            spatial_stateful_fn(g, frame_mesh(CPU8))(tl, tcs, frames)
    else:
        with pytest.raises(ValueError, match="unshardable"):
            spatial_stateful_fn(g, frame_mesh(["cpu"] * 5))(tl, tcs, frames)
