"""The port's spatial bands (`lives_tpu_torch.parallel.spatial_batch_fn`,
`grid_batch_fn`, `chain_band_halo`) against lives_tpu's.

Both packages get the same seeded RGB24 tracks and the same chain; the JAX
package runs on conftest's 8 virtual CPU devices on its float32 path
(`LIVES_TPU_CHAIN_DTYPE=f32`), the port on a mesh of 8 CPU entries.
Tolerance: +/-1 LSB on the u8 frames, since torch's and XLA's `exp` and
summation orders differ by an ulp."""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.graph import FrameGraph as JGraph
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.layer import Layer as JLayer
from lives_tpu.parallel import chain_band_halo as j_halo
from lives_tpu.parallel import frame_mesh as j_frame_mesh
from lives_tpu.parallel import grid_batch_fn as j_grid_batch_fn
from lives_tpu.parallel import grid_mesh as j_grid_mesh
from lives_tpu.parallel import spatial_batch_fn as j_spatial_batch_fn
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import Filter, instantiate
from lives_tpu_torch.graph import FrameGraph, SinkSpec
from lives_tpu_torch.graph.fused_sweep import COORD_SAFE, PALLAS_SAFE
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.parallel import (chain_band_halo, frame_mesh,
                                      grid_batch_fn, grid_mesh,
                                      spatial_batch_fn)

CPU8 = ["cpu"] * 8
#: the chain of tests/test_spatial.py:18-33 at 3 tracks
SPATIAL = [("crossfade", {"amount": 0.4}, (0, 1)),
           ("blend_screen", {"amount": 0.4}, (0, 2)),
           ("gaussian_blur", {"radius": 3, "amount": 0.7}, None),
           ("vignette", {"amount": 0.6}, None),
           ("saturation", {"saturation": 1.2}, None)]


@pytest.fixture(autouse=True)
def jax_f32(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def make_chain(make, spec):
    """Instances of `spec` ((name, values, in_tracks or None) each) made by
    one package's `instantiate`."""
    out = []
    for name, vals, tracks in spec:
        inst = make(name, **vals)
        if tracks is not None:
            inst.in_tracks = tuple(tracks)
        out.append(inst)
    return out


def graphs(spec, h, w):
    """(JAX FrameGraph, port FrameGraph) of one chain, same-geometry
    sinks."""
    return (JGraph(make_chain(j_instantiate, spec), JSink(width=w, height=h)),
            FrameGraph(make_chain(instantiate, spec),
                       SinkSpec(width=w, height=h)))


def tracks(n, B, h, w, seed=7):
    """n seeded (B,3,h,w) RGB24 tracks as (JAX layers, port layers)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 256, (B, 3, h, w), np.uint8) for _ in range(n)]
    return ([JLayer(planes=(jnp.asarray(a),), palette=int(JPalette.RGB24))
             for a in arrs],
            [Layer(planes=(torch.from_numpy(a),), palette=int(Palette.RGB24))
             for a in arrs])


def assert_within_1(got, ref):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("n", [1, 2, 8])
def test_spatial_batch_matches_jax(n):
    jg, tg = graphs(SPATIAL, 96, 256)
    jl, tl = tracks(3, 4, 96, 256)
    tcs, frames = np.arange(4) / 25.0, np.arange(4)
    assert chain_band_halo(tg) == j_halo(jg) == 3
    ref = np.asarray(j_spatial_batch_fn(jg, j_frame_mesh(n))(
        jl, tcs, frames).planes[0])
    out = spatial_batch_fn(tg, frame_mesh(["cpu"] * n))(tl, tcs, frames)
    assert out.palette == Palette.RGB24
    assert_within_1(out.planes[0], ref)


def test_spatial_batch_matches_run_batch():
    """The banded chain against the port's own whole-frame batch (vignette
    reads its rows' place in the frame)."""
    _, tg = graphs(SPATIAL, 96, 256)
    _, tl = tracks(3, 4, 96, 256)
    tcs, frames = np.arange(4) / 25.0, np.arange(4)
    ref = tg.run_batch(tl, tcs, frames).planes[0]
    out = spatial_batch_fn(tg, frame_mesh(CPU8))(tl, tcs, frames).planes[0]
    assert_within_1(out, ref)


def test_two_stencils_match_run_batch():
    """A band's halo stops at the frame edge, so each stencil pads there as
    over the whole frame: two stencils agree with run_batch too."""
    spec = SPATIAL + [("sharpen", {"radius": 2, "amount": 0.8}, None),
                      ("box_blur", {"radius": 1}, None)]
    _, tg = graphs(spec, 96, 256)
    _, tl = tracks(3, 2, 96, 256)
    tcs, frames = np.arange(2) / 25.0, np.arange(2)
    assert chain_band_halo(tg) == 6
    ref = tg.run_batch(tl, tcs, frames).planes[0]
    out = spatial_batch_fn(tg, frame_mesh(CPU8))(tl, tcs, frames).planes[0]
    assert_within_1(out, ref)


def test_grid_matches_jax():
    """4-way DP x 2-way SP on a 2-D mesh against the JAX grid and the
    port's run_batch."""
    jg, tg = graphs(SPATIAL, 96, 256)
    jl, tl = tracks(3, 8, 96, 256)
    tcs, frames = np.arange(8) / 25.0, np.arange(8)
    ref = np.asarray(j_grid_batch_fn(jg, j_grid_mesh(4, 2))(
        jl, tcs, frames).planes[0])
    mesh = grid_mesh(CPU8, 4, 2)
    assert mesh.shape == {"b": 4, "s": 2}
    out = grid_batch_fn(tg, mesh)(tl, tcs, frames).planes[0]
    assert_within_1(out, ref)
    assert_within_1(out, tg.run_batch(tl, tcs, frames).planes[0])


@pytest.mark.parametrize("trial", range(4))
def test_random_band_safe_chain_matches_jax(trial):
    """Property case (tests/test_spatial.py:83-121): random chains of the
    port's band-safe filters, with a blur at times, against the JAX bands
    and the port's run_batch."""
    from lives_tpu_torch.effects.host import list_filters
    rng = random.Random(100 + trial)
    pool = sorted((PALLAS_SAFE | COORD_SAFE) & set(list_filters()))
    assert {"crossfade", "luma_key", "vignette"} <= set(pool)
    spec, track = [], 1
    for _ in range(rng.randint(2, 5)):
        name = rng.choice(pool)
        n_in = instantiate(name).filter.n_in
        spec.append((name, {}, (0, track) if n_in > 1 else None))
        track += n_in > 1
    if rng.random() < 0.7:
        spec.append(("gaussian_blur", {"radius": rng.randint(1, 3)}, None))
    jg, tg = graphs(spec, 96, 128)
    jl, tl = tracks(track, 4, 96, 128, seed=trial)
    tcs, frames = np.arange(4) / 25.0, np.arange(4)
    ref = np.asarray(j_spatial_batch_fn(jg, j_frame_mesh(8))(
        jl, tcs, frames).planes[0])
    out = spatial_batch_fn(tg, frame_mesh(CPU8))(tl, tcs, frames).planes[0]
    assert_within_1(out, ref)
    tg2 = FrameGraph([copy.deepcopy(i) for i in tg.chain], tg.sink)
    assert_within_1(out, tg2.run_batch(tl, tcs, frames).planes[0])


def _gather_filter():
    """A filter outside the band-safe sets (the JAX package's rotozoom, a
    gather, is not registered in the port)."""
    return Filter(name="rotozoom", process=lambda ins, p, ctx: ins[0])


@pytest.mark.parametrize("case", ["gather", "stateful", "sink", "halo",
                                  "batch"])
def test_band_paths_refuse(case):
    _, tg = graphs(SPATIAL, 96, 256)
    _, tl = tracks(3, 4, 96, 256)
    tcs, frames = np.arange(4) / 25.0, np.arange(4)
    if case == "gather":
        from lives_tpu_torch.effects.host import Instance
        tg.chain.append(Instance(filter=_gather_filter()))
        with pytest.raises(ValueError, match="band-safe"):
            chain_band_halo(tg)
    elif case == "stateful":
        tg.chain.insert(0, instantiate("fire"))
        tg.states.insert(0, None)
        with pytest.raises(ValueError, match="'fire' is not band-safe"):
            spatial_batch_fn(tg, frame_mesh(CPU8))
    elif case == "sink":
        tg.sink = SinkSpec(width=128, height=48)
        with pytest.raises(ValueError, match="same-geometry"):
            spatial_batch_fn(tg, frame_mesh(CPU8))(tl, tcs, frames)
    elif case == "halo":
        # 96 rows over 48 bands: 2 rows each, less than the blur's 3
        with pytest.raises(ValueError, match="halo"):
            spatial_batch_fn(tg, frame_mesh(["cpu"] * 48))(tl, tcs, frames)
    else:
        with pytest.raises(ValueError, match="divide"):
            grid_batch_fn(tg, grid_mesh(["cpu"] * 6, 3, 2))(tl, tcs, frames)
