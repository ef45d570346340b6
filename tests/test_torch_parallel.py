"""The port's mesh, frame-batch DP, halo-exchange blur, pipeline and dry run
(`lives_tpu_torch.parallel`) against lives_tpu's, on conftest's 8 virtual
CPU devices and an 8-entry CPU mesh.

Tolerances: DP equals the port's own run_batch (+/-1 LSB, since torch's
CPU kernels are not bitwise repeatable) and the JAX DP render (+/-1 LSB,
torch's and XLA's `exp` differ by an ulp); the blur within 1 LSB of the
numpy reference of tests/test_parallel.py:57-69 and of the JAX blur; the
pipeline within 1e-5 of the sequential chain and of the JAX pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.graph import FrameGraph as JGraph
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.parallel import frame_mesh as j_frame_mesh
from lives_tpu.parallel import sharded_batch_fn as j_sharded_batch_fn
from lives_tpu.parallel import spatial_blur_sharded as j_blur
from lives_tpu.parallel.mesh import pipeline_chain_fn as j_pipeline
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import FrameContext, instantiate
from lives_tpu_torch.graph import FrameGraph, SinkSpec
from lives_tpu_torch.graph.nodemodel import states_to_numpy
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.parallel import (Mesh, dryrun_multichip, frame_mesh,
                                      grid_mesh, pipeline_chain_fn,
                                      shard_layer_batch, sharded_batch_fn,
                                      spatial_blur_sharded)
from test_torch_spatial import assert_within_1, make_chain, tracks

CPU8 = ["cpu"] * 8
#: eight one-input filters the port holds, with values
STAGES = [("colour_balance", {"red": 1.2, "blue": 0.8}),
          ("saturation", {"saturation": 1.4}),
          ("vignette", {"amount": 0.6}),
          ("gaussian_blur", {"radius": 2, "amount": 0.7}),
          ("box_blur", {"radius": 1, "amount": 0.5}),
          ("sharpen", {"radius": 1, "amount": 0.6}),
          ("colour_balance", {"green": 0.9}),
          ("saturation", {"saturation": 0.7})]


@pytest.fixture(autouse=True)
def jax_f32(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def test_mesh_layout():
    mesh = grid_mesh(["cpu"] * 6, 3, 2)
    assert mesh.shape == {"b": 3, "s": 2} and len(mesh.devices) == 6
    assert mesh.axis_names == ("b", "s")
    assert mesh.device(b=2, s=1) == torch.device("cpu")
    assert len(mesh.axis_devices("s", b=1)) == 2
    assert len(mesh.axis_devices("b")) == 3
    one = frame_mesh(["cpu"] * 4, axis="s")
    assert one.shape == {"s": 4} and one.devices == (torch.device("cpu"),) * 4


@pytest.mark.parametrize("bad", ["shape", "grid", "meta", "empty"])
def test_mesh_refuses(bad):
    with pytest.raises(ValueError):
        if bad == "shape":
            Mesh(CPU8, ("b", "s"), (3, 2))
        elif bad == "grid":
            grid_mesh(CPU8, 2, 2)
        elif bad == "meta":
            frame_mesh(["cpu", "meta"])
        else:
            frame_mesh([])


def test_shard_layer_batch():
    _, (lay,) = tracks(1, 8, 16, 128)
    shards = shard_layer_batch(lay, frame_mesh(CPU8))
    assert len(shards) == 8
    assert tuple(shards[0].planes[0].shape) == (1, 3, 16, 128)
    assert torch.equal(torch.cat([s.planes[0] for s in shards]),
                       lay.planes[0])
    with pytest.raises(ValueError, match="divide"):
        shard_layer_batch(lay, frame_mesh(["cpu"] * 3))


def test_dp_matches_run_batch_and_jax():
    """tests/test_parallel.py:21-41 with the port's filters: a vignette
    chain over 8 frames, DP on 8 entries."""
    spec = [("saturation", {"saturation": 1.3}, None),
            ("vignette", {"amount": 0.8}, None)]
    jl, tl = tracks(1, 8, 16, 128)
    tcs, frames = np.arange(8) / 25.0, np.arange(8)
    ref = FrameGraph(make_chain(instantiate, spec), SinkSpec()).run_batch(
        tl, tcs, frames).planes[0]
    out = sharded_batch_fn(FrameGraph(make_chain(instantiate, spec),
                                      SinkSpec()), frame_mesh(CPU8))(
        tl, tcs, frames)
    assert out.palette == Palette.RGB24
    assert_within_1(out.planes[0], ref)
    jref = j_sharded_batch_fn(JGraph(make_chain(j_instantiate, spec),
                                     JSink()), j_frame_mesh(8))(
        jl, tcs, frames).planes[0]
    assert_within_1(out.planes[0], np.asarray(jref))


def test_dp_carries_state_in_frame_order():
    """A stateful chain's DP shards run in frame order with the state
    handed on: frames and state as one run_batch over the whole batch."""
    spec = [("fire", {"threshold": 0.4}, None),
            ("crossfade", {"amount": 0.5}, (0, 1))]
    _, tl = tracks(2, 8, 24, 64)
    tcs, frames = np.arange(8) / 25.0, np.arange(8)
    g1 = FrameGraph(make_chain(instantiate, spec), SinkSpec())
    ref = g1.run_batch(tl, tcs, frames).planes[0]
    g2 = FrameGraph(make_chain(instantiate, spec), SinkSpec())
    out = sharded_batch_fn(g2, frame_mesh(["cpu"] * 4))(tl, tcs, frames)
    assert_within_1(out.planes[0], ref)
    np.testing.assert_allclose(states_to_numpy(g2.states)[0],
                               states_to_numpy(g1.states)[0], atol=1e-5)
    assert g2.chain[0].state is g2.states[0]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_spatial_blur_matches_reference_and_jax(dtype):
    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, (3, 64, 128)).astype(dtype)
    out = spatial_blur_sharded(torch.from_numpy(img), frame_mesh(CPU8),
                               radius=2)
    assert tuple(out.shape) == img.shape and out.dtype == torch.from_numpy(
        img).dtype
    x = img.astype(np.float32)
    pad = np.pad(x, ((0, 0), (2, 2), (0, 0)), mode="edge")
    expect = sum(pad[:, k:k + 64, :] for k in range(5)) / 5.0
    if dtype == np.uint8:
        expect = np.clip(expect + 0.5, 0, 255).astype(np.uint8)
        assert_within_1(out, expect)
    else:
        np.testing.assert_allclose(out.numpy(), expect, atol=1e-3)
    jout = np.asarray(j_blur(jnp.asarray(img), j_frame_mesh(8), radius=2))
    if dtype == np.uint8:
        assert_within_1(out, jout)
    else:
        np.testing.assert_allclose(out.numpy(), jout, atol=1e-3)


def _sequential(insts, x, t):
    """One (1,3,H,W) f32 frame through the stages in order."""
    for inst in insts:
        if inst is None:
            continue
        x = inst.filter.process(
            [Layer(planes=(x,), palette=int(Palette.RGBFLOAT))],
            inst.param_values(),
            FrameContext(tc=t, frame=0, fps=25.0, width=x.shape[-1],
                         height=x.shape[-2])).planes[0]
    return x


def test_pipeline_matches_sequential_and_jax():
    """tests/test_parallel.py:143-183: 8 stages on 8 entries, 12 frames."""
    insts = [instantiate(nm, **kw) for nm, kw in STAGES]
    batch = np.random.default_rng(0).random((12, 3, 16, 24)) \
        .astype(np.float32)
    tcs = np.arange(12, dtype=np.float32) / 25.0
    got = pipeline_chain_fn(insts, frame_mesh(CPU8))(batch, tcs)
    assert tuple(got.shape) == batch.shape
    for i in range(12):
        ref = _sequential(insts, torch.from_numpy(batch[i:i + 1]),
                          float(tcs[i]))
        torch.testing.assert_close(got[i:i + 1], ref, rtol=1e-5, atol=1e-5)
    jinsts = [j_instantiate(nm, **kw) for nm, kw in STAGES]
    jgot = np.asarray(j_pipeline(jinsts, j_frame_mesh(8))(batch, tcs))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-5, atol=1e-5)


def test_pipeline_pads_identity():
    insts = [instantiate("colour_balance", red=0.5)] + [None] * 7
    batch = np.random.default_rng(1).random((8, 3, 8, 16)).astype(np.float32)
    got = pipeline_chain_fn(insts, frame_mesh(CPU8))(
        batch, np.zeros(8, np.float32))
    expect = batch.copy()
    expect[:, 0] *= 0.5
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stage", ["crossfade", "fire", "count"])
def test_pipeline_refuses(stage):
    n = 7 if stage == "count" else 8
    insts = [instantiate("saturation" if stage == "count" else stage)] \
        + [None] * (n - 1)
    with pytest.raises(ValueError):
        pipeline_chain_fn(insts, frame_mesh(CPU8))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_dryrun_multichip(n):
    """The port's dry run (`__graft_entry__.py:73-270`'s twin) on n CPU
    entries; it checks each path against the DP render itself."""
    dryrun_multichip(["cpu"] * n)
