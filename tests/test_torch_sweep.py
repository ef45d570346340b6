"""The fused sweep of lives_tpu_torch: its plain version against lives_tpu's
Pallas kernel, its eligibility rule, and its launch counter.

`plain_sweep` is held against `lives_tpu.graph.pallas_composite.
build_fused_sweep` run in Pallas interpret mode on the CPU (set as
tests/test_fused_sweep.py sets it) at +/-1 LSB. The CUDA kernel itself
builds and runs only on a GPU: tests/test_torch_cuda.py holds it against
`plain_sweep` there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects.host import instantiate as j_instantiate
from lives_tpu.events import renderer as jr
from lives_tpu.events.event_list import TICKS_PER_SECOND
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import _split_params as j_split
from lives_tpu.graph.pallas_composite import build_fused_sweep as j_build
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu.scenes import multitrack_timeline as j_timeline
from lives_tpu_torch.effects.host import (FILTER_STATEFUL, Filter, Instance,
                                          instantiate)
from lives_tpu_torch.events import renderer as tr
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.graph import fused_sweep
from lives_tpu_torch.graph.nodemodel import chain_spec_of
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource


def _main_chunk(n_tracks, w, h, n_frames):
    """The benchmark timeline's first chunk: both packages' chain specs,
    the packed rows, src ids and rows_key, built by each package's own
    renderer helpers from one timeline (carried to the port as JSON)."""
    el = j_timeline(n_tracks=n_tracks, n_frames=n_frames, width=w, height=h,
                    fps=25.0)
    tel = TEventList.from_json(el.to_json())
    seg = jr.segment_events(el)[0]
    tseg = tr.segment_events(tel)[0]
    jinits, jchain = jr._chain_for(seg.inits, el, seg.frames[0].tc)
    tinits, tchain = tr._chain_for(tseg.inits, tel, tseg.frames[0].tc)
    tcs = [f.tc for f in seg.frames]
    params = jr._interp_arrays(el, jinits, jchain, tcs)
    rows = [(i, k) for i, d in enumerate(params) for k in sorted(d)]
    packed = np.stack([params[i][k] for i, k in rows]
                      + [np.asarray(tcs, np.float32) / TICKS_PER_SECOND,
                         np.arange(len(tcs), dtype=np.float32)])
    ids = np.stack([np.array([f.clips for f in seg.frames]).T,
                    np.array([f.frames for f in seg.frames]).T]
                   ).astype(np.int32)
    jspec = [(i.filter, j_split(i)[0], i.in_tracks, i.out_tracks, True)
             for i in jchain]
    return jspec, chain_spec_of(tchain), packed, ids, tuple(rows)


def _multi_stencil_chunk(w, h):
    """crossfade, blur, sharpen, vignette (tests/test_fused_sweep.py:110)
    with per-frame amounts."""
    names = [("crossfade", {"amount": 0.4}),
             ("gaussian_blur", {"radius": 2, "amount": 0.8}),
             ("sharpen", {"radius": 1, "amount": 0.5}),
             ("vignette", {"amount": 0.5})]
    jspec, tchain = [], []
    for n, v in names:
        ji, ti = j_instantiate(n, **v), instantiate(n, **v)
        if n == "crossfade":
            ji.in_tracks = ti.in_tracks = (0, 1)
        jspec.append((ji.filter, j_split(ji)[0], ji.in_tracks,
                      ji.out_tracks, True))
        tchain.append(ti)
    rows = ((0, "amount"), (1, "amount"), (2, "amount"), (3, "amount"),
            (3, "strength"))
    packed = np.array([[0.1, 0.9, 0.4], [0.3, 1.0, 0.6], [0.5, 2.5, 0.2],
                       [0.5, 0.9, 0.7], [1.0, 3.0, 0.5],
                       [0.0, 0.04, 0.08], [0, 1, 2]], np.float32)
    ids = np.array([[[1, 2, -1], [2, 3, 4]], [[0, 1, 2], [5, 6, 7]]],
                   np.int32)
    return jspec, chain_spec_of(tchain), packed, ids, rows


@pytest.mark.parametrize("case", ["main_4_tracks", "multi_stencil"])
def test_plain_sweep_matches_jax_kernel_interpret(case, monkeypatch):
    monkeypatch.setenv("LIVES_TPU_PALLAS_INTERPRET", "1")
    w, h = 256, 48
    if case == "main_4_tracks":
        jspec, tspec, packed, ids, rows = _main_chunk(4, w, h, 4)
    else:
        jspec, tspec, packed, ids, rows = _multi_stencil_chunk(w, h)
    T, B = ids.shape[1], ids.shape[2]
    run = j_build(jspec, T, B, h, w, rows, 25.0, JSource(h, w),
                  JSink(w, h))
    assert run is not None
    ref = np.asarray(run(jnp.asarray(ids), jnp.asarray(packed)))
    plan = fused_sweep.build_fused_sweep(tspec, T, h, w, rows, 25.0,
                                         TSource(h, w, device="cpu"),
                                         TSink(w, h), "cpu")
    assert plan is not None
    before = fused_sweep.LAUNCHES
    got = fused_sweep.fused_sweep(plan, torch.from_numpy(ids),
                                  torch.from_numpy(packed))
    assert fused_sweep.LAUNCHES == before  # CPU tensors: the plain version
    assert got.shape == (B, 3, h, w) and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()


def _spec(*items):
    """chain_spec_of instances made from (name, values, in_tracks) or
    Filter objects."""
    chain = []
    for it in items:
        if isinstance(it, Filter):
            chain.append(Instance(filter=it))
            continue
        name, vals, tracks = it
        inst = instantiate(name, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    return chain_spec_of(chain)


MAIN = [("crossfade", {}, (0, 1)), ("blend_screen", {}, (0, 2)),
        ("blend_overlay", {}, (0, 3)), ("luma_key", {}, (0, 4)),
        ("blend_add", {}, (0, 5)), ("blend_multiply", {}, (0, 6)),
        ("chroma_key", {}, (0, 7)), ("blend_lighten", {}, (0, 8)),
        ("blend_difference", {}, (0, 9)),
        ("gaussian_blur", {"radius": 3, "amount": 0.6}, (0,)),
        ("colour_balance", {}, (0,)), ("saturation", {}, (0,)),
        ("vignette", {"amount": 0.7}, (0,))]


def _eligible(spec, n_tracks=10, sink=None, source=None, h=40, w=96):
    return fused_sweep.build_fused_sweep(
        spec, n_tracks, h, w, (), 30.0, source or TSource(h, w, device="cpu"),
        sink or TSink(w, h), "cpu")


def test_eligibility_accepts_main_chain():
    plan = _eligible(_spec(*MAIN))
    assert plan is not None
    assert plan.halo == 3 and plan.n_stencils == 1
    assert plan.ops.shape == (13, fused_sweep.OP_FIELDS)
    assert plan.ops.dtype == torch.int32


@pytest.mark.parametrize("case", [
    "stateful", "radius_above_16", "letterbox_sink", "unknown_op",
    "resized_sink", "yuv_sink", "alpha_source", "track_out_of_range",
    "post_stencil_transition", "halo_over_shared_memory"])
def test_eligibility_rejects(case):
    """Each chain, sink or source outside the kernel's contract plans the
    plain chain (build_fused_sweep returns None), mirroring
    tests/test_fused_sweep.py:63."""
    from lives_tpu_torch.constants import Palette
    kw = {}
    spec = _spec(*MAIN)
    if case == "stateful":
        spec = _spec(Filter(name="probe_stateful",
                            process=lambda i, p, c, s: (i[0], s),
                            flags=FILTER_STATEFUL), *MAIN)
    elif case == "radius_above_16":
        spec = _spec(*MAIN[:9], ("gaussian_blur", {"radius": 20}, (0,)))
    elif case == "letterbox_sink":
        kw["sink"] = TSink(128, 40, letterbox=True)
    elif case == "unknown_op":
        spec = _spec(Filter(name="rotozoom", process=lambda i, p, c: i[0]),
                     *MAIN)
    elif case == "resized_sink":
        kw["sink"] = TSink(48, 20)
    elif case == "yuv_sink":
        kw["sink"] = TSink(96, 40, palette=Palette.YUV420P)
    elif case == "alpha_source":
        kw["source"] = TSource(40, 96, device="cpu", alpha=True)
    elif case == "track_out_of_range":
        kw["n_tracks"] = 9
    elif case == "post_stencil_transition":
        spec = _spec(*MAIN[:10], ("crossfade", {}, (0, 1)))
    else:  # three r=16 stencils: a 48-pixel halo
        spec = _spec(*[("box_blur", {"radius": 16}, (0,))] * 3)
    assert _eligible(spec, **kw) is None
    assert _eligible(_spec(*MAIN)) is not None


def test_launch_counter_untouched_on_cpu():
    """A full render of a qualifying chain on CPU tensors launches no
    kernel, and a CUDA-only entry refuses a CPU device it cannot serve."""
    before = fused_sweep.LAUNCHES
    el = j_timeline(n_tracks=3, n_frames=4, width=64, height=16, fps=25.0)
    arr, _ = tr.render_to_arrays(TEventList.from_json(el.to_json()),
                                 TSource(16, 64, device="cpu"),
                                 TSink(64, 16), batch_size=4)
    assert arr.shape == (4, 3, 16, 64)
    assert fused_sweep.LAUNCHES == before == 0



@pytest.mark.parametrize("seed", range(8))
def test_random_chain_matches_jax_xla_path(seed, monkeypatch):
    """Random chains inside the kernel's contract (the generator of
    tests/test_torch_cuda.py, which holds the kernel to the same chains on
    a GPU): the port's run_batch plans the sweep and, on CPU tensors, runs
    its plain version; lives_tpu runs its f32 XLA path. +/-1 LSB."""
    from lives_tpu.graph import FrameGraph as JGraph
    from lives_tpu_torch.graph import FrameGraph as TGraph
    from lives_tpu_torch.graph import nodemodel
    from test_torch_cuda import RANDOM_IDS, instances, random_chain
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    items = random_chain(seed, 4)
    jchain = []
    for name, vals, tracks in items:
        inst = j_instantiate(name, **vals)
        inst.in_tracks = tracks
        jchain.append(inst)
    h, w = 45, 70
    B = RANDOM_IDS.shape[2]
    tcs, frames = np.arange(B, dtype=np.float32) / 25.0, np.arange(B)
    ids = (RANDOM_IDS[0], RANDOM_IDS[1])
    ref = np.asarray(JGraph(jchain, JSink(w, h), fps=25.0).run_batch(
        [], tcs, frames, source=JSource(h, w), src_args=ids).planes[0])
    nodemodel._PLANS.clear()
    got = TGraph(instances(items), TSink(w, h), fps=25.0).run_batch(
        [], tcs, frames, source=TSource(h, w, device="cpu"),
        src_args=ids).planes[0].numpy()
    assert [type(p).__name__ for p in nodemodel._PLANS.values()] == \
        ["SweepPlan"]
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (items, diff.max())


@pytest.mark.parametrize("route,w,h", [("xla", 96, 54), ("pallas", 128, 48)])
def test_timeline_v_matches_jax(route, w, h, monkeypatch):
    """Timeline V (chip_smoke.timeline_v: every transition the sweep's
    vocabulary gained, alpha_over, mask_overlay, a blur, ten grading ops),
    10 tracks, 4 frames, through both packages' `render_to_arrays`: the
    port plans its sweep (the whole-vocabulary plan) and runs its plain
    version on the CPU; the JAX package runs its f32 XLA path, or its
    Pallas sweep in interpret mode (which needs a width of 128). +/-1
    LSB."""
    from chip_smoke import timeline_v
    from lives_tpu.events.event_list import EventList as JEventList
    from lives_tpu_torch.graph import nodemodel
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    if route == "xla":
        monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    else:
        monkeypatch.setenv("LIVES_TPU_PALLAS_INTERPRET", "1")
    el = timeline_v(4, w, h)
    ref, _ = jr.render_to_arrays(JEventList.from_json(el.to_json()),
                                 JSource(h, w), JSink(w, h), batch_size=4)
    nodemodel._PLANS.clear()
    nodemodel.PLAIN_CHUNKS = 0
    got, _ = tr.render_to_arrays(el, TSource(h, w, device="cpu"),
                                 TSink(w, h), batch_size=4)
    plans = list(nodemodel._PLANS.values())
    assert [type(p).__name__ for p in plans] == ["SweepPlan"]
    assert plans[0].full and nodemodel.PLAIN_CHUNKS == 0
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("name", ["negate", "brightness_contrast"])
def test_live_filters_plan_a_sweep(name):
    """`negate` and `brightness_contrast` (the live path's configurations)
    are in the sweep's vocabulary: a chain that holds one plans a
    `SweepPlan`, its prefix runs through them, and it is a whole-vocabulary
    plan."""
    spec = _spec(*MAIN[:9], (name, {}, (0,)), *MAIN[9:])
    plan = _eligible(spec)
    assert isinstance(plan, fused_sweep.SweepPlan) and plan.full
    chain = [instantiate(n, **v) for n, v, _ in MAIN[9:]]
    chain.insert(1, instantiate(name))
    assert fused_sweep.sweep_prefix_len(chain) == len(chain)
    assert not _eligible(_spec(*MAIN)).full


def test_vocabulary_is_the_jax_sweeps():
    """The sweep's vocabulary is the JAX sweep's, `PALLAS_SAFE | COORD_SAFE
    | STENCILS` (`pallas_composite.py:51-84`), every name registered in the
    port; K4's is PALLAS_SAFE."""
    from lives_tpu.graph import pallas_composite as jpc
    from lives_tpu_torch.effects.host import list_filters
    from lives_tpu_torch.graph import composite
    assert fused_sweep.VOCABULARY == (fused_sweep.PALLAS_SAFE
                                      | fused_sweep.COORD_SAFE
                                      | fused_sweep.STENCILS)
    # every point op has its opcode
    assert fused_sweep.VOCABULARY == (set(fused_sweep._POINT_OPS)
                                      | fused_sweep.STENCILS)
    assert fused_sweep.PALLAS_SAFE == jpc.PALLAS_SAFE
    assert fused_sweep.COORD_SAFE == jpc.COORD_SAFE
    assert fused_sweep.STENCILS == set(jpc._stencil_fns())
    assert fused_sweep.VOCABULARY <= set(list_filters())
    assert composite.VOCABULARY == jpc.PALLAS_SAFE
    assert len(fused_sweep.VOCABULARY - fused_sweep.CORE
               - fused_sweep.STENCILS) == 25
