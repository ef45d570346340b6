"""The whole render slice of lives_tpu_torch against lives_tpu.

A timeline is built once, carried to the port as `EventList.to_json()`
text, and rendered by both packages: lives_tpu on its float32 XLA path
(LIVES_TPU_FUSED_SWEEP=0, LIVES_TPU_CHAIN_DTYPE=f32), the port on the CPU,
where a qualifying chain runs the sweep's plain version. Frames agree to
+/-1 LSB; the host-side segmenting and parameter interpolation agree
exactly."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lives_tpu.events import renderer as jr
from lives_tpu.events.event_list import (TICKS_PER_SECOND, EventType,
                                         filter_init_event, filter_map_event,
                                         param_change_event)
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu.scenes import multitrack_timeline as j_timeline
from lives_tpu_torch.events import renderer as tr
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.graph import fused_sweep, nodemodel
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "fixtures" / "render_golden.npz"


@pytest.fixture
def jax_f32_path(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def _edited_timeline(w, h):
    """Two segments (a filter map switch at frame 4) and a second animated
    parameter; the second segment's chain holds a radius-20 blur, outside
    the sweep kernel's contract, so the port renders it on route (b)."""
    el = j_timeline(n_tracks=3, n_frames=8, width=w, height=h, fps=25.0)
    inits = [e for e in el.events if e.type == EventType.FILTER_INIT]
    tpf = int(TICKS_PER_SECOND / 25.0)
    blur = filter_init_event(4 * tpf, "gaussian_blur",
                             values={"radius": 20, "amount": 0.7})
    el.insert(blur)
    el.insert(filter_map_event(
        4 * tpf, [inits[0].event_id, inits[1].event_id, blur.event_id]))
    el.insert(param_change_event(0, inits[1].event_id, "amount", 0.1))
    el.insert(param_change_event(7 * tpf, inits[1].event_id, "amount", 0.9))
    return el


def _timeline(kind, w, h):
    if kind == "edited":
        return _edited_timeline(w, h)
    n_tracks, n_frames = kind
    return j_timeline(n_tracks=n_tracks, n_frames=n_frames, width=w,
                      height=h, fps=25.0)


@pytest.mark.parametrize("kind,w,h,batch", [
    ((4, 8), 256, 48, 4),       # the golden's scene
    ((10, 4), 96, 40, 4),       # all ten tracks of the benchmark chain
    ((3, 6), 100, 30, 4),       # ragged geometry, ragged last chunk
    ("edited", 64, 24, 3),      # two segments, one on the plain route
])
def test_render_matches_jax_f32_path(kind, w, h, batch, jax_f32_path):
    el = _timeline(kind, w, h)
    text = el.to_json()
    ref, ref_tcs = jr.render_to_arrays(el, JSource(h, w), JSink(w, h),
                                       batch_size=batch)
    before = fused_sweep.LAUNCHES
    got, tcs = tr.render_to_arrays(TEventList.from_json(text),
                                   TSource(h, w, device="cpu"), TSink(w, h),
                                   batch_size=batch)
    assert fused_sweep.LAUNCHES == before  # CPU tensors: no kernel launch
    assert tcs == ref_tcs
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()


def test_render_routes(jax_f32_path):
    """The benchmark chain plans the sweep (route a); a chain with a
    radius-20 blur plans the plain chain (route b)."""
    el = _edited_timeline(64, 24)
    nodemodel._PLANS.clear()
    list(tr.render_events(TEventList.from_json(el.to_json()),
                          TSource(24, 64, device="cpu"), TSink(64, 24),
                          batch_size=4))
    kinds = sorted(type(p).__name__ for p in nodemodel._PLANS.values())
    assert kinds == ["NoneType", "SweepPlan"]


def test_segments_and_interpolation_match_exactly():
    el = _edited_timeline(64, 24)
    tel = TEventList.from_json(el.to_json())
    jsegs, tsegs = jr.segment_events(el), tr.segment_events(tel)
    assert len(jsegs) == len(tsegs) == 2
    for js, ts in zip(jsegs, tsegs):
        assert [e.event_id for e in js.frames] == \
            [e.event_id for e in ts.frames]
        assert [e.event_id for e in js.inits] == \
            [e.event_id for e in ts.inits]
        jinits, jchain = jr._chain_for(js.inits, el, js.frames[0].tc)
        tinits, tchain = tr._chain_for(ts.inits, tel, ts.frames[0].tc)
        assert [i.event_id for i in jinits] == [i.event_id for i in tinits]
        assert [(i.filter.hashname, i.values, i.in_tracks, i.out_tracks)
                for i in jchain] == \
            [(i.filter.hashname, i.values, i.in_tracks, i.out_tracks)
             for i in tchain]
        tcs = [f.tc for f in js.frames]
        jp = jr._interp_arrays(el, jinits, jchain, tcs)
        tp = tr._interp_arrays(tel, tinits, tchain, tcs)
        assert [sorted(d) for d in jp] == [sorted(d) for d in tp]
        for a, b in zip(jp, tp):
            for k in a:
                assert b[k].dtype == np.float32
                np.testing.assert_array_equal(b[k], a[k])


def test_golden_reproduced_by_both_packages(jax_f32_path):
    """lives_tpu still renders the committed golden exactly; the port's
    plain path is within +/-1 LSB of it."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import gen_render_golden as gen
    finally:
        sys.path.pop(0)
    g = np.load(GOLDEN)
    text = str(g["timeline"])
    np.testing.assert_array_equal(gen.render_golden(text), g["frames"])
    got, _ = tr.render_to_arrays(
        TEventList.from_json(text),
        TSource(gen.HEIGHT, gen.WIDTH, device="cpu"),
        TSink(gen.WIDTH, gen.HEIGHT), batch_size=int(g["batch_size"]))
    diff = np.abs(got.astype(int) - g["frames"].astype(int))
    assert diff.max() <= 1, diff.max()


def test_run_batch_refuses_what_is_not_ported(jax_f32_path):
    """blurzoom, refused until ROADMAP item 15 ported it, renders as the
    JAX package renders it: a timeline holding it within 1 LSB of the JAX
    render, its glow state carried across chunks. A timeline whose
    recorded inits carry cconx props (raised until data connections were
    ported) renders from the synthetic source as the JAX package renders
    it, through the frame loop."""
    from lives_tpu.events.event_list import EventList, frame_event
    el = EventList(fps=25.0, width=40, height=24)
    inits = [filter_init_event(0, "blurzoom", values={"amount": 0.9}),
             filter_init_event(0, "crossfade", in_tracks=[0, 1],
                               out_tracks=[0], values={"amount": 0.3})]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = int(TICKS_PER_SECOND / 25.0)
    for i in range(8):
        el.insert(frame_event(i * tpf, [1, 2], [i, 3 * i]))
    ref, ref_tcs = jr.render_to_arrays(el, JSource(24, 40), JSink(40, 24),
                                       batch_size=3)
    got, tcs = tr.render_to_arrays(TEventList.from_json(el.to_json()),
                                   TSource(24, 40, device="cpu"),
                                   TSink(40, 24), batch_size=3)
    assert tcs == ref_tcs
    diff = np.abs(got.astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, diff.max()
    el = EventList(fps=25.0, width=40, height=24)
    mm = filter_init_event(0, "motion_mask", values={"threshold": 0.02})
    mo = filter_init_event(0, "mask_overlay", in_tracks=[0, 1],
                           out_tracks=[0])
    mo.props["cconx"] = [[mm.event_id, "mask", 0]]
    for e in (mm, mo):
        el.insert(e)
    el.insert(filter_map_event(0, [mm.event_id, mo.event_id]))
    for i in range(8):
        el.insert(frame_event(i * tpf, [1, 2], [i, 3 * i]))
    ref, _ = jr.render_to_arrays(el, JSource(24, 40), JSink(40, 24),
                                 batch_size=3)
    got, _ = tr.render_to_arrays(TEventList.from_json(el.to_json()),
                                 TSource(24, 40, device="cpu"),
                                 TSink(40, 24), batch_size=3)
    diff = np.abs(got.astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, diff.max()


def test_port_never_imports_jax():
    code = ("import sys, lives_tpu_torch, lives_tpu_torch.scenes, "
            "lives_tpu_torch.events.renderer, lives_tpu_torch.graph, "
            "lives_tpu_torch.graph.fused_sweep, lives_tpu_torch.native, "
            "lives_tpu_torch.graph.stateful_sweep, lives_tpu_torch.prefs, "
            "lives_tpu_torch.effects.builtin.effectv, "
            "lives_tpu_torch.graph.composite, lives_tpu_torch.ops.yuv_kernels, "
            "lives_tpu_torch.ops.gamma, lives_tpu_torch.ops.resize, "
            "lives_tpu_torch.io.clips, lives_tpu_torch.io.encoders, "
            "lives_tpu_torch.transcode, lives_tpu_torch.parallel, "
            "lives_tpu_torch.parallel.mesh, lives_tpu_torch.parallel.dryrun, "
            "lives_tpu_torch.utils.uid, lives_tpu_torch.utils.transfer, "
            "lives_tpu_torch.io.genclip, "
            "lives_tpu_torch.effects.builtin.generators, "
            "lives_tpu_torch.effects.builtin.geometry, "
            "lives_tpu_torch.effects.compound, lives_tpu_torch.utils.prng, "
            "lives_tpu_torch.utils.sinf, lives_tpu_torch.ops.fma_chain; "
            "from lives_tpu_torch.effects.host import list_filters; "
            "list_filters(); "
            "assert 'jax' not in sys.modules, sorted("
            "m for m in sys.modules if m.startswith('jax'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
