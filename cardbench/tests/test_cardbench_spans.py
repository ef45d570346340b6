"""The program's `lives.` spans in a traced stretch (`spans.py`): counts,
host self times and the device idle split over the spans open across
it, on a stretch built by hand; the trace reduction's own numbers
unmoved by those spans; and the spans of each cell's traced stretch at a
tiny size on the CPU."""

from __future__ import annotations

import pytest

from conftest import CHECKOUT
from test_cardbench_yardstick import _Ev, _Prof

from cardbench import bench, spans, trace

LIVES = [
    # host, one thread: a frame (0-70 us) holding its pack (2-9, a copy
    # op inside) and two effects (20-45, a launch inside; 45-60); two
    # sinks after it (75-90, 92-95)
    _Ev("lives.frame", 0, 70),
    _Ev("lives.frame.pack", 2, 9),
    _Ev("lives.fx.a", 20, 45),
    _Ev("lives.fx.b", 45, 60),
    _Ev("lives.sink", 75, 90),
    _Ev("lives.sink", 92, 95),
    # mirrored on the device's timeline: annotations, no work
    _Ev("lives.frame", 5, 70, device=True, annotation=True),
    _Ev("lives.fx.a", 10, 30, device=True, annotation=True),
]
OTHERS = [
    _Ev(trace.WINDOW, 0, 100),
    _Ev(trace.WINDOW, 0, 100, device=True, annotation=True),
    _Ev("aten::copy_", 3, 8),
    _Ev("cudaLaunchKernel", 35, 39),
    _Ev("lives.fx.c", 30, 50, thread=2),
    _Ev("k1", 10, 30, device=True),
    _Ev("k2", 50, 60, device=True),
    _Ev("Memcpy HtoD (Pageable -> Device)", 60, 65, device=True),
]


def test_counts_and_self_times():
    names = spans.reduce(_Prof(OTHERS + LIVES))["names"]
    assert {k: v["count"] for k, v in names.items()} == {
        "lives.frame": 1, "lives.frame.pack": 1, "lives.fx.a": 1,
        "lives.fx.b": 1, "lives.sink": 2}
    # a span's time less its children's: the frame's 70 us less its
    # pack's 7 and its effects' 25 and 15
    assert {k: v["self_s"] for k, v in names.items()} == pytest.approx({
        "lives.frame": 23e-6, "lives.frame.pack": 7e-6, "lives.fx.a": 25e-6,
        "lives.fx.b": 15e-6, "lives.sink": 18e-6})


def test_idle_is_split_over_the_spans_open_across_it():
    """The device idles over 0-10, 30-50 and 65-100 us. 0-10 lies in the
    frame (0-2, 9-10) and its pack (2-9); 30-50 crosses both effects
    (30-45, 45-50); 65-100 ends the frame (65-70), holds both sinks
    (75-90, 92-95) and no span at all (70-75, 90-92, 95-100)."""
    sp = spans.reduce(_Prof(OTHERS + LIVES))
    assert {k: v["idle_s"] for k, v in sp["names"].items()} == \
        pytest.approx({"lives.frame": 8e-6, "lives.frame.pack": 7e-6,
                       "lives.fx.a": 15e-6, "lives.fx.b": 5e-6,
                       "lives.sink": 18e-6})
    assert sp["unattributed_s"] == pytest.approx(12e-6)
    assert sp["idle_s"] == pytest.approx(65e-6)


def test_attributed_and_unattributed_idle_make_the_stretch_idle():
    t = trace.reduce(_Prof(OTHERS + LIVES))
    sp = spans.reduce(_Prof(OTHERS + LIVES))
    attributed = sum(v["idle_s"] for v in sp["names"].values())
    assert attributed + sp["unattributed_s"] == \
        pytest.approx(t["window_s"] - t["busy_s"], abs=1e-12)
    t["spans"] = sp
    s = spans.summary({**t, "units": 2})
    assert abs(s["closure_us"]) < 1e-6
    assert s["layers_idle_ms"] == pytest.approx({
        "Renderer": 0.0, "Plan and upload": 0.0, "Live frame": 16.5e-3,
        "Effects and generators": 10e-3})
    assert s["plan_builds"] == 0


def test_the_reduction_reads_the_same_with_the_spans():
    """Every number of the trace reduction but the idle gaps' names is
    the same with and without the `lives.` events; the gaps are named by
    the innermost host event at their midpoints, now `lives.` spans."""
    bare = trace.reduce(_Prof(OTHERS))
    spanned = trace.reduce(_Prof(OTHERS + LIVES))
    for k in ("window_s", "busy_s", "kernel_s", "kernels", "pageable_htod",
              "device_ops"):
        assert spanned[k] == bare[k], k
    assert spanned["busy_s"] == pytest.approx(35e-6)
    assert dict(bare["idle_gaps"]) == pytest.approx(
        {"aten::copy_": 10e-6, "after cudaLaunchKernel": 55e-6})
    assert dict(spanned["idle_gaps"]) == pytest.approx(
        {"aten::copy_": 10e-6, "lives.fx.a": 20e-6, "lives.sink": 35e-6})


def test_no_window_no_spans():
    assert spans.reduce(_Prof(LIVES)) is None


def test_a_stretch_without_spans_leaves_all_idle_unattributed():
    sp = spans.reduce(_Prof(OTHERS))
    assert sp["names"] == {}
    assert sp["unattributed_s"] == sp["idle_s"] == pytest.approx(65e-6)


@pytest.mark.parametrize("workload", [
    w["name"] for w in bench.load(CHECKOUT)["workloads"]])
def test_each_cells_stretch_holds_the_programs_spans(tiny, workload):
    """At a tiny size on the CPU (no device activity, so the whole
    stretch is idle), one traced run of the cell, still correct: the
    render cells' stretches hold the renderer's and the plan's spans, a
    chunk each, and build no plan; the live cell's a frame span, a pack,
    two generators and a sink a frame."""
    b = bench.load(tiny)
    out, t = spans.traced(b, workload, 2**31 + 77, 0.5, "cpu",
                          checkout=tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {
        m["name"] for m in bench.metrics_of(b, workload, True)}
    names = t["spans"]["names"]
    s = spans.summary(t)
    assert abs(s["closure_us"]) < 1e-6
    units = t["units"]
    if workload.startswith("mt10"):
        for name in ("lives.render.chunk", "lives.plan.batch",
                     "lives.plan.pack", "lives.plan.upload",
                     "lives.plan.launch"):
            assert names[name]["count"] == units, name
        assert s["plan_builds"] == 0
        assert s["layers_idle_ms"]["Renderer"] > 0
    else:
        for name in ("lives.frame", "lives.frame.pack", "lives.gen.plasma",
                     "lives.gen.colour_bars", "lives.fx.luma_key",
                     "lives.sink"):
            assert names[name]["count"] == units, name
        assert s["layers_idle_ms"]["Effects and generators"] > 0
