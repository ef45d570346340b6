"""The port's `lives.` spans (`diagnostics.span`) under `torch.profiler`
on the CPU: which spans the renderer, the plan and the live frame emit and
how often, that none stays open across the renderer's `yield`, that the
profiler is their only switch, that frames do not change with it, and
that `chip_smoke.py` counts no span mirrored on the device as its work."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lives_tpu_torch import diagnostics
from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.events.event_list import (TICKS_PER_SECOND, EventType,
                                               filter_init_event,
                                               filter_map_event)
from lives_tpu_torch.events.renderer import render_events
from lives_tpu_torch.graph import FrameGraph, SinkSpec, nodemodel
from lives_tpu_torch.io.genclip import GeneratorClip
from lives_tpu_torch.scenes import DeviceSyntheticSource, multitrack_timeline

W, H = 48, 24
STEP = "consumer.step"


def _two_segments():
    """Eight frames of three tracks; at frame 4 the filter map switches to
    a chain with a radius-20 blur, outside the sweep's contract, so the
    first segment runs the sweep (route a) and the second the plain chain
    (route b)."""
    el = multitrack_timeline(n_tracks=3, n_frames=8, width=W, height=H,
                             fps=25.0)
    inits = [e for e in el.events if e.type == EventType.FILTER_INIT]
    tpf = int(TICKS_PER_SECOND / 25.0)
    blur = filter_init_event(4 * tpf, "gaussian_blur",
                             values={"radius": 20, "amount": 0.7})
    el.insert(blur)
    el.insert(filter_map_event(
        4 * tpf, [inits[0].event_id, inits[1].event_id, blur.event_id]))
    return el


def _render(profiled: bool):
    """(frames, lives. events, consumer steps) of one render in chunks of
    3 (two chunks a segment), each step of the iteration inside a span of
    the consumer's own."""
    it = render_events(_two_segments(), DeviceSyntheticSource(
        H, W, device="cpu"), SinkSpec(W, H), batch_size=3)
    frames = []

    def consume():
        while True:
            with record_function(STEP):
                try:
                    _, lay = next(it)
                except StopIteration:
                    return
            frames.append(lay.planes[0].clone())
    if not profiled:
        consume()
        return torch.cat(frames), [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        consume()
    events = [e for e in prof.events() if e.name.startswith("lives.")]
    steps = [e for e in prof.events() if e.name == STEP]
    return torch.cat(frames), events, steps


def _live_graph():
    layers = [GeneratorClip("plasma", W, H, fps=60.0, device="cpu"),
              GeneratorClip("colour_bars", W, H, fps=60.0, device="cpu")]
    graph = FrameGraph([instantiate("luma_key"), instantiate("negate"),
                        instantiate("saturation", saturation=1.4)],
                       SinkSpec(width=W, height=H), fps=60.0)
    return layers, graph


def _counts(events):
    return Counter(e.name for e in events)


def test_render_emits_each_renderer_and_plan_span():
    nodemodel._PLANS.clear()
    _, events, steps = _render(True)
    n = _counts(events)
    assert n["lives.render.segment"] == 1
    assert n["lives.render.chain"] == 2
    for name in ("lives.render.chunk", "lives.plan.batch", "lives.plan.pack",
                 "lives.plan.upload"):
        assert n[name] == 4, name
    assert n["lives.plan.build"] == 2       # a plan a segment, both missed
    assert n["lives.plan.launch"] == 2      # the sweep's two chunks
    # on the CPU the sweep's plain version runs the chain through
    # `run_chain` too: an effect and the sink a chunk on both routes, and
    # the second segment's chain holds both blurs
    assert n["lives.sink"] == n["lives.fx.vignette"] == 4
    assert n["lives.fx.gaussian_blur"] == 6
    # warm plans: no build
    _, events, _ = _render(True)
    assert _counts(events)["lives.plan.build"] == 0


def test_no_render_span_is_open_across_a_yield():
    _, events, steps = _render(True)
    assert len(steps) == 5          # four chunks and the generator's end
    spans = [(e.time_range.start, e.time_range.end) for e in steps]
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        assert any(a <= s and t <= b for a, b in spans), e.name


def test_live_frame_emits_frame_pack_generators_effects_and_sink():
    layers, graph = _live_graph()
    graph.run(layers, 0.0, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph.run(layers, 5 / 60.0, 5)
    events = [e for e in prof.events() if e.name.startswith("lives.")]
    assert _counts(events) == Counter({
        "lives.frame": 1, "lives.frame.pack": 1, "lives.gen.plasma": 1,
        "lives.gen.colour_bars": 1, "lives.fx.luma_key": 1,
        "lives.fx.negate": 1, "lives.fx.saturation": 1, "lives.sink": 1})
    frame = next(e for e in events if e.name == "lives.frame")
    for e in events:
        assert frame.time_range.start <= e.time_range.start
        assert e.time_range.end <= frame.time_range.end


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a = diagnostics.span("lives.render.chunk")
    assert a is diagnostics.span("lives.fx.", "saturation")
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = diagnostics.span("lives.fx.", "saturation")
        assert on is not a
        with on:
            pass


def test_diagnostics_keeps_no_step_timer():
    assert not hasattr(diagnostics, "StepTimer")


@pytest.mark.parametrize("path", ["render", "live"])
def test_frames_are_the_same_with_the_profiler_on_and_off(path):
    if path == "render":
        off, _, _ = _render(False)
        on, _, _ = _render(True)
    else:
        layers, graph = _live_graph()
        off = graph.run(layers, 7 / 60.0, 7).planes[0]
        with profile(activities=[ProfilerActivity.CPU]):
            on = graph.run(layers, 7 / 60.0, 7).planes[0]
    assert off.dtype == torch.uint8 and off.shape == on.shape
    assert np.array_equal(off.numpy(), on.numpy())


def test_chip_smoke_counts_no_span_as_device_work():
    """A profiled stretch by hand: a kernel (10-30 us) and a device-to-host
    copy (30-35 us) on the device, and the spans around them mirrored
    there as user annotations, nested (`lives.frame` over
    `lives.plan.launch`): the smoke run's busy time, kernel and copy
    counts read the kernel and the copy alone."""
    import chip_smoke as cs

    def ev(name, start, end, annotation=False):
        return SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            is_user_annotation=annotation,
            time_range=SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))
    prof = SimpleNamespace(events=lambda: [
        ev("fused_sweep_kernel", 10, 30),
        ev("Memcpy DtoH (Device -> Pageable)", 30, 35),
        ev("lives.frame", 0, 40, annotation=True),
        ev("lives.plan.launch", 8, 32, annotation=True)])
    assert [e.name for e in cs.device_events(prof)] == [
        "fused_sweep_kernel", "Memcpy DtoH (Device -> Pageable)"]
    busy, top = cs.device_busy(prof)
    assert busy == pytest.approx(25e-3)
    assert "lives." not in top
    assert cs.dtoh_copies(prof) == 1
