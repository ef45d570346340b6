"""The CUDA kernels against their plain versions, on a GPU: the fused
sweep in its four modes, the fused stateful sweep, the colour kernels,
the composite kernel and K6, the fused-multiply-add probe (within a
relative error of K * 2^-23); and the live path (`FrameGraph.run`,
`GeneratorClip`) on the card against the CPU.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor lives_tpu, so they also run where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py configures jax for the rest of the suite.) Kernel and
plain version get the same inputs on the card and agree to +/-1 LSB:
both compute in float32, the fused sweep with fused multiply-adds and
CUDA's own expf; an f32 comp within 1/255; the stateful sweep's states
within 1e-5 (f32) or exactly (life's u8 cells)."""

import random

import numpy as np
import pytest
import torch

from lives_tpu_torch.effects.builtin.blends import _BLEND_MODES
from lives_tpu_torch.effects.host import get_filter, instantiate
from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
from lives_tpu_torch.events.renderer import (_chain_for, _interp_arrays,
                                             render_to_arrays,
                                             segment_events)
from lives_tpu_torch.graph import SinkSpec, fused_sweep, stateful_sweep
from lives_tpu_torch.graph.nodemodel import (_split_params, chain_spec_of,
                                             pack_params)
from lives_tpu_torch.scenes import DeviceSyntheticSource, multitrack_timeline

TRANSITIONS = ["crossfade", "blend_screen", "blend_overlay", "blend_add",
               "blend_multiply", "blend_lighten", "blend_difference",
               "blend_darken", "crossfade"]


def config_chain(make, cfg, n_tracks=3):
    """The chains of configs A, B and C (benchmarks/render_stateful_led.py
    :43-60, benchmarks/render_stateful.py:34-40) at `n_tracks` tracks, and
    the chains of tests/test_stateful_fused.py:18-65 that lie inside the
    port's vocabulary (life with saturation for brightness_contrast)."""
    def inst(name, tracks=None, enabled=True, **vals):
        i = make(name, **vals)
        i.enabled = enabled
        if tracks:
            i.in_tracks = tracks
        return i
    if cfg == "B":
        return [inst("crossfade", (0, 1), amount=0.6),
                inst("vignette", amount=0.5),
                inst("rgb_delay", delay_r=0.0, delay_g=1.0, delay_b=2.0),
                inst("fire", threshold=0.6),
                inst("saturation", saturation=1.2)]
    if cfg in ("A", "C"):
        chain = [inst("fire", threshold=0.6),
                 inst("alien_overlay") if cfg == "C" else
                 inst("rgb_delay", delay_r=0.0, delay_g=1.0, delay_b=2.0)]
        chain += [inst(TRANSITIONS[(t - 1) % 9], (0, t), amount=0.5)
                  for t in range(1, n_tracks)]
        return chain + [inst("saturation", saturation=1.2),
                        inst("vignette", amount=0.5)]
    return {
        "fire_led": lambda: [inst("fire", threshold=0.4, cooling=0.2),
                             inst("crossfade", (0, 1), amount=0.6),
                             inst("saturation", saturation=1.2),
                             inst("vignette", amount=0.5)],
        "alien": lambda: [inst("alien_overlay"),
                          inst("crossfade", (0, 1), amount=0.4),
                          inst("saturation", saturation=1.1)],
        "life": lambda: [inst("life", threshold=0.15, amount=0.5),
                         inst("saturation", saturation=1.2)],
        "multi": lambda: [inst("fire", threshold=0.5),
                          inst("alien_overlay"),
                          inst("crossfade", (0, 1), amount=0.5),
                          inst("vignette", amount=0.4)],
        "stencil_after": lambda: [inst("fire", threshold=0.5),
                                  inst("gaussian_blur", radius=2.0),
                                  inst("saturation", saturation=1.2)],
        "life_blur": lambda: [inst("life", threshold=0.15, amount=0.5),
                              inst("gaussian_blur", radius=2.0)],
        "alien_blur": lambda: [inst("alien_overlay"),
                               inst("box_blur", radius=2.0)],
        "stencil_before": lambda: [inst("gaussian_blur", radius=2.0),
                                   inst("fire", threshold=0.5),
                                   inst("saturation", saturation=1.2)],
        "sandwich": lambda: [inst("gaussian_blur", radius=2.0),
                             inst("life", threshold=0.15, amount=0.5),
                             inst("box_blur", radius=1.0)],
        # a disabled stateful step: the prefix takes the whole chain
        "disabled": lambda: [inst("crossfade", (0, 1), amount=0.6),
                             inst("fire", enabled=False),
                             inst("saturation", saturation=1.2)],
    }[cfg]()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    return torch.device("cuda")


def _check(plan, ids, packed):
    before = fused_sweep.LAUNCHES
    got = fused_sweep.fused_sweep(plan, ids, packed)
    torch.cuda.synchronize()
    assert fused_sweep.LAUNCHES == before + 1
    ref = fused_sweep.plain_sweep(plan, ids, packed)
    assert got.shape == ref.shape and got.dtype == torch.uint8
    diff = (got.int() - ref.int()).abs().max().item()
    assert diff <= 1, diff


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,n_tracks,B", [
    (256, 48, 4, 4), (100, 37, 3, 3), (1920, 1080, 10, 2), (33, 7, 10, 2)])
def test_main_chain_kernel_matches_plain(cuda, w, h, n_tracks, B):
    el = multitrack_timeline(n_tracks=n_tracks, n_frames=B + 5, width=w,
                             height=h, fps=30.0)
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[3:3 + B]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(_interp_arrays(el, inits, chain, tcs),
                               np.asarray(tcs) / TICKS_PER_SECOND,
                               np.arange(3, 3 + B))
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), n_tracks, h, w, rows, 30.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(ids).to(cuda),
           torch.from_numpy(packed).to(cuda))


CHAINS = {
    "empty": [],
    "multi_stencil": [("crossfade", {"amount": 0.4}, (0, 1)),
                      ("gaussian_blur", {"radius": 2, "amount": 0.8}, (0,)),
                      ("sharpen", {"radius": 1, "amount": 0.5}, (0,)),
                      ("vignette", {"amount": 0.5}, (0,))],
    "box_r16_sharpen": [("box_blur", {"radius": 16, "amount": 0.9}, (0,)),
                        ("sharpen", {"radius": 3, "amount": 3.0}, (0,))],
    "all_blends": [(n, {"amount": 0.3 + 0.05 * i}, (0, 1 + i % 2))
                   for i, n in enumerate(_BLEND_MODES)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("w,h", [(160, 72), (70, 45)])
def test_chain_kernel_matches_plain(cuda, name, w, h):
    """Default parameter rows (no traced params): each slot takes its
    constant; three tracks, one of them blank (clip id -1)."""
    chain = []
    for n, vals, tracks in CHAINS[name]:
        inst = instantiate(n, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    B = 3
    packed = np.stack([np.linspace(0, 0.1, B), np.arange(B)]).astype(
        np.float32)
    ids = np.array([[[1, 2, 3], [4, -1, 6], [7, 8, 9]],
                    [[0, 1, 2], [3, 4, 5], [6, 7, 8]]], np.int32)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 3, h, w, (), 25.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(ids).to(cuda),
           torch.from_numpy(packed).to(cuda))


@pytest.mark.cuda
def test_render_launches_once_per_chunk(cuda):
    el = multitrack_timeline(n_tracks=4, n_frames=10, width=128, height=40,
                             fps=25.0)
    before = fused_sweep.LAUNCHES
    arr, _ = render_to_arrays(el, DeviceSyntheticSource(40, 128, device=cuda),
                              SinkSpec(128, 40), batch_size=4)
    assert fused_sweep.LAUNCHES - before == 3
    assert arr.shape == (10, 3, 40, 128)


@pytest.mark.cuda
def test_wrapper_refuses_wrong_inputs(cuda):
    el = multitrack_timeline(n_tracks=2, n_frames=2, width=64, height=16)
    seg = segment_events(el)[0]
    _, chain = _chain_for(seg.inits, el)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 2, 16, 64, (), 30.0,
        DeviceSyntheticSource(16, 64, device=cuda), SinkSpec(64, 16), cuda)
    ids = torch.zeros((2, 2, 2), dtype=torch.int32, device=cuda)
    packed = torch.zeros((2, 2), device=cuda)
    with pytest.raises(TypeError):
        fused_sweep.fused_sweep(plan, ids.long(), packed)
    with pytest.raises(ValueError):
        fused_sweep.fused_sweep(plan, ids[:, :1], packed)
    with pytest.raises(ValueError):
        fused_sweep.fused_sweep(plan, ids, packed[:1])


_POINT = ["crossfade", *_BLEND_MODES, "luma_key", "chroma_key",
          "colour_balance", "saturation", "vignette"]


def random_chain(seed: int, n_tracks: int):
    """A random chain inside the sweep kernel's contract, as (name, values,
    in_tracks) items: 2-6 point ops on any tracks (a single-input op may
    read another track into track 0), then 0-2 stencils of r 1..4, each
    maybe followed by a single-input op on track 0. Every numeric value is
    drawn inside its range."""
    rng = random.Random(seed)

    def values(name, **fixed):
        return {**{p.name: rng.uniform(p.min, p.max)
                   for p in get_filter(name).params if p.kind == "num"},
                **fixed}
    items = []
    for _ in range(rng.randint(2, 6)):
        name = rng.choice(_POINT)
        n_in = get_filter(name).n_in
        items.append((name, values(name),
                      tuple(rng.randrange(n_tracks) for _ in range(n_in))))
    for _ in range(rng.randint(0, 2)):
        name = rng.choice(["gaussian_blur", "box_blur", "sharpen"])
        items.append((name, values(name, radius=rng.randint(1, 4)), (0,)))
        if rng.random() < 0.7:
            post = rng.choice(["colour_balance", "saturation", "vignette"])
            items.append((post, values(post), (0,)))
    return items


def instances(items):
    chain = []
    for name, vals, tracks in items:
        inst = instantiate(name, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    return chain


#: (2, T=4, B=3) clip ids (one blank track) and frame numbers
RANDOM_IDS = np.array([[[1, 2, 3], [5, -1, 7], [9, 10, 11], [40, 3, 17]],
                       [[0, 1, 2], [3, 4, 5], [6, 7, 8], [299, 0, 150]]],
                      np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_random_chain_kernel_matches_plain(cuda, seed):
    chain = instances(random_chain(seed, 4))
    B = RANDOM_IDS.shape[2]
    packed, rows = pack_params(
        [{k: np.full(B, v, np.float32)
          for k, v in _split_params(i)[1].items()} for i in chain],
        np.arange(B) / 25.0, np.arange(B))
    h, w = 45, 70
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 4, h, w, rows, 25.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(RANDOM_IDS).to(cuda),
           torch.from_numpy(packed).to(cuda))


def _main_chunk(w, h, n_tracks, B, device):
    """The benchmark timeline's chain and frames 3..3+B on `device`."""
    el = multitrack_timeline(n_tracks=n_tracks, n_frames=B + 5, width=w,
                             height=h, fps=30.0)
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[3:3 + B]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(_interp_arrays(el, inits, chain, tcs),
                               np.asarray(tcs) / TICKS_PER_SECOND,
                               np.arange(3, 3 + B))
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    return (chain_spec_of(chain), rows, torch.from_numpy(ids).to(device),
            torch.from_numpy(packed).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["comp_out", "comp_in"])
@pytest.mark.parametrize("w,h,n_tracks,B", [
    (256, 48, 4, 4), (100, 37, 3, 3), (1920, 1080, 10, 2), (33, 7, 10, 2)])
def test_comp_modes_match_plain(cuda, mode, w, h, n_tracks, B):
    """comp-out over the whole 13-effect chain (its f32 comp within
    1/255); comp-in over its point ops (the chain less the blur) reading a
    random comp (u8 within 1 LSB)."""
    spec, rows, ids, packed = _main_chunk(w, h, n_tracks, B, cuda)
    src = DeviceSyntheticSource(h, w, device=cuda)
    comp = None
    if mode == "comp_in":
        spec = [s for s in spec if s[0].name != "gaussian_blur"]
        comp = torch.rand((B, 3, h, w), device=cuda,
                          generator=torch.Generator(cuda).manual_seed(w))
    plan = fused_sweep.build_fused_sweep(
        spec, n_tracks, h, w, rows, 30.0, src, SinkSpec(w, h), cuda,
        emit="comp" if mode == "comp_out" else "u8",
        consume="comp" if mode == "comp_in" else None)
    assert plan is not None and plan.mode == mode
    before = fused_sweep.MODE_LAUNCHES[mode]
    got = fused_sweep.fused_sweep(plan, ids, packed, comp)
    torch.cuda.synchronize()
    assert fused_sweep.MODE_LAUNCHES[mode] == before + 1
    ref = fused_sweep.plain_sweep(plan, ids, packed, comp)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = (got.double() - ref.double()).abs().max().item()
    assert diff <= (1 / 255 if mode == "comp_out" else 1), diff


STATEFUL_KINDS = ["C", "fire_led", "alien", "life", "multi",
                  "stencil_after", "life_blur", "alien_blur",
                  "stencil_before", "sandwich"]


def _stateful_inputs(chain, n_tracks, B, k, rng, device):
    """Chunk k: clip ids (one blank track), frame numbers, and per-frame
    parameters drawn inside their ranges."""
    ids = np.zeros((2, n_tracks, B), np.int32)
    for t in range(n_tracks):
        ids[0, t] = t + 1
    ids[0, n_tracks - 1, 1] = -1
    ids[1] = np.arange(B) + k * B
    params = [{n: rng.uniform(inst.filter.param(n).min,
                              inst.filter.param(n).max, B).astype(np.float32)
               for n in _split_params(inst)[1]} for inst in chain]
    packed, rows = pack_params(params, (np.arange(B) + k * B) / 30.0,
                               np.arange(B) + k * B)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(packed).to(device), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(128, 32), (45, 37)])
@pytest.mark.parametrize("kind", STATEFUL_KINDS)
def test_stateful_kernel_matches_plain(cuda, kind, w, h):
    """Two chunks of 4 frames from the filters' initial states: frames
    within 1 LSB, the carried states within 1e-5 (f32) or exact (u8)."""
    chain = config_chain(instantiate, kind)
    rng = np.random.default_rng(7)
    src = DeviceSyntheticSource(h, w, device=cuda)
    ids, packed, rows = _stateful_inputs(chain, 3, 4, 0, rng, cuda)
    plan = stateful_sweep.build_stateful_sweep(
        chain_spec_of(chain), 3, h, w, rows, 30.0, src, SinkSpec(w, h), cuda)
    assert plan is not None
    st_k = [i.filter.init_state(w, h, None, cuda) if i.filter.init_state
            else None for i in chain]
    st_p = list(st_k)
    for k in range(2):
        if k:
            ids, packed, _ = _stateful_inputs(chain, 3, 4, k, rng, cuda)
        before = stateful_sweep.LAUNCHES
        got, st_k = stateful_sweep.stateful_sweep(plan, ids, packed, st_k)
        torch.cuda.synchronize()
        assert stateful_sweep.LAUNCHES == before + 1  # one launch a chunk
        ref, st_p = stateful_sweep.plain_stateful_sweep(plan, ids, packed,
                                                        st_p)
        assert (got.int() - ref.int()).abs().max().item() <= 1
        for i, _, kind_ in plan.state_steps:
            d = (st_k[i].double() - st_p[i].double()).abs().max().item()
            assert d <= (0 if kind_ == "u8hw" else 1e-5), (i, d)


def _stateful_chunks(chain, w, h, device, geom=None, n_tracks=3):
    """Two chunks of 4 frames of `chain` through the kernel (at `geom`,
    (tile, run), or the launch's own geometry) and its plain version from
    the filters' initial states: (plan, max |frame diff|, max |state diff|
    of the f32 states, of the u8 states)."""
    rng = np.random.default_rng(7)
    src = DeviceSyntheticSource(h, w, device=device)
    ids, packed, rows = _stateful_inputs(chain, n_tracks, 4, 0, rng, device)
    plan = stateful_sweep.build_stateful_sweep(
        chain_spec_of(chain), n_tracks, h, w, rows, 30.0, src,
        SinkSpec(w, h), device)
    assert plan is not None
    g = stateful_sweep.plan_geometry(plan, 4, *geom) if geom else None
    st_k = [i.filter.init_state(w, h, None, device) if i.filter.init_state
            else None for i in chain]
    st_p = list(st_k)
    frames = f32 = u8 = 0.0
    for k in range(2):
        if k:
            ids, packed, _ = _stateful_inputs(chain, n_tracks, 4, k, rng,
                                              device)
        got, st_k = stateful_sweep._launch(plan, ids, packed, st_k, g)
        torch.cuda.synchronize()
        ref, st_p = stateful_sweep.plain_stateful_sweep(plan, ids, packed,
                                                        st_p)
        frames = max(frames, (got.int() - ref.int()).abs().max().item())
        for i, _, kind_ in plan.state_steps:
            d = (st_k[i].double() - st_p[i].double()).abs().max().item()
            if kind_ == "u8hw":
                u8 = max(u8, d)
            else:
                f32 = max(f32, d)
    return plan, frames, f32, u8


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(1920, 1080), (45, 37)])
def test_stateful_kernel_at_the_largest_halo(cuda, w, h):
    """K5 at the largest summed halo it takes (blur r=16 + fire + blur
    r=16: 33) and with life in the middle: frames within 1 LSB, f32 states
    within 1e-5, u8 states exact."""
    for middle in (instantiate("fire", threshold=0.5),
                   instantiate("life", threshold=0.15, amount=0.5)):
        chain = [instantiate("gaussian_blur", radius=16.0), middle,
                 instantiate("box_blur", radius=16.0),
                 instantiate("saturation", saturation=1.2)]
        plan, frames, f32, u8 = _stateful_chunks(chain, w, h, cuda)
        assert plan.halo == 33
        assert frames <= 1 and f32 <= 1e-5 and u8 == 0, (frames, f32, u8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["C", "sandwich", "life", "alien_blur"])
def test_stateful_geometries_match_plain(cuda, kind):
    """K5 at every tile of `TILES` and both runs on a ragged 70x45 frame:
    frames within 1 LSB, states within 1e-5 (f32) or exact (u8)."""
    chain = config_chain(instantiate, kind)
    for tile in fused_sweep.TILES:
        for run in (8, 4):
            _, frames, f32, u8 = _stateful_chunks(chain, 70, 45, cuda,
                                                  (tile, run))
            assert frames <= 1 and f32 <= 1e-5 and u8 == 0, (tile, run)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_stateful,want", [
    ("0", {"comp_in": 2, "stateful": 0}),
    ("1", {"comp_in": 0, "stateful": 2})])
def test_stateful_render_routes(cuda, monkeypatch, fused_stateful, want):
    """Config C through render_events: the 3-phase route launches the
    comp-in sweep once a chunk; under the pref the stateful sweep launches
    once a chunk (one cooperative launch for its 5 frames) and no fused
    sweep runs."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    monkeypatch.setenv("LIVES_TPU_FUSED_STATEFUL", fused_stateful)
    el = EventList(fps=30.0, width=64, height=24)
    inits = [filter_init_event(0, i.filter.name, in_tracks=list(i.in_tracks),
                               values=dict(i.values))
             for i in config_chain(instantiate, "C")]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    for i in range(10):
        el.insert(frame_event(i * int(TICKS_PER_SECOND / 30), [1, 2, 3],
                               [i] * 3))
    before = (dict(fused_sweep.MODE_LAUNCHES), stateful_sweep.LAUNCHES)
    arr, _ = render_to_arrays(el, DeviceSyntheticSource(24, 64, device=cuda),
                              SinkSpec(64, 24), batch_size=5)
    assert arr.shape == (10, 3, 24, 64)
    assert {"comp_in": fused_sweep.MODE_LAUNCHES["comp_in"]
            - before[0]["comp_in"],
            "stateful": stateful_sweep.LAUNCHES - before[1]} == want
    assert fused_sweep.MODE_LAUNCHES["u8"] == before[0]["u8"]


# -- the colour kernels K2 and K3, the composite kernel K4 ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("run", [16, 8])     # yuv_kernels.RUNS
@pytest.mark.parametrize("subspace", [1, 2])   # BT.601, BT.709
@pytest.mark.parametrize("clamping", [0, 1])   # clamped, full range
@pytest.mark.parametrize("B,h,w", [
    (2, 1080, 1920),   # every access as wide as the run allows
    (3, 562, 1000),    # rows of 1000 and 500 bytes: widths 8 and 4
    (2, 36, 1004),     # 1004 and 502: widths 4 and 1
    (2, 34, 1002),     # 1002 and 501: single bytes
    (2, 20, 994),      # 994 and 497: single bytes, a run cut at 2 pixels
    (1, 2, 2), (2, 34, 66),
    (1, 4, 16400),     # a row pair over 1024 runs: 2 or 3 blocks
    (96, 1080, 1920)])  # a main-path chunk
def test_colour_kernels_match_plain(cuda, monkeypatch, B, h, w, clamping,
                                    subspace, run):
    """K2 within 1 LSB of `plain_yuv420_to_rgb` (both round every multiply
    and add alone, so it is 0 in practice), K3 integer-identical to
    `plain_rgb_to_yuv420`, RGB and RGBA input, odd heights and widths
    included (K3 then takes single bytes); each launch counted once, at
    runs of 16 and 8 pixels. The widths cover every access width of
    csrc/yuv420.cu and rows a run does not fill."""
    from lives_tpu_torch.ops import yuv_kernels as yk
    monkeypatch.setattr(yk, "RUN", run)
    g = torch.Generator(cuda).manual_seed(h * w + clamping)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                             generator=g)
    y, u, v = rand(B, h, w), rand(B, h // 2, w // 2), rand(B, h // 2, w // 2)
    before = dict(yk.LAUNCHES)
    got = yk.yuv420_to_rgb(y, u, v, subspace, clamping)
    torch.cuda.synchronize()
    assert yk.LAUNCHES["yuv420_to_rgb"] == before["yuv420_to_rgb"] + 1
    ref = yk.plain_yuv420_to_rgb(y, u, v, subspace, clamping)
    assert got.shape == (B, 3, h, w)
    worst = (got.int() - ref.int()).abs().max().item()
    assert worst <= 1, f"K2 max |diff| {worst}"
    del y, u, v, got, ref
    cases = ((3, h, w), (4, h, w), (4, h + 1, w + 1), (3, h + 1, w))
    for C, hh, ww in cases:
        rgb = rand(B, C, hh, ww)
        got = yk.rgb_to_yuv420(rgb, subspace, clamping)
        torch.cuda.synchronize()
        ref = yk.plain_rgb_to_yuv420(rgb, subspace, clamping)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and torch.equal(a, b), (C, hh, ww)
    assert yk.LAUNCHES["rgb_to_yuv420"] == \
        before["rgb_to_yuv420"] + len(cases)


@pytest.mark.cuda
def test_yuv_kernel_reads_strided_planes(cuda):
    """Planes that are views of one (B, frame bytes) upload, as a decoded
    chunk could be: K2 reads them in place; unbatched planes too."""
    from lives_tpu_torch.ops import yuv_kernels as yk
    B, h, w = 3, 36, 50
    fs = h * w * 3 // 2
    buf = torch.randint(0, 256, (B, fs + 7), dtype=torch.uint8, device=cuda)
    y = buf[:, :h * w].view(B, h, w)
    u = buf[:, h * w:h * w + fs // 6].view(B, h // 2, w // 2)
    v = buf[:, h * w + fs // 6:fs].view(B, h // 2, w // 2)
    got = yk.yuv420_to_rgb(y, u, v)
    torch.cuda.synchronize()
    assert torch.equal(got, yk.plain_yuv420_to_rgb(
        y.contiguous(), u.contiguous(), v.contiguous()))
    assert torch.equal(yk.yuv420_to_rgb(y[1], u[1], v[1]), got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("run", [16, 8])
@pytest.mark.parametrize("off", [0, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("h,w", [(36, 1920), (22, 1000), (9, 47)])
def test_colour_kernels_read_views_at_byte_offsets(cuda, monkeypatch, off,
                                                   run, h, w):
    """K2 over Y, U and V that are views at byte offset `off` of one packed
    upload (frame after frame), and K3 over an RGBA chunk that is a view
    at that offset: the launch takes the access width every pointer and
    stride allows (single bytes at offsets 1-3), K2 within 1 LSB and K3
    bit for bit their plain versions on the contiguous copies."""
    from lives_tpu_torch.ops import yuv_kernels as yk
    monkeypatch.setattr(yk, "RUN", run)
    g = torch.Generator(cuda).manual_seed(off * 131 + w)
    B = 3
    if h % 2 == 0 and w % 2 == 0:
        fs = h * w * 3 // 2
        buf = torch.randint(0, 256, (B * fs + 16,), dtype=torch.uint8,
                            device=cuda, generator=g)
        flat = buf[off:off + B * fs].view(B, fs)
        y = flat[:, :h * w].view(B, h, w)
        u = flat[:, h * w:h * w + fs // 6].view(B, h // 2, w // 2)
        v = flat[:, h * w + fs // 6:].view(B, h // 2, w // 2)
        got = yk.yuv420_to_rgb(y, u, v)
        torch.cuda.synchronize()
        ref = yk.plain_yuv420_to_rgb(y.contiguous(), u.contiguous(),
                                     v.contiguous())
        assert (got.int() - ref.int()).abs().max().item() <= 1
    buf = torch.randint(0, 256, (B * 4 * h * w + 16,), dtype=torch.uint8,
                        device=cuda, generator=g)
    rgba = buf[off:off + B * 4 * h * w].view(B, 4, h, w)
    got = yk.rgb_to_yuv420(rgba)
    torch.cuda.synchronize()
    for a, b in zip(got, yk.plain_rgb_to_yuv420(rgba.contiguous())):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,n_tracks", [(4, 1080, 1920, 10),
                                            (3, 37, 100, 3), (2, 1, 1, 2)])
@pytest.mark.parametrize("seed", range(3))
def test_composite_kernel_matches_plain(cuda, B, h, w, n_tracks, seed):
    """K4 against `plain_composite` on random prefixes of its vocabulary
    (per-frame parameters drawn past their max, which both clamp): within
    1 LSB; one launch counted."""
    from lives_tpu_torch.graph import composite
    rng = np.random.default_rng(seed)
    names = sorted(composite.VOCABULARY)
    chain = []
    for _ in range(9):
        inst = instantiate(names[rng.integers(len(names))])
        inst.in_tracks = tuple(int(t) for t in
                               rng.integers(0, n_tracks, inst.filter.n_in))
        chain.append(inst)
    chain[2].enabled = False
    params = [{k: rng.uniform(i.filter.param(k).min,
                              i.filter.param(k).max * 1.2, B)
               .astype(np.float32) for k in _split_params(i)[1]}
              for i in chain]
    packed, rows = pack_params(params, np.arange(B) / 30.0, np.arange(B))
    plan = composite.build_composite(chain_spec_of(chain), n_tracks, rows,
                                     30.0, cuda)
    g = torch.Generator(cuda).manual_seed(seed)
    tracks = [torch.randint(0, 256, (B, 3, h, w), dtype=torch.uint8,
                            device=cuda, generator=g)
              for _ in range(n_tracks)]
    packed = torch.from_numpy(packed).to(cuda)
    before = composite.LAUNCHES
    got = composite.composite(plan, tracks, packed)
    torch.cuda.synchronize()
    assert composite.LAUNCHES == before + 1
    ref = composite.plain_composite(plan, tracks, packed)
    assert (got.int() - ref.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 45), (1080, 1920), (1, 3)])
def test_composite_kernel_unaligned_tracks(cuda, h, w):
    """K4 on frames whose H*W is no multiple of 16 (37x45, 1x3; 1080p is
    one), on tracks that are views at byte offsets 0-3 and on a prefix that
    reads track 1 three times and track 2 twice: within 1 LSB of
    `plain_composite`; the plan stages each track once."""
    from lives_tpu_torch.graph import composite
    items = [("crossfade", (0, 1)), ("blend_screen", (0, 1)),
             ("chroma_key", (2, 0)), ("luma_key", (1, 2)),
             ("saturation", (0,))]
    chain = instances([(n, {}, tr) for n, tr in items])
    rng = np.random.default_rng(h * w)
    B = 2
    params = [{k: rng.uniform(i.filter.param(k).min, i.filter.param(k).max,
                              B).astype(np.float32)
               for k in _split_params(i)[1]} for i in chain]
    packed, rows = pack_params(params, np.arange(B) / 30.0, np.arange(B))
    plan = composite.build_composite(chain_spec_of(chain), 3, rows, 30.0,
                                     cuda)
    assert plan.tracks_read == (0, 1, 2)
    packed = torch.from_numpy(packed).to(cuda)
    g = torch.Generator(cuda).manual_seed(h)
    flat = [torch.randint(0, 256, (B * 3 * h * w + 3,), dtype=torch.uint8,
                          device=cuda, generator=g) for _ in range(3)]
    for off in range(4):
        tracks = [f[off:off + B * 3 * h * w].view(B, 3, h, w) for f in flat]
        ref = composite.plain_composite(plan, tracks, packed)
        before = composite.LAUNCHES
        got = composite.composite(plan, tracks, packed)
        torch.cuda.synchronize()
        assert composite.LAUNCHES == before + 1
        diff = (got.int() - ref.int()).abs().max().item()
        assert diff <= 1, (off, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("n_read,span", [(7, 4096), (10, 2048), (15, 1024),
                                         (29, 512), (64, 256)])
def test_composite_kernel_every_span(cuda, n_read, span):
    """K4 at each span of `composite.SPANS`, reached by the number of tracks
    a prefix reads (a chain of crossfades, track 0 with each other track),
    over a 1080p frame and a ragged 37x45 one at a byte offset of 1: within
    1 LSB of `plain_composite`."""
    from lives_tpu_torch.graph import composite
    chain = instances([("crossfade", {"amount": 0.3 + 0.01 * t}, (0, t))
                       for t in range(1, n_read)])
    plan = composite.build_composite(chain_spec_of(chain), n_read, (), 30.0,
                                     cuda)
    assert len(plan.tracks_read) == n_read
    packed = torch.zeros((2, 2), device=cuda)
    g = torch.Generator(cuda).manual_seed(n_read)
    for h, w, off in ((1080, 1920, 0), (37, 45, 1)):
        assert composite.plan_geometry(plan, 2, h, w).span == span
        tracks = [torch.randint(0, 256, (2 * 3 * h * w + off,),
                                dtype=torch.uint8, device=cuda,
                                generator=g)[off:].view(2, 3, h, w)
                  for _ in range(n_read)]
        got = composite.composite(plan, tracks, packed)
        torch.cuda.synchronize()
        ref = composite.plain_composite(plan, tracks, packed)
        assert (got.int() - ref.int()).abs().max().item() <= 1, (h, w)


def _decoded_clips(tmp_path, n_clips, n_frames, h, w):
    """Y4M clips of synthetic-source frames, opened, unique_id = 1.."""
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.decoders import write_y4m
    from lives_tpu_torch.ops.colorspace import convert_layer
    src = DeviceSyntheticSource(h, w, device="cpu")
    clips = {}
    for c in range(1, n_clips + 1):
        yuv = convert_layer(src.get_batch([c] * n_frames, range(n_frames)),
                            Palette.YUV420P).planes
        path = tmp_path / f"c{c}.y4m"
        write_y4m(str(path), [tuple(p[i].numpy() for p in yuv)
                              for i in range(n_frames)], 30.0)
        clips[c] = open_clip(str(path), tmp_path / "work")
        clips[c].unique_id = c
    return clips


@pytest.mark.cuda
def test_clip_source_converts_on_the_card(cuda, tmp_path, monkeypatch):
    """`ClipFrameSource` on a CUDA device: every conversion sees CUDA
    planes (none on the host), one K2 launch a track chunk, and the frames
    equal the CPU source's (the plain version)."""
    from lives_tpu_torch.events import renderer
    from lives_tpu_torch.ops import yuv_kernels as yk
    clips = _decoded_clips(tmp_path, 3, 6, 36, 50)
    seen = []
    real = renderer.convert_layer
    monkeypatch.setattr(renderer, "convert_layer", lambda l, p: (
        seen.append(l.device.type), real(l, p))[1])
    src = renderer.ClipFrameSource(clips, device=cuda)
    before = yk.LAUNCHES["yuv420_to_rgb"]
    got = src.get_batch([1, 2, 3, 99], [0, 5, 2, 0])
    torch.cuda.synchronize()
    assert seen == ["cuda"] and got.device.type == "cuda"
    assert yk.LAUNCHES["yuv420_to_rgb"] == before + 1
    ref = renderer.ClipFrameSource(clips, device="cpu").get_batch(
        [1, 2, 3, 99], [0, 5, 2, 0])
    assert torch.equal(got.planes[0].cpu(), ref.planes[0])
    assert not ref.planes[0][3].any()  # the missing clip: a blank frame


@pytest.mark.cuda
@pytest.mark.parametrize("pref,k4", [("1", 2), ("0", 0)])
def test_decoded_render_to_encoder_launches(cuda, tmp_path, monkeypatch,
                                            pref, k4):
    """Config D at 4 tracks from decoded clips into a YUV4MPEG file on the
    card: K2 once a track a chunk, K4 once a chunk under the pref, K3 once a
    chunk (the encoder gets each chunk whole); the file's frames match the
    same render on the CPU (plain versions) within 1 LSB."""
    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.graph import composite
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.transcode import render_to_encoder
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", pref)
    h, w = 36, 50
    clips = _decoded_clips(tmp_path, 4, 6, h, w)
    el = multitrack_timeline(n_tracks=4, n_frames=8, width=w, height=h,
                             fps=30.0)
    for e in el.frame_events():
        e.props["frames"] = [f % 6 for f in e.frames]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        before = (dict(yk.LAUNCHES), composite.LAUNCHES)
        path = tmp_path / f"out_{dev.type}.y4m"
        render_to_encoder(el, ClipFrameSource(clips, device=dev), str(path),
                          encoder="yuv4mpeg", batch_size=4)
        counts = (yk.LAUNCHES["yuv420_to_rgb"] - before[0]["yuv420_to_rgb"],
                  composite.LAUNCHES - before[1],
                  yk.LAUNCHES["rgb_to_yuv420"] - before[0]["rgb_to_yuv420"])
        assert counts == ((4 * 2, k4, 2) if dev.type == "cuda"
                          else (0, 0, 0)), counts
        cd = try_decoders(str(path))
        outs[dev.type] = [cd.decoder.get_frame(n).planes for n in range(8)]
        cd.decoder.close()
    for a, b in zip(outs["cuda"], outs["cpu"]):
        for p, q in zip(a, b):
            assert (p.int() - q.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,n_tracks,band_h", [
    (70, 45, 4, 15), (100, 90, 3, 30), (100, 90, 3, 45), (64, 61, 2, 13)])
def test_band_kernel_matches_whole_frame(cuda, w, h, n_tracks, band_h):
    """K1's band mode at every y0 (a ragged last band when band_h does not
    divide h) bit for bit against the same rows of the whole-frame kernel,
    and within 1 LSB of plain_band_sweep; the main chain holds a stencil
    and a coordinate effect."""
    spec, rows, ids, packed = _main_chunk(w, h, n_tracks, 3, cuda)
    args = (spec, n_tracks, h, w, rows, 30.0,
            DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    whole = fused_sweep.fused_sweep(fused_sweep.build_fused_sweep(*args),
                                    ids, packed)
    plan = fused_sweep.build_fused_sweep(*args, band_h=band_h)
    y0s = list(range(0, h - band_h + 1, band_h)) + [h - band_h]
    before = fused_sweep.MODE_LAUNCHES["band"]
    for y0 in y0s:
        band = fused_sweep.fused_sweep(plan, ids, packed, y0=y0)
        torch.cuda.synchronize()
        assert torch.equal(band, whole[:, :, y0:y0 + band_h]), y0
        ref = fused_sweep.plain_band_sweep(plan, ids, packed, y0)
        assert (band.int() - ref.int()).abs().max().item() <= 1
    assert fused_sweep.MODE_LAUNCHES["band"] == before + len(y0s)


@pytest.mark.cuda
def test_band_sweep_on_one_card_matches_run_batch(cuda):
    """spatial_sweep_fn on a 4-entry mesh of one card: one band launch a
    band, no whole-frame launch, frames bit for bit those of run_batch
    (the whole-frame kernel) on the same chunk."""
    from lives_tpu_torch.graph import FrameGraph
    from lives_tpu_torch.parallel import frame_mesh, spatial_sweep_fn
    w, h, n_tracks, B = 96, 68, 3, 3
    el = multitrack_timeline(n_tracks=n_tracks, n_frames=B, width=w,
                             height=h, fps=30.0)
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    tcs = [f.tc for f in seg.frames[:B]]
    params = _interp_arrays(el, inits, chain, tcs)
    tc_s, fnum = np.asarray(tcs) / TICKS_PER_SECOND, np.arange(B)
    packed, _ = pack_params(params, tc_s, fnum)
    ids = np.stack([np.array([f.clips for f in seg.frames[:B]]).T,
                    np.array([f.frames for f in seg.frames[:B]]).T]
                   ).astype(np.int32)
    graph = FrameGraph(chain, SinkSpec(w, h), fps=30.0)
    src = DeviceSyntheticSource(h, w, device=cuda)
    run = spatial_sweep_fn(graph, frame_mesh([cuda] * 4, axis="s"), src, B,
                           h, w, axis="s")
    before = dict(fused_sweep.MODE_LAUNCHES)
    out = run(torch.from_numpy(ids).to(cuda),
              torch.from_numpy(packed).to(cuda))
    torch.cuda.synchronize()
    assert fused_sweep.MODE_LAUNCHES["band"] == before["band"] + 4
    assert fused_sweep.MODE_LAUNCHES["u8"] == before["u8"]
    ref = graph.run_batch([], tc_s, fnum, params, source=src,
                          src_args=(ids[0], ids[1]))
    assert fused_sweep.MODE_LAUNCHES["u8"] == before["u8"] + 1
    assert torch.equal(out, ref.planes[0])


# -- K1's geometry: tiles, runs of pixels, ragged edges -------------------------

#: stencil radii of a chain of summed radius R > 3: two and three stencils
STACKS = {16: [8, 8], 33: [16, 16, 1]}


def _halo_case(halo, w, h, device, B=2):
    """(plan, ids, packed) of summed stencil radius `halo`: the main chain
    (R = 3) and the same without its blur (R = 0) at 4 tracks, or
    crossfade + stencils of `STACKS[halo]` with a vignette after the first
    (one track blank)."""
    src = DeviceSyntheticSource(h, w, device=device)
    if halo <= 3:
        spec, rows, ids, packed = _main_chunk(w, h, 4, B, device)
        if halo == 0:
            spec = [s for s in spec if s[0].name not in fused_sweep.STENCILS]
        plan = fused_sweep.build_fused_sweep(spec, 4, h, w, rows, 30.0, src,
                                             SinkSpec(w, h), device)
    else:
        items = [("crossfade", {"amount": 0.4}, (0, 1))]
        for i, r in enumerate(STACKS[halo]):
            items.append((("gaussian_blur", "sharpen", "box_blur")[i % 3],
                          {"radius": r, "amount": 0.7}, (0,)))
            if i == 0:
                items.append(("vignette", {"amount": 0.5}, (0,)))
        plan = fused_sweep.build_fused_sweep(
            chain_spec_of(instances(items)), 2, h, w, (), 30.0, src,
            SinkSpec(w, h), device)
        ids = torch.tensor([[[1, 2], [4, -1]], [[0, 1], [3, 4]]],
                           dtype=torch.int32, device=device)
        packed = torch.tensor([[0.0, 0.05], [0.0, 1.0]], device=device)
    assert plan is not None and plan.halo == halo
    return plan, ids, packed


def _geometries(plan, B):
    """The launch's own geometry, then every tile of TILES that fits a
    block's shared memory."""
    yield fused_sweep.plan_geometry(plan, B)
    for tile in fused_sweep.TILES:
        try:
            yield fused_sweep.plan_geometry(plan, B, tile)
        except ValueError:  # the tile's halo is over shared memory
            pass


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [0, 3, 16, 33])
@pytest.mark.parametrize("w,h", [(1000, 37), (1001, 70), (70, 45), (45, 70)])
def test_sweep_geometry_edges_match_plain(cuda, halo, w, h):
    """K1 at every tile on widths that are no multiple of a run or a tile
    and heights no multiple of a tile, summed R of 0, 3 (runs of 8), 16
    and 33 (runs of 4): within 1 LSB of plain_sweep, one launch counted
    each."""
    plan, ids, packed = _halo_case(halo, w, h, cuda)
    ref = fused_sweep.plain_sweep(plan, ids, packed)
    for geom in _geometries(plan, 2):
        before = fused_sweep.LAUNCHES
        got = fused_sweep._launch(plan, ids, packed, None, 0, geom)
        torch.cuda.synchronize()
        assert fused_sweep.LAUNCHES == before + 1
        diff = (got.int() - ref.int()).abs().max().item()
        assert diff <= 1, (geom, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [3, 33])
@pytest.mark.parametrize("w,h,band_h", [(1001, 75, 27), (1000, 130, 70),
                                        (45, 70, 33)])
def test_band_geometry_matches_whole_frame(cuda, halo, w, h, band_h):
    """Bands at first rows and heights that are no multiple of a tile's
    height, at every tile: bit for bit the rows of the whole frame at the
    launch's own geometry."""
    plan, ids, packed = _halo_case(halo, w, h, cuda)
    whole = fused_sweep.fused_sweep(plan, ids, packed)
    band = fused_sweep.build_fused_sweep(
        plan.chain_spec, plan.n_tracks, h, w, plan.rows_key, 30.0,
        plan.source, plan.sink, cuda, band_h=band_h)
    for geom in _geometries(band, 2):
        for y0 in (0, 5, (h - band_h) // 2, h - band_h):
            got = fused_sweep._launch(band, ids, packed, None, y0, geom)
            torch.cuda.synchronize()
            assert torch.equal(got, whole[:, :, y0:y0 + band_h]), (geom, y0)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1001, 1000, 70, 45])
def test_comp_in_ragged_width_matches_plain(cuda, w):
    """Comp-in over the main chain's point ops at every tile: a
    comp whose rows are 16-byte aligned (vector reads) or not (scalar),
    and a comp that is a view at an odd offset: within 1 LSB."""
    h, B = 37, 2
    spec, rows, ids, packed = _main_chunk(w, h, 4, B, cuda)
    spec = [s for s in spec if s[0].name not in fused_sweep.STENCILS]
    plan = fused_sweep.build_fused_sweep(
        spec, 4, h, w, rows, 30.0, DeviceSyntheticSource(h, w, device=cuda),
        SinkSpec(w, h), cuda, consume="comp")
    g = torch.Generator(cuda).manual_seed(w)
    flat = torch.rand((B * 3 * h * w + 1,), device=cuda, generator=g)
    for comp in (flat[:-1].view(B, 3, h, w), flat[1:].view(B, 3, h, w)):
        ref = fused_sweep.plain_sweep(plan, ids, packed, comp)
        for geom in _geometries(plan, B):
            got = fused_sweep._launch(plan, ids, packed, comp, 0, geom)
            torch.cuda.synchronize()
            diff = (got.int() - ref.int()).abs().max().item()
            assert diff <= 1, (geom, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (1_000_003,), (7,),
                                   (3, 5, 9)])
@pytest.mark.parametrize("K", [1, 32, 128])
def test_fma_chain_kernel_matches_plain(cuda, shape, K):
    """K6 against its plain version: one FFMA a step against a multiply
    and an add, within a relative error of K * 2^-23; lengths that are no
    multiple of 4 take the kernel's ragged tail."""
    from lives_tpu_torch.ops import fma_chain as fc
    g = torch.Generator(cuda).manual_seed(K)
    # magnitudes in [0.5, 1.5) of either sign: no value near 0, where a
    # relative error means nothing
    x = (torch.rand(shape, device=cuda, generator=g) + 0.5) \
        * (torch.randint(0, 2, shape, device=cuda, generator=g) * 2 - 1)
    before = fc.LAUNCHES
    got = fc.fma_chain(x, K)
    torch.cuda.synchronize()
    assert fc.LAUNCHES == before + 1
    ref = fc.plain_fma_chain(x, K)
    rel = ((got.double() - ref.double()).abs() / ref.double().abs()).max()
    assert rel.item() <= fc.tolerance(K), rel.item()


@pytest.mark.cuda
def test_fma_chain_refuses_wrong_inputs(cuda):
    from lives_tpu_torch.ops import fma_chain as fc
    x = torch.ones((3, 64, 64), device=cuda)
    before = fc.LAUNCHES
    with pytest.raises(TypeError):
        fc.fma_chain(x.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fma_chain(x.transpose(1, 2), 8)
    with pytest.raises(ValueError, match="aligned"):
        fc.fma_chain(x.reshape(-1)[1:], 8)
    assert fc.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("names", [["saturation", "vignette"], ["negate"],
                                   ["vignette", "brightness_contrast"], []])
def test_live_run_on_the_card_matches_cpu(cuda, names):
    """FrameGraph.run over [plasma, colour_bars] at 256x144: the card's
    frame within 1 LSB of the CPU's, every temporary on the card."""
    from lives_tpu_torch.graph import FrameGraph
    from lives_tpu_torch.io.genclip import GeneratorClip
    out = {}
    for dev in ("cpu", "cuda"):
        fg = GeneratorClip("plasma", 256, 144, fps=60.0, device=dev)
        bg = GeneratorClip("colour_bars", 256, 144, fps=60.0, device=dev)
        g = FrameGraph([instantiate(n) for n in names],
                       SinkSpec(width=256, height=144), fps=60.0)
        out[dev] = g.run([fg, bg], 37 / 60.0, 37).planes[0]
    assert out["cuda"].device.type == "cuda"
    assert out["cuda"].shape == (3, 144, 256)
    diff = (out["cuda"].cpu().int() - out["cpu"].int()).abs().max().item()
    assert diff <= 1, diff


@pytest.mark.cuda
def test_generator_clip_frame_lies_on_the_card(cuda):
    from lives_tpu_torch.graph import FrameGraph, GenSlot
    from lives_tpu_torch.io.genclip import GeneratorClip
    fg = GeneratorClip("plasma", 256, 144, fps=60.0)
    assert fg.device.type == "cuda"
    frame = fg.get_frame(5)
    assert frame.planes[0].device.type == "cuda"
    assert frame.planes[0].shape == (3, 144, 256)
    g = FrameGraph([instantiate("negate")])
    assert torch.equal(g.run([GenSlot(fg, 5)]).planes[0],
                       g.run([frame]).planes[0])


@pytest.mark.cuda
def test_live_run_device_params_on_the_card(cuda):
    """Traced values that are tensors on the card (the chain's and a
    generator's) are copied into the column there: the frame is the host
    numbers' bit for bit, and neither path makes a synchronizing call."""
    import warnings

    from lives_tpu_torch.graph import FrameGraph
    from lives_tpu_torch.io.genclip import GeneratorClip
    fg = GeneratorClip("plasma", 256, 144, fps=60.0, device=cuda)
    bg = GeneratorClip("colour_bars", 256, 144, fps=60.0, device=cuda)
    chain = [instantiate("saturation", saturation=1.6),
             instantiate("vignette", amount=0.3)]
    g = FrameGraph(chain, SinkSpec(width=256, height=144), fps=60.0)
    g.run([fg, bg], 0.0, 0)
    torch.cuda.synchronize()

    def watched(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]

    def run_watched():
        return watched(lambda: g.run([fg, bg], 37 / 60.0, 37).planes[0])

    _, syncs = watched(lambda: torch.ones(1, device=cuda).sum().item())
    assert syncs                      # the watch sees a sync where one is
    host, syncs = run_watched()
    assert not syncs, syncs
    for inst in (*chain, fg.inst):
        for k, v in _split_params(inst)[1].items():
            inst.values[k] = torch.tensor(float(v), device=cuda)
    dev, syncs = run_watched()
    assert not syncs, syncs
    assert len(g.stats) == 2
    assert torch.equal(dev, host)
