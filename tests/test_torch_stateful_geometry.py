"""The launch geometry of the fused stateful sweep (K5) and of the composite
kernel (K4), on the CPU.

`stateful_geometry` is the geometry `stateful_sweep._launch` passes to
csrc/stateful_sweep.cu: a tile of `TILES` and a run of 8 or 4 pixels,
chosen by phase-1 cells times the rounds of tiles a frame takes over the
blocks the card holds at once (on a card, the occupancy query's blocks an
SM times its SMs; here `h100`, the same numbers for an H100 SXM). The
chains the kernel takes are decided by its first
design's limit (`stateful_eligible`), unchanged: the expectations below are
literal, recorded from that rule (a summed halo up to 33). Every plan the
rule takes has a launch that fits a block's 227 KB.

`composite_geometry` sizes K4's staging (csrc/composite.cu): the distinct
tracks a prefix reads (`tracks_read`) and the span of pixels a block owns,
within a budget of staged bytes that keeps two blocks on an SM. The kernels
run only on a GPU (tests/test_torch_cuda.py)."""

import types

import pytest
import torch

from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.graph import SinkSpec, composite, fused_sweep
from lives_tpu_torch.graph import stateful_sweep
from lives_tpu_torch.graph.nodemodel import chain_spec_of
from lives_tpu_torch.scenes import DeviceSyntheticSource

H, W = 40, 96


def h100(g, sms=132):
    """The blocks of a K5 launch at `g` an H100 SXM holds at once: 132 SMs,
    two blocks an SM by the kernel's registers (its __launch_bounds__(256,
    2)), fewer where shared memory holds fewer; `sms` for another card."""
    return sms * min(2, fused_sweep.blocks_per_sm(g))


def _chain(items):
    chain = []
    for name, vals, tracks in items:
        inst = instantiate(name, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    return chain


def _plan(items, h=H, w=W, n_tracks=3):
    return stateful_sweep.build_stateful_sweep(
        chain_spec_of(_chain(items)), n_tracks, h, w, (), 30.0,
        DeviceSyntheticSource(h, w, device="cpu"), SinkSpec(w, h), "cpu")


FIRE = ("fire", {"threshold": 0.5}, (0,))
LIFE = ("life", {"threshold": 0.15}, (0,))
ALIEN = ("alien_overlay", {}, (0,))


def _blur(r, name="gaussian_blur"):
    return (name, {"radius": r}, (0,))


#: case -> (items, the rule's decision: Y or N, the plan's summed halo)
CASES = {
    "fire": ([FIRE], "Y", 1),
    "alien": ([ALIEN], "Y", 0),
    "life_fire_alien": ([LIFE, FIRE, ALIEN], "Y", 2),
    "config_c": ([FIRE, ALIEN, ("crossfade", {}, (0, 1)),
                  ("saturation", {}, (0,)), ("vignette", {}, (0,))], "Y", 1),
    "blur16_fire_blur16": ([_blur(16), FIRE, _blur(16, "box_blur")], "Y",
                           33),
    "sharpen16_box16_life": ([_blur(16, "sharpen"), _blur(16, "box_blur"),
                              LIFE], "Y", 33),
    "blur16_blur16_alien": ([_blur(16), _blur(16), ALIEN], "Y", 32),
    "blur11x3_fire": ([_blur(11), _blur(11), _blur(11), FIRE], "N", 34),
    "life_fire_blur16x2": ([LIFE, FIRE, _blur(16), _blur(16)], "N", 34),
    "blur16x3_alien": ([_blur(16), _blur(16), _blur(16), ALIEN], "N", 48),
    "no_stateful_step": ([_blur(3), ("saturation", {}, (0,))], "N", 3),
    "rgb_delay": ([("rgb_delay", {}, (0,)), FIRE], "N", 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stateful_eligibility_as_before(case):
    """The kernel takes what its first design took: any chain of its
    vocabulary with a stateful step whose summed halo (stencil radii, fire
    and life 1, alien_overlay 0) is 33 or less."""
    items, want, halo = CASES[case]
    plan = _plan(items)
    assert ("N" if plan is None else "Y") == want
    if plan is not None:
        assert plan.halo == halo


@pytest.mark.parametrize("n_steps", [1, 2, 3, 8])
def test_stateful_rule_is_the_first_designs_limit(n_steps):
    """`stateful_eligible` is the first design's shared memory (two
    3-channel buffers over a 32x32 tile plus the halo, with the slots)
    against a block's: true up to a summed halo of 33, false from 34, and
    `stateful_geometry` refuses exactly what it refuses."""
    for halo in range(64):
        ok = fused_sweep.stateful_eligible(halo, n_steps)
        assert ok == (halo <= 33)
        assert ok == (fused_sweep.stateful_smem_bytes(halo, n_steps)
                      + 4 * fused_sweep.MAX_SLOTS <= fused_sweep.SMEM_LIMIT)
        if ok:
            fused_sweep.stateful_geometry(1080, 1920, halo, 13, 0, h100,
                                          96)
        else:
            with pytest.raises(ValueError):
                fused_sweep.stateful_geometry(1080, 1920, halo, 13, 0, h100,
                                          96)


@pytest.mark.parametrize("h,w", [(1080, 1920), (562, 1000), (37, 45),
                                 (1, 1), (4320, 7680)])
@pytest.mark.parametrize("n_ops", [1, 13, fused_sweep.MAX_STATEFUL_OPS])
def test_every_eligible_plan_fits(h, w, n_ops):
    """Every plan the rule takes has a launch that fits a block: each
    summed halo 0-33, as many ops as the op table holds and the most taps
    such a chain can hold (33 stencils of radius 1: 3 taps a unit of
    halo). The tile holds whole runs, the margin keeps every tap of a run
    in the shared row, and the shared memory is the kernel's smem_need."""
    for halo in range(34):
        n_taps = 3 * halo
        g = fused_sweep.stateful_geometry(h, w, halo, n_ops, n_taps, h100,
                                          96)
        assert g.smem + fused_sweep.STATIC_SMEM <= fused_sweep.SMEM_LIMIT
        assert g.run in (4, 8) and g.tile_w % g.run == 0
        assert g.margin % g.run == 0
        assert g.margin >= halo + g.run - 1 if halo else g.margin == 0
        ws = g.tile_w + 2 * g.margin
        assert g.smem == 4 * (g.tile_h + 2 * halo) * (
            3 * ws + fused_sweep.v_stride(ws)) \
            + fused_sweep.OP_REC_BYTES * n_ops + 4 * n_taps
        assert fused_sweep.blocks_per_sm(g) >= 1
        assert fused_sweep.stateful_rounds(g, h100(g)) >= 1


@pytest.mark.parametrize("h,w", [(1080, 1920), (37, 45), (70, 1001)])
def test_stateful_tiles_cover_each_pixel_once(h, w):
    """The launch's tiles (the strided loop walks tiles 0 .. gx*gy-1 of a
    frame, a tile's stores masked to the frame) cover every pixel once, at
    every tile and run that fits."""
    for tile in fused_sweep.TILES:
        for run in (8, 4):
            g = fused_sweep.stateful_geometry(h, w, 2, 13, 5, h100, 1,
                                              tile, run)
            gx, gy, _ = g.grid
            count = torch.zeros((h, w), dtype=torch.int32)
            for t in range(gx * gy):
                y0, x0 = t // gx * g.tile_h, t % gx * g.tile_w
                count[y0:y0 + g.tile_h, x0:x0 + g.tile_w] += 1
            assert bool((count == 1).all()), g


#: (H, W, summed halo) -> (tile, run, rounds of tiles a frame), recorded
#: from the cost model at 13 ops, 3 taps a unit of halo, on an H100 SXM
CHOICES = {
    (1080, 1920, 0): ((64, 64), 8, 2),
    (1080, 1920, 1): ((32, 128), 8, 2),
    (1080, 1920, 3): ((32, 128), 8, 2),
    (1080, 1920, 8): ((32, 64), 8, 4),
    (1080, 1920, 16): ((32, 64), 4, 4),
    (1080, 1920, 33): ((32, 64), 8, 8),
    (562, 1000, 0): ((32, 32), 8, 3),
    (562, 1000, 1): ((32, 32), 4, 3),
    (562, 1000, 8): ((32, 32), 8, 3),
    (562, 1000, 16): ((32, 32), 8, 3),
    (562, 1000, 33): ((32, 64), 8, 3),
    (37, 45, 0): ((32, 32), 8, 1),
    (37, 45, 1): ((32, 32), 4, 1),
    (37, 45, 33): ((32, 32), 8, 1),
}


@pytest.mark.parametrize("key", sorted(CHOICES))
def test_stateful_geometry_choices(key):
    """The tile and run the cost model chooses: config C's halo of 1 at
    1080p takes 32x128 tiles in runs of 8, two blocks an SM, 510 tiles a
    frame in 2 rounds of 264 blocks (a 32x32 tile would take 8 rounds);
    runs of 4 where a margin of 8 would cost more than STATEFUL_RUN8_COST
    saves; a small frame the smallest tile."""
    h, w, halo = key
    tile, run, rounds = CHOICES[key]
    g = fused_sweep.stateful_geometry(h, w, halo, 13, 3 * halo, h100, 96)
    assert ((g.tile_h, g.tile_w), g.run,
            fused_sweep.stateful_rounds(g, h100(g))) == (tile, run, rounds)


def test_stateful_rounds_model():
    """Rounds are whole: tiles a frame over the resident blocks (blocks an
    SM by shared memory and registers, times 132 SMs), rounded up; the
    cost is rounds times a tile's phase-1 cells, runs of 8 weighing
    STATEFUL_RUN8_COST."""
    g = fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, h100, 96)
    assert g.grid == (15, 34, 96) and (g.run, g.margin) == (8, 8)
    assert h100(g) == 264
    assert fused_sweep.stateful_rounds(g, 264) == 2  # 510 tiles over 264
    # 2 rounds of 34 rows of 144 cells
    assert fused_sweep.stateful_cost(g, 1, 264) == pytest.approx(
        2 * 34 * 144 * fused_sweep.STATEFUL_RUN8_COST)
    small = fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, h100, 96,
                                          (32, 32), 8)
    # shared memory would hold 7 blocks; registers hold it to 2
    assert fused_sweep.blocks_per_sm(small) == 7 and h100(small) == 264
    assert fused_sweep.stateful_rounds(small, 264) == 8  # 2,040 over 264
    big = fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, h100, 96,
                                        (64, 128), 8)
    assert h100(big) == 132
    assert fused_sweep.stateful_rounds(big, 132) == 2  # 255 tiles over 132
    assert fused_sweep.stateful_cost(g, 1, 264) < fused_sweep.stateful_cost(
        big, 1, 132) < 2 * fused_sweep.stateful_cost(g, 1, 264)
    with pytest.raises(ValueError):
        fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, h100, 96,
                                      (32, 28), 8)


#: SMs of a card -> K5's (tile, run, rounds) for config C's halo of 1 at
#: 1080p; 114 SMs is an H100 PCIe
CARDS = {132: ((32, 128), 8, 2), 114: ((32, 64), 8, 5),
         66: ((32, 128), 8, 4)}


@pytest.mark.parametrize("sms", sorted(CARDS))
def test_stateful_geometry_follows_the_card(sms):
    """The tile follows the blocks the card holds: on 114 SMs, 32x128
    tiles would take 3 rounds (510 over 228) and 32x64 tiles 5 rounds of
    cheaper tiles; a card that holds no block of a launch refuses it."""
    def card(g):
        return h100(g, sms)
    g = fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, card, 96)
    assert ((g.tile_h, g.tile_w), g.run,
            fused_sweep.stateful_rounds(g, card(g))) == CARDS[sms]
    with pytest.raises(ValueError):
        fused_sweep.stateful_geometry(1080, 1920, 1, 13, 0, lambda g: 0, 96)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _recorder(monkeypatch, module, entry):
    calls = []

    def record(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(**{entry: record})
    monkeypatch.setattr(module, "build",
                        lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    # the recorder counts as a launch: keep the process's count as it was
    monkeypatch.setattr(module, "LAUNCHES", module.LAUNCHES)
    return calls


def test_stateful_launch_is_one_a_chunk(monkeypatch):
    """`_launch` makes one launch for a chunk of B frames with the
    geometry `plan_geometry` computes, hands the kernel each state's
    incoming plane and both ping-pong planes, and returns plane (B-1) % 2
    as the new state; the caller's state is not handed as a plane."""
    calls = _recorder(monkeypatch, stateful_sweep, "lives_stateful_sweep")
    seen = []

    def resident(g, device, full=False):
        seen.append((device, full))
        return h100(g)
    monkeypatch.setattr(stateful_sweep, "resident_blocks", resident)
    plan = _plan([FIRE, ALIEN, ("crossfade", {}, (0, 1))])
    states = [f.init_state(W, H, None, "cpu") if f.init_state else None
              for f, *_ in plan.chain_spec]
    B = 5
    ids = torch.zeros((2, 3, B), dtype=torch.int32)
    packed = torch.zeros((2, B))
    before = stateful_sweep.LAUNCHES
    out, new = stateful_sweep._launch(plan, ids, packed, states)
    assert out.shape == (B, 3, H, W) and stateful_sweep.LAUNCHES == before + 1
    assert len(calls) == 1
    (*_, first, p0, p1, n, _out, T, b, h, w, halo, _sx, _sy, th, tw, run,
     margin, smem, full, _s) = calls[0]
    g = stateful_sweep.plan_geometry(plan, B)
    assert g == fused_sweep.stateful_geometry(H, W, 1, plan.ops.shape[0],
                                              plan.taps.shape[0], h100, B)
    # the plan's own card, and the core instantiation's occupancy
    assert set(seen) == {(plan.ops.device, False)}
    assert (n, T, b, h, w, halo, full) == (2, 3, B, H, W, 1, 0)
    assert (th, tw, run, margin, smem) == (g.tile_h, g.tile_w, g.run,
                                           g.margin, g.smem)
    for s, (i, _, _) in enumerate(plan.state_steps):
        assert first[s] == states[i].data_ptr()
        assert new[i].data_ptr() == (p0, p1)[(B - 1) % 2][s]
        assert new[i].data_ptr() != states[i].data_ptr()


# -- K4 -----------------------------------------------------------------------

def _prefix(items, n_tracks):
    return composite.build_composite(
        chain_spec_of(_chain([(n, {}, tr) for n, tr in items])), n_tracks,
        (), 30.0, "cpu")


def test_tracks_read_stages_each_track_once():
    """A prefix that reads track 1 three times and track 2 twice stages
    tracks 0, 1 and 2 once each; track 0 is staged for any prefix, empty
    too; a track no op reads is not staged."""
    plan = _prefix([("crossfade", (0, 1)), ("blend_screen", (0, 1)),
                    ("chroma_key", (2, 0)), ("luma_key", (1, 2)),
                    ("saturation", (0,))], 5)
    assert plan.tracks_read == (0, 1, 2)
    assert _prefix([("saturation", (0,))], 3).tracks_read == (0,)
    assert _prefix([], 2).tracks_read == (0,)
    assert _prefix([("crossfade", (3, 7))], 8).tracks_read == (0, 3, 7)
    assert composite.tracks_read([(1, 4, 4, 0, 0, 0, 0)]) == (0, 4)


#: distinct tracks read -> the span a block owns and its staged bytes
SPANS = {1: (4096, 12336), 2: (4096, 24672), 4: (4096, 49344),
         6: (4096, 74016), 7: (2048, 43344), 10: (2048, 61920),
         14: (1024, 43680), 15: (1024, 46800), 29: (512, 45936),
         64: (256, 52224)}


@pytest.mark.parametrize("n_read", sorted(SPANS))
def test_composite_span_within_budget(n_read):
    """The largest span of SPANS whose staged bytes (3 planes of span + 16
    bytes a track read) stay within STAGE_BUDGET: 10 tracks stage 2,048
    pixels in 61,920 bytes, 64 tracks 256. With the largest op table, the
    static shared memory and the reserve, two blocks fit an SM."""
    span, staged = SPANS[n_read]
    g = composite.composite_geometry(n_read, 9, 1080 * 1920, 96)
    assert (g.span, g.smem - 9 * fused_sweep.OP_REC_BYTES) == (span, staged)
    assert g.grid == (-(-1080 * 1920 // span), 96)
    assert span % 16 == 0  # whole 16-byte copies and runs of 4
    worst = staged + fused_sweep.OP_REC_BYTES * fused_sweep.MAX_SLOTS
    static = 4 * fused_sweep.MAX_SLOTS + 4 * 3 * composite.MAX_TRACKS
    assert 2 * (worst + static + fused_sweep.BLOCK_RESERVED) \
        <= fused_sweep.SM_SMEM
    bigger = [s for s in composite.SPANS if s > span]
    assert not bigger or 3 * n_read * (min(bigger) + 16) \
        > composite.STAGE_BUDGET


def test_composite_geometry_refuses_what_the_kernel_does_not_build():
    """The kernel stages 1 to MAX_TRACKS tracks; a frame smaller than a
    span is one block a frame."""
    for n_read in (0, composite.MAX_TRACKS + 1):
        with pytest.raises(ValueError):
            composite.composite_geometry(n_read, 9, 100, 1)
    g = composite.composite_geometry(3, 9, 100, 2)
    assert (g.span, g.grid) == (4096, (1, 2))


def test_composite_launch_stages_the_tracks_read(monkeypatch):
    """`_launch` hands the kernel the tracks read in slot order (a view at
    an offset as it is), each track's slot (-1 for one not read), the span
    and shared memory of `plan_geometry`."""
    calls = _recorder(monkeypatch, composite, "lives_composite")
    plan = _prefix([("crossfade", (0, 2)), ("blend_add", (2, 0))], 4)
    B, h, w = 2, 37, 45
    flat = torch.zeros(B * 3 * h * w + 1, dtype=torch.uint8)
    tracks = [flat[1:].view(B, 3, h, w)] + [
        torch.zeros((B, 3, h, w), dtype=torch.uint8) for _ in range(3)]
    packed = torch.zeros((len(plan.rows_key) + 2, B))
    out = composite._launch(plan, tracks, packed, B, h, w)
    assert out.shape == (B, 3, h, w) and len(calls) == 1
    (_p, table, n_read, slots, T, _ops, n_ops, _sr, _sv, _ns, _out, b, hh,
     ww, span, smem, _s) = calls[0]
    g = composite.plan_geometry(plan, B, h, w)
    assert (n_read, T, n_ops, b, hh, ww) == (2, 4, 2, B, h, w)
    assert list(table) == [tracks[0].data_ptr(), tracks[2].data_ptr()]
    assert tracks[0].data_ptr() == flat.data_ptr() + 1
    assert list(slots) == [0, -1, 1, -1]
    assert (span, smem) == (g.span, g.smem)
