"""The fused sweep's eligibility rule and its launch geometry, on the CPU.

`build_fused_sweep` decides which chains, sinks and modes the kernel takes;
the expectations below are literal, recorded from the rule as it stood
before the kernel was redesigned for the H100 (a 32x32 tile, summed stencil
radius up to 33), so a new geometry takes exactly the chains the old one
took. `sweep_geometry` is the geometry `_launch` passes to the kernel
(csrc/fused_sweep.cu): its tiles cover every output pixel of a frame or a
band exactly once, every read of a launch stays inside the block's shared
rows, and every launch fits the 227 KB a block can use. The kernel itself
runs only on a GPU (tests/test_torch_cuda.py)."""

import types

import pytest
import torch

from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.builtin.blends import _BLEND_MODES
from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.graph import SinkSpec, fused_sweep
from lives_tpu_torch.graph.nodemodel import chain_spec_of
from lives_tpu_torch.scenes import DeviceSyntheticSource

H, W = 40, 96
MODES = ("u8", "comp_out", "comp_in", "band")
MAIN = [("crossfade", {}, (0, 1)), ("blend_screen", {}, (0, 2)),
        ("blend_overlay", {}, (0, 3)), ("luma_key", {}, (0, 4)),
        ("blend_add", {}, (0, 5)), ("blend_multiply", {}, (0, 6)),
        ("chroma_key", {}, (0, 7)), ("blend_lighten", {}, (0, 8)),
        ("blend_difference", {}, (0, 9)),
        ("gaussian_blur", {"radius": 3, "amount": 0.6}, (0,)),
        ("colour_balance", {}, (0,)), ("saturation", {}, (0,)),
        ("vignette", {"amount": 0.7}, (0,))]


def _spec(items):
    chain = []
    for name, vals, tracks in items:
        inst = instantiate(name, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    return chain_spec_of(chain)


def _stack(radii):
    """crossfade, then stencils of `radii` (gaussian, sharpen, box in
    turn), a saturation after each."""
    items = [("crossfade", {}, (0, 1))]
    for i, r in enumerate(radii):
        items.append((("gaussian_blur", "sharpen", "box_blur")[i % 3],
                      {"radius": r}, (0,)))
        items.append(("saturation", {}, (0,)))
    return items


#: case -> (items, sink, the rule's decision in each of MODES: Y or N)
CASES = {
    "main": (MAIN, None, "YYNY"),
    "main_without_blur": (MAIN[:9] + MAIN[10:], None, "YYYY"),
    **{f"{b}": ([(b, {}, (0, 1)), ("saturation", {}, (0,))], None, "YYYY")
       for b in _BLEND_MODES},
    "luma_key": ([("luma_key", {}, (0, 2))], None, "YYYY"),
    "chroma_key": ([("chroma_key", {}, (1, 0))], None, "YYYY"),
    **{f"radius_{r}": (_stack([r]), None, "YYNY") for r in range(1, 17)},
    **{f"radius_{r}": (_stack([r]), None, "NNNN") for r in (17, 20, 64)},
    **{f"stack_{s}": (_stack([16, s - 16] if s <= 32 else [16, 16, s - 32]),
                      None, "YYNY") for s in range(17, 34)},
    "stack_33_of_ones": (_stack([1] * 33), None, "YYNY"),
    **{f"stack_{s}": (_stack([16, 16, s - 32]), None, "NNNN")
       for s in (34, 35, 48)},
    "stack_34_of_ones": (_stack([1] * 34), None, "NNNN"),
    "transition_after_stencil": (MAIN[:10] + [("crossfade", {}, (0, 1))],
                                 None, "NNNN"),
    "rgba_sink": (MAIN[:9], SinkSpec(W, H, palette=Palette.RGBA32), "NYNN"),
    "letterbox_sink": (MAIN[:9], SinkSpec(128, H, letterbox=True), "NYNN"),
    "resized_sink": (MAIN[:9], SinkSpec(48, 20), "NYNN"),
}


def _build(items, sink, mode, n_tracks=10):
    kw = {"u8": {}, "comp_out": {"emit": "comp"},
          "comp_in": {"consume": "comp"}, "band": {"band_h": H // 2 + 1}}
    return fused_sweep.build_fused_sweep(
        _spec(items), n_tracks, H, W, (), 30.0,
        DeviceSyntheticSource(H, W, device="cpu"), sink or SinkSpec(W, H),
        "cpu", **kw[mode])


@pytest.mark.parametrize("case", sorted(CASES))
def test_eligibility_as_before(case):
    """The rule takes, in each mode, exactly what it took before: every
    blend, both keys, stencils of radius 1-16 but not past, stacks summing
    to 33 but not past, no transition after a stencil, the RGB24 sink for
    the u8 modes only, no stencil in comp-in mode."""
    items, sink, want = CASES[case]
    got = "".join("N" if _build(items, sink, m) is None else "Y"
                  for m in MODES)
    assert got == want


#: (rows of the launch: a whole frame's or a band's, W, summed radius)
FRAMES = [(1080, 1920, 3), (270, 1920, 3), (562, 1000, 3), (281, 1000, 3),
          (45, 70, 0), (15, 70, 0), (61, 1001, 16), (13, 64, 33),
          (70, 45, 33), (7, 33, 1)]


@pytest.mark.parametrize("rows,width,halo", FRAMES)
def test_geometry_covers_each_pixel_once(rows, width, halo):
    """The launch's own geometry and every tile: the pixels a block stores
    (its tile's rows inside the band, columns inside the frame) cover the
    launch's output exactly once, and the launch fits a block's shared
    memory."""
    geoms = [fused_sweep.sweep_geometry(rows, width, halo, 13, 7, 2)]
    for tile in fused_sweep.TILES:
        try:
            geoms.append(fused_sweep.sweep_geometry(
                rows, width, halo, 13, 7, 2, tile))
        except ValueError:
            assert halo > 3  # only a large halo outgrows a tile
    for g in geoms:
        gx, gy, B = g.grid
        assert B == 2
        count = torch.zeros((rows, width), dtype=torch.int32)
        for by in range(gy):
            for bx in range(gx):
                # the kernel's store masks: band rows, frame columns
                y_lo, x_lo = by * g.tile_h, bx * g.tile_w
                count[y_lo:min(y_lo + g.tile_h, rows),
                      x_lo:min(x_lo + g.tile_w, width)] += 1
        assert bool((count == 1).all()), g
        assert g.smem + fused_sweep.STATIC_SMEM <= fused_sweep.SMEM_LIMIT
        assert g.run == fused_sweep.sweep_run(halo)
        assert g.tile_w % g.run == 0 and g.margin % g.run == 0


def _spans(g, radii):
    """The shared rows and columns one block of `g` reads and writes over a
    chain of stencils `radii` (csrc/fused_sweep.cu, its loops as written):
    yields (what, row lo, row hi, col lo, col hi), hi exclusive."""
    R, P, M, TH, TW = sum(radii), g.run, g.margin, g.tile_h, g.tile_w
    yield ("phase 1", 0, TH + 2 * R, (M - R) // P * P,
           -(-(M + TW + R) // P) * P)
    cur = R
    for r in radii:
        after = cur - r
        rows = (R - after, R + TH + after)
        vlo, vhi = (M - cur) // P * P, -(-(M + TW + cur) // P) * P
        hlo, hhi = (M - after) // P * P, -(-(M + TW + after) // P) * P
        yield ("vertical reads", rows[0] - r, rows[1] + r, vlo, vhi)
        yield ("horizontal reads", *rows, hlo - r, hhi - 1 + r + 1)
        yield ("horizontal writes", *rows, hlo, hhi)
        cur = after
    assert cur == 0


@pytest.mark.parametrize("radii", [[1], [3], [1, 1], [2, 3, 1], [8, 8],
                                   [16], [16, 16, 1], [1] * 33])
def test_geometry_keeps_reads_in_shared_rows(radii):
    """Every span a block reads or writes lies inside its shared rows of
    tile_w + 2 * margin columns and tile_h + 2R rows, at every tile that
    fits, and the columns a valid output reads were written by the passes
    before it."""
    R = sum(radii)
    for tile in fused_sweep.TILES:
        try:
            g = fused_sweep.sweep_geometry(1080, 1920, R, 20,
                                           sum(2 * r + 1 for r in radii),
                                           1, tile)
        except ValueError:
            continue
        WS, HA = g.tile_w + 2 * g.margin, g.tile_h + 2 * R
        for what, r0, r1, c0, c1 in _spans(g, radii):
            assert 0 <= r0 <= r1 <= HA, (what, g)
            assert 0 <= c0 <= c1 <= WS, (what, g)
        # a valid output of a stencil reads [M - cur, M + TW + cur), which
        # the vertical pass writes and phase 1 (or the stencil before)
        # keeps valid
        assert g.margin - R >= 0 and g.margin >= R + g.run - 1


def test_geometry_choices():
    """The tiles the launches choose: the whole 1080p frame at R = 3 and a
    270-row band 32x128 at runs of 8 with two blocks an SM (a band in
    32-row tiles wastes 18 of its rows where 64-row tiles would waste 50);
    larger halos, at runs of 4, take the tile of least weighted halo work
    even when one block fills an SM: R = 8 64x64 (two blocks), R = 16
    64x64, R = 33 32x64, and 32x32 where 256 ops leave no room for
    more."""
    g = fused_sweep.sweep_geometry(1080, 1920, 3, 13, 7, 96)
    assert (g.tile_h, g.tile_w, g.run, g.margin) == (32, 128, 8, 16)
    assert g.grid == (15, 34, 96) and fused_sweep.blocks_per_sm(g) == 2
    g = fused_sweep.sweep_geometry(270, 1920, 3, 13, 7, 96)
    assert (g.tile_h, g.tile_w) == (32, 128) and g.grid == (15, 9, 96)
    g = fused_sweep.sweep_geometry(1080, 1920, 8, 2, 17, 96)
    assert (g.tile_h, g.tile_w, g.run, g.margin) == (64, 64, 4, 12)
    assert fused_sweep.blocks_per_sm(g) == 2
    g = fused_sweep.sweep_geometry(1080, 1920, 16, 13, 33, 96)
    assert (g.tile_h, g.tile_w, g.run) == (64, 64, 4)
    assert fused_sweep.blocks_per_sm(g) == 1
    g = fused_sweep.sweep_geometry(1080, 1920, 33, 13, 69, 96)
    assert (g.tile_h, g.tile_w, g.run) == (32, 64, 4)
    g = fused_sweep.sweep_geometry(1080, 1920, 33, fused_sweep.MAX_SLOTS, 99,
                                   96)
    assert (g.tile_h, g.tile_w) == fused_sweep.TILES[-1] == (32, 32)
    g = fused_sweep.sweep_geometry(1080, 1920, 0, 12, 0, 96)
    assert g.smem == 12 * fused_sweep.OP_REC_BYTES and g.margin == 0


@pytest.mark.parametrize("rows", [1080, 270, 7])
def test_every_plan_fits(rows):
    """Every plan the rule takes has a launch that fits a block, over a
    whole frame or a band: any summed radius up to MAX_HALO, with as many
    ops as there are parameter slots and the most taps such a chain can
    hold. A tile given for a measurement that does not fit, or does not
    hold whole runs, is refused."""
    for halo in range(fused_sweep.MAX_HALO + 1):
        g = fused_sweep.sweep_geometry(rows, 1920, halo,
                                       fused_sweep.MAX_SLOTS, 3 * halo, 96)
        assert g.smem + fused_sweep.STATIC_SMEM <= fused_sweep.SMEM_LIMIT
    with pytest.raises(ValueError):
        fused_sweep.sweep_geometry(rows, 1920, 33, 13, 69, 96, (64, 128))
    with pytest.raises(ValueError):
        fused_sweep.sweep_geometry(rows, 1920, 3, 13, 7, 96, (32, 28))


@pytest.mark.parametrize("halo,run", [(0, 8), (3, 8), (7, 8), (8, 4),
                                      (16, 4), (33, 4)])
def test_run_follows_the_halo(halo, run):
    """Runs of 8 pixels up to a summed radius of 7, of 4 from 8 on, the
    same for a band as for the whole frame (the arithmetic of a band must
    be the whole frame's)."""
    assert fused_sweep.sweep_run(halo) == run
    for rows in (1080, 270, 13):
        assert fused_sweep.sweep_geometry(rows, 1920, halo, 13, 7, 2).run \
            == run


def test_launch_passes_the_geometry(monkeypatch):
    """`_launch` hands the kernel the geometry `plan_geometry` computes
    (tile, run, margin, shared memory) and the band's rows; the library's
    entry point is replaced by a recorder, as no kernel runs here."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(lives_fused_sweep=entry)
    monkeypatch.setattr(fused_sweep, "build",
                        lambda full=False: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    # the recorder counts as a launch: keep the process's counts as they were
    monkeypatch.setattr(fused_sweep, "LAUNCHES", fused_sweep.LAUNCHES)
    monkeypatch.setattr(fused_sweep, "MODE_LAUNCHES",
                        dict(fused_sweep.MODE_LAUNCHES))
    plan = _build(MAIN, None, "band")
    ids = torch.zeros((2, 10, 3), dtype=torch.int32)
    packed = torch.zeros((2, 3))
    out = fused_sweep._launch(plan, ids, packed, None, 7)
    g = fused_sweep.plan_geometry(plan, 3)
    assert out.shape == (3, 3, H // 2 + 1, W)
    *_, y0, band_h, halo, _sx, _sy, th, tw, run, margin, smem, _s = calls[0]
    assert (y0, band_h, halo) == (7, H // 2 + 1, 3)
    assert (th, tw, run, margin, smem) == (g.tile_h, g.tile_w, g.run,
                                           g.margin, g.smem)
    assert fused_sweep.MODE_LAUNCHES["band"] == 1


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
