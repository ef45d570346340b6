"""K1's band mode on the CPU: `fused_sweep.plain_band_sweep` and
`parallel.spatial_sweep_fn` against lives_tpu's band sweep, and against the
port's own whole-frame `plain_sweep`.

The JAX side runs `spatial_sweep_fn` on conftest's 8 virtual CPU devices
with its Pallas kernel in interpret mode (`LIVES_TPU_PALLAS_INTERPRET=1`,
as tests/test_stateful_sweep.py:121-170 runs it). Tolerances: frames +/-1
LSB, since torch's and XLA's `exp` differ by an ulp; the synthetic
source's rows exact (integer formulas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.graph import FrameGraph as JGraph
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.parallel.mesh import frame_mesh as j_frame_mesh
from lives_tpu.parallel.mesh import spatial_sweep_fn as j_spatial_sweep_fn
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.graph import FrameGraph, SinkSpec, fused_sweep
from lives_tpu_torch.graph.nodemodel import chain_spec_of, pack_params
from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.parallel import frame_mesh, spatial_sweep_fn
from lives_tpu_torch.parallel.mesh import _default_params
from lives_tpu_torch.scenes import DeviceSyntheticSource
from test_torch_spatial import assert_within_1, make_chain

#: tests/test_stateful_sweep.py:136-139
THREE = [("crossfade", {"amount": 0.6}, (0, 1)),
         ("gaussian_blur", {"radius": 2, "amount": 1.0}, None),
         ("vignette", {"amount": 0.7}, None)]
TRANS = ["crossfade", "blend_screen", "blend_overlay", "luma_key",
         "blend_add", "blend_multiply", "chroma_key", "blend_lighten",
         "blend_difference"]
#: the main path's 13 effects over 10 tracks
FLAGSHIP = ([(name, {"amount": 0.5} if name.startswith(("cross", "blend"))
              else {}, (0, t)) for t, name in enumerate(TRANS, 1)]
            + [("gaussian_blur", {"radius": 3, "amount": 0.6}, None),
               ("colour_balance", {"red": 1.1, "green": 1.0, "blue": 0.9},
                None),
               ("saturation", {"saturation": 1.3}, None),
               ("vignette", {"amount": 0.7}, None)])
#: two stencils and a coordinate effect between them
TWO_STENCILS = [("blend_overlay", {"amount": 0.7}, (0, 1)),
                ("gaussian_blur", {"radius": 2, "amount": 0.8}, None),
                ("vignette", {"amount": 0.6}, None),
                ("sharpen", {"radius": 3, "amount": 0.9}, None)]


def _v_spec():
    """Timeline V's chain (chip_smoke.timeline_v): every transition the
    sweep's vocabulary gained, alpha_over and mask_overlay, a blur and ten
    grading ops."""
    from chip_smoke import V_FX, V_TRANS
    return ([(n, v, (0, t)) for t, (n, v) in enumerate(V_TRANS, 1)]
            + [(n, v, tuple(tr[0]) if tr else None) for n, v, *tr in V_FX])


V = _v_spec()


def inputs(graph, n_tracks, B):
    """(ids (2,T,B) int32, packed (P+2,B) f32) numpy arrays: track t plays
    clip t+1, frame b at frame b."""
    ids = np.zeros((2, n_tracks, B), np.int32)
    ids[0] = np.arange(1, n_tracks + 1)[:, None]
    ids[1] = np.arange(B)
    tcs, frames = np.arange(B) / 25.0, np.arange(B)
    packed, rows = pack_params(_default_params(graph, B), tcs, frames)
    return ids, packed, rows


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("y_lo,y_hi", [(0, 40), (10, 17), (-3, 5),
                                       (35, 44), (-2, 42)])
def test_traced_rows_matches_traced_tile(y_lo, y_hi):
    """Rows of the port's source at clamped global rows against the JAX
    source's traced_tile at the same clamped coordinates: exact."""
    h, w = 40, 64
    clips = np.array([1, 7, -1, 123456, 2**31 - 5], np.int64)
    frames = np.array([0, 3, 5, 99, 1000], np.int64)
    lay = DeviceSyntheticSource(h, w, device="cpu").traced_rows(
        torch.from_numpy(clips.astype(np.int32)),
        torch.from_numpy(frames.astype(np.int32)), y_lo, y_hi)
    assert lay.planes[0].shape == (5, 3, y_hi - y_lo, w)
    yy = np.clip(np.arange(y_lo, y_hi), 0, h - 1)[:, None] \
        * np.ones((1, w), np.int32)
    xx = np.arange(w)[None] * np.ones((y_hi - y_lo, 1), np.int32)
    src = JSource(h, w)
    for b in range(5):
        ref = np.asarray(src.traced_tile(
            jnp.asarray(clips[b].astype(np.int32)),
            jnp.asarray(frames[b].astype(np.int32)),
            jnp.asarray(yy, jnp.int32), jnp.asarray(xx, jnp.int32)))
        np.testing.assert_array_equal(lay.planes[0][b].numpy(), ref)


@pytest.mark.parametrize("chain,n_tracks,H,n", [
    ("three", 2, 64, 2), ("three", 2, 64, 8), ("flagship", 10, 64, 4),
    ("v", 10, 56, 8)])
def test_band_sweep_matches_jax(interpret, chain, n_tracks, H, n):
    """The port's band sweep on an n-entry CPU mesh against the JAX band
    sweep on n devices, and against the port's whole-frame plain_sweep
    (V: bands of 7 rows, at odd first rows)."""
    spec = {"three": THREE, "flagship": FLAGSHIP, "v": V}[chain]
    W, B = 256, 4
    jg = JGraph(make_chain(j_instantiate, spec), JSink(width=W, height=H),
                fps=25.0)
    tg = FrameGraph(make_chain(instantiate, spec), SinkSpec(width=W, height=H),
                    fps=25.0)
    ids, packed, rows = inputs(tg, n_tracks, B)
    run_j = j_spatial_sweep_fn(jg, j_frame_mesh(n, axis="s"), JSource(H, W),
                               B, H, W, axis="s")
    ref = np.asarray(run_j(ids, packed))
    src = DeviceSyntheticSource(H, W, device="cpu")
    run = spatial_sweep_fn(tg, frame_mesh(["cpu"] * n, axis="s"), src, B, H,
                           W, axis="s")
    before = dict(fused_sweep.MODE_LAUNCHES)
    out = run(ids, packed)
    assert fused_sweep.MODE_LAUNCHES == before  # the CPU launches nothing
    assert out.dtype == torch.uint8 and tuple(out.shape) == (B, 3, H, W)
    assert_within_1(out, ref)
    plan = fused_sweep.build_fused_sweep(chain_spec_of(tg.chain), n_tracks,
                                         H, W, rows, 25.0, src, tg.sink,
                                         "cpu")
    whole = fused_sweep.plain_sweep(plan, torch.from_numpy(ids),
                                    torch.from_numpy(packed))
    assert_within_1(out, whole)


@pytest.mark.parametrize("spec,H,W,band_h", [
    (THREE, 90, 100, 30), (THREE, 90, 100, 7), (TWO_STENCILS, 90, 100, 45),
    (TWO_STENCILS, 61, 40, 13), (FLAGSHIP, 50, 64, 50), (V, 61, 40, 13)])
def test_band_rows_match_whole_frame(spec, H, W, band_h):
    """plain_band_sweep at every y0 (a ragged last band too) against the
    same rows of the whole frame: the halo stops at the frame's edges, so
    two stencils agree as well as one."""
    tg = FrameGraph(make_chain(instantiate, spec), SinkSpec(width=W, height=H))
    n_tracks = 1 + max(max(tr or (0,)) for _, _, tr in spec)
    ids, packed, rows = inputs(tg, n_tracks, 3)
    ids, packed = torch.from_numpy(ids), torch.from_numpy(packed)
    src = DeviceSyntheticSource(H, W, device="cpu")
    args = (chain_spec_of(tg.chain), n_tracks, H, W, rows, 25.0, src,
            tg.sink, "cpu")
    whole = fused_sweep.plain_sweep(fused_sweep.build_fused_sweep(*args),
                                    ids, packed)
    plan = fused_sweep.build_fused_sweep(*args, band_h=band_h)
    assert plan.band_h == band_h and plan.height == H and plan.mode == "band"
    for y0 in list(range(0, H - band_h + 1, band_h)) + [H - band_h]:
        band = fused_sweep.fused_sweep(plan, ids, packed, y0=y0)
        assert tuple(band.shape) == (3, 3, band_h, W)
        assert_within_1(band, whole[:, :, y0:y0 + band_h])


def _one(name="saturation"):
    inst = instantiate(name)
    return chain_spec_of([inst]), tuple((0, k) for k in sorted(
        p.name for p in inst.filter.params if p.kind == "num"))


@pytest.mark.parametrize("sink,qualifies", [
    (SinkSpec(width=256, height=64), True),
    (SinkSpec(width=256, height=64, palette=int(Palette.YUV420P)), False),
    (SinkSpec(width=256, height=64, letterbox=True), False),
    (SinkSpec(width=128, height=32), False)])
def test_band_plan_follows_sink_rules(sink, qualifies):
    """Band mode keeps the u8 mode's sink rules (tests/test_stateful_sweep
    .py:173-194): RGB24, same geometry, no letterbox."""
    spec, rows = _one()
    src = DeviceSyntheticSource(64, 256, device="cpu")
    plan = fused_sweep.build_fused_sweep(spec, 1, 64, 256, rows, 25.0, src,
                                         sink, "cpu", band_h=32)
    assert (plan is not None) == qualifies


def test_band_plan_refuses_misuse():
    spec, rows = _one()
    src = DeviceSyntheticSource(64, 256, device="cpu")
    sink = SinkSpec(width=256, height=64)
    args = (spec, 1, 64, 256, rows, 25.0, src, sink, "cpu")
    for mode in ({"emit": "comp"}, {"consume": "comp"}):
        with pytest.raises(ValueError, match="u8 frames only"):
            fused_sweep.build_fused_sweep(*args, band_h=32, **mode)
    for band_h in (0, 65):
        with pytest.raises(ValueError, match="rows in a 64-row frame"):
            fused_sweep.build_fused_sweep(*args, band_h=band_h)
    plan = fused_sweep.build_fused_sweep(*args, band_h=32)
    whole = fused_sweep.build_fused_sweep(*args)
    ids = torch.ones((2, 1, 2), dtype=torch.int32)
    packed = torch.zeros((len(rows) + 2, 2))
    for y0 in (None, -1, 33):
        with pytest.raises(ValueError, match="y0"):
            fused_sweep.fused_sweep(plan, ids, packed, y0=y0)
    with pytest.raises(ValueError, match="y0 is for a band plan"):
        fused_sweep.fused_sweep(whole, ids, packed, y0=0)
    # neither CUDA nor CPU: no kernel and no plain version
    with pytest.raises(ValueError, match="no kernel for meta"):
        fused_sweep.fused_sweep(plan, ids.to("meta"), packed.to("meta"),
                                y0=0)


@pytest.mark.parametrize("case", ["ragged", "blur_r20", "stateful"])
def test_spatial_sweep_declines_like_jax(interpret, case):
    """None where the JAX band sweep gives None: H not divisible by the
    bands (from spatial_sweep_fn), or a chain outside the kernel's
    contract (from run, before any launch)."""
    H, W, B = 64, 256, 2
    spec = {"ragged": THREE,
            "blur_r20": [("gaussian_blur", {"radius": 20}, None)],
            "stateful": [("fire", {}, None)]}[case]
    n = 3 if case == "ragged" else 4
    jg = JGraph(make_chain(j_instantiate, spec), JSink(width=W, height=H))
    tg = FrameGraph(make_chain(instantiate, spec), SinkSpec(width=W, height=H))
    run_j = j_spatial_sweep_fn(jg, j_frame_mesh(n, axis="s"), JSource(H, W),
                               B, H, W, axis="s")
    run = spatial_sweep_fn(tg, frame_mesh(["cpu"] * n, axis="s"),
                           DeviceSyntheticSource(H, W, device="cpu"), B, H,
                           W, axis="s")
    if case == "ragged":
        assert run_j is None and run is None
        return
    ids, packed, _ = inputs(tg, 1, B)
    assert run_j(ids, packed) is None
    assert run(ids, packed) is None
