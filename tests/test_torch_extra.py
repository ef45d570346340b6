"""`extra.py`'s filters of lives_tpu_torch against lives_tpu, on the same
seeded frames and per-frame parameters.

A stateless filter goes through both packages' `FrameGraph.run_batch`,
one instance over u8 tracks: the JAX package jits its plan there, so the
reference is the JITTED filter, whose hard selects (a floor, a compare, a
truncation to an index) XLA computes with its contractions and its C
library `sin`/`cos`; the port computes those values as the jit does (see
`effects/builtin/extra.py` and `puretext.py`). toonz_light_bloom runs only
eagerly in the JAX package (`int()` of its traced radius fails in the
graph), so both packages run it through `apply_instance` with numbers, and
both refuse it in a graph. The analysers (data_processor, randomiser) are
compared by their out-values through `apply_instance`.

Tolerances: u8 frames +/-1 LSB; exact where a filter only moves or copies
pixels (push, photo_censor, videowall's tiles aside) and for haip, bit for
bit at a size where its trails cross; threefry draws, haip's trails and
textfun's glyph indices exact; data_processor's out-values exact (the
same float32 operations, sin and cos through the C library's twins)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import apply_instance as j_apply
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.builtin import extra
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import apply_instance as t_apply
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.effects.host import instantiate as t_instantiate
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer

B = 3
SIZES = [(54, 96), (41, 67)]
TCS = np.array([0.0, 0.7, 123.4], np.float32)
FRAMES = np.array([0, 1, 100_000], np.int32)

#: (case id, filter, static values)
CASES = [("videowall_3", "videowall", {"tiles": 3}),
         ("videowall_5", "videowall", {"tiles": 5}),
         ("push", "push", {}), ("deinterlace", "deinterlace", {}),
         ("toonz_paraffin", "toonz_paraffin", {}),
         ("toonz_pencil_hatching", "toonz_pencil_hatching", {}),
         ("toonz_coherent_noise", "toonz_coherent_noise", {}),
         ("xeffect", "xeffect", {}), ("haip", "haip", {})]
CASES += [(f"photo_censor_{m}", "photo_censor", {"mode": m, "block": 5})
          for m in range(3)]
CASES += [(f"textfun_{m}", "textfun", {"mode": m}) for m in range(4)]
CASES += [(f"scribbler_{m}", "scribbler",
           {"mode": m, "text": "Hello\ntitles", "size": 12})
          for m in range(3)]
#: a filter that only moves or copies pixels, or draws them bit for bit
EXACT = {"push", "photo_censor", "haip"}


def _inputs(name, h, w, case=None):
    rng = np.random.default_rng(zlib.crc32((case or name).encode()) + h)
    f = j_get_filter(name)
    frames = [rng.integers(0, 256, (B, 3, h, w), np.uint8)
              for _ in range(max(f.n_in, 1))]
    params = {p.name: rng.uniform(p.min, p.max, B).astype(np.float32)
              for p in f.params if p.kind == "num"}
    if name == "photo_censor":   # a rectangle: its edges in order
        for lo, hi in (("left", "right"), ("top", "bottom")):
            params[lo], params[hi] = np.sort([params[lo], params[hi]], 0)
    return frames, params


def graphs_out(name, static, frames, params, fps=30.0):
    """(JAX FrameGraph's u8 frames, the port's): one instance of `name`
    reading tracks 0.. of `frames`."""
    ji, ti = j_instantiate(name, **static), t_instantiate(name, **static)
    ji.in_tracks = ti.in_tracks = tuple(range(len(frames)))
    ref = JGraph([ji], JSink(), fps=fps).run_batch(
        [JLayer(planes=(jnp.asarray(f),), palette=int(JPalette.RGB24))
         for f in frames], TCS, FRAMES, [params])
    got = TGraph([ti], TSink(), fps=fps).run_batch(
        [TLayer(planes=(torch.from_numpy(f),), palette=int(Palette.RGB24))
         for f in frames], TCS, FRAMES, [params])
    return np.asarray(ref.planes[0]), got.planes[0].numpy()


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("case,name,static", CASES, ids=[c[0] for c in CASES])
def test_filter_through_frame_graphs(case, name, static, h, w):
    frames, params = _inputs(name, h, w, case)
    ref, got = graphs_out(name, static, frames, params)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= (0 if name in EXACT else 1), d.max()
    assert (ref != frames[0]).any()   # the filter did something


def test_registered_as_jax_registers_them():
    """Hashnames, flags, params and out-params as the JAX package's."""
    for name in ("livetext", "videowall", "push", "data_processor",
                 "randomiser", "toonz_light_bloom", "toonz_paraffin",
                 "toonz_pencil_hatching", "toonz_coherent_noise",
                 "deinterlace", "scribbler", "textfun", "photo_censor",
                 "xeffect", "haip"):
        jf, tf = j_get_filter(name), t_get_filter(name)
        assert (tf.hashname, tf.flags, tf.n_in) == \
            (jf.hashname, jf.flags, jf.n_in), name
        for a, b in ((tf.params, jf.params), (tf.out_params, jf.out_params)):
            assert [(p.name, p.kind, p.default, p.min, p.max, p.choices)
                    for p in a] == [(p.name, p.kind, p.default, p.min,
                                     p.max, p.choices) for p in b], name
        assert (tf.analyse is None) == (jf.analyse is None), name


@pytest.mark.parametrize("h,w", SIZES)
def test_livetext_matches_jax(h, w):
    """The generator's RGBA32 frames (colour premultiplied by the mask's
    alpha) against the JAX filter a frame at a time."""
    rng = np.random.default_rng(h)
    cols = rng.random((B, 3)).astype(np.float32)
    static = {"text": "live\ntext", "size": 12}
    jf, tf = j_get_filter("livetext"), t_get_filter("livetext")
    ref = np.stack([np.asarray(jax.jit(lambda c: jf.process(
        [], {**static, "red": c[0], "green": c[1], "blue": c[2]},
        JContext(tc=0.0, width=w, height=h)).planes[0])(cols[b]))
        for b in range(B)])
    out = tf.process([], {**static, "red": torch.from_numpy(cols[:, 0]),
                          "green": torch.from_numpy(cols[:, 1]),
                          "blue": torch.from_numpy(cols[:, 2])},
                     TContext(tc=torch.from_numpy(TCS), width=w, height=h,
                              device="cpu"))
    assert out.palette == int(Palette.RGBA32)
    got = out.planes[0].numpy()
    assert got.shape == ref.shape == (B, 4, h, w)
    assert np.abs(got.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    assert got[:, 3].any()


def test_light_bloom_eager_matches_jax_and_refuses_a_graph():
    """Eager `apply_instance` with numbers, as the JAX tests run it; in a
    graph its per-frame radius fails in both packages, never silently
    taking one frame's value."""
    h, w = 41, 67
    frames, _ = _inputs("toonz_light_bloom", h, w)
    vals = {"gamma": 1.8, "exposure": 2.0, "gain": 1.5}
    for radius in (0.05, 0.9):   # 1 tap each side, and the band form
        v = {**vals, "radius": radius}
        ref = np.stack([np.asarray(j_apply(
            j_instantiate("toonz_light_bloom", **v),
            [JLayer(planes=(jnp.asarray(frames[0][b]),),
                    palette=int(JPalette.RGB24))])[0].planes[0])
            for b in range(B)])
        got = t_apply(t_instantiate("toonz_light_bloom", **v),
                      [TLayer(planes=(torch.from_numpy(frames[0]),),
                              palette=int(Palette.RGB24))])[0].planes[0]
        assert np.abs(got.numpy().astype(int) - ref).max() <= 1
        assert (ref != frames[0]).any()
    params = {k: np.full(B, x, np.float32) for k, x in
              {**vals, "radius": 0.2}.items()}
    with pytest.raises(jax.errors.ConcretizationTypeError):
        graphs_out("toonz_light_bloom", {}, frames, params)
    with pytest.raises(TypeError, match="radius"):
        TGraph([t_instantiate("toonz_light_bloom")], TSink()).run_batch(
            [TLayer(planes=(torch.from_numpy(frames[0]),),
                    palette=int(Palette.RGB24))], TCS, FRAMES, [params])


def _analyse_both(name, values, tc, frame):
    a = np.random.default_rng(1).integers(0, 256, (3, 8, 8), np.uint8)
    jinst = j_instantiate(name, **values)
    j_apply(jinst, [JLayer(planes=(jnp.asarray(a),),
                           palette=int(JPalette.RGB24))],
            JContext(tc=tc, frame=frame, width=8, height=8))
    tinst = t_instantiate(name, **values)
    out = t_apply(tinst, [TLayer(planes=(torch.from_numpy(a[None]),),
                                 palette=int(Palette.RGB24))],
                  TContext(tc=tc, frame=frame, width=8, height=8))
    np.testing.assert_array_equal(out[0].planes[0][0].numpy(), a)
    return jinst.out_values, tinst.out_values


EXPRS = ["a + b", "a * b - c / d", "sin(a) + cos(b)", "sqrt(abs(c)) * t",
         "min(a, b) + max(c, d) * pi", "a ** 2 + b", "t", "bad(", "a +* b",
         "__import__('os')", "undefined_name"]


@pytest.mark.parametrize("expr", EXPRS)
def test_data_processor_out_values_match_jax(expr):
    """Out-values through the analyse hook, float32 bit for bit; a bad
    expression gives 0.0 in both."""
    vals = {"a": 1.25, "b": -3.5, "c": 7.0, "d": 0.125,
            "expr_o0": expr, "expr_o1": "a - d"}
    ref, got = _analyse_both("data_processor", vals, 2.5, 3)
    assert set(got) == set(ref) == {"o0", "o1"}
    for k in ref:
        r = np.float32(np.asarray(ref[k], np.float32))
        g = np.float32(np.asarray(torch.as_tensor(got[k]).float()))
        assert g.view(np.uint32) == r.view(np.uint32), (expr, k, g, r)
    if expr in ("bad(", "a +* b", "__import__('os')", "undefined_name"):
        assert float(got["o0"]) == 0.0


@pytest.mark.parametrize("frame", [0, 1, 100_000])
def test_randomiser_matches_jax_bit_for_bit(frame):
    ref, got = _analyse_both("randomiser", {}, 0.0, frame)
    assert set(got) == set(ref) == {f"rand{i}" for i in range(4)}
    for k in ref:
        assert np.float32(ref[k]).view(np.uint32) == \
            got[k].numpy().view(np.uint32)
    # a batch of frames draws each frame's numbers
    out = t_get_filter("randomiser").analyse(
        [], {}, TContext(frame=torch.tensor([frame, 7]), device="cpu"))
    assert out["rand0"].shape == (2,)
    assert np.float32(ref["rand0"]).view(np.uint32) == \
        out["rand0"][0].numpy().view(np.uint32)


def test_analyser_alpha_out_channel_raises():
    """A Layer among an analyser's outputs is an alpha out-channel (cconx),
    kept in `Instance.out_channels` and apart from the out-values, as the
    JAX host splits them (`host.py:309-317`); it raised until data
    connections were ported."""
    from lives_tpu.effects.host import Filter as JFilter
    from lives_tpu.effects.host import Instance as JInstance
    from lives_tpu_torch.effects.host import Filter, Instance
    outs = {}
    for pkg, filt, inst, apply, lay in (
            ("torch", Filter, Instance, t_apply,
             TLayer(planes=(torch.zeros(1, 3, 4, 4),),
                    palette=int(Palette.RGBFLOAT))),
            ("jax", JFilter, JInstance, j_apply,
             JLayer(planes=(jnp.zeros((3, 4, 4)),),
                    palette=int(JPalette.RGBFLOAT)))):
        f = filt(name="probe_alpha", process=lambda ins, p, c: ins[0],
                 analyse=lambda ins, p, c: {"mask": ins[0], "level": 0.5})
        i = inst(filter=f)
        apply(i, [lay])
        outs[pkg] = (sorted(i.out_values), sorted(i.out_channels),
                     i.out_channels["mask"] is not None)
    assert outs["torch"] == outs["jax"] == (["level"], ["mask"], True)


def test_haip_trails_and_scatters_bit_for_bit():
    """At 24x32 the 48 wurms' 3x3 smears cross each other and themselves
    on every frame: the trails (threefry, bit for bit) and the frames are
    the JAX package's exactly, every scatter's repeated targets resolved
    to the last write."""
    h, w = 24, 32
    rng = np.random.default_rng(24)
    frames = rng.integers(0, 256, (B, 3, h, w), np.uint8)
    wurms = np.array([100.0, 55.0, 80.0], np.float32)
    ref, got = graphs_out("haip", {}, [frames], {"wurms": wurms})
    np.testing.assert_array_equal(got, ref)

    def jax_trails(frame):
        key = jax.random.fold_in(jax.random.PRNGKey(1913),
                                 jnp.asarray(frame, jnp.int32))
        k1, k1b, k2, _ = jax.random.split(key, 4)
        sx = jax.random.randint(k1, (48, 1), 1, w - 1)
        sy = jax.random.randint(k1b, (48, 1), 1, h - 1)
        steps = jax.random.randint(k2, (2, 48, 32), -1, 2)
        return (np.asarray(jnp.clip(sx + jnp.cumsum(steps[0], 1), 1, w - 2)),
                np.asarray(jnp.clip(sy + jnp.cumsum(steps[1], 1), 1, h - 2)))
    xs, ys, _ = extra.haip_trails(torch.from_numpy(FRAMES), h, w, "cpu")
    for b, f in enumerate(FRAMES):
        jx, jy = jax_trails(f)
        np.testing.assert_array_equal(xs[b].numpy(), jx)
        np.testing.assert_array_equal(ys[b].numpy(), jy)
        flat = (jy * w + jx).ravel()
        assert len(np.unique(flat)) < len(flat)   # trails cross


def test_scatter_last_keeps_the_last_write():
    out = torch.zeros(1, 1, 5)
    flat = torch.tensor([[2, 4, 2, 2, 0]])
    vals = torch.tensor([[[1.0, 2.0, 3.0, 4.0, 5.0]]])
    got = extra.scatter_last(out, flat, vals)
    assert got.tolist() == [[[5.0, 0.0, 4.0, 0.0, 2.0]]]


@pytest.mark.parametrize("h,w", SIZES)
def test_textfun_glyph_indices_exact(h, w):
    """The block means, their luma and the glyph pick as the jit computes
    them: every index equal."""
    rng = np.random.default_rng(w)
    a = rng.integers(0, 256, (B, 3, h, w), np.uint8)
    k = len(extra.glyph_atlas(8))

    @jax.jit
    def ref_idx(x):
        from lives_tpu.effects.util import luma
        rgb = x.astype(jnp.int32).astype(jnp.float32) * np.float32(1 / 255)
        hh, ww = h // 8, w // 8
        blocks = rgb[:, : hh * 8, : ww * 8].reshape(3, hh, 8, ww, 8)
        g = luma(blocks.mean((2, 4)))
        return jnp.clip((g * k).astype(jnp.int32), 0, k - 1)
    ref = np.stack([np.asarray(ref_idx(a[b])) for b in range(B)])
    _, _, got = extra.textfun_glyphs(
        TLayer(planes=(torch.from_numpy(a),), palette=int(Palette.RGB24)),
        8, k)
    np.testing.assert_array_equal(got[:, 0].numpy(), ref)
    np.testing.assert_array_equal(extra.glyph_atlas(8),
                                  __import__("lives_tpu.effects.builtin"
                                             ".extra", fromlist=["x"])
                                  ._glyph_atlas(8))
