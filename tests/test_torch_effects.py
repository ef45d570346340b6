"""Each ported filter of lives_tpu_torch against its lives_tpu original.

The same seeded numpy frames and per-frame parameters go through the JAX
filter's `process`, one frame at a time, and through the port's, which
takes the whole batch with (B,) parameter tensors. Float32 layers agree to
atol=1e-5 (both compute in float32; only the order of a few operations
may differ; kaleidoscope's bound is derived in `f32_atol`); u8 layers,
quantised by `from_f01`, agree to +/-1 LSB; a filter that only moves
pixels (`EXACT`) agrees exactly."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.effects.builtin.blends import _BLEND_MODES
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.layer import Layer as TLayer

B, H, W = 3, 24, 40

#: (case id, filter name, static values, (y0, x0, full H, full W) or None)
CASES = [("crossfade", "crossfade", {}, None)]
CASES += [(n, n, {}, None) for n in _BLEND_MODES]
CASES += [
    ("luma_key", "luma_key", {}, None),
    ("chroma_key", "chroma_key", {}, None),
    ("gaussian_blur_r3", "gaussian_blur", {"radius": 3}, None),
    # 41 taps > 33: the band-matrix form (bf16 in, f32 accumulate)
    ("gaussian_blur_r20", "gaussian_blur", {"radius": 20}, None),
    ("box_blur_r2", "box_blur", {"radius": 2}, None),
    ("sharpen_r2", "sharpen", {"radius": 2}, None),
    ("colour_balance", "colour_balance", {}, None),
    ("saturation", "saturation", {}, None),
    ("vignette", "vignette", {}, None),
    # a tile of a larger frame, its origin partly outside (clamped grid)
    ("vignette_tile", "vignette", {}, (-3, 17, 60, 70)),
    ("vignette_tile_inside", "vignette", {}, (30, 25, 90, 80)),
]
#: the filters of blends.py, colour.py, keying.py and extra.py that the
#: sweep's op table gained, then the plain-route ones of those modules
CASES += [(f"wipe_{d}", "wipe", {"direction": i}, None)
          for i, d in enumerate(("left", "right", "top", "bottom"))]
CASES += [(n, n, {}, None) for n in (
    "iris_circle", "iris_rectangle", "dissolve", "rand_replace",
    "chroma_blend", "luma_overlay", "luma_underlay", "negative_luma_overlay",
    "alpha_over", "mask_overlay", "negate",
    "brightness_contrast", "gamma_adjust", "levels", "greyscale", "sepia",
    "posterize", "solarize", "threshold", "softlight", "tint", "hue_rotate",
    "modulate", "colour_replace")]
# the coordinate filters on tiles whose origin lies partly outside the
# frame (clamped coordinates) and inside it
CASES += [(f"{n}_tile{k}", n, st, tile)
          for n, st in (("wipe", {"direction": 0}), ("wipe", {"direction": 3}),
                        ("iris_circle", {}), ("iris_rectangle", {}),
                        ("dissolve", {}), ("rand_replace", {}))
          for k, tile in enumerate(((-3, 17, 60, 70), (30, 25, 90, 80)))]
CASES += [("alpha_over_rgba", "alpha_over", {}, None)]
CASES += [(n, n, {}, None) for n in (
    "averaged_luma_overlay", "picture_in_picture", "grid4", "white_balance")]
CASES += [(f"slide_over_{d}", "slide_over", {"direction": d}, None)
          for d in range(4)]
CASES += [(f"compositor_revz{r}", "compositor", {"revz": r}, None)
          for r in (0, 1)]
CASES += [(f"triple_split_vert{v}", "triple_split", {"vert": v}, None)
          for v in (0, 1)]
CASES += [(f"posterise_{n}", "posterise", {"levels": n}, None)
          for n in (1, 3, 8)]
CASES += [(f"palette_mapper_{k}", "palette_mapper", {"palette": k}, None)
          for k in range(5)]
#: geometry.py, motion_blur, edge and the stateless compounds
CASES += [(n, n, {}, None) for n in (
    "flip_horizontal", "flip_vertical", "rotate180", "mirror", "rotozoom",
    "kaleidoscope", "ripple", "lens", "rotate", "wave", "swirl", "spread",
    "shift", "bump2d", "tvpic", "emboss", "charcoal", "warptv",
    "targeted_zoom", "edge", "dream", "night_vision", "comic")]
CASES += [(f"pixelate_{n}", "pixelate", {"block": n}, None) for n in (2, 5, 8)]
CASES += [(f"revtv_{n}", "revtv", {"linespace": n}, None) for n in (2, 4, 7)]
CASES += [(f"motion_blur_r{r}", "motion_blur", {"radius": r}, None)
          for r in (1, 8, 30)]
CASES += [("mirror_odd", "mirror", {}, None)]
#: filters whose output is a permutation of the input's pixels: equal
EXACT = {"flip_horizontal", "flip_vertical", "rotate180", "mirror", "shift"}
#: the JAX package runs a filter inside a jitted plan, where XLA contracts
#: spread's hash argument into a fused multiply-add; the port computes that
#: argument (`geometry.spread_hash`), so the jitted process is its
#: reference (the eager one differs by up to 255 LSB wherever the hash's
#: floor flips)
JIT_REFERENCE = {"spread"}


def f32_atol(name, h, w):
    """The float32 bound: 1e-5, and for kaleidoscope what its angle's
    one-ulp gaps give. torch's atan2, sin and cos differ from XLA's by an
    ulp; theta = atan2 + angle * 2 pi lies in [-pi, 3 pi], so it differs
    by at most 2^-20 + 2^-22, the fold doubles that, sin and cos add an
    ulp, and the radius (at most hypot((h-1)/2, (w-1)/2)) scales it into a
    coordinate gap; a unit of coordinate moves a [0,1] pixel by at most 1:
    1e-5 + r_max * 2^-18."""
    if name == "kaleidoscope":
        return 1e-5 + float(np.hypot((h - 1) / 2, (w - 1) / 2)) * 2.0 ** -18
    return 1e-5


def _inputs(name, static, dtype, alpha=False, w=W):
    """Seeded frames and per-frame parameter values for one case; with
    `alpha` the first input has an alpha channel."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    filt = j_get_filter(name)
    frames = [rng.random((B, 4 if alpha and i == 0 else 3, H, w), np.float32)
              for i in range(filt.n_in)]
    if dtype == "u8":
        frames = [np.floor(f * 255.0 + 0.5).astype(np.uint8)
                  for f in frames]
    params = {}
    for p in filt.params:
        if p.name in static:
            params[p.name] = static[p.name]
        elif p.kind == "num":
            params[p.name] = rng.uniform(p.min, p.max, B).astype(np.float32)
        else:
            params[p.name] = p.default
    return filt, frames, params


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("case,name,static,tile", CASES,
                         ids=[c[0] for c in CASES])
def test_filter_matches_jax(case, name, static, tile, dtype):
    alpha = case.endswith("_rgba")
    w = W - 1 if case.endswith("_odd") else W
    filt, frames, params = _inputs(name, static, dtype, alpha, w)
    pal = Palette.RGBFLOAT if dtype == "f32" else Palette.RGB24
    apal = Palette.RGBAFLOAT if dtype == "f32" else Palette.RGBA32
    pals = [apal if f.shape[1] == 4 else pal for f in frames]
    y0, x0, fh, fw = tile if tile else (0, 0, H, w)
    tcs = np.array([0.0, 0.5, 1.25], np.float32)

    def process(ins, p, tc, frame):
        return filt.process(ins, p, JContext(
            tc=tc, frame=frame, fps=25.0, width=fw, height=fh, y0=y0, x0=x0))
    if name in JIT_REFERENCE:
        process = jax.jit(process)
    ref = []
    for b in range(B):
        ins = [JLayer(planes=(jnp.asarray(f[b]),), palette=int(pl))
               for f, pl in zip(frames, pals)]
        p = {k: (jnp.asarray(v[b], jnp.float32) if isinstance(v, np.ndarray)
                 else v) for k, v in params.items()}
        ref.append(np.asarray(process(ins, p, jnp.float32(tcs[b]),
                                      jnp.int32(b)).planes[0]))
    ref = np.stack(ref)

    tfilt = t_get_filter(name)
    assert tfilt.hashname == filt.hashname
    assert [(p.name, p.kind, p.default, p.min, p.max) for p in tfilt.params] \
        == [(p.name, p.kind, p.default, p.min, p.max) for p in filt.params]
    ins = [TLayer(planes=(torch.from_numpy(f),), palette=int(pl))
           for f, pl in zip(frames, pals)]
    p = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in params.items()}
    ctx = TContext(tc=torch.from_numpy(tcs), frame=torch.arange(B), fps=25.0,
                   width=fw, height=fh, y0=y0, x0=x0)
    out = tfilt.process(ins, p, ctx)
    got = out.planes[0].numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert out.palette == ins[0 if name != "alpha_over" else 1].palette
    if name in EXACT:
        np.testing.assert_array_equal(got, ref)
    elif dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=f32_atol(name, H, w))
    else:
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1, diff.max()


def test_apply_instance_clamps_and_short_stack():
    """apply_instance clamps each parameter to its range and feeds a
    missing track from the front layer (`host.py:283-288`), as in JAX."""
    from lives_tpu.effects.host import Instance as JInstance
    from lives_tpu.effects.host import apply_instance as j_apply
    from lives_tpu_torch.effects.host import Instance as TInstance
    from lives_tpu_torch.effects.host import apply_instance as t_apply
    rng = np.random.default_rng(5)
    f0 = rng.random((2, 3, H, W), np.float32)
    values = {"amount": 1.7}   # above max 1.0
    ref = [np.asarray(j_apply(
        JInstance(filter=j_get_filter("blend_screen"), values=values,
                  in_tracks=(0, 3)),
        [JLayer(planes=(jnp.asarray(f0[b]),), palette=int(Palette.RGBFLOAT))],
        JContext(width=W, height=H))[0].planes[0]) for b in range(2)]
    got = t_apply(
        TInstance(filter=t_get_filter("blend_screen"), values=values,
                  in_tracks=(0, 3)),
        [TLayer(planes=(torch.from_numpy(f0),),
                palette=int(Palette.RGBFLOAT))],
        TContext(width=W, height=H))[0].planes[0].numpy()
    np.testing.assert_allclose(got, np.stack(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [
    (Palette.RGB24, Palette.RGBFLOAT), (Palette.RGB24, Palette.RGBAFLOAT),
    (Palette.RGBA32, Palette.RGBFLOAT), (Palette.RGBFLOAT, Palette.RGB24),
    (Palette.RGBAFLOAT, Palette.RGB24), (Palette.RGBFLOAT, Palette.RGBA32),
    (Palette.RGB24, Palette.RGBA32)])
def test_convert_layer_rgb_family_matches_jax(src, dst):
    """The conversions of the float chain and the RGB24 sink, exact (u8 out
    rounds half up and clamps before the cast)."""
    from lives_tpu.constants import has_alpha, is_float_palette
    from lives_tpu.ops.colorspace import convert_layer as j_convert
    from lives_tpu_torch.ops.colorspace import convert_layer as t_convert
    rng = np.random.default_rng(int(src) * 100 + int(dst))
    c = 4 if has_alpha(src) else 3
    if is_float_palette(src):
        # include values outside [0,1] and exact half steps
        arr = rng.uniform(-0.2, 1.2, (2, c, 8, 16)).astype(np.float32)
        arr[0, 0, 0, :4] = np.array([0.5, 1.5, 254.5, 127.5]) / 255.0
    else:
        arr = rng.integers(0, 256, (2, c, 8, 16), dtype=np.uint8)
    ref = np.stack([np.asarray(j_convert(
        JLayer(planes=(jnp.asarray(a),), palette=int(src)), dst).planes[0])
        for a in arr])
    out = t_convert(TLayer(planes=(torch.from_numpy(arr),), palette=int(src)),
                    dst)
    assert out.palette == int(dst)
    np.testing.assert_array_equal(out.planes[0].numpy(), ref)


def test_conversions_outside_the_slice_raise():
    """RGB24 -> YUV420P is ported now (tests/test_torch_colour.py holds
    every pair); a batch converts as the JAX package converts its frame,
    and a target with no conversion still raises."""
    from lives_tpu.ops.colorspace import convert_layer as j_convert
    from lives_tpu_torch.ops.colorspace import convert_layer as t_convert
    arr = np.random.default_rng(3).integers(0, 256, (1, 3, 8, 8),
                                            dtype=np.uint8)
    lay = TLayer(planes=(torch.from_numpy(arr),), palette=int(Palette.RGB24))
    got = t_convert(lay, Palette.YUV420P)
    ref = j_convert(JLayer(planes=(jnp.asarray(arr[0]),),
                           palette=int(Palette.RGB24)), Palette.YUV420P)
    for g, r in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    with pytest.raises(NotImplementedError, match="RGB24 -> NONE"):
        t_convert(lay, Palette.NONE)


@pytest.mark.parametrize("pal", [Palette.RGB24, Palette.RGBA32,
                                 Palette.RGBFLOAT, Palette.YUV420P,
                                 Palette.YUVA4444P])
def test_layer_blank_matches_jax(pal):
    from lives_tpu.layer import layer_blank as j_blank
    from lives_tpu_torch.layer import layer_blank as t_blank
    ref = j_blank(20, 10, pal)
    got = t_blank(20, 10, pal, device="cpu")
    assert (got.width, got.height, got.palette) == (20, 10, int(pal))
    for a, b in zip(ref.planes, got.planes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("tile", [None, (0, 0, 12, 20), (-4, 9, 30, 25),
                                  (8, -2, 15, 1)])
def test_grids_match_jax(centered, tile):
    """lazy_grid and ctx_grid (tile origins clamped to the frame) give the
    JAX package's float32 coordinates exactly."""
    from lives_tpu.effects.util import ctx_grid as j_ctx_grid
    from lives_tpu.effects.util import lazy_grid as j_lazy_grid
    from lives_tpu_torch.effects.util import ctx_grid, lazy_grid
    h, w = 12, 20
    if tile is None:
        ref = j_lazy_grid(h, w, centered)
        got = lazy_grid(h, w, centered, device="cpu")
    else:
        y0, x0, fh, fw = tile
        ref = j_ctx_grid(JContext(width=fw, height=fh, y0=y0, x0=x0), h, w,
                         centered)
        got = ctx_grid(TContext(width=fw, height=fh, y0=y0, x0=x0), h, w,
                       centered, device="cpu")
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("salt", [None, 0, 7, 16777215, -5])
@pytest.mark.parametrize("tile", [(0, 0, 24, 40), (-3, 17, 60, 70),
                                  (1000, 30000, 1080, 40000)])
def test_pixel_hash_matches_jax_exactly(salt, tile):
    """`_pixel_hash` is the JAX integer hash bit for bit, at coordinates
    whose products wrap int32 (x up to 39,999) and at frame salts up to
    2^24 - 1 and below 0, clamped to the frame at tile origins outside
    it."""
    from lives_tpu.effects.builtin.blends import _pixel_hash as j_hash
    from lives_tpu_torch.effects.builtin.blends import _pixel_hash as t_hash
    y0, x0, fh, fw = tile
    h, w = 24, 40
    ref = np.asarray(j_hash(JContext(width=fw, height=fh, y0=y0, x0=x0), h,
                            w, None if salt is None else jnp.int32(salt)))
    got = t_hash(TContext(width=fw, height=fh, y0=y0, x0=x0), h, w,
                 None if salt is None else torch.tensor([salt]),
                 device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.reshape(h, w), ref)


def test_mask_overlay_connected_alpha_raises():
    """mask_overlay's third input, a connected alpha channel (cconx), is
    its mask in place of the bg's luma, as in the JAX filter (it raised
    until data connections were ported)."""
    filt = t_get_filter("mask_overlay")
    rng = np.random.default_rng(5)
    fg = rng.random((1, 3, 4, 6), dtype=np.float32)
    bg = rng.random((1, 3, 4, 6), dtype=np.float32)
    m = rng.random((1, 4, 6), dtype=np.float32)
    lay, under = (TLayer(planes=(torch.from_numpy(a),),
                         palette=int(Palette.RGBFLOAT)) for a in (fg, bg))
    mask = TLayer(planes=(torch.from_numpy(m),), palette=int(Palette.AFLOAT))
    p = {"threshold": 0.5, "softness": 0.05, "invert": 0.0}
    assert filt.process([lay, under], p, TContext()).planes[0].shape == \
        (1, 3, 4, 6)
    got = filt.process([lay, under, mask], p, TContext()).planes[0]
    jf = j_get_filter("mask_overlay")
    ref = jf.process([JLayer(planes=(jnp.asarray(a[0]),),
                             palette=int(Palette.RGBFLOAT)) for a in (fg, bg)]
                     + [JLayer(planes=(jnp.asarray(m[0]),),
                               palette=int(Palette.AFLOAT))], p, JContext())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref.planes[0]),
                               atol=1e-6)
    assert [t.name for t in filt.alpha_ins] == \
        [t.name for t in jf.alpha_ins]
