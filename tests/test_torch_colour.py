"""The colour engine of lives_tpu_torch against lives_tpu: `convert_layer`
over every palette pair, the colour kernels' plain versions against the
JAX package's Pallas kernels (run in interpret mode), resize, letterbox,
gamma, and the byte layouts of `layer_from_bytes` / `layer_to_bytes`.

Inputs come from numpy seeds. Tolerances: +/-1 LSB where a float formula
decides a u8 value (colour matrices, clamp remaps, gamma, resampling
matrices: torch's and XLA's float orders and transcendentals may differ by
an ulp before a floor); exact where the maths is integer (chroma
resampling, u8 RGB <-> RGB, alpha palettes, byte layouts). On the CPU
every kernel of the port runs its plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lives_tpu.layer import Layer as JLayer
from lives_tpu.layer import layer_from_bytes as j_from_bytes
from lives_tpu.layer import layer_to_bytes as j_to_bytes
from lives_tpu.ops import colorspace as jc
from lives_tpu.ops import colorspace_ref as jref
from lives_tpu.ops import gamma as jg
from lives_tpu.ops import pallas_kernels as jpk
from lives_tpu.ops import resize as jrz
from lives_tpu_torch.constants import (Gamma, Palette, YUVClamping,
                                       YUVSubspace, has_alpha,
                                       is_alpha_palette, is_float_palette,
                                       is_rgb_palette, is_yuv_palette)
from lives_tpu_torch.layer import Layer, layer_blank
from lives_tpu_torch.layer import layer_from_bytes, layer_to_bytes
from lives_tpu_torch.ops import colorspace as tc
from lives_tpu_torch.ops import colorspace_ref as tref
from lives_tpu_torch.ops import gamma as tg
from lives_tpu_torch.ops import resize as trz
from lives_tpu_torch.ops import yuv_kernels as yk

H, W = 8, 16
PALETTES = [p for p in Palette if p not in (Palette.ANY, Palette.NONE)]
FLOAT_RGB = (Palette.RGBFLOAT, Palette.RGBAFLOAT)


def frame_bytes(pal, seed, w=W, h=H):
    """One frame of random reference-format bytes in palette `pal`."""
    rng = np.random.default_rng(seed)
    if pal == Palette.AFLOAT:
        return (rng.integers(0, 256, h * w) / 255).astype(np.float32).tobytes()
    n = len(layer_to_bytes(layer_blank(w, h, pal, device="cpu")))
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def layer_pair(pal, seed, w=W, h=H):
    """The same frame as a lives_tpu and a lives_tpu_torch layer."""
    if pal in FLOAT_RGB:
        c = 4 if has_alpha(pal) else 3
        arr = (np.random.default_rng(seed).integers(0, 256, (c, h, w))
               / 255).astype(np.float32)
        return (JLayer(planes=(jnp.asarray(arr),), palette=int(pal)),
                Layer(planes=(torch.from_numpy(arr),), palette=int(pal)))
    buf = frame_bytes(pal, seed, w, h)
    return (j_from_bytes(buf, w, h, pal),
            layer_from_bytes(buf, w, h, pal, device="cpu"))


def as_np(layer):
    return [np.asarray(p) for p in layer.planes]


def integer_only(pi, po) -> bool:
    """No float formula between the two palettes: u8 RGB <-> RGB, YUV <->
    YUV resampling, alpha <-> alpha."""
    u8_rgb = (lambda p: is_rgb_palette(p) and not is_float_palette(p))
    return ((u8_rgb(pi) and u8_rgb(po))
            or (is_yuv_palette(pi) and is_yuv_palette(po))
            or (pi in (Palette.A8, Palette.A1) and po in (Palette.A8,
                                                         Palette.A1)))


def jax_reference(jl, pi, po):
    """lives_tpu's conversion. Where it mislabels data (ROADMAP Queue 3),
    the port is held to the JAX package's conversion through RGB24: a
    float RGB source quantised first, a float RGB target converted from
    RGB24."""
    if pi in FLOAT_RGB and is_yuv_palette(po):
        jl = jc.convert_layer(jl, Palette.RGBA32 if has_alpha(pi)
                              else Palette.RGB24)
    if is_yuv_palette(pi) and po in FLOAT_RGB:
        return jc.convert_layer(jc.convert_layer(
            jl, Palette.RGBA32 if has_alpha(po) else Palette.RGB24), po)
    return jc.convert_layer(jl, po)


@pytest.mark.parametrize("po", PALETTES, ids=lambda p: p.name)
@pytest.mark.parametrize("pi", PALETTES, ids=lambda p: p.name)
def test_convert_layer_matches_jax(pi, po):
    """Tolerance: exact where the pair's maths is integer, else +/-1 LSB
    (1/255 for float planes)."""
    jl, tl = layer_pair(pi, seed=int(pi) * 7 + int(po))
    ref = as_np(jax_reference(jl, pi, po))
    got = tc.convert_layer(tl, po)
    assert got.palette == int(po)
    got = as_np(got)
    assert [(g.shape, g.dtype) for g in got] == \
        [(r.shape, r.dtype) for r in ref]
    tol = 0 if integer_only(pi, po) else 1
    for g, r in zip(got, ref):
        scale = 255.0 if g.dtype == np.float32 else 1.0
        d = np.abs(g.astype(np.float64) - r.astype(np.float64)) * scale
        assert d.max() <= tol + 1e-4, (d.max(), tol)


@pytest.mark.parametrize("pal", [Palette.YUV420P, Palette.YUV422P,
                                 Palette.RGBA32, Palette.A8, Palette.YUV411],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("po", [Palette.RGB24, Palette.YUV420P,
                                Palette.RGBAFLOAT, Palette.A1],
                         ids=lambda p: p.name)
def test_convert_layer_is_batch_aware(pal, po):
    """A (B, ...) layer converts as its frames do one by one (the JAX
    version stacks channels on axis 0, so only single frames exist
    there)."""
    frames = [layer_pair(pal, seed=s)[1] for s in range(3)]
    batch = Layer(planes=tuple(torch.stack([f.planes[i] for f in frames])
                               for i in range(len(frames[0].planes))),
                  palette=int(pal))
    got = tc.convert_layer(batch, po)
    for b, f in enumerate(frames):
        one = tc.convert_layer(f, po)
        for g, o in zip(got.planes, one.planes):
            assert torch.equal(g[b], o)


@pytest.mark.parametrize("clamping", list(YUVClamping), ids=lambda c: c.name)
@pytest.mark.parametrize("subspace", [YUVSubspace.YCBCR, YUVSubspace.BT709],
                         ids=lambda s: s.name)
def test_matrices_match_integer_twin(subspace, clamping):
    """The float32 matrices against the numpy 16.16 twin, over every u8
    value of each input: +/-1 LSB (the twin's rounded fixed-point terms and
    float32 differ by under one unit before the floor); chroma resampling
    exact."""
    assert np.array_equal(tref.rgb2yuv_coeffs(subspace),
                          jref.rgb2yuv_coeffs(subspace))
    rng = np.random.default_rng(int(subspace) * 2 + int(clamping))
    r, g, b = (rng.integers(0, 256, (64, 64), dtype=np.uint8)
               for _ in range(3))
    ey = tref.rgb_to_yuv_planes(r, g, b, subspace, clamping)
    gy = tc.rgb_to_yuv(*(torch.from_numpy(p) for p in (r, g, b)), subspace,
                       clamping)
    for e, q in zip(ey, gy):
        assert np.abs(e.astype(int) - q.numpy().astype(int)).max() <= 1
    er = tref.yuv_to_rgb_planes(r, g, b, subspace, clamping)
    gr = tc.yuv_to_rgb(*(torch.from_numpy(p) for p in (r, g, b)), subspace,
                       clamping)
    for e, q in zip(er, gr):
        assert np.abs(e.astype(int) - q.numpy().astype(int)).max() <= 1
    for sh, sv in ((2, 2), (2, 1), (4, 1)):
        down = tc.chroma_down(torch.from_numpy(r[:63, :62]), sh, sv)
        assert np.array_equal(down.numpy(),
                              tref.chroma_down(r[:63, :62], sh, sv))
        up = tc.chroma_up(torch.from_numpy(r), sh, sv)
        assert np.array_equal(up.numpy(), tref.chroma_up(r, sh, sv))


@pytest.mark.parametrize("clamping", list(YUVClamping), ids=lambda c: c.name)
def test_clamp_convert_matches_twin(clamping):
    """Clamped <-> unclamped remap against the twin tables: +/-1 LSB."""
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    to = YUVClamping(1 - int(clamping))
    ey, eu, _ = tref.yuv_clamp_convert(v, v, v, clamping, to)
    gy, gu, _ = tc.yuv_clamp_convert(*(torch.from_numpy(v),) * 3, clamping,
                                     to)
    assert np.abs(ey.astype(int) - gy.numpy().astype(int)).max() <= 1
    assert np.abs(eu.astype(int) - gu.numpy().astype(int)).max() <= 1


def test_alpha_premultiply_matches_jax():
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(3)]
    a = rng.integers(0, 256, (H, W), dtype=np.uint8)
    for un in (False, True):
        ref = jc.alpha_premultiply([jnp.asarray(p) for p in planes],
                                   jnp.asarray(a), un=un)
        got = tc.alpha_premultiply([torch.from_numpy(p) for p in planes],
                                   torch.from_numpy(a), un=un)
        for r, g in zip(ref, got):
            d = np.abs(np.asarray(r).astype(int) - g.numpy().astype(int))
            assert d.max() <= 1


# -- the colour kernels' plain versions vs the JAX Pallas kernels -------------

@pytest.mark.parametrize("h", [32, 40])  # the fused and the full body
@pytest.mark.parametrize("clamping", list(YUVClamping), ids=lambda c: c.name)
@pytest.mark.parametrize("subspace", [YUVSubspace.YCBCR, YUVSubspace.BT709],
                         ids=lambda s: s.name)
def test_yuv420_to_rgb_matches_pallas(subspace, clamping, h):
    """K2's plain version against `pallas_kernels.yuv420_to_rgb` in
    interpret mode: +/-1 LSB."""
    rng = np.random.default_rng(h + int(clamping))
    y = rng.integers(0, 256, (h, 256), dtype=np.uint8)
    u = rng.integers(0, 256, (h // 2, 128), dtype=np.uint8)
    v = rng.integers(0, 256, (h // 2, 128), dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(p) for p in jpk.yuv420_to_rgb(
            y, u, v, int(subspace), int(clamping))]
    got = yk.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(u),
                           torch.from_numpy(v), subspace, clamping)
    assert got.shape == (3, h, 256) and got.dtype == torch.uint8
    for c in range(3):
        d = np.abs(got[c].numpy().astype(int) - ref[c].astype(int))
        assert d.max() <= 1


@pytest.mark.parametrize("h", [32, 40])
@pytest.mark.parametrize("clamping", list(YUVClamping), ids=lambda c: c.name)
@pytest.mark.parametrize("subspace", [YUVSubspace.YCBCR, YUVSubspace.BT709],
                         ids=lambda s: s.name)
def test_rgb_to_yuv420_matches_pallas(subspace, clamping, h):
    """K3's plain version against `pallas_kernels.rgb_to_yuv420` in
    interpret mode: +/-1 LSB (a box average of +/-1-divergent values stays
    within 1)."""
    rng = np.random.default_rng(h * 3 + int(subspace))
    rgb = rng.integers(0, 256, (3, h, 256), dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(p) for p in jpk.rgb_to_yuv420(
            rgb[0], rgb[1], rgb[2], int(subspace), int(clamping))]
    got = yk.rgb_to_yuv420(torch.from_numpy(rgb), subspace, clamping)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g.numpy().astype(int) - r.astype(int)).max() <= 1


def test_colour_kernel_wrappers_check_their_inputs():
    y = torch.zeros((2, 6, 8), dtype=torch.uint8)
    u = torch.zeros((2, 3, 4), dtype=torch.uint8)
    assert yk.yuv420_to_rgb(y, u, u).shape == (2, 3, 6, 8)
    assert not yk.yuv420_to_rgb_supported(5, 8)
    assert yk.yuv420_to_rgb_supported(562, 1000)
    with pytest.raises(ValueError, match="even"):
        yk.yuv420_to_rgb(y[:, :5], u, u)
    with pytest.raises(ValueError, match="chroma"):
        yk.yuv420_to_rgb(y, u[:, :2], u)
    with pytest.raises(TypeError):
        yk.yuv420_to_rgb(y.float(), u, u)
    with pytest.raises(ValueError, match="no kernel"):
        yk.yuv420_to_rgb(y.to("meta"), u.to("meta"), u.to("meta"))
    # K3 takes odd geometry: chroma drops the ragged edge, as chroma_down
    yy, uu, _ = yk.rgb_to_yuv420(torch.zeros((4, 5, 7), dtype=torch.uint8))
    assert yy.shape == (5, 7) and uu.shape == (2, 3)
    assert yk.LAUNCHES == {"yuv420_to_rgb": 0, "rgb_to_yuv420": 0}


# -- resize, letterbox, gamma ------------------------------------------------

RESIZE_CASES = [(Palette.RGB24, 24, 10, "smooth"),
                (Palette.RGB24, 6, 4, "area"),
                (Palette.RGBA32, 20, 12, "bilinear"),
                (Palette.RGBFLOAT, 9, 5, "nearest"),
                (Palette.YUV420P, 32, 12, "smooth"),
                (Palette.YUVA4444P, 10, 6, "bilinear")]


@pytest.mark.parametrize("pal,w,h,method", RESIZE_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_resize_layer_matches_jax(pal, w, h, method):
    """+/-1 LSB (1/255 for float): f32 matmuls in another order."""
    jl, tl = layer_pair(pal, seed=w + h)
    ref = as_np(jrz.resize_layer(jl, w, h, method=method))
    got = as_np(trz.resize_layer(tl, w, h, method=method))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        scale = 255.0 if g.dtype == np.float32 else 1.0
        assert np.abs(g.astype(np.float64) - r).max() * scale <= 1 + 1e-4
    assert np.array_equal(trz.interp_matrix(16, w, method),
                          jrz.interp_matrix(16, w, method))


@pytest.mark.parametrize("pal,w,h", [(Palette.RGB24, 24, 24),
                                     (Palette.RGBA32, 32, 10),
                                     (Palette.RGBAFLOAT, 12, 20),
                                     (Palette.YUV420P, 40, 20),
                                     (Palette.YUV422P, 16, 16)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_letterbox_matches_jax(pal, w, h):
    """Letterbox (+/-1 LSB, resampling) and the unletterbox crop."""
    jl, tl = layer_pair(pal, seed=w * h)
    ref = jrz.letterbox_layer(jl, w, h)
    got = trz.letterbox_layer(tl, w, h)
    for g, r in zip(as_np(got), as_np(ref)):
        scale = 255.0 if g.dtype == np.float32 else 1.0
        assert g.shape == r.shape
        assert np.abs(g.astype(np.float64) - r).max() * scale <= 1 + 1e-4
    geo = trz.letterbox_geometry(W, H, w, h)
    assert geo == jrz.letterbox_geometry(W, H, w, h)
    back = trz.unletterbox_layer(got, *geo)
    jback = jrz.unletterbox_layer(ref, *geo)
    assert [p.shape for p in as_np(back)] == [p.shape for p in as_np(jback)]


GAMMAS = [(Gamma.SRGB, Gamma.LINEAR), (Gamma.LINEAR, Gamma.SRGB),
          (Gamma.SRGB, Gamma.BT709), (Gamma.BT709, Gamma.MONITOR),
          (Gamma.FILE, Gamma.SRGB)]


@pytest.mark.parametrize("pal", [Palette.RGB24, Palette.RGBA32,
                                 Palette.YUV420P], ids=lambda p: p.name)
@pytest.mark.parametrize("gfrom,gto", GAMMAS,
                         ids=lambda g: Gamma(g).name)
def test_gamma_matches_jax_and_twin(pal, gfrom, gto):
    """+/-1 LSB against the JAX package (torch's and XLA's pow differ by an
    ulp) and against the LUT twin; alpha and chroma untouched."""
    jl, tl = layer_pair(pal, seed=abs(int(gfrom) + 10 * int(gto)))
    jl, tl = jl.replace(gamma=int(gfrom)), tl.replace(gamma=int(gfrom))
    ref = jg.gamma_convert_layer(jl, gto)
    got = tg.gamma_convert_layer(tl, gto)
    assert got.gamma == int(gto)
    for g, r in zip(as_np(got), as_np(ref)):
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
    assert np.array_equal(tg.ref_gamma_lut(int(gfrom), int(gto)),
                          jg.ref_gamma_lut(int(gfrom), int(gto)))
    src = as_np(tl)[0]
    colour = src[:3] if is_rgb_palette(pal) else src
    first = as_np(got)[0]
    first = first[:3] if is_rgb_palette(pal) else first
    (twin,) = tg.ref_gamma_convert([colour], int(gfrom), int(gto))
    assert np.abs(first.astype(int) - twin.astype(int)).max() <= 1
    for g, s in zip(as_np(got)[1:], as_np(tl)[1:]):
        assert np.array_equal(g, s)


# -- byte layouts --------------------------------------------------------------

@pytest.mark.parametrize("pal", [p for p in PALETTES if p not in FLOAT_RGB],
                         ids=lambda p: p.name)
def test_bytes_round_trip_and_match_jax(pal):
    """Byte-exact round trip; the same planes and bytes as lives_tpu (float
    RGB palettes have no byte layout in either package)."""
    w = 24 if pal != Palette.A1 else 21  # A1 rows pad to whole bytes
    buf = frame_bytes(pal, int(pal), w=w)
    lay = layer_from_bytes(buf, w, H, pal, device="cpu")
    jlay = j_from_bytes(buf, w, H, pal)
    for g, r in zip(as_np(lay), as_np(jlay)):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert layer_to_bytes(lay) == j_to_bytes(jlay)
    if pal != Palette.A1:
        assert layer_to_bytes(lay) == buf
    else:  # the padding bits of each row come back as 0
        again = layer_from_bytes(layer_to_bytes(lay), w, H, pal,
                                 device="cpu")
        assert torch.equal(again.planes[0], lay.planes[0])
    assert is_alpha_palette(pal) == (len(lay.planes) == 1
                                     and lay.planes[0].ndim == 2)
