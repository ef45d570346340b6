"""The port's geometry layer against lives_tpu: the shared bilinear sampler
(`effects.util.bilinear`) against `jax.scipy.ndimage.map_coordinates`
(order 1, modes "constant" and "nearest"), `utils.sinf` bit for bit
against `jnp.sin` (the C library's `sinf`, which XLA's CPU backend calls),
and `spread` at 1920x1080 against the JAX package's jitted filter.

(Every float32 below 2^17 is held by `tools/sinf_exhaustive.py`; here a
stride through that range and the edges of the library's three paths.)
Filter by filter at a small size: tests/test_torch_effects.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates

from lives_tpu.constants import Palette
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.effects.builtin.geometry import spread_hash
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.effects.util import bilinear
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.utils.sinf import sinf


@pytest.mark.parametrize("mode", ["constant", "nearest"])
@pytest.mark.parametrize("shape", [(1, 1, 9, 13), (2, 3, 17, 6)])
def test_bilinear_matches_map_coordinates(mode, shape):
    """Coordinates inside, on and beyond every edge; the same float32 sum
    of four corners in JAX's order (XLA may fuse a multiply-add of it,
    hence 1e-6)."""
    B, C, H, W = shape
    rng = np.random.default_rng(H * W)
    src = rng.random(shape, np.float32)
    v = rng.uniform(-3, H + 2, (B, 11, 7)).astype(np.float32)
    u = rng.uniform(-3, W + 2, (B, 11, 7)).astype(np.float32)
    v[:, 0, :3] = [0.0, H - 1, H - 0.5]
    u[:, 0, :3] = [W - 1, 0.0, -0.5]
    ref = np.stack([np.stack([np.asarray(map_coordinates(
        jnp.asarray(src[b, c]), [jnp.asarray(v[b]), jnp.asarray(u[b])],
        order=1, mode=mode)) for c in range(C)]) for b in range(B)])
    got = bilinear(torch.from_numpy(src), torch.from_numpy(v),
                   torch.from_numpy(u), mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bilinear_refuses_other_modes():
    with pytest.raises(ValueError, match="mode"):
        bilinear(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1),
                 torch.zeros(1, 1, 1), "wrap")


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("lo,hi", [(0, 0x3F400000), (0x3F400000, 0x42F00000),
                                   (0x42F00000, 0x48000000)])
def test_sinf_is_jax_sin_on_a_stride(lo, hi):
    """Every 1,009th float32 of each of the library's paths: the
    polynomial alone (|y| < 0.75), one multiply-subtract (< 120), the
    Payne-Hanek reduction (to 2^17, and in the negatives)."""
    x = np.arange(lo, hi, 1009, dtype=np.uint32).view(np.float32)
    for v in (x, -x):
        np.testing.assert_array_equal(_bits(sinf(torch.from_numpy(v))),
                                      _bits(jnp.sin(v)))


def test_sinf_edges():
    """Around each path's threshold, zero and tiny values, huge values,
    infinities and NaN."""
    edges = [0x00000000, 0x00000001, 0x39800000, 0x3F400000, 0x3F490FDB,
             0x42F00000, 0x48000000, 0x4B000000, 0x7F7FFFFF]
    bits = np.unique(np.concatenate([np.arange(e - 40, e + 40) for e in
                                     edges]).clip(0, 0x7F7FFFFF))
    x = bits.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, -x, np.float32([np.inf, -np.inf, np.nan])])
    got = sinf(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.sin(x))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(ref[ok]))
    with pytest.raises(TypeError, match="float32"):
        sinf(torch.zeros(2, dtype=torch.float64))


def test_spread_hash_needs_the_twin():
    """On spread's arguments at 1920x1080, torch's own sin is not XLA's:
    the hash through it flips where the twin's equals the JAX package's
    jitted hash."""
    h, w, seed = 1080, 1920, np.float32(7.0)
    y = jnp.arange(h, dtype=jnp.float32)[:, None]
    x = jnp.arange(w, dtype=jnp.float32)[None, :]

    @jax.jit
    def ref_hash(u, v, s):
        t = jnp.sin(u * 12.9898 + v * 78.233 + 1.0 * 0.317 + s) * 43758.5453
        return (t - jnp.floor(t)) * 2.0 - 1.0
    ref = np.asarray(ref_hash(x, y, seed))
    ty = torch.arange(h, dtype=torch.float32)[:, None]
    tx = torch.arange(w, dtype=torch.float32)[None, :]
    got = spread_hash(tx, ty, 1.0, torch.tensor([[[7.0]]]))[0].numpy()
    np.testing.assert_array_equal(got, ref)
    # the same argument through torch.sin flips some hashes far
    arg = ((tx.double() * float(np.float32(12.9898))
            + (ty * np.float32(78.233)).double()).float() + 0.317) + 7.0
    t = torch.sin(arg) * 43758.5453
    plain = ((t - torch.floor(t)) * 2.0 - 1.0).numpy()
    assert np.abs(plain - ref).max() > 0.1


@pytest.mark.parametrize("frame", [0, 100_000])
def test_spread_at_1080p_within_one_lsb(frame):
    """u8 frames at 1920x1080 within 1 LSB of the JAX package's jitted
    spread (its bilinear weights fused or not: an ulp of coordinate)."""
    H, W = 1080, 1920
    rng = np.random.default_rng(frame)
    fr = rng.integers(0, 256, (1, 3, H, W), dtype=np.uint8)
    filt = j_get_filter("spread")
    run = jax.jit(lambda lay, a, n: filt.process(
        [lay], {"amount": a}, JContext(frame=n, width=W, height=H)))
    ref = np.asarray(run(JLayer(planes=(jnp.asarray(fr[0]),),
                                palette=int(Palette.RGB24)),
                         jnp.float32(0.7), jnp.int32(frame)).planes[0])
    got = t_get_filter("spread").process(
        [TLayer(planes=(torch.from_numpy(fr),), palette=int(Palette.RGB24))],
        {"amount": torch.tensor([0.7])},
        TContext(frame=torch.tensor([frame]), width=W, height=H))
    d = np.abs(got.planes[0][0].numpy().astype(int) - ref.astype(int))
    assert d.max() <= 1, (d.max(), int((d > 1).sum()))


@pytest.mark.parametrize("d", [0.5 / 40, 1.5 / 40, -2.5 / 40, 0.3, -1.0])
def test_shift_rounds_half_to_even(d):
    """A roll by round(d * n), half to even as `jnp.round`: equal."""
    a = np.random.default_rng(1).random((1, 3, 24, 40), np.float32)
    ref = np.asarray(j_get_filter("shift").process(
        [JLayer(planes=(jnp.asarray(a[0]),), palette=int(Palette.RGBFLOAT))],
        {"dx": jnp.float32(d), "dy": jnp.float32(-d)},
        JContext(width=40, height=24)).planes[0])
    got = t_get_filter("shift").process(
        [TLayer(planes=(torch.from_numpy(a),), palette=int(Palette.RGBFLOAT))],
        {"dx": d, "dy": -d}, TContext(width=40, height=24)).planes[0][0]
    np.testing.assert_array_equal(got.numpy(), ref)
