"""The compressed encode lane of lives_tpu_torch (`io/jpeg_encode.py`,
ROADMAP Queue 1 item 19) against lives_tpu's on the CPU: coefficients
within +-1 on under 2e-3 of them (the JAX package's bound against its
float64 twin, `tests/test_jpeg_encode.py:56-57`), the v2 and v3 wires
packed from the same coefficients byte for byte (the cases of
`tests/test_jpeg_encode.py:207-240`), the encoder's JPEG bytes equal to
the JAX encoder's where the coefficients agree, the exact round trip
through the ingest lane, and the overflow that grows the pool.

Frames are seeded numpy content; the port runs on CPU tensors
(`device="cpu"`), the JAX package under JAX_PLATFORMS=cpu.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lives_tpu.io import jpeg_encode as jje
from lives_tpu_torch.io import jpeg_encode as je
from lives_tpu_torch.io import jpeg_ingest as ji
from test_torch_bridges import jax_bridge


@pytest.fixture(autouse=True)
def jax_jpegcoef():
    """Every test here compares against the JAX package's jpegcoef bridge."""
    jax_bridge("jpegcoef")


def smooth_rgb(h, w, seed=0):
    """The JAX package's test content (`tests/test_jpeg_encode.py:19`)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 70 * np.sin(xx / 19.0) * np.cos(yy / 13.0)
    rgb = np.stack([base, np.roll(base, 7, 1), 255 - base]) \
        + rng.normal(0, 4, (3, h, w))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def case_frames(case):
    """(frames (2, 3, h, w), capacity or None, esc_cap or None) of the JAX
    package's wire cases."""
    rng = np.random.default_rng(42)
    if case == "smooth":
        rgb, cap, esc = smooth_rgb(48, 64, seed=1), None, None
    elif case == "overflow":
        # AC capacity and escape table both overflow
        rgb, cap, esc = rng.integers(0, 256, (3, 40, 56), np.uint8), 128, 8
    else:
        yy, xx = np.mgrid[0:32, 0:48]
        cb = (255 * ((yy + xx) % 2)).astype(np.uint8)
        rgb, cap, esc = np.stack([cb, 255 - cb, cb]), None, None
    return np.stack([rgb, rgb[::-1]]), cap, esc


def jax_coefs(meta, frames, quality=85):
    stage = jax.jit(jax.vmap(jje._coef_stage(meta, quality, "rgb")))
    return [np.array(a) for a in stage(jnp.asarray(frames))]


def coef_gap(a, b):
    """(max |a - b|, share of differing values) of two (dc, ac2) pairs."""
    d = np.concatenate([np.abs(a[0].astype(np.int64) - b[0]).reshape(-1),
                        np.abs(a[1].astype(np.int64) - b[1]).reshape(-1)])
    return int(d.max()), float((d > 0).mean())


def test_tables_and_layouts_match_jax():
    for q in (1, 25, 50, 85, 90, 100):
        np.testing.assert_array_equal(je.quality_qtabs(q),
                                      jje.quality_qtabs(q))
    for w, h, s in ((1920, 1080, (2, 2)), (75, 37, (2, 2)), (64, 48, (1, 1))):
        m, jm = je.encode_meta(w, h, s), jje.encode_meta(w, h, s)
        assert m == ji.JpegMeta(*jm.__dict__.values())
        assert je.capacity_for(m, 0.18) == jje.capacity_for(jm, 0.18)
        for a, b in ((je.WireLayout(m.n_blocks, 1280, 300),
                      jje.WireLayout(jm.n_blocks, 1280, 300)),
                     (je.CompactLayout(8, m.n_blocks, 1280, 300),
                      jje.CompactLayout(8, jm.n_blocks, 1280, 300))):
            for attr in dir(b):
                if not attr.startswith("_") and attr != "used":
                    assert getattr(a, attr) == getattr(b, attr), attr
        assert je.CompactLayout(8, m.n_blocks, 1280, 300).used(9000, 7) == \
            jje.CompactLayout(8, jm.n_blocks, 1280, 300).used(9000, 7)


@pytest.mark.parametrize("shape,sampling", [
    ((64, 96), (2, 2)), ((37, 75), (2, 2)), ((48, 64), (1, 1)),
    ((41, 57), (1, 1))])
def test_coefficients_match_jax(shape, sampling):
    h, w = shape
    frames = np.stack([smooth_rgb(h, w, s) for s in range(3)])
    meta = je.encode_meta(w, h, sampling)
    j = jax_coefs(jje.encode_meta(w, h, sampling), frames, 85)
    t = [a.numpy() for a in je._coef_stage(meta, 85, "cpu")(
        torch.from_numpy(frames))]
    assert t[0].dtype == np.int16 and t[1].dtype == np.int32
    worst, share = coef_gap(j, t)
    assert worst <= 1 and share < 2e-3, (worst, share)


@pytest.mark.parametrize("shape", [(64, 80), (33, 49)])
def test_coefficients_match_float64_twin(shape):
    h, w = shape
    rgb = smooth_rgb(h, w, 3)
    meta, ref = je.encode_frame_ref(rgb, 85)
    _, jref = jje.encode_frame_ref(rgb, 85)
    for a, b in zip(ref, jref):
        np.testing.assert_array_equal(a, b)
    dc, ac = je._coef_stage(meta, 85, "cpu")(torch.from_numpy(
        rgb[None]))
    ref = np.concatenate(ref)
    worst, share = coef_gap((ref[:, 0], ref[:, 1:]),
                            (dc[0].numpy(), ac[0].numpy()))
    assert worst <= 1 and share < 2e-3, (worst, share)


@pytest.mark.parametrize("case", ["smooth", "overflow", "checkerboard"])
def test_wires_from_the_same_coefficients_match_jax(case):
    """v2 and v3 packed by the port from the JAX coefficient stage's
    output equal the JAX encoder functions' wires byte for byte."""
    frames, cap, esc = case_frames(case)
    h, w = frames.shape[2:]
    jmeta = jje.encode_meta(w, h)
    cap = cap or jje.capacity_for(jmeta)
    dc, ac = (torch.from_numpy(a) for a in jax_coefs(jmeta, frames))
    jfn, jlay = jje.build_device_encoder(jmeta, 2, cap, 85, esc_cap=esc)
    lay = je.WireLayout(jlay.nb, jlay.capacity, jlay.esc_cap)
    np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(frames))),
                                  je.pack_wire(dc, ac, lay).numpy())
    jfn3, jlay3 = jje.build_device_encoder_compact(jmeta, 2, cap, 85,
                                                   esc_cap=esc)
    lay3 = je.CompactLayout(2, jlay3.nb, jlay3.capacity, jlay3.esc_cap)
    np.testing.assert_array_equal(np.asarray(jfn3(jnp.asarray(frames))),
                                  je.pack_compact(dc, ac, lay3).numpy())


@pytest.mark.parametrize("case", ["smooth", "checkerboard"])
def test_encoder_functions_match_jax_wires_where_coefficients_agree(case):
    """At q90 (the MJPEG encoder's default) these frames' coefficients
    agree with the JAX lane's (asserted): the two wire functions' output is
    then the JAX package's byte for byte."""
    frames, _, _ = case_frames(case)
    h, w = frames.shape[2:]
    meta, jmeta = je.encode_meta(w, h), jje.encode_meta(w, h)
    cap = je.capacity_for(meta)
    fn, lay = je.build_device_encoder(meta, 2, cap, 90, device="cpu")
    fn3, lay3 = je.build_device_encoder_compact(meta, 2, cap, 90,
                                                device="cpu")
    coefs = [a.numpy() for a in je._coef_stage(meta, 90, "cpu")(
        torch.from_numpy(frames))]
    assert coef_gap(jax_coefs(jmeta, frames, 90), coefs) == (0, 0.0)
    jfn, _ = jje.build_device_encoder(jmeta, 2, cap, 90)
    jfn3, _ = jje.build_device_encoder_compact(jmeta, 2, cap, 90)
    x = torch.from_numpy(frames)
    np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(frames))),
                                  fn(x).numpy())
    np.testing.assert_array_equal(np.asarray(jfn3(jnp.asarray(frames))),
                                  fn3(x).numpy())
    n_ac, n_esc, *_ = je.unpack_wire(fn(x)[0].numpy(), lay)
    assert n_ac == int((coefs[1][0] != 0).sum())


@pytest.mark.parametrize("batch", [2, 4])
def test_encoder_bytes_match_jax(batch):
    """Frames whose coefficients agree with the JAX lane's (asserted)
    encode to the JAX encoder's JPEG bytes, from its v3 (default) and its
    v2 (`compact=False`) path; 5 frames at batch 2 or 4 pad the tail by
    repeating its last frame."""
    h, w = 48, 64
    frames = np.stack([smooth_rgb(h, w, s) for s in range(5)])
    assert coef_gap(jax_coefs(jje.encode_meta(w, h), frames, 90),
                    [a.numpy() for a in je._coef_stage(
                        je.encode_meta(w, h), 90, "cpu")(
                        torch.from_numpy(frames))]) == (0, 0.0)
    enc = je.JpegDeviceEncoder(w, h, 90, batch=batch, device="cpu")
    tb = enc.encode_batch(torch.from_numpy(frames))
    assert len(tb) == 5 and enc.overflows == 0
    for compact in (True, False):
        assert tb == jje.JpegDeviceEncoder(
            w, h, 90, batch=batch, compact=compact).encode_batch(
            jnp.asarray(frames))
    # a list of frames encodes the same
    assert enc.encode_batch([torch.from_numpy(f) for f in frames[:2]]) \
        == tb[:2]


def test_roundtrip_through_ingest_lane_is_exact():
    """The entropy coder is lossless: the JPEGs decode back to the
    quantised coefficients exactly, and through PIL within quantisation
    error."""
    h, w = 40, 72
    frames = np.stack([smooth_rgb(h, w, s) for s in range(2)])
    enc = je.JpegDeviceEncoder(w, h, 85, batch=2, device="cpu")
    dc, ac = enc.coefs(torch.from_numpy(frames))
    for i, data in enumerate(enc.encode_batch(torch.from_numpy(frames))):
        f = ji.read_coefficients(data)
        assert (f.height, f.width) == (h, w)
        got = np.concatenate([c["coefs"] for c in f.comps])
        np.testing.assert_array_equal(got[:, 0], dc[i].numpy())
        np.testing.assert_array_equal(got[:, 1:], ac[i].numpy())
        np.testing.assert_array_equal(f.qtabs[:2], je.quality_qtabs(85)[:2])
        pil = np.moveaxis(np.asarray(Image.open(io.BytesIO(data))
                                     .convert("RGB")), -1, 0)
        mse = np.mean((pil.astype(float) - frames[i]) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 30


def test_escapes_survive_the_round_trip():
    """A block-scale checkerboard (`tests/test_jpeg_encode.py:107-124`):
    its ACs past +-127 ship as escapes, come back exactly, and the bytes
    are the JAX encoder's."""
    yy, xx = np.mgrid[0:32, 0:32]
    hard = (((xx // 4) + (yy // 4)) % 2 * 255).astype(np.uint8)
    rgb = np.stack([hard, hard, hard])[None]
    enc = je.JpegDeviceEncoder(32, 32, 95, batch=1, device="cpu")
    dc, ac = enc.coefs(torch.from_numpy(rgb))
    n_ac, n_esc, *_ = je.unpack_compact(enc.cfn(torch.from_numpy(rgb))
                                        .numpy(), enc.clayout)[0]
    assert n_esc == int((ac.abs() > 127).sum()) > 0
    data = enc.encode_batch(torch.from_numpy(rgb))
    got = np.concatenate([c["coefs"] for c in
                          ji.read_coefficients(data[0]).comps])
    np.testing.assert_array_equal(got[:, 1:], ac[0].numpy())
    assert data == jje.JpegDeviceEncoder(32, 32, 95, batch=1).encode_batch(
        jnp.asarray(rgb))


def test_overflow_grows_and_recovers_as_jax():
    """Dense noise overflows the v3 pool: the batch is written truncated
    (valid JPEGs), counted, the pool grows, and the next batch equals an
    encode at full capacity; the JAX encoder does the same, byte for
    byte."""
    rng = np.random.default_rng(5)
    noise = np.stack([rng.integers(0, 256, (3, 40, 56), np.uint8)
                      for _ in range(2)])
    x = torch.from_numpy(noise)
    enc = je.JpegDeviceEncoder(56, 40, quality=95, batch=2, density=0.01,
                               device="cpu")
    jenc = jje.JpegDeviceEncoder(56, 40, quality=95, batch=2, density=0.01)
    cap0 = enc.capacity
    first, jfirst = enc.encode_batch(x), jenc.encode_batch(
        jnp.asarray(noise))
    assert enc.overflows == jenc.overflows >= 1 and first == jfirst
    for data in first:
        Image.open(io.BytesIO(data)).load()
    second = enc.encode_batch(x)
    assert second == jenc.encode_batch(jnp.asarray(noise))
    assert enc.capacity == jenc.capacity > cap0
    full = je.JpegDeviceEncoder(56, 40, quality=95, batch=2, density=1.0,
                                device="cpu")
    assert second == full.encode_batch(x) and full.overflows == 0


def test_dispatch_then_collect_equals_encode_batch():
    h, w = 32, 48
    frames = torch.from_numpy(np.stack([smooth_rgb(h, w, s)
                                        for s in range(3)]))
    enc = je.JpegDeviceEncoder(w, h, 85, batch=4, device="cpu")
    handle = enc.dispatch_batch(frames)        # padded to 4
    assert enc.collect_batch(handle, 3) == enc.encode_batch(frames)
    with pytest.raises(ValueError):
        enc.dispatch_batch(torch.cat([frames, frames]))
