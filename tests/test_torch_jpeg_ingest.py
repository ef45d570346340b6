"""The compressed ingest lane of lives_tpu_torch (`io/jpeg_ingest.py`,
ROADMAP Queue 1 item 18) against lives_tpu's on the CPU: the host packs
tuple for tuple, the device decoder within 1 LSB of the JAX decoder and
of the float64 twin (4:2:0, 4:4:4 and 4:2:0 at odd sizes, greyscale,
progressive), a capacity overflow decoded by the twin and counted, and
the layers through the colour conversion.

JPEG frames come from PIL on seeded numpy content (the JAX package's own
test images, `tests/test_jpeg_ingest.py:22-36`). The port's decoder runs
on CPU tensors (`device="cpu"`); the JAX one under JAX_PLATFORMS=cpu.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lives_tpu.constants import Palette as JPalette
from lives_tpu.io import jpeg_ingest as jji
from lives_tpu.layer import Layer as JLayer
from lives_tpu.ops.colorspace import convert_layer as j_convert_layer
from lives_tpu_torch import native
from lives_tpu_torch.constants import Palette, YUVClamping
from lives_tpu_torch.io import jpeg_ingest as ji
from lives_tpu_torch.ops.colorspace import convert_layer

CPU = torch.device("cpu")


def jpeg_bytes(w=128, h=64, quality=85, seed=0, gray=False, **save):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 80 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
            + rng.normal(0, 6, (h, w))).clip(0, 255)
    if gray:
        img = Image.fromarray(base.astype(np.uint8), "L")
    else:
        rgb = np.stack([base, np.roll(base, 7, 1), 255 - base],
                       -1).astype(np.uint8)
        img = Image.fromarray(rgb, "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality, **save)
    return buf.getvalue()


#: name -> (w, h, PIL save arguments)
CASES = {
    "420": (128, 64, {}),
    "444_odd": (75, 37, {"subsampling": 0}),
    "420_odd": (101, 75, {}),
    "gray": (96, 40, {"gray": True}),
    "progressive": (128, 64, {"progressive": True}),
}


def case_frames(name, n=3, quality=90):
    w, h, kw = CASES[name]
    return [jpeg_bytes(w, h, quality, seed=s, **kw) for s in range(n)]


def within_1(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def test_bridge_builds_under_its_own_name():
    """The port's jpegcoef library lives under build/, named by a hash,
    never the JAX loader's native/jpegcoef.so."""
    lib = native.load_jpegcoef()
    built = native._LOADED["jpegcoef"]
    assert built.lib is lib
    assert built.path.parent == native.BUILD_DIR
    assert built.path.name.startswith("libjpegcoef-")
    assert built.path.name != "jpegcoef.so"
    for fn in ("jc_read", "jc_read_packed", "jc_write_packed"):
        assert getattr(lib, fn).restype is not None
    route = native.system_libjpeg() or native.pillow_libjpeg()
    assert built.libjpeg == route.name


def test_bridge_on_pillows_libjpeg_matches_the_loaded_one(monkeypatch):
    """The build a host without libjpeg headers makes (the kept jpeg62
    headers, Pillow's libjpeg-turbo) reads, packs and writes what the
    loaded build does, under another name."""
    from lives_tpu_torch.io import jpeg_encode as je
    loaded = native._LOADED.get("jpegcoef") or native._LOADED.setdefault(
        "jpegcoef", native.build_jpegcoef(
            native.system_libjpeg() or native.pillow_libjpeg()))
    pil = native.build_jpegcoef(native.pillow_libjpeg())
    assert pil.libjpeg.startswith("pillow libjpeg-turbo ")
    out = {}
    for name, built in (("loaded", loaded), ("pillow", pil)):
        monkeypatch.setitem(native._LOADED, "jpegcoef", built)
        got = []
        for case in sorted(CASES):
            data = case_frames(case, 1)[0]
            f = ji.read_coefficients(data)
            packed = ji.read_packed_native(data, ji.JpegMeta.of(f), 4096)
            got.append((f.qtabs, [c["coefs"] for c in f.comps], packed))
        rgb = np.random.default_rng(1).integers(0, 256, (2, 3, 24, 40),
                                                np.uint8)
        got.append(je.JpegDeviceEncoder(40, 24, batch=2, device="cpu")
                   .encode_batch(torch.from_numpy(rgb)))
        out[name] = got
    for a, b in zip(out["loaded"], out["pillow"]):
        if isinstance(a, list):
            assert a == b
            continue
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)
        assert (a[2] is None) == (b[2] is None)
        for x, y in zip(a[2] or (), b[2] or ()):
            np.testing.assert_array_equal(x, y)


def test_pillow_libjpeg_refuses_what_does_not_fit(tmp_path, monkeypatch):
    """The fallback raises, naming what it found: not exactly one jpeg62
    library, another JPEG_LIB_VERSION, a libjpeg-turbo older than the
    kept headers; and a library that cannot read a JPEG after its build."""
    import PIL
    from PIL import features
    real = features.version
    fake = tmp_path / "PIL" / "__init__.py"
    (tmp_path / "pillow.libs").mkdir()
    monkeypatch.setattr(PIL, "__file__", str(fake))
    with pytest.raises(RuntimeError, match="holds 0 jpeg62"):
        native.pillow_libjpeg()
    for n in ("libjpeg-a.so.62.4.0", "libjpeg-b.so.62.3.0"):
        (tmp_path / "pillow.libs" / n).write_bytes(b"")
    with pytest.raises(RuntimeError, match="holds 2 jpeg62"):
        native.pillow_libjpeg()
    (tmp_path / "pillow.libs" / "libjpeg-b.so.62.3.0").unlink()
    assert native.pillow_libjpeg().library.name == "libjpeg-a.so.62.4.0"
    for jpg, turbo in (("8.0", "3.1.3"), ("6.2", "2.0.4"), ("6.2", None)):
        monkeypatch.setattr(features, "version", lambda f, jpg=jpg,
                            turbo=turbo: {"jpg": jpg,
                                          "libjpeg_turbo": turbo}.get(f))
        with pytest.raises(RuntimeError, match="must serve the same"):
            native.pillow_libjpeg()
    monkeypatch.setattr(features, "version", real)

    class Refusing:
        @staticmethod
        def jc_read(*args):
            return -1
    with pytest.raises(RuntimeError, match="cannot read a 16x16 JPEG"):
        native._check_jpegcoef(Refusing, native.pillow_libjpeg())


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_coefficients_matches_jax(name):
    data = case_frames(name, 1)[0]
    j, t = jji.read_coefficients(data), ji.read_coefficients(data)
    assert (j.height, j.width) == (t.height, t.width)
    np.testing.assert_array_equal(j.qtabs, t.qtabs)
    assert len(j.comps) == len(t.comps)
    for a, b in zip(j.comps, t.comps):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ji.JpegMeta.of(t) == ji.JpegMeta(*jji.JpegMeta.of(j).__dict__
                                            .values())


@pytest.mark.parametrize("quality", [85, 97])
def test_pack_frame_and_native_pack_match_jax(quality):
    """The v2 pack tuples, python and native, equal the JAX package's
    (q97 ships escapes)."""
    data = jpeg_bytes(quality=quality, seed=11)
    jf, tf = jji.read_coefficients(data), ji.read_coefficients(data)
    meta = ji.JpegMeta.of(tf)
    cap = meta.n_blocks * 64
    py_j, py_t = jji.pack_frame(jf, cap), ji.pack_frame(tf, cap)
    nat_j = jji.read_packed_native(data, jji.JpegMeta.of(jf), cap)
    nat_t = ji.read_packed_native(data, meta, cap)
    for a, b, c, d in zip(py_j, py_t, nat_j, nat_t):
        for x in (b, c, d):
            np.testing.assert_array_equal(a, x)
    if quality == 97:
        assert (py_t[4] >= 0).any()        # escapes present
    assert ji.wire_bytes(cap, meta.n_blocks) == \
        jji.wire_bytes(cap, meta.n_blocks)


def test_native_pack_overflow_returns_none():
    data = jpeg_bytes(quality=95, seed=1)
    meta = ji.JpegMeta.of(ji.read_coefficients(data))
    assert ji.read_packed_native(data, meta, 4) is None
    assert ji.pack_frame(ji.read_coefficients(data), 4) is None


def test_corrupt_stream_raises():
    with pytest.raises(ValueError):
        ji.read_coefficients(b"not a jpeg")


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_decoder_matches_jax_and_twin(name):
    """The decoder's planes within 1 LSB of the JAX decoder and of
    `decode_frame_ref`; the layers (cropped to even sizes for 4:2:0) and
    their RGB within 1 LSB of the JAX package's."""
    frames = case_frames(name)
    js = jji.JpegStreamSource(frames)
    ts = ji.JpegStreamSource(frames, device="cpu")
    assert (ts.capacity, ts.meta) == (js.capacity, ji.JpegMeta(
        *js.meta.__dict__.values()))
    idx = [2, 0, 1]
    jl, tl = js.get_batch_planes(idx), ts.get_batch_planes(idx)
    assert (tl.palette, tl.clamping) == (int(jl.palette), int(jl.clamping))
    assert tl.clamping == YUVClamping.UNCLAMPED
    refs = [ji.decode_frame_ref(ji.read_coefficients(frames[i]))
            for i in idx]
    for k, (a, b) in enumerate(zip(jl.planes, tl.planes)):
        within_1(a, b)
        if len(refs[0]) > k:
            within_1(np.stack([r[k][:b.shape[1], :b.shape[2]]
                               for r in refs]), b)
    # the layer through the colour conversion, one frame at a time on the
    # JAX side (its convert_layer stacks channels on axis 0)
    rgb = convert_layer(tl, Palette.RGB24).planes[0]
    for i in range(len(idx)):
        one = JLayer(planes=tuple(p[i] for p in jl.planes),
                     palette=jl.palette, clamping=jl.clamping,
                     subspace=jl.subspace)
        within_1(j_convert_layer(one, JPalette.RGB24).planes[0], rgb[i])
    assert ts.fallbacks == js.fallbacks == 0


def test_decoder_is_its_own_function_of_the_packs():
    """build_device_decoder on packs built by hand: the same planes as the
    stream source, and escapes override their clamped entries."""
    data = jpeg_bytes(quality=97, seed=5)
    f = ji.read_coefficients(data)
    meta = ji.JpegMeta.of(f)
    cap = meta.n_blocks * 64
    p = ji.pack_frame(f, cap)
    assert (p[4] >= 0).any()
    dec = ji.build_device_decoder(meta, 1, cap, device="cpu")
    planes = dec(*(torch.from_numpy(np.asarray(a)[None]) for a in p[:6]),
                 torch.from_numpy(p[6].astype(np.float32)[None]))
    jdec = jji.build_device_decoder(jji.JpegMeta(*meta.__dict__.values()),
                                    1, cap)
    jplanes = jdec(*(jnp.asarray(np.asarray(a)[None]) for a in p[:6]),
                   jnp.asarray(p[6].astype(np.float32)[None]))
    for a, b, r in zip(jplanes, planes, ji.decode_frame_ref(f)):
        within_1(a, b)
        within_1(r[None], b)


def test_capacity_overflow_decodes_through_the_twin_and_counts():
    frames = [jpeg_bytes(quality=95, seed=s) for s in range(3)]
    js = jji.JpegStreamSource(frames, capacity_frac=0.01)
    ts = ji.JpegStreamSource(frames, capacity_frac=0.01, device="cpu")
    jl, tl = js.get_batch_planes([0, 1, 2]), ts.get_batch_planes([0, 1, 2])
    assert ts.fallbacks == js.fallbacks == 3
    for k, (a, b) in enumerate(zip(jl.planes, tl.planes)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        ref = np.stack([ji.decode_frame_ref(ji.read_coefficients(x))[k]
                        [:b.shape[1], :b.shape[2]] for x in frames])
        np.testing.assert_array_equal(ref, b.numpy())


def test_split_layer_batch_views_each_frame():
    ts = ji.JpegStreamSource(case_frames("420"), device="cpu")
    lay = ts.get_batch_planes([0, 1, 2])
    parts = ji.split_layer_batch(lay)
    assert len(parts) == 3
    for i, one in enumerate(parts):
        assert one.palette == lay.palette and one.clamping == lay.clamping
        for p, q in zip(one.planes, lay.planes):
            assert torch.equal(p, q[i])
    jparts = jji.split_layer_batch(jji.JpegStreamSource(
        case_frames("420")).get_batch_planes([0, 1, 2]))
    assert [int(p.gamma) for p in jparts] == [p.gamma for p in parts]


def test_stream_source_reads_wrapping_indices_and_sizes():
    frames = case_frames("420", 2)
    ts = ji.JpegStreamSource(frames, device="cpu")
    a = ts.get_batch_planes([3])     # 3 % 2 == 1
    b = ts.get_batch_planes([1])
    for p, q in zip(a.planes, b.planes):
        assert torch.equal(p, q)
    assert ts.wire_bytes_per_frame() == ji.wire_bytes(
        ts.capacity, ts.meta.n_blocks)


def test_cuda_device_refused_without_cuda():
    """The device is explicit: "cuda" (the default) raises without CUDA
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert ji.resolve_device("cuda", "x").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ji.JpegStreamSource(case_frames("420", 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ji.build_device_decoder(ji.JpegMeta(8, 8, ((1, 1, 0, 8, 8),),
                                            (1, 1)), 1, 64)


def test_block_products_round_once():
    """The IDCT's two products: float64 accumulation rounded once to
    float32, within half an ulp of the float64 result."""
    rng = np.random.default_rng(3)
    F = torch.from_numpy(rng.normal(0, 300, (64, 8, 8)).astype(np.float32))
    A = torch.from_numpy(ji._idct_basis(np.float64))
    got = ji.block_products(A, F, A.T)
    assert got.dtype == torch.float32
    exact = A.numpy() @ F.double().numpy() @ A.numpy().T
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
