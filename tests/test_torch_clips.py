"""The clip store, decoders and encoders of lives_tpu_torch against
lives_tpu's on the CPU: image-sequence, WAV and YUV4MPEG2-stream decoders,
`Clip` (image frames, `put_frame`, `realize`, audio, `Clip.load`,
`check_integrity`, `md5_frame`, `open_clip`'s audio rip), clip
directories written by one package and loaded by the other, the batched
read `read_rgb_batch`, the PNG-sequence, PDF and WAV encoders and audio
beside the YUV4MPEG2 and MJPEG encoders, `PNGSink` and `transcode`.

Inputs are made from a seed with numpy; the port runs with
`device="cpu"`. Tolerances: headers, frame indexes, audio files, WAV,
PNG and PDF files and `md5_frame` strings byte for byte; pixels 0 LSB
(the YUV -> RGB conversion is the JAX package's arithmetic, its K2 plain
version); audio sample-exact.
"""

import os
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lives_tpu.effects.host import instantiate as j_instantiate
from lives_tpu.io import clips as jclips
from lives_tpu.io import decoders as jdec
from lives_tpu.io import encoders as jenc
from lives_tpu.layer import Layer as JLayer
from lives_tpu.ops.colorspace import convert_layer as j_convert
from lives_tpu.player import sinks as jsinks
from lives_tpu.transcode import transcode as j_transcode
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import instantiate as t_instantiate
from lives_tpu_torch.io import clips as tclips
from lives_tpu_torch.io import decoders as tdec
from lives_tpu_torch.io import encoders as tenc
from lives_tpu_torch.player import sinks as tsinks
from lives_tpu_torch.transcode import transcode as t_transcode

CPU = "cpu"


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


# -- shared helpers (tests/test_torch_rfx.py, test_torch_clipedit.py) ---------

def yuv_frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(16, 236, (h, w), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8))
            for _ in range(n)]


def write_clip_y4m(path, n=8, w=48, h=32, seed=3, fps=25.0):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    jdec.write_y4m(str(path), yuv_frames(n, w, h, seed), fps)
    return path


def y4m_pair(tmp, n=8, w=48, h=32, seed=3, fps=25.0, audio=None,
             arate=8000):
    """The same YUV4MPEG2 file opened by both packages (all frames
    virtual), with the same unique_id; with `audio` (n, ch) float32, the
    same WAV ripped beside it."""
    tmp = Path(tmp)
    src = write_clip_y4m(tmp / f"src{seed}.y4m", n, w, h, seed, fps)
    jc = jclips.open_clip(str(src), tmp / "j")
    tc = tclips.open_clip(str(src), tmp / "t")
    tc.unique_id = jc.unique_id
    if audio is not None:
        for c in (jc, tc):
            c.write_audio(audio, arate)
    for c in (jc, tc):
        c.save_header()
    return jc, tc


def image_pair(tmp, n=8, w=48, h=32, seed=3, fps=25.0):
    """A clip of n seeded RGB image frames written by both packages."""
    tmp = Path(tmp)
    rng = np.random.default_rng(seed)
    jc = jclips.create_clip(tmp / "j", w, h, fps)
    tc = tclips.create_clip(tmp / "t", w, h, fps)
    tc.unique_id = jc.unique_id
    for i in range(n):
        arr = rng.integers(0, 256, (3, h, w), np.uint8)
        jc.put_frame(i, JLayer(planes=(jnp.asarray(arr),)))
        tc.put_frame(i, tclips.rgb_layer(arr))
    for c in (jc, tc):
        c.frames = n
        c.save_header()
    return jc, tc


def tree(d) -> dict:
    """{relative path: bytes} of every file under a directory (hardlinks
    read as their content)."""
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def frame_px(c, n) -> np.ndarray:
    """Frame n of either package's clip as a host (3, H, W) int array."""
    lay = c.get_frame(n)
    if isinstance(lay.planes[0], torch.Tensor):
        from lives_tpu_torch.ops.colorspace import convert_layer
        return convert_layer(lay, Palette.RGB24).planes[0].numpy().astype(
            int)
    return np.asarray(j_convert(lay, Palette.RGB24).planes[0]).astype(int)


def assert_clips_match(jc, tc, tol=0):
    """Both clips: the same frame count and index, header bytes, audio
    bytes, and each image frame within `tol` LSB and byte-identical where
    its pixels are equal."""
    assert jc.frames == tc.frames
    if jc.frame_index is None:
        assert tc.frame_index is None
    else:
        np.testing.assert_array_equal(jc.frame_index, tc.frame_index)
    assert (jc.clip_dir / "header.lives").read_bytes() == \
        (tc.clip_dir / "header.lives").read_bytes()
    for name in ("frame_index", "audio"):
        jp, tp = jc.clip_dir / name, tc.clip_dir / name
        assert jp.exists() == tp.exists()
        if jp.exists():
            assert jp.read_bytes() == tp.read_bytes(), name
    for n in range(jc.frames):
        if jc.is_virtual_frame(n):
            continue
        a, b = frame_px(jc, n), frame_px(tc, n)
        d = int(np.abs(a - b).max())
        assert d <= tol, (n, d)
        if d == 0:
            assert jc.image_path(n).read_bytes() == \
                tc.image_path(n).read_bytes(), n


# -- decoders -----------------------------------------------------------------

def test_imageseq_decoder_numeric_order_matches_jax(tmp_path):
    """Unpadded numbered sequences (1..12) decode in numeric order; the
    frames are the JAX decoder's, RGBA images keep their alpha."""
    for i in range(1, 13):
        Image.new("RGB", (8, 6), (i * 10, 3, 250 - i)).save(
            tmp_path / f"{i}.png")
    Image.new("RGBA", (8, 6), (1, 2, 3, 40)).save(tmp_path / "13.png")
    tcd, jcd = tdec.try_decoders(str(tmp_path)), \
        jdec.try_decoders(str(tmp_path))
    assert tcd.decoder.name == "imageseq" and tcd.nframes == jcd.nframes == 13
    assert (tcd.width, tcd.height, tcd.palette) == \
        (jcd.width, jcd.height, jcd.palette)
    for n in range(13):
        g, r = tcd.decoder.get_frame(n), jcd.decoder.get_frame(n)
        assert g.palette == r.palette
        np.testing.assert_array_equal(g.planes[0].numpy(),
                                      np.asarray(r.planes[0]))
    assert int(tcd.decoder.get_frame(9).planes[0][0, 0, 0]) == 100


def _wav_bytes(tag, bits, ch, rate, data: bytes) -> bytes:
    block = ch * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, tag, ch, rate,
                                    rate * block, block, bits)
            + b"data" + struct.pack("<I", len(data)) + data)


WAV_FORMATS = {
    "pcm8": (1, 8, lambda r: r.integers(0, 256, 600, np.uint8).tobytes()),
    "pcm16": (1, 16, lambda r: r.integers(-32768, 32767, 600,
                                          np.int16).astype("<i2").tobytes()),
    "pcm24": (1, 24, lambda r: r.integers(0, 256, 900, np.uint8).tobytes()),
    "pcm32": (1, 32, lambda r: r.integers(-2 ** 31, 2 ** 31 - 1, 600,
                                          np.int64).astype("<i4").tobytes()),
    "float32": (3, 32, lambda r: (r.random(600) * 2.2 - 1.1).astype(
        "<f4").tobytes()),
}


@pytest.mark.parametrize("fmt", sorted(WAV_FORMATS))
def test_wav_decoder_rips_like_jax(tmp_path, fmt):
    """Each PCM width and IEEE float rip to the same s16le bytes as the
    JAX decoder (float32 at `* 32767`, clipped)."""
    tag, bits, gen = WAV_FORMATS[fmt]
    p = tmp_path / "a.wav"
    p.write_bytes(_wav_bytes(tag, bits, 2, 8000,
                             gen(np.random.default_rng(len(fmt)))))
    tcd, jcd = tdec.try_decoders(str(p)), jdec.try_decoders(str(p))
    assert tcd.decoder.name == "wav"
    assert (tcd.achans, tcd.arate, tcd.asamps, tcd.nframes) == \
        (jcd.achans, jcd.arate, jcd.asamps, jcd.nframes) == (2, 8000, 16, 0)
    assert tcd.decoder.rip_audio(str(tmp_path / "t"))
    assert jcd.decoder.rip_audio(str(tmp_path / "j"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    with pytest.raises(RuntimeError):
        tcd.decoder.get_frame(0)


def test_wav_opens_as_audio_only_clip_like_jax(tmp_path):
    audio = np.sin(np.linspace(0, 200, 882)).astype(np.float32)
    stereo = np.stack([audio, -audio], 1)
    tenc.get_encoder("wav").encode(str(tmp_path / "t.wav"), [], 0, stereo,
                                   44100)
    jenc.get_encoder("wav").encode(str(tmp_path / "j.wav"), [], 0, stereo,
                                   44100)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    tc = tclips.open_clip(str(tmp_path / "t.wav"), tmp_path / "tw")
    jc = jclips.open_clip(str(tmp_path / "t.wav"), tmp_path / "jw")
    assert (tc.frames, tc.achans, tc.arate) == (jc.frames, jc.achans,
                                                jc.arate) == (0, 2, 44100)
    assert tc.audio_path.read_bytes() == jc.audio_path.read_bytes()
    np.testing.assert_array_equal(tc.read_audio(), jc.read_audio())


def test_y4m_stream_source_matches_jax(tmp_path):
    """The fifo reader: the next frame each call, the last one held at
    the end of the stream."""
    p = write_clip_y4m(tmp_path / "s.y4m", n=3, w=16, h=8, seed=4)
    ts, js = tdec.Y4MStreamSource(str(p)), jdec.Y4MStreamSource(str(p))
    assert (ts.width, ts.height, ts.fps, ts.scrap_on_record) == \
        (js.width, js.height, js.fps, True)
    for _ in range(5):
        g, r = ts.get_frame(), js.get_frame()
        for a, b in zip(g.planes, r.planes):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts.close()
    js.close()
    q = tmp_path / "empty.y4m"
    q.write_bytes(b"YUV4MPEG2 W16 H8 F25:1\n")
    with pytest.raises(EOFError):
        tdec.Y4MStreamSource(str(q)).get_frame()


def test_decoder_contract_defaults_match_jax(tmp_path):
    p = write_clip_y4m(tmp_path / "a.y4m", n=4, w=16, h=8)
    tcd, jcd = tdec.try_decoders(str(p)), jdec.try_decoders(str(p))
    assert tcd.decoder.rip_audio(str(tmp_path / "x")) is False
    for a, b in ((0, 3), (3, 1), (2, 2)):
        assert tcd.decoder.estimate_delay(a, b) == \
            jcd.decoder.estimate_delay(a, b)
    assert [c.name for c in tdec._DECODERS] == \
        [c.name for c in jdec._DECODERS]


# -- the clip store -----------------------------------------------------------

def test_put_frame_writes_the_jax_bytes_through_a_new_inode(tmp_path):
    jc, tc = image_pair(tmp_path, n=3, seed=11)
    before = os.stat(tc.image_path(1)).st_ino
    link = tmp_path / "held.png"
    os.link(tc.image_path(1), link)
    old = link.read_bytes()
    arr = np.random.default_rng(2).integers(0, 256, (3, 32, 48), np.uint8)
    # a YUV layer converts on its device first, as the JAX one does
    yuv = tuple(torch.from_numpy(p) for p in yuv_frames(1, 48, 32, 9)[0])
    tc.put_frame(1, tclips.Layer(planes=yuv, palette=int(Palette.YUV420P)))
    jc.put_frame(1, JLayer(planes=tuple(jnp.asarray(p.numpy())
                                        for p in yuv),
                           palette=int(Palette.YUV420P)))
    tc.put_frame(2, tclips.rgb_layer(arr))
    jc.put_frame(2, JLayer(planes=(jnp.asarray(arr),)))
    assert os.stat(tc.image_path(1)).st_ino != before
    assert link.read_bytes() == old            # the undo link is intact
    assert not list(tc.clip_dir.glob("*.tmp"))
    for c in (jc, tc):
        c.save_header()
    assert_clips_match(jc, tc)
    assert tc.version == jc.version


def test_realize_matches_jax(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=6)
    jc.realize(1, 4)
    tc.realize(1, 4, device=CPU)
    for c in (jc, tc):
        c.save_header()
    assert [tc.is_virtual_frame(n) for n in range(6)] == \
        [False if 1 <= n < 4 else True for n in range(6)]
    assert_clips_match(jc, tc)
    assert tc.get_frame(2).palette == Palette.RGB24


def test_frame_index_ops_and_header_match_jax(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=8)
    for c in (jc, tc):
        c.delete_frames(0, 2)
        c.reverse()
        c.insert_frames(0, np.array([0, 1]))
        c.save_header()
    assert tc.frames == 8 and tc.frame_index[2] == 7
    assert_clips_match(jc, tc)
    assert tc.check_integrity() and jc.check_integrity()


@pytest.mark.parametrize("audio_fmt", ["stereo", "mono_clip"])
def test_audio_roundtrip_is_sample_exact_and_jax_bytes(tmp_path, audio_fmt):
    """write_audio's `* 32768` and read_audio's `/ 32768` are symmetric:
    read -> write -> read is the identity, and the file is the JAX one."""
    rng = np.random.default_rng(7)
    if audio_fmt == "stereo":
        data = (rng.random((4410, 2)) * 2 - 1).astype(np.float32)
    else:
        data = (rng.random(1000) * 2.4 - 1.2).astype(np.float32)  # clips
    tc = tclips.create_clip(tmp_path / "t", 8, 8)
    jc = jclips.create_clip(tmp_path / "j", 8, 8)
    tc.write_audio(data, arate=44100)
    jc.write_audio(data, arate=44100)
    assert tc.audio_path.read_bytes() == jc.audio_path.read_bytes()
    a = tc.read_audio()
    np.testing.assert_array_equal(a, jc.read_audio())
    tc.write_audio(a)
    np.testing.assert_array_equal(tc.read_audio(), a)
    assert (tc.achans, tc.arate, tc.asampsize) == (jc.achans, jc.arate, 16)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_clip_dirs_load_across_packages(tmp_path, writer):
    """A clip directory (virtual and image frames, audio, the header) that
    one package wrote loads in the other with the same frames, index,
    audio and header bytes, and saving it again rewrites the same
    bytes."""
    audio = (np.random.default_rng(1).random((2000, 2)) - 0.5).astype(
        np.float32)
    jc, tc = y4m_pair(tmp_path, n=6, audio=audio)
    src = jc if writer == "jax" else tc
    src.realize(2, 4) if writer == "jax" else src.realize(2, 4, device=CPU)
    src.name = "clip é"
    src.save_header()
    before = tree(src.clip_dir)
    other = (tclips.Clip if writer == "jax" else jclips.Clip).load(
        src.clip_dir)
    assert other.check_integrity()
    assert (other.frames, other.fps, other.unique_id, other.name,
            other.achans, other.arate) == (src.frames, src.fps,
                                           src.unique_id, src.name, 2, 8000)
    np.testing.assert_array_equal(other.frame_index, src.frame_index)
    for n in range(6):
        np.testing.assert_array_equal(frame_px(other, n), frame_px(src, n))
    np.testing.assert_array_equal(other.read_audio(), src.read_audio())
    other.save_header()
    assert tree(src.clip_dir) == before


def test_check_integrity_matches_jax(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=4)
    for c in (jc, tc):
        c.insert_frames(1, np.array([-1]))   # an image that is missing
    assert tc.check_integrity() == jc.check_integrity() is False
    for c in (jc, tc):
        c.delete_frames(1, 1)
        c.frame_index[0] = 99                # past the decoder's frames
    assert tc.check_integrity() == jc.check_integrity() is False
    t2 = tclips.Clip.load(tc.clip_dir)
    t2.source_uri = ""
    t2.cdata = None
    assert not t2.check_integrity()


def test_md5_frame_matches_jax(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=4)
    same = np.full((3, 32, 48), 7, np.uint8)
    for n in (1, 2):
        jc.put_frame(n, JLayer(planes=(jnp.asarray(same),)))
        tc.put_frame(n, tclips.rgb_layer(same))
    jv = [jclips.md5_frame(jc, n) for n in range(4)]
    tv = [tclips.md5_frame(tc, n) for n in range(4)]
    assert tv == jv
    assert tv[1] == tv[2] and tv[0] != tv[3]


def test_create_clip_header_matches_jax(tmp_path):
    tc = tclips.create_clip(tmp_path / "t", 48, 24, fps=30.0, name="r")
    jc = jclips.create_clip(tmp_path / "j", 48, 24, fps=30.0, name="r")
    tc.unique_id = jc.unique_id
    tc.save_header()
    assert (tc.clip_dir / "header.lives").read_bytes() == \
        (jc.clip_dir / "header.lives").read_bytes()
    assert tc.clip_type == tclips.ClipType.DISK and tc.frames == 0


@pytest.mark.parametrize("kind", ["y4m", "images", "mixed"])
def test_read_rgb_batch_is_the_jax_conversion(tmp_path, kind):
    """The batched read equals the JAX package's per-frame
    `convert_layer(get_frame(n), RGB24)`, bit for bit."""
    jc, tc = (image_pair(tmp_path, n=5) if kind == "images"
              else y4m_pair(tmp_path, n=5))
    if kind == "mixed":
        jc.realize(1, 3)
        tc.realize(1, 3, device=CPU)
    ns = [4, 0, 1, 2, 3, 3]
    got = tclips.read_rgb_batch(tc, ns, CPU)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (6, 3, 32, 48)
    ref = np.stack([np.asarray(j_convert(jc.get_frame(n),
                                         Palette.RGB24).planes[0])
                    for n in ns])
    np.testing.assert_array_equal(got.numpy(), ref)


# -- encoders and sinks -------------------------------------------------------

def _rgb_frames(n, w=24, h=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, h, w), np.uint8) for _ in range(n)]


def test_encoder_registry_matches_jax():
    """The port's registry is the JAX package's as a fresh process imports
    it once its bridges have loaded (`test_torch_bridges.jax_bridge`):
    that registry is decided at import, and a worker whose import lost
    the bridges' build race lacks "mjpeg" and "av". "ffmpeg" stands in
    both where the binary is on PATH, in neither where it is not."""
    from lives_tpu_torch import native
    from test_torch_bridges import jax_registry_in_subprocess
    bridges = ["jpegcoef"] + (["avbridge"] if native.load_avbridge()
                              is not None else [])
    jreg = jax_registry_in_subprocess(bridges)
    assert tenc.list_encoders() == sorted(jreg)
    assert tenc.WavEncoder.get_capabilities() == jenc.CAP_AUDIO
    for name in ("pngseq", "pdf", "wav", "mjpeg"):
        assert [f.__dict__ for f in tenc.get_encoder(name).get_formats()] \
            == jreg[name]


@pytest.mark.parametrize("layout", ["chw", "hwc", "tensor"])
def test_pngseq_encoder_bytes_match_jax(tmp_path, layout):
    frames = _rgb_frames(3)
    tin = {"chw": frames, "hwc": [np.moveaxis(f, 0, -1) for f in frames],
           "tensor": [torch.from_numpy(f) for f in frames]}[layout]
    assert tenc.get_encoder("pngseq").encode(str(tmp_path / "t"), tin, 25.0)
    assert jenc.get_encoder("pngseq").encode(str(tmp_path / "j"), frames,
                                             25.0)
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert len(tree(tmp_path / "t")) == 3


def test_pdf_encoder_bytes_match_jax(tmp_path):
    import re
    frames = _rgb_frames(3, seed=4)
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
    assert tenc.get_encoder("pdf").encode(str(tmp_path / "t" / "o.pdf"),
                                          frames, 25.0)
    assert jenc.get_encoder("pdf").encode(str(tmp_path / "j" / "o.pdf"),
                                          frames, 25.0)
    t = (tmp_path / "t" / "o.pdf").read_bytes()
    j = (tmp_path / "j" / "o.pdf").read_bytes()
    # PIL stamps the time of writing into the document's info dictionary
    stamp = re.compile(rb"\(D:\d{14}Z\)")
    assert stamp.sub(b"", t) == stamp.sub(b"", j) and t.startswith(b"%PDF")
    assert not tenc.get_encoder("pdf").encode(str(tmp_path / "e.pdf"), [],
                                              25.0)


@pytest.mark.parametrize("shape", ["interleaved", "channels_first", "mono"])
def test_wav_encoder_bytes_match_jax(tmp_path, shape):
    rng = np.random.default_rng(3)
    a = (rng.random((500, 2)) * 2.4 - 1.2).astype(np.float32)
    a = {"interleaved": a, "channels_first": a.T, "mono": a[:, 0]}[shape]
    assert tenc.get_encoder("wav").encode(str(tmp_path / "t.wav"), [], 25.0,
                                          a, 8000)
    assert jenc.get_encoder("wav").encode(str(tmp_path / "j.wav"), [], 25.0,
                                          a, 8000)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    assert not tenc.get_encoder("wav").encode(str(tmp_path / "n.wav"), [],
                                              25.0)


def test_y4m_and_mjpeg_encoders_write_audio_beside(tmp_path):
    frames = _rgb_frames(2, w=32, h=16)
    audio = (np.random.default_rng(8).random((800, 2)) - 0.5).astype(
        np.float32)
    assert tenc.get_encoder("yuv4mpeg").encode(str(tmp_path / "t.y4m"),
                                               frames, 25.0, audio, 8000)
    assert jenc.get_encoder("yuv4mpeg").encode(str(tmp_path / "j.y4m"),
                                               frames, 25.0, audio, 8000)
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    enc = tenc.MJPEGDeviceEncoder(device=CPU)
    flat = [torch.full((3, 16, 32), 60 * i, dtype=torch.uint8)
            for i in range(2)]
    assert enc.encode(str(tmp_path / "m.avi"), flat, 25.0, audio, 8000)
    assert (tmp_path / "m.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()


def test_png_sink_matches_jax(tmp_path):
    frames = _rgb_frames(3, seed=6)
    ts, js = tsinks.PNGSink(tmp_path / "t"), jsinks.PNGSink(tmp_path / "j")
    for i, f in enumerate(frames):
        assert ts.play_frame(tclips.rgb_layer(f), i / 25.0)
        js.play_frame(JLayer(planes=(jnp.asarray(f),)), i / 25.0)
    assert ts.n == 3 and tree(tmp_path / "t") == tree(tmp_path / "j")


# -- transcode ----------------------------------------------------------------

@pytest.mark.parametrize("encoder,chain", [
    ("yuv4mpeg", ("gaussian_blur", "vignette")),
    ("yuv4mpeg", ()),
    ("pngseq", ("sepia",)),
])
def test_transcode_matches_jax(tmp_path, encoder, chain):
    """A Y4M clip through a chain into an encoder, its audio in a WAV
    beside the output: the files equal the JAX transcode's (batches of 3
    against the JAX package's 32)."""
    audio = (np.random.default_rng(2).random((2560, 1)) - 0.5).astype(
        np.float32)
    jc, tc = y4m_pair(tmp_path, n=7, audio=audio)
    ext = "y4m" if encoder == "yuv4mpeg" else "png"
    tout, jout = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    seen = []
    assert t_transcode(tc, str(tout), encoder,
                       [t_instantiate(n) for n in chain], batch_size=3,
                       device=CPU, progress_cb=lambda d, t: seen.append(d))
    assert j_transcode(jc, str(jout), encoder,
                       [j_instantiate(n) for n in chain])
    assert seen == list(range(1, 8))
    if encoder == "yuv4mpeg":
        assert tout.read_bytes() == jout.read_bytes()
        assert tout.with_suffix(".wav").read_bytes() == \
            jout.with_suffix(".wav").read_bytes()
    else:
        assert tree(tout) == tree(jout)


def test_transcode_range_resize_and_no_audio(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=6,
                      audio=np.zeros((100, 2), np.float32))
    assert t_transcode(tc, str(tmp_path / "t.y4m"), start=1, end=5,
                       width=24, height=16, include_audio=False,
                       batch_size=2, device=CPU)
    assert j_transcode(jc, str(tmp_path / "j.y4m"), start=1, end=5,
                       width=24, height=16, include_audio=False)
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()
    assert not (tmp_path / "t.wav").exists()
