"""The in-process libav lane of lives_tpu_torch (`io/av.py`, the "av"
encoder, `AVStreamSink`) against lives_tpu's.

Each case of tests/test_av.py runs on the port with real H.264/MKV,
Theora/OGV, MPEG-4/AVI, GIF and DV media made in-process. Both packages
build the same bridge (native/avbridge.cpp), so the same file decodes to
the same planes and clip data in both, bit for bit, and a clip the port's
encoder writes decodes in the JAX package to the planes of the JAX
encoder's own file. The containers' bytes are the same only for MPEG-4
in AVI: the Matroska, Ogg and WebM muxers write per-file identifiers, so
the other files are held by their decoded planes.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from lives_tpu.io import av as jav
from lives_tpu.io.decoders import try_decoders as j_try_decoders
from lives_tpu_torch import native
from lives_tpu_torch.io import av
from lives_tpu_torch.io.decoders import try_decoders
from test_torch_bridges import jax_bridge, jax_encoder

pytestmark = pytest.mark.skipif(av.load_avbridge() is None,
                                reason="libav bridge unavailable")


@pytest.fixture(autouse=True)
def jax_avbridge():
    """Every test here compares against the JAX package's avbridge bridge."""
    jax_bridge("avbridge")

W, H, N = 128, 64, 30


def _frames():
    """Index-coded frames: frame i is a flat grey at 8*i + vertical bar."""
    out = []
    for i in range(N):
        f = np.full((3, H, W), i * 8, np.uint8)
        f[:, :, (i * 4) % W:(i * 4) % W + 4] = 255
        out.append(f)
    return out


def _tone():
    t = np.linspace(0, 1.0, 22050)
    tone = (np.sin(2 * np.pi * 440 * t) * 16000).astype(np.int16)
    return np.stack([tone, tone], -1)


def _write(mod, path, frames=None, **kw):
    sess = mod.AVEncodeSession(str(path), W, H, 25.0, **kw)
    for f in frames if frames is not None else _frames():
        sess.write_frame(f)
    if kw.get("arate"):
        sess.write_audio(_tone())
    sess.close()
    return path


@pytest.fixture(scope="module")
def mkv_fixture(tmp_path_factory):
    path = _write(av, tmp_path_factory.mktemp("av") / "fixture.mkv",
                  arate=22050, achans=2)
    assert path.stat().st_size > 1000
    return path


def assert_same_decode(path, frames=range(N)):
    """The port and the JAX package decode `path` to the same clip data
    and the same planes."""
    cd, jcd = try_decoders(str(path)), j_try_decoders(str(path))
    for f in ("nframes", "width", "height", "fps", "palette",
              "yuv_clamping", "yuv_subspace", "arate", "achans",
              "interlace", "kframe_dist"):
        assert getattr(cd, f) == getattr(jcd, f), f
    assert cd.decoder.codec == jcd.decoder.codec
    for i in frames:
        lay, jlay = cd.decoder.get_frame(i), jcd.decoder.get_frame(i)
        assert (lay.palette, lay.clamping, lay.subspace) == \
            (jlay.palette, jlay.clamping, jlay.subspace)
        for p, q in zip(lay.planes, jlay.planes):
            assert p.device.type == "cpu"
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    cd.decoder.close()
    jcd.decoder.close()
    return cd


def test_h264_mkv_decode_contract(mkv_fixture):
    cd = try_decoders(str(mkv_fixture))
    assert cd is not None and cd.decoder is not None
    assert type(cd.decoder).__name__ == "AVDecoder"
    assert (cd.width, cd.height, cd.nframes) == (W, H, N)
    assert abs(cd.fps - 25.0) < 0.01
    assert cd.decoder.codec == "h264"
    assert cd.arate == 22050 and cd.achans == 2
    for i in (0, 7, 15, N - 1):
        lay = cd.decoder.get_frame(i)
        y = lay.planes[0].numpy()
        assert y.shape == (H, W) and lay.planes[1].shape == (H // 2, W // 2)
        cols = np.ones(W, bool)
        bar = (i * 4) % W
        cols[max(0, bar - 4):bar + 8] = False
        expect = 16 + 8 * i * 219 / 255
        assert abs(float(y[:, cols].mean()) - expect) < 14, (i, y.mean())
    out = (np.empty((H, W), np.uint8), np.empty((H // 2, W // 2), np.uint8),
           np.empty((H // 2, W // 2), np.uint8))
    lay = cd.decoder.get_frame(3, out=out)
    assert lay.planes[0].data_ptr() == out[0].ctypes.data
    cd.decoder.close()


def test_same_file_same_planes_in_both_packages(mkv_fixture):
    assert_same_decode(mkv_fixture)


def test_estimate_delay_ordering(mkv_fixture):
    cd = try_decoders(str(mkv_fixture))
    jcd = j_try_decoders(str(mkv_fixture))
    d = cd.decoder
    fwd = d.estimate_delay(10, 11)
    jump_far = d.estimate_delay(-1, N - 1)
    assert fwd < jump_far
    kf_cost = [d.estimate_delay(-1, i) for i in range(0, 8)]
    assert kf_cost == sorted(kf_cost)
    assert kf_cost == [jcd.decoder.estimate_delay(-1, i) for i in range(8)]
    d.close()
    jcd.decoder.close()


def test_rip_audio(mkv_fixture, tmp_path):
    cd = try_decoders(str(mkv_fixture))
    out = tmp_path / "a.pcm"
    assert cd.decoder.rip_audio(str(out))
    pcm = np.fromfile(out, np.int16).reshape(-1, 2)
    assert abs(pcm.shape[0] - 22050) < 4096
    spec = np.abs(np.fft.rfft(pcm[2048:2048 + 8192, 0].astype(float)))
    hz = (spec[10:].argmax() + 10) * 22050 / 8192
    assert abs(hz - 440) < 30, hz
    jcd = j_try_decoders(str(mkv_fixture))
    assert jcd.decoder.rip_audio(str(tmp_path / "j.pcm"))
    assert out.read_bytes() == (tmp_path / "j.pcm").read_bytes()
    cd.decoder.close()
    jcd.decoder.close()


def test_player_plays_100_frames_from_mkv(mkv_fixture, tmp_path):
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.player import CollectSink, Player
    clip = open_clip(str(mkv_fixture), tmp_path)
    assert clip.frames == N and clip.audio_path.exists()
    sink = CollectSink()
    p = Player(sink=sink, sink_spec=SinkSpec(width=W, height=H),
               device="cpu")
    p.state.fg_clip = clip
    p.start()
    for i in range(100):
        p.state.frame = -1
        p._clock0 = time.monotonic()
        p._frame0 = float(i % N)
        assert p.process_one()
    p.stop()
    assert p.frames_shown == 100
    assert np.asarray(sink.frames[-1]).shape[-2:] == (H, W)


def test_theora_ogv_roundtrip(tmp_path):
    if not av.load_avbridge().avb_have_encoder(b"libtheora"):
        pytest.skip("libtheora encoder absent")
    path = _write(av, tmp_path / "t.ogv", _frames()[:10])
    cd = try_decoders(str(path))
    assert cd is not None and cd.nframes == 10
    assert cd.decoder.codec == "theora"
    y = cd.decoder.get_frame(5).planes[0].numpy()
    assert abs(float(y[:, :8].mean()) - (16 + 40 * 219 / 255)) < 16
    cd.decoder.close()
    assert_same_decode(path, range(10))


def test_encoder_registry_contract():
    from lives_tpu_torch.io.encoders import (CAP_AUDIO, CAP_VIDEO,
                                             get_encoder, list_encoders)
    assert "av" in list_encoders()
    enc = get_encoder("av")
    assert enc.get_capabilities() == CAP_VIDEO | CAP_AUDIO
    fmts = {(f.name, f.extension) for f in enc.get_formats()}
    assert {"mkv", "mp4", "ogv"} <= {e for _, e in fmts}
    assert fmts == {(f.name, f.extension)
                    for f in jax_encoder("av").get_formats()}


@pytest.mark.parametrize("ext", ["mkv", "ogv", "avi", "webm"])
def test_port_encoder_file_decodes_as_the_jax_encoders(ext, tmp_path):
    """The same frames through both packages' "av" encoders: the JAX
    package decodes the port's file to the planes of its own (MPEG-4 in
    AVI byte for byte)."""
    from lives_tpu_torch.io.encoders import get_encoder
    frames = _frames()[:12]
    port, ref = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
    assert get_encoder("av").encode(str(port), [torch.from_numpy(f)
                                                for f in frames], 25.0)
    assert jax_encoder("av").encode(str(ref), frames, 25.0)
    a, b = j_try_decoders(str(port)), j_try_decoders(str(ref))
    assert a.nframes == b.nframes == 12
    for i in range(12):
        for p, q in zip(a.decoder.get_frame(i).planes,
                        b.decoder.get_frame(i).planes):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))
    if ext == "avi":
        assert port.read_bytes() == ref.read_bytes()
    a.decoder.close()
    b.decoder.close()


def test_transcode_mkv_to_mkv_with_fx(mkv_fixture, tmp_path):
    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.transcode import transcode
    clip = open_clip(str(mkv_fixture), tmp_path)
    out = tmp_path / "out.mkv"
    assert transcode(clip, str(out), encoder="av",
                     chain=[instantiate("negate")], device="cpu")
    assert out.stat().st_size > 1000
    cd2 = try_decoders(str(out))
    assert cd2.nframes == N and cd2.decoder.codec == "h264"
    y = cd2.decoder.get_frame(0).planes[0].numpy()
    cols = np.ones(W, bool)
    cols[:12] = False
    assert y[:, cols].mean() > 200
    cd2.decoder.close()


def test_corrupt_media_fails_cleanly(tmp_path):
    garbage = tmp_path / "garbage.mkv"
    garbage.write_bytes(b"\x1aE\xdf\xa3" + bytes(64))
    assert try_decoders(str(garbage)) is None
    noise = tmp_path / "noise.mp4"
    noise.write_bytes(np.random.default_rng(0).integers(
        0, 256, 4096, dtype=np.uint8).tobytes())
    assert try_decoders(str(noise)) is None


def test_truncated_valid_media(mkv_fixture, tmp_path):
    data = mkv_fixture.read_bytes()
    cut = tmp_path / "cut.mkv"
    cut.write_bytes(data[: len(data) * 2 // 3])
    cd = try_decoders(str(cut))
    jcd = j_try_decoders(str(cut))
    assert (cd is None) == (jcd is None)
    if cd is None:
        return
    assert 0 < cd.nframes <= N and cd.nframes == jcd.nframes
    np.testing.assert_array_equal(
        cd.decoder.get_frame(0).planes[0].numpy(),
        np.asarray(jcd.decoder.get_frame(0).planes[0]))
    cd.decoder.close()
    jcd.decoder.close()


def test_concurrent_decode_threadsafe(mkv_fixture):
    cd = try_decoders(str(mkv_fixture))
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                i = int(rng.integers(0, N))
                y = cd.decoder.get_frame(i).planes[0].numpy()
                cols = np.ones(W, bool)
                bar = (i * 4) % W
                cols[max(0, bar - 4):bar + 8] = False
                if abs(float(y[:, cols].mean())
                       - (16 + 8 * i * 219 / 255)) > 14:
                    errors.append((seed, i))
        except Exception as e:  # noqa: BLE001
            errors.append((seed, repr(e)))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:5]
    cd.decoder.close()


def test_longtail_encoders_gif_dv_pdf(tmp_path):
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.encoders import get_encoder
    enc = get_encoder("av")
    if ("gif", "gif") not in {(f.name, f.extension)
                              for f in enc.get_formats()}:
        pytest.skip("gif encoder absent from this libav build")
    frames = [np.full((120, 160, 3), i * 40, np.uint8) for i in range(5)]
    assert enc.encode(str(tmp_path / "o.gif"), frames, 10.0)
    c = open_clip(str(tmp_path / "o.gif"), tmp_path / "w1")
    assert c.frames == 5 and (c.width, c.height) == (160, 120)
    assert_same_decode(tmp_path / "o.gif", range(5))
    dv = [np.full((576, 720, 3), i * 40, np.uint8) for i in range(3)]
    assert enc.encode(str(tmp_path / "o.dv"), dv, 25.0)
    c2 = open_clip(str(tmp_path / "o.dv"), tmp_path / "w2")
    assert c2.frames == 3
    pdf = get_encoder("pdf")
    assert pdf.encode(str(tmp_path / "o.pdf"), frames, 10.0)
    assert (tmp_path / "o.pdf").read_bytes()[:5] == b"%PDF-"


def test_audio_dropped_for_audioless_containers(tmp_path):
    from lives_tpu_torch.io.encoders import get_encoder
    enc = get_encoder("av")
    if ("gif", "gif") not in {(f.name, f.extension)
                              for f in enc.get_formats()}:
        pytest.skip("gif encoder absent")
    frames = [np.full((120, 160, 3), i * 40, np.uint8) for i in range(3)]
    audio = np.zeros((8820, 2), np.float32)
    assert enc.encode(str(tmp_path / "a.gif"), frames, 10.0,
                      audio=audio, arate=44100)
    assert (tmp_path / "a.gif").stat().st_size > 0


# ---------------------------------------------------------------------------
# AVStreamSink, the probe order, the build


def _rgb_layer(f):
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.layer import Layer
    return Layer(planes=(torch.from_numpy(f)[None],),
                 palette=int(Palette.RGB24))


def test_stream_sink_to_local_file(tmp_path):
    """AVStreamSink into an ogg file (the icecast/oggstream class) and an
    mpegts file: the port's file decodes as the JAX sink's does."""
    from lives_tpu.constants import Palette as JPalette
    from lives_tpu.layer import Layer as JLayer
    from lives_tpu.player.sinks import AVStreamSink as JSink
    from lives_tpu_torch.player.sinks import AVStreamSink
    frames = [np.full((3, 48, 64), i * 16, np.uint8) for i in range(10)]
    for name, container in (("s.ogv", "ogg"), ("s.ts", "")):
        if container == "ogg" and not av.load_avbridge().avb_have_encoder(
                b"libtheora"):
            continue
        sink = AVStreamSink(str(tmp_path / name), fps=25.0,
                            container=container)
        jsink = JSink(str(tmp_path / f"j{name}"), fps=25.0,
                      container=container)
        sink.init_screen(64, 48, 25.0)
        jsink.init_screen(64, 48, 25.0)
        for i, f in enumerate(frames):
            sink.play_frame(_rgb_layer(f), i / 25.0)
            jsink.play_frame(JLayer(planes=(f,),
                                    palette=int(JPalette.RGB24)), i / 25.0)
        sink.exit_screen()
        jsink.exit_screen()
        assert sink.frames == 10
        # read in stream order: an mpegts file has no seek index
        a = jav.AVStreamSource(str(tmp_path / name))
        b = jav.AVStreamSource(str(tmp_path / f"j{name}"))
        for i in range(8):
            np.testing.assert_array_equal(
                np.asarray(a.get_frame(i).planes[0]),
                np.asarray(b.get_frame(i).planes[0]))
        a.close()
        b.close()
    assert (tmp_path / "s.ts").read_bytes()[0] == 0x47


def test_stream_sink_udp_mpegts_receivable():
    """udp:// means mpegts: the datagrams carry MPEG-TS packets (sync
    byte 0x47 at 188-byte strides), and AVStreamSource reads an mpegts
    stream in order."""
    from lives_tpu_torch.player.sinks import AVStreamSink
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    port = rx.getsockname()[1]
    sink = AVStreamSink(f"udp://127.0.0.1:{port}", fps=25.0,
                        bitrate=300_000)
    assert sink.container == "mpegts"
    assert AVStreamSink("icecast://h:8000/x").container == "ogg"
    assert AVStreamSink("srt://h:9000").container == "mpegts"
    sink.init_screen(64, 48, 25.0)
    for i in range(25):
        sink.play_frame(_rgb_layer(np.full((3, 48, 64), i * 8, np.uint8)),
                        i / 25.0)
    sink.exit_screen()
    data = rx.recv(65536)
    assert data[0] == 0x47 and data[188] == 0x47
    rx.close()


def test_av_stream_source_sequential(tmp_path):
    path = tmp_path / "live.ts"
    sess = av.AVEncodeSession(str(path), 64, 48, 25.0, container="mpegts")
    for i in range(15):
        sess.write_frame(np.full((3, 48, 64), i * 16, np.uint8))
    sess.close()
    src = av.AVStreamSource(str(path))
    jsrc = jav.AVStreamSource(str(path))
    assert (src.width, src.height) == (64, 48)
    ys = []
    for i in range(10):
        lay = src.get_frame(i)
        np.testing.assert_array_equal(
            lay.planes[0].numpy(), np.asarray(jsrc.get_frame(i).planes[0]))
        ys.append(float(lay.planes[0].numpy().mean()))
    assert ys == sorted(ys) and ys[-1] > ys[0] + 40
    src.close()
    jsrc.close()


def test_probe_order_keeps_mjpeg_avi_on_the_jpeg_lane(tmp_path):
    """An MJPEG .avi opens with AVIDecoder (the device JPEG lane), an
    MPEG-4 .avi, which AVIDecoder does not claim, with AVDecoder; the
    ffmpeg decoder comes after it, last, as in the JAX registry."""
    import io as pyio
    from PIL import Image
    from lives_tpu_torch.io.decoders import _DECODERS, write_mjpeg_avi
    names = [c.name for c in _DECODERS]
    assert names.index("avi") < names.index("avformat") == len(names) - 2
    assert names[-1] == "ffmpeg"
    jpegs = []
    for i in range(3):
        buf = pyio.BytesIO()
        Image.fromarray(np.full((32, 48, 3), i * 60, np.uint8)).save(
            buf, "JPEG")
        jpegs.append(buf.getvalue())
    write_mjpeg_avi(str(tmp_path / "m.avi"), jpegs, 48, 32)
    assert type(try_decoders(str(tmp_path / "m.avi")).decoder).__name__ \
        == "AVIDecoder"
    _write(av, tmp_path / "p.avi", _frames()[:4])
    cd = try_decoders(str(tmp_path / "p.avi"))
    assert type(cd.decoder).__name__ == "AVDecoder"
    assert cd.decoder.codec == "mpeg4"
    cd.decoder.close()


def test_failed_build_raises_with_gpp_stderr(tmp_path, monkeypatch):
    """A bridge source g++ cannot compile raises naming its error; a host
    without libavformat has no lane and says so."""
    bad = tmp_path / "avbridge.cpp"
    bad.write_text("#include <libavformat/avformat.h>\n"
                   "int broken( { return 0; }\n")
    monkeypatch.setattr(native, "AVBRIDGE_ABSENT", "")
    monkeypatch.setattr(native, "AVBRIDGE_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(native._LOADED, "avbridge")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.load_avbridge()
    assert "error" in str(e.value) and "broken" in str(e.value)
    monkeypatch.setattr("ctypes.util.find_library", lambda name: None)
    assert native.load_avbridge() is None
    assert "libavformat" in av.absent_reason()
