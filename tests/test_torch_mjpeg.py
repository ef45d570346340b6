"""The MJPEG lanes of lives_tpu_torch end to end against lives_tpu's on
the CPU: AVI files (`write_mjpeg_avi` byte for byte, `AVIDecoder`'s probe
and frames for MJPG and raw DIB), the multi-clip source, the default
"mjpeg" encoder of `render_to_encoder`, and the player's compressed lane
(JAX `lives_tpu/player/player.py:1015-1025,1047-1064,1228-1245`).

Frames are seeded numpy content, JPEGs written through PIL or the
encoders; the port runs on the CPU (`device="cpu"`), the JAX package under
JAX_PLATFORMS=cpu.
"""

import io
import struct
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from lives_tpu.constants import Palette as JPalette
from lives_tpu.events import EventList as JEventList
from lives_tpu.events.renderer import render_to_arrays as j_render_to_arrays
from lives_tpu.io import decoders as jdec
from lives_tpu.io import encoders as jenc
from lives_tpu.io import jpeg_ingest as jji
from lives_tpu.io.clips import open_clip as j_open_clip
from lives_tpu.layer import Layer as JLayer
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import Player as JPlayer
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.events.renderer import render_to_arrays
from lives_tpu_torch.io import decoders as tdec
from lives_tpu_torch.io import encoders as tenc
from lives_tpu_torch.io import jpeg_ingest as ji
from lives_tpu_torch.io.clips import open_clip
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.player import CollectSink, Player
from lives_tpu_torch.player import player as t_player_mod
from lives_tpu_torch.scenes import DeviceSyntheticSource, multitrack_timeline
from lives_tpu_torch.transcode import render_to_encoder

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def jpeg(w, h, seed, quality=85):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 80 * np.sin(xx / 9.0 + seed) * np.cos(yy / 7.0)
            + rng.normal(0, 6, (h, w))).clip(0, 255)
    rgb = np.stack([base, np.roll(base, 5, 1), 255 - base],
                   -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def write_avi(path, w=64, h=32, n=6, seed=0, fps=25.0):
    frames = [jpeg(w, h, seed * 100 + s) for s in range(n)]
    tdec.write_mjpeg_avi(str(path), frames, w, h, fps)
    return frames


def within_1(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


# -- AVI files ----------------------------------------------------------------

@pytest.mark.parametrize("fps", [25.0, 29.97])
def test_write_mjpeg_avi_bytes_match_jax(tmp_path, fps):
    frames = [jpeg(48 + s, 32, s) for s in range(5)]
    frames.append(frames[0] + b"\0")      # an odd-length chunk is padded
    a, b = tmp_path / "t.avi", tmp_path / "j.avi"
    tdec.write_mjpeg_avi(str(a), iter(frames), 48, 32, fps)
    jdec.write_mjpeg_avi(str(b), frames, 48, 32, fps)
    assert a.read_bytes() == b.read_bytes()


def test_avi_probe_and_frames_match_jax(tmp_path):
    path = tmp_path / "c.avi"
    frames = write_avi(path, 75, 37, 5, fps=29.97)
    t, j = tdec.try_decoders(str(path)), jdec.try_decoders(str(path))
    assert isinstance(t.decoder, tdec.AVIDecoder)
    for k in ("nframes", "fps", "width", "height", "palette"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.decoder.offsets == j.decoder.offsets
    assert (t.decoder.fourcc, t.decoder.topdown) == ("MJPG", False)
    for n in range(5):
        assert t.decoder.get_frame_bytes(n) == frames[n]
        got = t.decoder.get_frame(n)
        assert got.palette == int(Palette.RGB24)
        assert got.planes[0].device == CPU
        np.testing.assert_array_equal(
            got.planes[0].numpy(), np.asarray(j.decoder.get_frame(n).planes[0]))
    out = (np.zeros((3, 37, 75), np.uint8),)
    t.decoder.get_frame(3, out=out)
    np.testing.assert_array_equal(out[0], t.decoder.get_frame(3).planes[0])
    t.decoder.close()
    j.decoder.close()


def write_dib_avi(path, w, h, n, topdown=False):
    """A raw-DIB AVI of n seeded (h, w, 3) RGB frames, written by hand as
    `tests/test_io.py:131` does, with bottom-up or top-down rows; the
    frames."""
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]
    stride = (w * 3 + 3) & ~3

    def chunk(cid, payload):
        pad = b"\0" if len(payload) & 1 else b""
        return cid + struct.pack("<I", len(payload)) + payload + pad
    strh = (b"vids" + b"DIB " + b"\0" * 12 + struct.pack("<II", 1, 25)
            + b"\0" * 28)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h if topdown else h, 1, 24, 0,
                       stride * h, 0, 0, 0, 0)
    movi = b"movi"
    for f in frames:
        bgr = f[:, :, ::-1] if topdown else f[::-1, :, ::-1]
        movi += chunk(b"00dc", b"".join(
            bgr[r].tobytes() + b"\0" * (stride - w * 3) for r in range(h)))
    hdrl = b"hdrl" + chunk(b"avih", b"\0" * 56) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf))
    body = b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", movi)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return frames


@pytest.mark.parametrize("topdown", [False, True])
def test_avi_dib_frames_match_jax(tmp_path, topdown):
    """A raw-DIB AVI: bottom-up and top-down rows."""
    w, h, n = 18, 8, 3
    p = tmp_path / "raw.avi"
    frames = write_dib_avi(p, w, h, n, topdown)
    t, j = tdec.try_decoders(str(p)), jdec.try_decoders(str(p))
    assert (t.nframes, t.width, t.height, t.decoder.fourcc) == \
        (n, w, h, "DIB")
    assert t.decoder.topdown == topdown == j.decoder.topdown
    for k in range(n):
        got = t.decoder.get_frame(k).planes[0].numpy()
        np.testing.assert_array_equal(np.moveaxis(got, 0, -1), frames[k])
        np.testing.assert_array_equal(
            got, np.asarray(j.decoder.get_frame(k).planes[0]))
    with pytest.raises(RuntimeError, match="MJPG-only"):
        t.decoder.get_frames_device([0], device="cpu")


def test_avi_decoder_declines_other_files(tmp_path):
    (tmp_path / "x.avi").write_bytes(b"RIFF\0\0\0\0WAVEfmt ")
    assert tdec.AVIDecoder.get_clip_data(str(tmp_path / "x.avi")) is None
    assert tdec.AVIDecoder.get_clip_data(str(tmp_path / "none.avi")) is None


def test_get_frames_device_matches_jax_and_per_frame(tmp_path):
    path = tmp_path / "c.avi"
    frames = write_avi(path, 96, 64, 8)
    dec = tdec.try_decoders(str(path)).decoder
    jd = jdec.try_decoders(str(path)).decoder
    lays = dec.get_frames_device([1, 3, 5], device="cpu")
    jlays = jd.get_frames_device([1, 3, 5])
    assert len(lays) == 3
    for n, lb, jl in zip((1, 3, 5), lays, jlays):
        ls = dec.get_frame_device(n, device="cpu")
        assert lb.palette == ls.palette == int(Palette.YUV420P)
        assert (lb.palette, lb.clamping, lb.gamma) == \
            (int(jl.palette), int(jl.clamping), int(jl.gamma))
        ref = ji.decode_frame_ref(ji.read_coefficients(frames[n]))
        for pb, ps, pj, r in zip(lb.planes, ls.planes, jl.planes, ref):
            assert torch.equal(pb, ps)
            within_1(pj, pb)
            within_1(r, pb)
    assert dec.fallbacks == 0
    dec.close()
    jd.close()


# -- the "mjpeg" encoder --------------------------------------------------------

def test_get_encoder_mjpeg_is_the_device_encoder(tmp_path):
    enc = tenc.get_encoder("mjpeg")
    assert isinstance(enc, tenc.MJPEGDeviceEncoder)
    assert enc.accepts_device_frames and "mjpeg" not in tenc.DEFERRED
    assert (enc.quality, enc.batch) == (90, 8)
    assert [f.extension for f in enc.get_formats()] == ["avi"]
    # no frames, no file: the audio beside it is not written either, as
    # in the JAX encoder (its WAV goes beside a written AVI)
    assert not enc.encode(str(tmp_path / "a.avi"), [], 25.0,
                          audio=np.zeros((10, 2), np.float32))
    assert not (tmp_path / "a.wav").exists()
    assert not enc.encode(str(tmp_path / "b.avi"), [], 25.0)


def test_mjpeg_encoder_chunks_frames_and_jax_agree(tmp_path):
    """A (B, C, H, W) chunk, the same frames one at a time (CHW and HWC,
    tensors and numpy) and the JAX encoder on them write the same AVI: a
    chunk splits into the fixed batch, the tail padded once at the end."""
    src = DeviceSyntheticSource(32, 48, device="cpu")
    rgb = src.get_batch([1] * 11, range(11)).planes[0]
    paths = [tmp_path / f"{k}.avi" for k in range(4)]
    enc = tenc.MJPEGDeviceEncoder(batch=4, device="cpu")
    assert enc.encode(str(paths[0]), [rgb[:6], rgb[6:]], 30.0)
    assert enc.encode(str(paths[1]), list(rgb), 30.0)
    assert enc.encode(str(paths[2]),
                      [f.permute(1, 2, 0).numpy() for f in rgb], 30.0)
    j = jenc.get_encoder("mjpeg")
    j.batch = 4
    assert j.encode(str(paths[3]), [jnp.asarray(f.numpy()) for f in rgb],
                    30.0)
    blobs = [p.read_bytes() for p in paths]
    assert all(b == blobs[0] for b in blobs) and enc.overflows == 0
    cd = tdec.try_decoders(str(paths[0]))
    assert (cd.nframes, cd.width, cd.height, cd.fps) == (11, 48, 32, 30.0)


def test_mjpeg_encoder_counts_and_warns_overflows(tmp_path):
    """Noise passes the lane's first AC pool: the frames written with
    their ACs cut are totalled over every encode on the encoder, and a
    warning says so the first time only."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (4, 3, 32, 48), np.uint8))
    enc = tenc.MJPEGDeviceEncoder(batch=2, device="cpu")
    with pytest.warns(UserWarning, match="cut at the pool"):
        assert enc.encode(str(tmp_path / "a.avi"), [x], 25.0)
    first = enc.overflows
    assert first == 2          # the first batch; the pool grew for the next
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert enc.encode(str(tmp_path / "b.avi"), [x], 25.0)
    assert enc.overflows == 2 * first
    clip = open_clip(str(tmp_path / "a.avi"), tmp_path / "w")
    assert clip.frames == 4 and clip.get_frame(0).planes[0].float().std() > 10


def test_render_to_encoder_default_is_mjpeg(tmp_path):
    """`render_to_encoder` with its default encoder writes an MJPEG AVI
    that both packages open; the port's rendered frames encoded by the
    JAX encoder give the same bytes (their coefficients agree: asserted
    through the lanes' coefficient stages)."""
    from lives_tpu.io import jpeg_encode as jje
    from lives_tpu_torch.io import jpeg_encode as je
    el = multitrack_timeline(n_tracks=3, n_frames=12, width=96, height=64,
                             fps=25.0)
    src = DeviceSyntheticSource(64, 96, device="cpu")
    out = tmp_path / "render.avi"
    assert render_to_encoder(el, src, str(out))
    frames, _ = render_to_arrays(el, src)
    dc, ac = je._coef_stage(je.encode_meta(96, 64), 90, "cpu")(
        torch.from_numpy(frames))
    import jax
    jdc, jac = jax.jit(jax.vmap(jje._coef_stage(jje.encode_meta(96, 64), 90,
                                                "rgb")))(jnp.asarray(frames))
    assert np.array_equal(np.asarray(jdc), dc.numpy()) and \
        np.array_equal(np.asarray(jac), ac.numpy())
    ref = tmp_path / "jax.avi"
    assert jenc.get_encoder("mjpeg").encode(
        str(ref), [jnp.asarray(f) for f in frames], 25.0)
    assert out.read_bytes() == ref.read_bytes()
    clip = open_clip(str(out), tmp_path / "w")
    assert (clip.frames, clip.width, clip.height) == (12, 96, 64)
    jclip = j_open_clip(str(out), tmp_path / "jw")
    assert jclip.frames == 12
    got = clip.get_frame(5).planes[0].numpy()
    mse = np.mean((got.astype(float) - frames[5]) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 30


# -- the multi-clip source ---------------------------------------------------

def _bad_clip(pkg):
    """An MJPG clip whose chunks do not entropy-decode; get_frame serves
    77s (`tests/test_jpeg_ingest.py:364-394`)."""
    arr = np.full((3, 32, 64), 77, np.uint8)

    class Dec:
        fourcc = "MJPG"

        class cdata:
            nframes = 4

        def get_frame_bytes(self, n):
            return b"not a jpeg"

    class Bad:
        width, height, frames, fps = 64, 32, 4, 25.0

        def get_frame(self, n):
            if pkg == "jax":
                return JLayer(planes=(jnp.asarray(arr),),
                              palette=int(JPalette.RGB24))
            return Layer(planes=(torch.from_numpy(arr.copy()),),
                         palette=int(Palette.RGB24))
    clip = Bad()
    clip.cdata = type("CD", (), {"decoder": Dec()})()
    return clip


def test_multi_clip_source_matches_jax(tmp_path):
    """MJPEG clips (one at another geometry, resized), a YUV4MPEG clip and
    a bad stream in one batch: within 1 LSB of the JAX source; the Y4M and
    bad clips decode on the host, counted, the bad one warned about once;
    an unknown id stays black."""
    write_avi(tmp_path / "a.avi", 64, 32, 6, seed=1)
    write_avi(tmp_path / "b.avi", 96, 40, 6, seed=2)
    cs.write_clips(str(tmp_path), DeviceSyntheticSource(32, 64,
                                                        device="cpu"), 1, 4)
    names = {1: "a.avi", 2: "b.avi", 3: "clip1.y4m"}
    tclips = {u: open_clip(str(tmp_path / n), tmp_path / "tw")
              for u, n in names.items()}
    jclips = {u: j_open_clip(str(tmp_path / n), tmp_path / "jw")
              for u, n in names.items()}
    tclips[4], jclips[4] = _bad_clip("torch"), _bad_clip("jax")
    ids, nums = [1, 3, 2, 4, 1, 9, 4], [0, 1, 5, 0, 3, 0, 2]
    t = ji.MJPEGMultiClipSource(tclips, 64, 32, device="cpu")
    j = jji.MJPEGMultiClipSource(jclips, 64, 32)
    with pytest.warns(UserWarning, match="clip 4 decodes on the host"):
        got = t.get_batch(ids, nums)
    want = j.get_batch(ids, nums)
    assert got.palette == int(Palette.RGB24)
    within_1(want.planes[0], got.planes[0])
    assert (got.planes[0][5] == 0).all() and (got.planes[0][3] == 77).all()
    assert t.host_decoded == 3 and t.fallbacks == 0
    assert t._srcs[4] is None and j._srcs[4] is None
    # a second batch: the bad clip stays on the host without a warning
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t.get_batch([4, 1], [1, 1])
    assert t.host_decoded == 4


def test_multi_clip_render_matches_jax(tmp_path):
    """A 2-track crossfade over two MJPEG clips through both packages'
    renderers: frames within 1 LSB."""
    clips = {}
    for uid in (1, 2):
        write_avi(tmp_path / f"c{uid}.avi", 64, 32, 6, seed=uid)
    el = multitrack_timeline(n_tracks=2, n_frames=6, width=64, height=32,
                             fps=25.0)
    jel = JEventList.from_json(el.to_json())
    tclips = {u: open_clip(str(tmp_path / f"c{u}.avi"), tmp_path / "tw")
              for u in (1, 2)}
    jclips = {u: j_open_clip(str(tmp_path / f"c{u}.avi"), tmp_path / "jw")
              for u in (1, 2)}
    got, _ = render_to_arrays(el, ji.MJPEGMultiClipSource(
        tclips, 64, 32, device="cpu"), batch_size=6)
    want, _ = j_render_to_arrays(jel, jji.MJPEGMultiClipSource(
        jclips, 64, 32), batch_size=6)
    assert got.shape == (6, 3, 32, 64) and got.std() > 10
    within_1(want, got)


# -- the player's compressed lane --------------------------------------------

def test_player_pull_takes_the_lane_and_the_pref_turns_it_off(
        tmp_path, monkeypatch):
    frames = write_avi(tmp_path / "c.avi", 64, 32, 5)
    clip = open_clip(str(tmp_path / "c.avi"), tmp_path / "w")
    p = Player(sink=CollectSink(), device="cpu")
    p.state.fg_clip = clip
    lay = p._pull(clip, 2)
    assert lay.palette == int(Palette.YUV420P)
    ref = ji.decode_frame_ref(ji.read_coefficients(frames[2]))
    for a, r in zip(lay.planes, ref):
        within_1(r, a)
    clip.get_frame = None        # a host decode would fail now
    p.start()
    p.state.frame = -1
    p._frame0 = 2.0
    assert p.process_one()
    p.stop()
    assert p.frames_shown == 1 and p.lane_errors == 0
    monkeypatch.setenv("LIVES_TPU_MJPEG_DEVICE_DECODE", "0")
    del clip.get_frame
    assert p._pull(clip, 3).palette == int(Palette.RGB24)


def test_player_lane_failure_is_counted_and_warned(tmp_path):
    write_avi(tmp_path / "c.avi", 64, 32, 4)
    clip = open_clip(str(tmp_path / "c.avi"), tmp_path / "w")

    def broken(ns, device="cuda"):
        raise ValueError("corrupt chunk")
    clip.cdata.decoder.get_frames_device = broken
    p = Player(sink=CollectSink(), device="cpu")
    with pytest.warns(UserWarning, match="compressed lane failed"):
        lay = p._pull(clip, 1)
    assert lay.palette == int(Palette.RGB24) and p.lane_errors == 1
    assert p._decode_frames_batched(clip, [2, 3]) is None
    assert p.lane_errors == 2


def test_player_decodes_a_dib_clip_on_the_host(tmp_path):
    """A raw-DIB AVI's decoder has `get_frames_device` but no JPEG to
    decode: the player reads its frames on the host, with no lane error
    and no warning."""
    frames = write_dib_avi(tmp_path / "raw.avi", 18, 8, 3)
    clip = open_clip(str(tmp_path / "raw.avi"), tmp_path / "w")
    p = Player(sink=CollectSink(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lay = p._pull(clip, 1)
        assert p._decode_frames_batched(clip, [0, 2]) is None
    assert lay.palette == int(Palette.RGB24) and p.lane_errors == 0
    np.testing.assert_array_equal(np.moveaxis(lay.planes[0].numpy(), 0, -1),
                                  frames[1])


def test_precache_worker_batches_through_the_lane(tmp_path):
    """The worker decodes its window through `get_frames_device` in
    chunks of `precache_chunk`; the cached frames serve `_pull`, and a
    miss on such a clip drops the frame (the worker has it)."""
    import time
    frames = write_avi(tmp_path / "c.avi", 64, 32, 10)
    clip = open_clip(str(tmp_path / "c.avi"), tmp_path / "w")
    p = Player(sink=CollectSink(), device="cpu")
    p.state.fg_clip = clip
    p.precache_depth, p.precache_chunk = 4, 3
    calls = []
    dec = clip.cdata.decoder
    orig = dec.get_frames_device
    dec.get_frames_device = lambda ns, device: calls.append(list(ns)) or \
        orig(ns, device=device)
    p._request_precache(2)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 10 and not all(
            p._ck(clip, f) in p._precache for f in range(2, 7)):
        time.sleep(0.01)
    p.stop()
    assert sorted(f for c in calls for f in c) == [2, 3, 4, 5, 6]
    assert all(len(c) <= 3 for c in calls) and len(calls) == 2
    lay = p._pull(clip, 4)
    ref = ji.decode_frame_ref(ji.read_coefficients(frames[4]))
    within_1(ref[0], lay.planes[0])
    p.frames_shown = 1
    with pytest.raises(t_player_mod._PrecacheMiss):
        p._pull(clip, 9)


def test_player_on_mjpeg_clips_matches_jax(tmp_path, monkeypatch):
    """Phase 19c's performance, cut to 60 cycles at 64x36, on both
    packages' players over the same MJPEG AVIs (written by
    `chip_smoke.write_mjpeg_clips`): the shown frames within 1 LSB; every
    port decode took the lane."""
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 36)
    cs.write_mjpeg_clips(str(tmp_path), DeviceSyntheticSource(
        36, 64, device="cpu"), 2, 12)
    shown = {}
    for pkg, mod in (("jax", j_player_mod), ("torch", t_player_mod)):
        clips = []
        for c in (1, 2):
            path = str(tmp_path / f"clip{c}.avi")
            clip = (j_open_clip(path, tmp_path / "jw") if pkg == "jax"
                    else open_clip(path, tmp_path / "tw"))
            clip.unique_id = c
            clips.append(clip)
        clock = cs.ScriptedClock()
        monkeypatch.setattr(mod, "time", clock)
        sink = JCollectSink() if pkg == "jax" else CollectSink()
        p = JPlayer(sink=sink, fps=cs.FPS) if pkg == "jax" else \
            Player(sink=sink, fps=cs.FPS, device="cpu")
        p.async_compile = False
        p.drop_on_miss = False
        if pkg == "torch":
            for c in clips:
                c.get_frame = None     # every decode must take the lane
        cs.player_setup(p, clips, cs.FPS, 10)
        p._frame0 += 0.5
        cs.perform(p, clips, cs.FPS, 60, 10, clock=clock)
        p.record_stop()
        p.stop()
        shown[pkg] = [np.asarray(f) for f in sink.frames]
        if pkg == "torch":
            assert p.lane_errors == 0
    assert len(shown["torch"]) == len(shown["jax"]) == 60
    for a, b in zip(shown["jax"], shown["torch"]):
        within_1(a, b)


def test_card_vs_cpu_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke's 19a at 64x36 with both sides on the CPU: the script's
    own checks pass (its first run on a card is then a run of checked
    code)."""
    monkeypatch.setattr(cs, "W", 64)
    monkeypatch.setattr(cs, "H", 36)
    cs.mjpeg_card_vs_cpu(CPU, "cpu")
