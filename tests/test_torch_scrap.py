"""Scrap capture of lives_tpu_torch against lives_tpu's on the CPU:
`io/scrap.py` (raw scrap files, `ScrapSink`, `MJPEGScrapRecorder` and
`scan_scrap_clips`) and the player's scrap take, where recording a live
source that cannot replay (a stateful generator, a `scrap_on_record`
feed) captures its frames to an MJPEG scrap clip that the FRAME events
reference (JAX `player/player.py:509-630,1493-1533`,
tests/test_player.py:676-790).

Inputs are seeded numpy frames and the beat_rings generator at 64x36 on
both players, each on a `chip_smoke.ScriptedClock`; the port runs with
`device="cpu"`. Tolerances: raw scrap files byte for byte; the shown
frames of the two players bit for bit; each take's re-render against its
own sink's frames at PSNR >= `chip_smoke.SCRAP_PSNR_DB` (the JAX take
shows 32.2 dB: JPEG q85), the JAX package's held to it in the same test;
the event lists' clip references by position equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from lives_tpu.events.renderer import render_recording as j_render
from lives_tpu.graph import SinkSpec as JSinkSpec
from lives_tpu.io import scrap as jscrap
from lives_tpu.io.genclip import GeneratorClip as JGen
from lives_tpu.layer import Layer as JLayer
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import Player as JPlayer
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.events.renderer import render_recording as t_render
from lives_tpu_torch.graph import SinkSpec
from lives_tpu_torch.io import decoders as tdec
from lives_tpu_torch.io import scrap as tscrap
from lives_tpu_torch.io.genclip import GeneratorClip as TGen
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.ops.colorspace import convert_layer
from lives_tpu_torch.player import CollectSink, Player
from lives_tpu_torch.player import player as t_player_mod
from test_torch_clips import write_clip_y4m

CPU = "cpu"
W, H, FPS = 64, 36, 30.0


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def psnr(a, b) -> float:
    """PSNR in dB of two host frame stacks, over all their values."""
    mse = float(((np.asarray(a, np.float64) - b) ** 2).mean())
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _layers(pal, w, h, n, seed=5):
    """n seeded frames as (JAX layer, port layer) pairs of palette pal."""
    rng = np.random.default_rng(seed)
    shapes = {Palette.RGB24: [(3, h, w)], Palette.RGBA32: [(4, h, w)],
              Palette.YUV420P: [(h, w), (h // 2, w // 2), (h // 2, w // 2)]}
    out = []
    for _ in range(n):
        planes = [rng.integers(0, 256, s, np.uint8) for s in shapes[pal]]
        out.append((JLayer(planes=tuple(jnp.asarray(p) for p in planes),
                           palette=int(pal)),
                    Layer(planes=tuple(torch.from_numpy(p) for p in planes),
                          palette=int(pal))))
    return out


@pytest.mark.parametrize("pal,w,h", [(Palette.RGB24, 16, 8),
                                     (Palette.RGBA32, 10, 6),
                                     (Palette.YUV420P, 17, 9)],
                         ids=["rgb24", "rgba32", "yuv420p_odd"])
def test_scrap_file_bytes_and_reader_match_jax(tmp_path, pal, w, h):
    lays = _layers(pal, w, h, 3)
    tw = tscrap.ScrapWriter(tmp_path / "t.scrap", w, h, pal, fps=30.0)
    jw = jscrap.ScrapWriter(tmp_path / "j.scrap", w, h, int(pal), fps=30.0)
    for jl, tl in lays:
        tw.write(tl)
        jw.write(jl)
    tw.close()
    jw.close()
    assert (tmp_path / "t.scrap").read_bytes() == \
        (tmp_path / "j.scrap").read_bytes()
    tr, jr = tscrap.ScrapReader(tmp_path / "t.scrap"), \
        jscrap.ScrapReader(tmp_path / "t.scrap")
    assert (tr.frames, tr.width, tr.height, tr.fps) == \
        (jr.frames, jr.width, jr.height, jr.fps) == (3, w, h, 30.0)
    for n in (-1, 0, 2, 9):
        for a, b in zip(tr.get_frame(n).planes, jr.get_frame(n).planes):
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tw2 = tscrap.ScrapWriter(tmp_path / "x.scrap", w + 2, h, pal)
        tw2.write(lays[0][1])
    bad = tmp_path / "bad.scrap"
    bad.write_bytes(json.dumps({"magic": "nope"}).encode() + b"\n")
    with pytest.raises(ValueError):
        tscrap.ScrapReader(bad)


def test_scrap_sink_tees_like_jax(tmp_path):
    lays = _layers(Palette.YUV420P, 16, 8, 2, seed=2)
    inner = CollectSink()
    ts = tscrap.ScrapSink(tmp_path / "t.scrap", inner=inner)
    js = jscrap.ScrapSink(tmp_path / "j.scrap")
    ts.init_screen(16, 8, 25.0)
    js.init_screen(16, 8, 25.0)
    for i, (jl, tl) in enumerate(lays):
        assert ts.play_frame(tl, i / 25.0)
        js.play_frame(jl, i / 25.0)
    ts.exit_screen()
    js.exit_screen()
    assert (tmp_path / "t.scrap").read_bytes() == \
        (tmp_path / "j.scrap").read_bytes()
    assert len(inner.frames) == 2


def test_mjpeg_scrap_recorder_and_recovery_scan(tmp_path):
    """Ten frames (RGB and YUV420P, converted by the worker) through the
    recorder: the finalized MJPEG AVI reopens as a 10-frame clip whose
    frames are the queued ones at JPEG quality, and `scan_scrap_clips`
    rebuilds the uid -> clip map from the file name, as the JAX scan
    does."""
    from test_torch_bridges import jax_bridge
    jax_bridge("jpegcoef")
    rec = tscrap.MJPEGScrapRecorder(W, H, fps=30.0, device=CPU)
    yy, xx = np.mgrid[0:H, 0:W]
    sent = []
    for i in range(10):
        rgb = np.stack([xx * 3 + i * 5, yy * 5,
                        np.full_like(xx, 40 * (i % 5))]).astype(np.uint8)
        if i % 2:
            lay = convert_layer(Layer(planes=(torch.from_numpy(rgb),)),
                                Palette.YUV420P)
            rgb = convert_layer(lay, Palette.RGB24).planes[0].numpy()
        else:
            lay = Layer(planes=(torch.from_numpy(rgb),))
        sent.append(rgb.astype(int))
        assert rec.put(lay) == i
    path = tmp_path / "scrap" / f"scrap_{rec.unique_id:016x}_000001.avi"
    clip = rec.finalize(path)
    assert clip is not None and clip.frames == 10
    assert clip.unique_id == rec.unique_id and not rec.overflowed
    for n in range(10):
        got = clip.get_frame(n).planes[0].numpy().astype(int)
        assert psnr(got, sent[n]) >= cs.SCRAP_PSNR_DB
    found = tscrap.scan_scrap_clips(tmp_path)
    jfound = jscrap.scan_scrap_clips(tmp_path)
    assert set(found) == set(jfound) == {rec.unique_id}
    assert found[rec.unique_id].frames == jfound[rec.unique_id].frames
    (tmp_path / "scrap" / "scrap_zz_1.avi").write_bytes(b"junk")
    assert set(tscrap.scan_scrap_clips(tmp_path)) == {rec.unique_id}
    assert tscrap.scan_scrap_clips(tmp_path / "none") == {}


def test_scrap_recorder_overflow_and_empty(tmp_path):
    rec = tscrap.MJPEGScrapRecorder(16, 8, device=CPU, max_queue=0)
    assert rec.put(Layer(planes=(torch.zeros((3, 8, 16), dtype=torch.uint8),
                                 ))) is None
    assert rec.overflowed and rec.put(None) is None
    assert rec.finalize(tmp_path / "x.avi") is None
    assert not (tmp_path / "x.avi").exists()


def _take(pkg, monkeypatch, tmp_path, cycles=40):
    """scrap_take on a fresh player of `pkg` on a scripted clock: (player,
    sink, take, host frames the sink showed)."""
    clock = cs.ScriptedClock()
    monkeypatch.setattr(j_player_mod if pkg == "jax" else t_player_mod,
                        "time", clock)
    if pkg == "jax":
        gen = JGen("beat_rings", W, H, fps=FPS)
        sink = JCollectSink()
        p = JPlayer(sink=sink, sink_spec=JSinkSpec(width=W, height=H),
                    fps=FPS)
    else:
        gen = TGen("beat_rings", W, H, fps=FPS, device=CPU)
        sink = CollectSink()
        p = Player(sink=sink, sink_spec=SinkSpec(width=W, height=H),
                   fps=FPS, device=CPU)
    p.scrap_dir = str(tmp_path / pkg)
    p.async_compile = False
    el = cs.scrap_take(p, gen, cycles, FPS, clock)
    shown = np.stack([np.asarray(f) for f in sink.frames]).astype(int)
    return p, el, shown


def _rerender(pkg, p, el):
    kw = {} if pkg == "jax" else {"device": CPU}
    frames, _ = (j_render if pkg == "jax" else t_render)(
        el, p.recording_uid_map(), batch_size=8, **kw)
    return np.asarray(frames).astype(int)[cs.rerender_index(el, FPS)]


def test_player_scraps_a_stateful_generator_like_jax(monkeypatch, tmp_path):
    """A take of beat_rings with scrap capture on: each player shows the
    same frames, every FRAME event references its scrap clip at the
    frame's capture index, the scrap clips hold every frame under the
    scrap directory (named by uid), and each take's re-render from its
    scrap matches its sink's frames at JPEG quality."""
    res = {pkg: _take(pkg, monkeypatch, tmp_path) for pkg in ("jax",
                                                              "torch")}
    np.testing.assert_array_equal(res["jax"][2], res["torch"][2])
    for pkg, (p, el, shown) in res.items():
        assert len(p.rec_scrap_clips) == 1, pkg
        uid, scrap = next(iter(p.rec_scrap_clips.items()))
        refs = [e for e in el.events if getattr(e, "clips", None)]
        assert [(e.clips[0], e.frames[0]) for e in refs] == \
            [(uid, i) for i in range(len(refs))], pkg
        assert scrap.frames == len(refs) == len(shown) == 40
        assert (tmp_path / pkg / "scrap").is_dir()
        assert f"{uid:016x}" in scrap.source_uri
        got = _rerender(pkg, p, el)
        assert psnr(got, shown) >= cs.SCRAP_PSNR_DB, pkg
        assert p.recording_uid_map()[uid] is scrap


def test_live_feed_scraps_on_record(monkeypatch, tmp_path):
    """A YUV4MPEG fifo (`Y4MStreamSource`, scrap_on_record) as the fg: its
    frames are captured (converted to RGB24 by the worker) and the FRAME
    events reference the scrap clip."""
    src = write_clip_y4m(tmp_path / "feed.y4m", n=12, w=W, h=H, seed=8)
    feed = tdec.Y4MStreamSource(str(src))
    clock = cs.ScriptedClock()
    monkeypatch.setattr(t_player_mod, "time", clock)
    p = Player(sink=CollectSink(), sink_spec=SinkSpec(width=W, height=H),
               fps=FPS, device=CPU)
    p.scrap_dir = str(tmp_path)
    p.precache_depth = 0
    p.state.fg_clip = feed
    p.set_pb_fps(FPS)
    p.start()
    p.record_start(W, H)
    for c in range(10):
        p.process_one()
        clock.now = (c + 1) / FPS
    el = p.record_stop()
    p.stop()
    uid, scrap = next(iter(p.rec_scrap_clips.items()))
    refs = [e for e in el.events if getattr(e, "clips", None)]
    assert refs and all(e.clips[0] == uid for e in refs)
    assert max(e.frames[0] for e in refs) < scrap.frames == 10
    assert p.discard_recording()
    assert not p.rec_scrap_clips
    assert list((tmp_path / "scrap").glob("*.avi")) == []


def test_failed_capture_rewrites_to_live_references(monkeypatch, tmp_path):
    """A capture whose encode fails leaves no scrap clip: record_stop
    points the FRAME events back at the live source's (uid, frame), as the
    JAX player does, and the autosave never names a scrap frame that is
    not durable."""
    monkeypatch.setattr(tscrap.MJPEGScrapRecorder, "finalize",
                        lambda self, path: None)
    clock = cs.ScriptedClock()
    monkeypatch.setattr(t_player_mod, "time", clock)
    gen = TGen("beat_rings", W, H, fps=FPS, device=CPU)
    p = Player(sink=CollectSink(), sink_spec=SinkSpec(width=W, height=H),
               fps=FPS, device=CPU)
    p.async_compile = False
    backup = tmp_path / "take.jsonl"
    p.state.fg_clip = gen
    p.set_pb_fps(FPS)
    p.start()
    p.record_start(W, H, backup_path=str(backup), backup_every=0.0)
    for c in range(6):
        p.process_one()
        clock.now = (c + 1) / FPS
    lines = [json.loads(x) for x in backup.read_text().splitlines()[1:]]
    el = p.record_stop()
    p.stop()
    assert not p.rec_scrap_clips
    refs = [e for e in el.events if getattr(e, "clips", None)]
    assert [e.clips[0] for e in refs] == [gen.unique_id] * 6
    saved = [ln["props"]["clips"][0] for ln in lines
             if "clips" in ln.get("props", {})]
    assert saved and set(saved) == {gen.unique_id}


def test_scrap_capture_off_records_the_generator(monkeypatch, tmp_path):
    clock = cs.ScriptedClock()
    monkeypatch.setattr(t_player_mod, "time", clock)
    gen = TGen("beat_rings", W, H, fps=FPS, device=CPU)
    p = Player(sink=CollectSink(), fps=FPS, device=CPU)
    p.state.fg_clip = gen
    p.start()
    p.record_start(W, H, scrap_generators=False)
    p.process_one()
    el = p.record_stop()
    p.stop()
    assert not p.rec_scrap_clips
    assert [e.clips[0] for e in el.events if getattr(e, "clips", None)] \
        == [gen.unique_id]


def test_jax_scrap_take_meets_the_bound(monkeypatch, tmp_path):
    """The bound phase 21d holds the card to, on the JAX player's own
    take (32.2 dB at 64x36)."""
    p, el, shown = _take("jax", monkeypatch, tmp_path, cycles=30)
    assert psnr(_rerender("jax", p, el), shown) >= cs.SCRAP_PSNR_DB
