"""The multi-camera MJPEG export on the CPU at 64x48: ten tracks cut to
three, 12 frames, chunks of 4, the encoder's batches of 2.
`transcode.render_to_encoder` over an `MJPEGMultiClipSource` of clips
written as the benchmark's export driver writes them
(`cardbench/drivers/export.py`), held to the plain reference
(`cardbench/reference/mjpeg.py`): the rendered frames and the output
file's quantised coefficients, within the benchmark cell's limits; the
reference in bfloat16 fails them. Under the profiler one pass opens every
span of the compressed lanes on the calling thread and the lanes' counters
count three decoded frames a rendered frame; with it off no span is
made."""

import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cardbench import harness
from cardbench.drivers import export as drv
from cardbench.reference import mjpeg as ref
from lives_tpu_torch import diagnostics
from lives_tpu_torch.events import renderer
from lives_tpu_torch.io import encoders, jpeg_encode, jpeg_ingest
from lives_tpu_torch.io.clips import open_clip
from lives_tpu_torch.io.jpeg_ingest import MJPEGMultiClipSource
from lives_tpu_torch.transcode import render_to_encoder

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "cardbench/configs/mjpeg10_1080p30.json")
                 .read_text())
CFG.update(width=64, height=48, tracks=3, frames=12, clip_frames=12,
           chunk=4)
ENC_BATCH = 2
CPU = torch.device("cpu")

#: every span the compressed lanes and the export open
SPANS = ("lives.export", "lives.decode.read", "lives.decode.entropy",
         "lives.decode.upload", "lives.decode.idct", "lives.decode.convert",
         "lives.encode.coef", "lives.encode.fetch", "lives.encode.huffman",
         "lives.mux")


def _export(tmp: Path, seed: int, prof=None):
    """One export pass: (rendered frames (F, 3, H, W) u8, the output
    file's path, the source)."""
    tmp.mkdir(parents=True, exist_ok=True)
    paths = drv.write_clips(str(tmp), CFG, seed, CPU)
    clips = {}
    for c, path in paths.items():
        clips[c] = open_clip(path, str(tmp / "work"))
        clips[c].unique_id = c
    src = MJPEGMultiClipSource(clips, CFG["width"], CFG["height"],
                               device="cpu")
    el = drv.event_list(drv.schedule(CFG, seed))
    out = str(tmp / "export.avi")
    chunks = []
    orig = renderer.render_events

    def tapped(*args, **kw):
        for tcs, lay in orig(*args, **kw):
            chunks.append(lay.planes[0].clone())
            yield tcs, lay
    init = encoders.MJPEGDeviceEncoder.__init__
    with mock.patch.object(renderer, "render_events", tapped), \
            mock.patch.object(encoders.MJPEGDeviceEncoder, "__init__",
                              lambda self, **kw: init(
                                  self, quality=CFG["quality"],
                                  batch=ENC_BATCH, **kw)):
        if prof is None:
            assert render_to_encoder(el, src, out, batch_size=CFG["chunk"])
        else:
            with profile(activities=[ProfilerActivity.CPU]) as p:
                assert render_to_encoder(el, src, out,
                                         batch_size=CFG["chunk"])
            prof.append(p)
    return torch.cat(chunks), out, src


def _file_coefficients(path):
    lib = drv._jpegcoef()
    return torch.stack([torch.from_numpy(drv.read_coefficients(
        lib, d, CFG["height"], CFG["width"])) for d in drv.avi_frames(path)])


def _judge(got, want, limits):
    r = harness.Readings()
    r.add(got, want, list(range(len(got))), limits["max_lsb"])
    return harness.judge(r.numbers(), limits, len(got))


def _reference(seed, dtype=torch.float32):
    sched = drv.schedule(CFG, seed)
    js = list(range(CFG["frames"]))
    frames = drv.reference_frames(sched, CFG, seed, js, dtype, CPU)
    co = drv.reference_coefficients(sched, CFG, seed, js, dtype, CPU)
    return frames, torch.stack([drv.coefficient_frame(co, k)
                                for k in range(len(js))])


@pytest.mark.parametrize("seed", [0, 1])
def test_export_matches_the_reference(tmp_path, seed):
    frames, out, src = _export(tmp_path, seed)
    assert src.host_decoded == 0 and src.fallbacks == 0
    want_frames, want_coefs = _reference(seed)
    ok, checks = _judge(frames, want_frames, CFG["limits"])
    assert ok, checks
    coefs = _file_coefficients(out)
    assert coefs.shape == want_coefs.shape
    ok, checks = _judge(coefs, want_coefs, CFG["limits"]["file"])
    assert ok, checks


@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_control_fails_the_limits(seed):
    frames, coefs = _reference(seed)
    low_frames, low_coefs = _reference(seed, torch.bfloat16)
    ok, checks = _judge(low_frames, frames, CFG["limits"])
    assert not ok, checks
    ok, checks = _judge(low_coefs, coefs, CFG["limits"]["file"])
    assert not ok, checks


@pytest.mark.parametrize("rgb", [(0, 0, 0), (255, 255, 255),
                                 (128, 128, 128), (200, 30, 90),
                                 (17, 240, 3)])
def test_reference_decode_inverts_its_forward_transform(rgb):
    h, w = 48, 64
    frame = torch.tensor(rgb, dtype=torch.uint8).reshape(1, 3, 1, 1) \
        .expand(2, 3, h, w).contiguous()
    back = ref.decoded(ref.forward(frame, 90), 90, h, w)
    d = (back.to(torch.int16) - frame.to(torch.int16)).abs()
    assert int(d.max()) <= 1


def test_clip_frames_are_the_same_on_every_call():
    a = ref.clip_frames(2**31 + 77, [1, 2], [0, 5], 48, 64, 2.0, CPU)
    b = ref.clip_frames(2**31 + 77, [1, 2], [0, 5], 48, 64, 2.0, CPU)
    assert torch.equal(a, b)
    noise = a.to(torch.int16) - ref.ops.synthetic(
        torch.tensor([1, 2]), torch.tensor([0, 5]), 48, 64).to(torch.int16)
    assert 1.5 < float(noise.float().std()) < 2.5


def test_one_pass_opens_every_span_and_counts_the_lanes(tmp_path):
    e0, u0 = jpeg_ingest.ENTROPY_FRAMES, jpeg_ingest.UPLOAD_BYTES
    n0, c0, f0 = (jpeg_encode.ENCODED_FRAMES, jpeg_encode.CUT_FRAMES,
                  jpeg_encode.FETCH_BYTES)
    profs = []
    frames, _, _ = _export(tmp_path, 0, profs)
    events = [e for e in profs[0].events() if e.name.startswith("lives.")]
    names = {e.name for e in events}
    assert set(SPANS) <= names, set(SPANS) - names
    export = next(e for e in events if e.name == "lives.export")
    for e in events:
        if e.name in SPANS:
            assert e.thread == export.thread, e.name
            assert export.time_range.start <= e.time_range.start
            assert e.time_range.end <= export.time_range.end
    n = CFG["frames"]
    assert jpeg_ingest.ENTROPY_FRAMES - e0 == CFG["tracks"] * n
    assert jpeg_ingest.UPLOAD_BYTES > u0
    assert jpeg_encode.ENCODED_FRAMES - n0 == n
    assert jpeg_encode.CUT_FRAMES == c0
    assert jpeg_encode.FETCH_BYTES > f0
    assert len(frames) == n


def test_spans_off_make_nothing(tmp_path):
    """With the profiler off a pass makes no `record_function`: each span
    is the one shared no-op."""
    assert not torch.autograd._profiler_enabled()
    assert diagnostics.span("lives.decode.entropy") is \
        diagnostics.span("lives.export")

    def made(*args, **kw):
        raise AssertionError("a span was made with the profiler off")
    with mock.patch.object(torch.profiler, "record_function", made):
        frames, out, _ = _export(tmp_path, 1)
    assert os.path.getsize(out) > 0 and len(frames) == CFG["frames"]


def test_the_file_is_the_same_with_the_profiler_on_and_off(tmp_path):
    _, off, _ = _export(tmp_path / "off", 0)
    _, on, _ = _export(tmp_path / "on", 0, [])
    assert Path(off).read_bytes() == Path(on).read_bytes()
    assert np.array_equal(_file_coefficients(off).numpy(),
                          _file_coefficients(on).numpy())
