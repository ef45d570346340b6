"""The export cell's own pieces on the CPU at a tiny size: every planted
fault and the bfloat16 control fail `harness.judge`, the driver's AVI
writer is read back frame for frame by the port's `AVIDecoder`, and
`work_mjpeg`'s counts of a known frame, written out by hand."""

from __future__ import annotations

import json

import pytest
import torch

from cardbench import bench, harness, run, work, work_mjpeg
from cardbench.drivers import export as drv

CELL = "mjpeg10_1080p30.export"
SEED = 2**31 + 77


def _pieces(tiny):
    b = bench.load(tiny)
    cfg = bench.config(b, bench.cell(b, CELL)["config"], tiny)
    return b, cfg, bench.traffic("export", tiny / "cardbench")


def test_the_program_passes_both_checks(tiny):
    b, cfg, _ = _pieces(tiny)
    cells = []
    orig = drv.Cell.release

    def keep(self):
        cells.append(self)
        orig(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(drv.Cell, "release", keep)
        out = run.run_cell(b, CELL, SEED, 0.5, False, "cpu", checkout=tiny)
    assert out["correct"], out["checks"]
    assert out["checks"]["frames_compared"]["value"] >= 4
    checks = cells[0].file_checks
    assert checks["frames_compared"]["value"] == 8
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "frames_compared")


@pytest.mark.parametrize("kind", drv.FAULTS)
def test_each_fault_fails_judge(tiny, kind):
    b, _, _ = _pieces(tiny)
    with drv.fault(kind):
        out = run.run_cell(b, CELL, SEED, 0.5, False, "cpu", checkout=tiny)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_fails_judge_on_frames_and_file(tiny, seed):
    _, cfg, traffic = _pieces(tiny)
    ids, frames = drv.control(cfg, traffic, seed, 8, torch.device("cpu"))
    r = harness.Readings()
    r.add(frames(ids, torch.bfloat16), frames(ids, torch.float32), ids,
          cfg["limits"]["max_lsb"])
    assert not harness.judge(r.numbers(), cfg["limits"], 4)[0]
    ids, coefs = drv.control_file(cfg, traffic, seed, torch.device("cpu"))
    r = harness.Readings()
    r.add(coefs(ids, torch.bfloat16), coefs(ids, torch.float32), ids,
          cfg["limits"]["file"]["max_lsb"])
    assert not harness.judge(r.numbers(), cfg["limits"]["file"],
                             len(ids))[0]


def test_the_avi_writer_is_read_back_by_the_ports_decoder(tmp_path):
    from lives_tpu_torch.io.decoders import AVIDecoder
    frames = [bytes([k]) * (100 + 37 * k) for k in range(7)]
    path = tmp_path / "clip.avi"
    drv.write_avi(path, frames, 64, 48, 30.0)
    cd = AVIDecoder.get_clip_data(str(path))
    assert (cd.width, cd.height, cd.nframes, cd.fps) == (64, 48, 7, 30.0)
    assert cd.decoder.fourcc == "MJPG"
    assert [cd.decoder.get_frame_bytes(k) for k in range(7)] == frames
    assert drv.avi_frames(path) == frames


def test_work_of_a_known_frame_by_hand():
    # 32x16: luma 4 x 2 blocks, each chroma plane 16x8, 2 x 1 blocks:
    # (8 + 2 + 2) blocks of 64
    assert work_mjpeg.coefficients(32, 16) == 768
    # two tracks, a crossfade, no effects: each track decoded (37 a
    # coefficient) and converted (19 a pixel); the timeline 2 * 3 + 16 +
    # 15 = 37 a pixel; the encode 17 a pixel, 4 a chroma sample (2 * 128),
    # 35 a coefficient
    ops, nbytes = work_mjpeg.export_frame(2, ["crossfade"], [], 32, 16)
    px = 512
    assert ops == (2 * (768 * 37 + px * 19) + px * 37
                   + px * 17 + 256 * 4 + 768 * 35)
    assert nbytes == 3 * 768 * 2
    assert work.render_frame(2, ["crossfade"], [], 32, 16)[0] \
        - 2 * work.SOURCE * px == px * 37


def test_the_config_keeps_mt10s_timeline():
    from conftest import CHECKOUT
    cfgs = {n: json.loads((CHECKOUT / f"cardbench/configs/{n}.json")
                          .read_text())
            for n in ("mt10_1080p30", "mjpeg10_1080p30")}
    for k in ("width", "height", "fps", "tracks", "transitions", "effects",
              "params", "animate"):
        assert cfgs["mjpeg10_1080p30"][k] == cfgs["mt10_1080p30"][k], k
