"""Whole runs of each cell at a tiny size on the CPU, the harness's look
for a card skipped: the program against the reference, the reference's
lower-precision control, the timed path broken underneath, and a cell,
configuration, traffic mix and metric added as files alone."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from conftest import CHECKOUT

from cardbench import bench, harness, run

CELLS = [w["name"] for w in bench.load(CHECKOUT)["workloads"]]
SEED = 2**31 + 77


def _run(checkout, workload, seed=SEED, trace=False):
    return run.run_cell(bench.load(checkout), workload, seed, 1.0, trace,
                        "cpu", checkout=checkout)


@pytest.mark.parametrize("workload", CELLS)
def test_program_matches_the_reference(tiny, workload):
    out = _run(tiny, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["frames_compared"]["value"] >= 4
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {
        m["name"] for m in bench.metrics_of(bench.load(tiny), workload,
                                            False)}


@pytest.mark.parametrize("workload", CELLS)
def test_a_seed_gives_the_same_inputs(tiny, workload):
    b = bench.load(tiny)
    spec = bench.cell(b, workload)
    cfg = bench.config(b, spec["config"], tiny)
    traffic = bench.traffic(spec["traffic"], tiny / "cardbench")
    drv = bench.driver(traffic["driver"])
    one = drv.control(cfg, traffic, SEED, 6, torch.device("cpu"))
    two = drv.control(cfg, traffic, SEED, 6, torch.device("cpu"))
    assert one[0] == two[0]
    assert torch.equal(one[1](one[0], torch.float32),
                       two[1](two[0], torch.float32))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_in_bfloat16_is_not_correct(tiny, workload, seed):
    """The reference in the program's place, computed in bfloat16 (the
    precision below the configuration's float32), fails the limits."""
    b = bench.load(tiny)
    spec = bench.cell(b, workload)
    cfg = bench.config(b, spec["config"], tiny)
    traffic = bench.traffic(spec["traffic"], tiny / "cardbench")
    drv = bench.driver(traffic["driver"])
    ids, ref = drv.control(cfg, traffic, seed, 8, torch.device("cpu"))
    r = harness.Readings()
    r.add(ref(ids, torch.bfloat16), ref(ids, torch.float32), ids,
          cfg["limits"]["max_lsb"])
    correct, checks = harness.judge(r.numbers(), cfg["limits"], 4)
    assert not correct, checks


def _faults():
    out = []
    for w in CELLS:
        b = bench.load(CHECKOUT)
        traffic = bench.traffic(bench.cell(b, w)["traffic"])
        out += [(w, k) for k in bench.driver(traffic["driver"]).FAULTS]
    return out


@pytest.mark.parametrize("workload,kind", _faults())
def test_broken_timed_path_is_not_correct(tiny, workload, kind):
    b = bench.load(tiny)
    traffic = bench.traffic(bench.cell(b, workload)["traffic"],
                            tiny / "cardbench")
    with bench.driver(traffic["driver"]).fault(kind):
        out = _run(tiny, workload)
    assert not out["correct"], out["checks"]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_config_traffic_and_metric_added_as_files(tiny):
    before = _digests(tiny / "cardbench")
    root = tiny / "cardbench"
    cfg = json.loads((root / "configs" / "mt10_1080p30.json").read_text())
    cfg.update(name="mt4_small", tracks=4, frames=40,
               transitions=cfg["transitions"][:3])
    (root / "configs" / "mt4_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "cuts.json").read_text())
    traffic.update(cut_every=10)
    (root / "traffic" / "quick_cuts.json").write_text(json.dumps(traffic))
    (root / "metrics" / "segments_per_pass.render.py").write_text(
        "def read(rec):\n    return rec['frames'] / 10.0\n")
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "mt4_small", "source": "https://x.org",
                         "file": "cardbench/configs/mt4_small.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "mt4_small.quick_cuts",
                           "config": "mt4_small", "traffic": "quick_cuts",
                           "chips": 1, "why": "a test"})
    # an end-to-end metric of its own, read by `render_fps.py`, its stem
    b["end_to_end"].insert(0, {"name": "render_fps.quick_cuts",
                               "unit": "frames/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["mt4_small.quick_cuts"]})
    b["per_layer"].append({"name": "segments_per_pass.render",
                           "unit": "segments", "better": "higher",
                           "source": "program_counter", "layer": "Renderer",
                           "moves": "render_fps.quick_cuts",
                           "workloads": ["mt4_small.quick_cuts"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    out = _run(tiny, "mt4_small.quick_cuts", trace=True)
    assert out["correct"], out["checks"]
    assert "segments_per_pass.render" in out["metrics"]
    out = _run(tiny, "mt4_small.quick_cuts")
    assert set(out["metrics"]) == {"render_fps.quick_cuts", "setup_s"}


@pytest.mark.cuda
def test_long_cell_on_the_card():
    """A run of the first cell on a card at the benchmark's length,
    traced: correct, with every metric it reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    b = bench.load(CHECKOUT)
    out = run.run_cell(b, CELLS[0], SEED, b["run_seconds"], True, "cuda:0")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {
        m["name"] for m in bench.metrics_of(b, CELLS[0], True)}
    assert out["device"]["busy_s"] > 0
