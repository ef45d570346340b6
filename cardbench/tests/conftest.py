"""The benchmark's own tests: run from the checkout's root with
`python -m pytest cardbench/tests`; the card's cases with `-m cuda` on a
machine that has one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
# tiny frames: one thread a worker keeps workers from starving each other
torch.set_num_threads(1)

#: the cells at a size a CPU test holds: geometry cut, the timeline short,
#: every window chunk or frame sampled
TINY = {"mt10_1080p30": {"width": 48, "height": 28, "frames": 90,
                         "chunk": 16},
        "vj_4k60": {"width": 64, "height": 36}}


@pytest.fixture
def tiny(tmp_path) -> Path:
    """A checkout whose benchmark is the real one at tiny sizes: a copy of
    `cardbench/` and `BENCHMARK.json`, the configurations cut to `TINY`,
    the traffic mixes sampling every unit with a floor of 4 frames."""
    shutil.copytree(CHECKOUT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    for path in (tmp_path / "cardbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(sample_stride=1, min_compared=4, sample_slots=64)
        path.write_text(json.dumps(t))
    return tmp_path
