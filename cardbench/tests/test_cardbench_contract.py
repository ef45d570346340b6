"""BENCHMARK.json keeps to the benchmark's contract: names, units and
lines of the allowed characters, the keys each entry may have, and a file
for every piece the harness finds by name."""

from __future__ import annotations

import json
import re

from conftest import CHECKOUT

from cardbench import bench

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p.split("/") and not p.startswith("/")
        assert (CHECKOUT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_keys_names_units():
    for group, keys in KEYS.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_metrics_and_cells_hold_together():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved, m["name"]
    for w in cells:
        reported = [n for n, m in e2e.items() if w in m.get("workloads",
                                                            cells)]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert any(w in m["workloads"] for m in BENCH["per_layer"]), w
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(k) for k in layers)


def test_every_piece_has_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("cardbench/")
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (CHECKOUT / cfg["reference"]).is_file()
    root = CHECKOUT / "cardbench"
    for w in BENCH["workloads"]:
        traffic = json.loads((root / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (root / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(bench.reader(m["name"], root)), m["name"]
