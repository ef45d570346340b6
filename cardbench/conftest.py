"""The tiny size of the export's configuration for the benchmark's CPU
tests: `tests/conftest.py`'s `tiny` fixture cuts every configuration
`BENCHMARK.json` names by its `TINY` table, which predates this
configuration, so the entry is added to the table before each test."""

from __future__ import annotations

import sys

import pytest

TINY = {"mjpeg10_1080p30": {"width": 64, "height": 48, "tracks": 3,
                            "frames": 12, "clip_frames": 12, "chunk": 4}}


@pytest.fixture(autouse=True)
def _tiny_export():
    tests = sys.modules.get("conftest")
    table = getattr(tests, "TINY", None)
    if isinstance(table, dict):
        for name, size in TINY.items():
            table.setdefault(name, size)
    yield
