"""Diagnostics: self-tests, timing ladder, perf stats.

Counterpart of `lives_tpu/diagnostics.py` (reference `src/diagnostics.c`:
`run_weed_startup_tests` :1064, `test_palette_conversions` :2065, the
instant-fps + stats overlay :97,398, micro-benchmarks :840). Copied, as
host Python: `current_ticks`, `FrameLadder` (the per-frame timing ladder
`Player.ladder` fills; `frameloader.c:46`, the layers.h:78 status enum),
`benchmark_memcpy` (a host copy) and `CostPredictor`
(`:21-107,182-231`). `run_startup_tests` (`:108-179`) runs the same six
checks on the port's layers, colour engine, effect host, event lists and
JPEG lanes, on an explicit device ("cuda" by default).

`span` marks where the port's work happens (the renderer, the plan and its
uploads, the live frame, each effect and generator) in a `torch.profiler`
trace, on the clock of the device's own activity. The profiler being on is
its only switch: with it off a span is one shared no-op context, and the
port keeps no timestamps of its own.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

TICKS_PER_SECOND = 100_000_000


def current_ticks() -> int:
    """lives_get_current_ticks (timing.c:49)."""
    return int(time.monotonic() * TICKS_PER_SECOND)


# ---------------------------------------------------------------------------
# Per-frame timing ladder (layer status lifecycle, layers.h:78-85)
# ---------------------------------------------------------------------------

LADDER_STAGES = ("queued", "loaded", "converted", "applied", "displayed")


class FrameLadder:
    """Collects per-frame stage timestamps; aggregates p50/p99 per stage."""

    def __init__(self, keep: int = 512):
        self.keep = keep
        self.frames: list[dict[str, int]] = []
        self._cur: dict[str, int] | None = None

    def begin(self):
        self._cur = {"queued": current_ticks()}

    def mark(self, stage: str):
        if self._cur is not None:
            self._cur[stage] = current_ticks()

    def end(self):
        if self._cur is not None:
            self.frames.append(self._cur)
            self._cur = None
            if len(self.frames) > self.keep:
                self.frames = self.frames[-self.keep // 2:]

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for a, b in zip(LADDER_STAGES[:-1], LADDER_STAGES[1:]):
            deltas = [(f[b] - f[a]) / 1e5 for f in self.frames
                      if a in f and b in f]  # ms
            if deltas:
                arr = np.asarray(deltas)
                out[f"{a}->{b}"] = {
                    "mean_ms": float(arr.mean()),
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p99_ms": float(np.percentile(arr, 99)),
                }
        total = [(f.get("displayed", 0) - f["queued"]) / 1e5
                 for f in self.frames if "displayed" in f]
        if total:
            arr = np.asarray(total)
            out["total"] = {"mean_ms": float(arr.mean()),
                            "p50_ms": float(np.percentile(arr, 50)),
                            "p99_ms": float(np.percentile(arr, 99))}
        return out


# ---------------------------------------------------------------------------
# Spans on the profiler's clock
# ---------------------------------------------------------------------------

_OFF = contextlib.nullcontext()


def span(name: str, sub: str = ""):
    """A `torch.profiler.record_function` named `name + sub` while the
    profiler is on; otherwise one shared no-op context, so an unprofiled
    call allocates nothing (a name that depends on a filter is built only
    when it is on). Never hold one open across a `yield`."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name + sub)
    return _OFF


# ---------------------------------------------------------------------------
# Startup self-tests (run_weed_startup_tests / test_palette_conversions)
# ---------------------------------------------------------------------------

def run_startup_tests(verbose: bool = False,
                      device="cuda") -> dict[str, bool]:
    """Fast in-process sanity assertions over the core subsystems, on
    `device` (`diagnostics.py:108-179`). Returns {test_name: passed}. The
    JPEG lanes' check passes where the host's libjpeg coder cannot load,
    as the JAX package's does, and names what is missing when
    `verbose`."""
    from .constants import Palette
    from .layer import layer_blank, layer_from_bytes, layer_to_bytes
    from .ops import colorspace as cs
    from .ops import colorspace_ref as ref
    from .utils.device import resolve_device
    dev = resolve_device(device, "run_startup_tests")

    results = {}

    def check(name, fn):
        try:
            fn()
            results[name] = True
        except Exception as e:
            results[name] = False
            if verbose:
                print(f"FAIL {name}: {e}")

    def t_layer_blank():
        lay = layer_blank(64, 32, Palette.YUV420P, device=dev)
        assert int(lay.planes[0][0, 0]) == 16 \
            and int(lay.planes[1][0, 0]) == 128

    def t_palette_roundtrip():
        rng = np.random.default_rng(0)
        buf = rng.integers(0, 256, 32 * 64 * 3, np.uint8).tobytes()
        lay = layer_from_bytes(buf, 64, 32, Palette.RGB24, device=dev)
        assert layer_to_bytes(lay) == buf

    def t_conversion_parity():
        rng = np.random.default_rng(1)
        r, g, b = rng.integers(0, 256, (3, 16, 32), np.uint8)
        ey, eu, ev = ref.rgb_to_yuv_planes(r, g, b)
        dy, du, dv = cs.rgb_to_yuv(*(torch.from_numpy(c).to(dev)
                                     for c in (r, g, b)))
        for e, d in ((ey, dy), (eu, du), (ev, dv)):
            assert np.abs(e.astype(int)
                          - d.cpu().numpy().astype(int)).max() <= 1

    def t_effect_host():
        from .effects import apply_instance, instantiate
        lay = layer_blank(32, 16, Palette.RGB24, device=dev)
        out = apply_instance(instantiate("negate"), [lay])[0]
        assert int(out.planes[0].min()) == 255

    def t_event_list():
        from .events import EventList, frame_event
        el = EventList()
        el.insert(frame_event(0, [1], [0]))
        assert len(EventList.from_json(el.to_json())) == 1

    def t_jpeg_lanes():
        # both halves of the compressed pipeline: encode a frame on the
        # device, entropy-decode it back, check its geometry
        from .io.jpeg_encode import JpegDeviceEncoder
        from .io.jpeg_ingest import read_coefficients
        from .native import load_jpegcoef
        try:
            load_jpegcoef()
        except Exception as e:          # gated: no libjpeg coder here
            if verbose:
                print(f"SKIP jpeg_encode_decode_lanes: no libjpeg coder "
                      f"({e})")
            return
        rng = np.random.default_rng(2)
        rgb = torch.from_numpy(rng.integers(0, 256, (3, 32, 48),
                                            np.uint8)).to(dev)
        enc = JpegDeviceEncoder(48, 32, quality=85, batch=1, device=dev)
        data = enc.encode_batch(rgb[None])[0]
        assert data[:3] == b"\xff\xd8\xff"
        f = read_coefficients(data)
        assert f.height == 32 and f.width == 48

    check("layer_blank", t_layer_blank)
    check("palette_bytes_roundtrip", t_palette_roundtrip)
    check("conversion_parity", t_conversion_parity)
    check("effect_host", t_effect_host)
    check("event_list_serialise", t_event_list)
    check("jpeg_encode_decode_lanes", t_jpeg_lanes)
    return results


def benchmark_memcpy(sizes=(1 << 20, 8 << 20)) -> dict[str, float]:
    """Host copy micro-benchmark (diagnostics.c:840 `benchmark`)."""
    out = {}
    for n in sizes:
        a = np.random.default_rng(0).integers(0, 256, n, np.uint8)
        t0 = time.perf_counter()
        for _ in range(8):
            b = a.copy()
        dt = (time.perf_counter() - t0) / 8
        out[f"memcpy_{n >> 20}MB_GBps"] = n / dt / 1e9
    return out


# ---------------------------------------------------------------------------
# Frame-cost predictor (the nodemodel ANN load predictor, ann_roll
# nodemodel.c:1336 + nn_programmer.c): predicts the next frame's render
# cost so adaptive quality can degrade BEFORE deadline misses.
# ---------------------------------------------------------------------------

class CostPredictor:
    """Online least-squares over recent (features, cost) pairs with an EMA
    fallback. Features: anything monotone with load (fx count, pixels)."""

    def __init__(self, n_features: int = 2, window: int = 64):
        self.n = n_features
        self.window = window
        self.samples: list[tuple[np.ndarray, float]] = []
        self.ema = 0.0

    def observe(self, features, cost: float):
        f = np.asarray(features, np.float64)[: self.n]
        self.samples.append((f, float(cost)))
        if len(self.samples) > self.window:
            self.samples.pop(0)
        self.ema = 0.9 * self.ema + 0.1 * float(cost) if self.ema else cost

    def predict(self, features) -> float:
        if len(self.samples) < max(self.n + 2, 8):
            return self.ema
        X = np.stack([np.concatenate([f, [1.0]])
                      for f, _ in self.samples])
        y = np.asarray([c for _, c in self.samples])
        try:
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        except np.linalg.LinAlgError:
            return self.ema
        f = np.concatenate([np.asarray(features, np.float64)[: self.n],
                            [1.0]])
        pred = float(f @ coef)
        return max(pred, 0.0) if np.isfinite(pred) else self.ema
