"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. With `--trace 0` the result's metrics are the cell's end-to-end
metrics; with `--trace 1`, after the same window, a stretch is profiled
and the metrics are its per-layer ones. Either way the frames the window
produced are compared with the plain reference (`harness.py`), each
number compared printed beside its limit on standard error and under the
result's last key, `checks`. The run refuses to print a result without
the cards the cell asks for, and when a JAX module or the JAX package was
loaded (`guard.py`).

Set-up (`setup_s`) runs from the start of this module to the window's
first frame: imports, the card's context, building the cell's CUDA
libraries where the checkout has none yet (into `build/` inside it), the
inputs and one warm pass of every shape the window uses.

`memory_peak_bytes` is the program's: the card's peak of allocated bytes
less the buffer of sampled frames that the check keeps
(`harness.program_peak`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from cardbench import bench, guard, harness  # noqa: E402

CACHE = bench.CHECKOUT / "build" / "cardbench"


def _caches() -> None:
    """Every compiler cache a run could write, at fixed paths inside the
    checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"


def run_cell(bench_json: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, checkout: Path = bench.CHECKOUT,
             t_start: float | None = None) -> dict:
    """One run of `workload` on `device`: the result's fields, without
    the check for cards, which `main` makes."""
    import torch
    dev = torch.device(device)
    cellspec = bench.cell(bench_json, workload)
    cfg = bench.config(bench_json, cellspec["config"], checkout)
    traffic = bench.traffic(cellspec["traffic"], Path(checkout) / "cardbench")
    drv = bench.driver(traffic["driver"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)      # the context and the allocator up
        torch.cuda.reset_peak_memory_stats(dev)
    cell = drv.Cell(cfg, traffic, seed, dev)
    rec = cell.window(seconds)
    rec["setup_s"] = rec["t0"] - (T_START if t_start is None else t_start)
    rec["trace"] = cell.traced() if trace else None
    peak = harness.program_peak(dev, cell.sampler)
    cell.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    frames, ids = cell.sampler.taken()
    readings = harness.check(cell.reference, frames, ids, cfg["limits"])
    correct, checks = harness.judge(readings.numbers(), cfg["limits"],
                                    int(traffic["min_compared"]))
    metrics = {}
    for m in bench.metrics_of(bench_json, workload, trace):
        v = bench.reader(m["name"], Path(checkout) / "cardbench")(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else dev.type),
               "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": rec["frames"],
           "failed": len(readings.frames_over), "metrics": metrics,
           "device": devinfo}
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        devinfo.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    bench_json = bench.load()
    chips = int(bench.cell(bench_json, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench_json, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda:0")
    found = guard.forbidden()
    if found:
        print(f"cardbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    out["card"] = card_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
