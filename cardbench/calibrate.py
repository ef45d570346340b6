"""Read the numbers `correct` compares, over many seeds in one process:
the program's, its lower-precision control's, and those of the program
with its timed path broken. The limits in a configuration's file are set
from these readings; the benchmark's own runs never run this.

    python3 -m cardbench.calibrate --workload <name> --seconds <s> \
        --seeds 1,2,... [--control 1,2,3] [--faults 1,2,3] [--out FILE]

- program: one run of the cell (`run.run_cell`, trace off) a seed;
- control: the reference itself put in the program's place, computed in
  bfloat16 (the nearest precision below the configuration's float32), on
  as many frames of the seed's inputs as a run compares, against the
  float32 reference;
- faults: one run a seed with each of the driver's `fault`s planted.

Each reading is a JSON line on standard output and in `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from cardbench import bench, harness, run


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control", type=_seeds, default=[])
    ap.add_argument("--faults", type=_seeds, default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    run._caches()
    import torch
    if not torch.cuda.is_available():
        print("cardbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    b = bench.load()
    cellspec = bench.cell(b, args.workload)
    cfg = bench.config(b, cellspec["config"])
    traffic = bench.traffic(cellspec["traffic"])
    drv = bench.driver(traffic["driver"])
    sink = open(args.out, "a") if args.out else None

    def emit(**kw):
        line = json.dumps({"workload": args.workload, **kw})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    compared = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run.run_cell(b, args.workload, seed, args.seconds, False,
                           "cuda:0", t_start=t0)
        checks = {k: c["value"] for k, c in out["checks"].items()}
        compared.append(checks["frames_compared"])
        emit(kind="program", seed=seed, correct=out["correct"], **checks,
             metrics={k: m["value"] for k, m in out["metrics"].items()})
        torch.cuda.empty_cache()
    # the control compares as many frames as the program's runs did
    n = (round(sum(compared) / len(compared)) if compared
         else int(traffic["min_compared"]) * 4)
    block = harness.block_for((3, int(cfg["height"]), int(cfg["width"])))
    for seed in args.control:
        ids, ref = drv.control(cfg, traffic, seed, n, dev)
        r = harness.Readings()
        for i in range(0, len(ids), block):
            js = ids[i:i + block]
            r.add(ref(js, torch.bfloat16), ref(js, torch.float32), js,
                  cfg["limits"]["max_lsb"])
        emit(kind="control", seed=seed, dtype="bfloat16", **r.numbers())
    for seed in args.faults:
        for kind in drv.FAULTS:
            with drv.fault(kind):
                out = run.run_cell(b, args.workload, seed, args.seconds,
                                   False, "cuda:0")
            emit(kind="fault", fault=kind, seed=seed, correct=out["correct"],
                 **{k: c["value"] for k, c in out["checks"].items()})
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
