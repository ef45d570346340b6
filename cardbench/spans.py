"""The program's own spans in a traced stretch, and the device idle each
one leaves.

The program marks where its work happens with `record_function` spans
whose names start with `lives.` (`lives_tpu_torch.diagnostics.span`: the
renderer, the plan and its uploads, the live frame, each effect and
generator). For each such name in a stretch, `attribute` gives:

- `count`: the spans that start in the stretch;
- `self_s`: their host time less the part their child `lives.` spans
  cover;
- `idle_s`: the device idle put down to them. Each idle interval of the
  stretch is split, instant by instant, over the innermost `lives.` span
  open on the window's thread (interval intersection, not a gap's
  midpoint).

Idle with no `lives.` span open is `unattributed_s`; the stretch's idle
(its window less the device's busy time, as `trace.reduce` counts both)
is `idle_s`, the sum of the two. A `lives.` span mirrored on the device's
timeline is an annotation and never device work (`trace._annotation`).

Run from the root of a checkout on a machine with the card:

    python3 -m cardbench.spans --workload <name> --seeds 1,2,... \
        --seconds <s> [--out FILE]

For each seed, one traced run of the cell as `cardbench.run --trace 1`
makes it (`run.run_cell`), with `trace.reduce`'s record given the key
`spans`; one JSON line a seed: `correct` and its checks (a window shorter
than the benchmark's may sample too few frames to be judged), the cell's
per-layer readings, and the device idle each layer (`LAYERS`) leaves a
unit (a chunk or a frame) of the stretch. Once `trace.reduce` itself
gives `spans`, `traced`, `summary` and this command give nothing
`--trace 1` does not, and go.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

from cardbench import bench, run, trace

PREFIX = "lives."

#: the layers of the program (PERF.md's names) and the spans of each
LAYERS = {"Renderer": ("lives.render.",),
          "Plan and upload": ("lives.plan.",),
          "Live frame": ("lives.frame", "lives.sink"),
          "Effects and generators": ("lives.fx.", "lives.gen.")}


def _pieces(spans, w0, w1):
    """Disjoint (start, end, name) pieces of [w0, w1] in which a span of
    `spans` ((start, end, name) of one thread, so nested) is open, each
    named by the innermost one."""
    out, stack, at = [], [], w0

    def close(upto):
        nonlocal at
        while stack and stack[-1][0] <= upto:
            end, name = stack.pop()
            if end > at:
                out.append((at, end, name))
                at = end
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, w0), min(e, w1)
        close(s)
        if stack and s > at:
            out.append((at, s, stack[-1][1]))
        at = max(at, s)
        # a child never outlives its parent
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    close(w1)
    return out


def _overlap(pieces, gaps):
    """{name: the time of `gaps` inside `pieces` of that name}; both lists
    sorted and each disjoint."""
    out, j = {}, 0
    for s, e in gaps:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def attribute(events) -> dict | None:
    """The `spans` record of a stretch's profiler events, times in
    seconds; None when they hold no window span."""
    win = [e for e in events if not trace._is_device(e)
           and e.name == trace.WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    dev = []
    for e in events:
        if trace._is_device(e) and not trace._annotation(e):
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                dev.append((s, t))
    gaps, prev = [], w0
    for s, e in trace._merge(dev):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if not trace._is_device(e) and e.thread == thread
             and e.name.startswith(PREFIX)
             and e.time_range.end > w0 and e.time_range.start < w1]
    pieces = _pieces(spans, w0, w1)
    idle = _overlap(pieces, gaps)
    names = {}
    for s, _, name in spans:
        n = names.setdefault(name, {"count": 0, "self_s": 0.0,
                                    "idle_s": 0.0})
        n["count"] += s >= w0
    for a, b, name in pieces:
        names[name]["self_s"] += (b - a) / 1e6
    for name, d in idle.items():
        names[name]["idle_s"] = d / 1e6
    total = sum(e - s for s, e in gaps)
    return {"idle_s": total / 1e6,
            "unattributed_s": (total - sum(idle.values())) / 1e6,
            "names": names}


def reduce(prof) -> dict | None:
    """`attribute` over a finished profiler's events."""
    return attribute(list(prof.events()))


def layer_ms(spans: dict, prefixes, units: int, what: str = "idle_s"
             ) -> float:
    """Milliseconds a unit of `what` (the device idle, or the host self
    time with "self_s") of the spans named from `prefixes`."""
    return 1e3 * sum(n[what] for name, n in spans["names"].items()
                     if name.startswith(tuple(prefixes))) / units


def traced(bench_json: dict, workload: str, seed: int, seconds: float,
           device: str, checkout: Path = bench.CHECKOUT) -> tuple:
    """One traced run of the cell (`run.run_cell`) whose `trace.reduce`
    record gains the key `spans`: (the run's result, that record)."""
    base, records = trace.reduce, []

    def reduce_with_spans(prof):
        out = base(prof)
        if out is not None:
            out["spans"] = reduce(prof)
            records.append(out)
        return out
    with mock.patch.object(trace, "reduce", reduce_with_spans):
        result = run.run_cell(bench_json, workload, seed, seconds, True,
                              device, checkout)
    return result, records[-1] if records else None


def summary(t: dict) -> dict:
    """A traced record's numbers a unit: window, busy and idle in
    milliseconds, the idle each layer leaves, its spans' host self time,
    the idle no span holds, and the plans built in the stretch."""
    units, sp = t["units"], t["spans"]
    out = {"units": units, "window_ms": 1e3 * t["window_s"] / units,
           "busy_ms": 1e3 * t["busy_s"] / units,
           "idle_ms": 1e3 * (t["window_s"] - t["busy_s"]) / units}
    if sp is not None:
        out["layers_idle_ms"] = {k: layer_ms(sp, p, units)
                                 for k, p in LAYERS.items()}
        out["layers_self_ms"] = {k: layer_ms(sp, p, units, "self_s")
                                 for k, p in LAYERS.items()}
        out["plan_builds"] = sp["names"].get("lives.plan.build",
                                             {"count": 0})["count"]
        out["unattributed_ms"] = 1e3 * sp["unattributed_s"] / units
        # attributed plus unattributed idle, less the stretch's idle
        attributed = sum(n["idle_s"] for n in sp["names"].values())
        out["closure_us"] = 1e6 * (attributed + sp["unattributed_s"]
                                   - (t["window_s"] - t["busy_s"]))
    return out


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    run._caches()
    import torch
    if not torch.cuda.is_available():
        print("cardbench.spans: no CUDA card", file=sys.stderr)
        return 2
    b = bench.load()
    card = run.card_limit()
    for seed in args.seeds:
        result, t = traced(b, args.workload, seed, args.seconds, "cuda:0")
        line = json.dumps({
            "workload": args.workload, "seed": seed, "card": card,
            "correct": result["correct"], "checks": result["checks"],
            "metrics": result["metrics"],
            **summary(t), "idle_gaps": t["idle_gaps"], "spans": t["spans"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
