"""Reduce a `torch.profiler` trace of a stretch to the numbers the
per-layer metrics read: device kernel time, the device's busy time (the
union of every kernel, copy and set), counts of kernels and of pageable
host-to-device copies, the device operations that took most time, and the
device's idle gaps named by the host operation running across them.

The stretch is the span of the benchmark's own `record_function`
(`WINDOW`) on the host; device events are clipped to it. Inside it the
drivers wrap each call into the program in a span of their own (`span`,
`spanned`), so a gap the program's operations leave uncovered is named by
the call the host was in.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "cardbench.window"
SPAN = "cardbench."
TOP = 10


def _is_device(e) -> bool:
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA


def _annotation(e) -> bool:
    """A `record_function` span mirrored on the device's timeline: no
    work of the device's."""
    return (e.name.startswith(SPAN) or e.name == WINDOW
            or bool(getattr(e, "is_user_annotation", False)))


@contextlib.contextmanager
def span(name: str):
    """The benchmark's span around a call into the program, `cardbench.`
    and the call's name: it names the device's idle gaps the call's own
    operations do not cover."""
    import torch
    with torch.profiler.record_function(SPAN + name):
        yield


def spanned(items, name: str):
    """`items`, each step of the iteration inside `span(name)`."""
    it = iter(items)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(cpu, points):
    """For each of the increasing `points`, the name of the innermost host
    event (of one thread, so nested) open at it; where none is open, the
    last one that ended before it, as "after <name>"."""
    ends = sorted((e, name) for _, e, name in cpu)
    end_at = [e for e, _ in ends]
    names, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            s, e, name = cpu[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if stack:
            names.append(stack[-1][2])
        else:
            k = bisect.bisect_left(end_at, p)
            names.append(f"after {ends[k - 1][1]}" if k else None)
    return names


def reduce(prof) -> dict | None:
    """The stretch's numbers from a finished profiler, times in seconds;
    None when the trace holds no window span."""
    events = list(prof.events())
    win = [e for e in events if not _is_device(e) and e.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    dev, kernel_us, kernels, pageable, by_name = [], 0.0, 0, 0, {}
    for e in events:
        if not _is_device(e) or _annotation(e):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        dev.append((s, t))
        name = e.name
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if name.startswith("Memcpy"):
            pageable += "HtoD" in name and "Pageable" in name
        elif not name.startswith("Memset"):
            kernels += 1
            kernel_us += t - s
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if not _is_device(e)
                 and e.thread == thread and e.name != WINDOW)
    named = _innermost(cpu, [(s + e) / 2 for s, e in gaps])
    idle = {}
    for (s, e), name in zip(gaps, named):
        key = name or "host (no profiled operation)"
        idle[key] = idle.get(key, 0.0) + (e - s)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "kernel_s": kernel_us / 1e6, "kernels": kernels,
            "pageable_htod": pageable, "device_ops": top(by_name),
            "idle_gaps": top(idle)}

