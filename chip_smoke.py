#!/usr/bin/env python
"""Smoke run of lives_tpu_torch on one NVIDIA GPU: build, check, render.

Drives the port's main path, the 10-track 1080p30 multitrack render
(`scenes.multitrack_timeline` -> `events.renderer.render_events` ->
`graph.nodemodel.FrameGraph.run_batch` -> the fused sweep kernel), after
building the kernel from `lives_tpu_torch/csrc/fused_sweep.cu` and holding
it against its plain PyTorch version and the committed JAX golden.

    python3 chip_smoke.py

Phases, one line each:
1. require CUDA (exit 1 without it); the card's name and power limit;
2. build the kernel (nvcc, sm_90a) and print the build time;
3. kernel vs `plain_sweep` on the card, max |diff| <= 1 LSB: the 13-effect
   chain at 1920x1080 with 10 tracks (B=4), and a ragged 1000x562 frame
   with 3 tracks;
4. `render_to_arrays` of the golden timeline on the card vs
   tests/fixtures/render_golden.npz (lives_tpu, f32 XLA path), <= 1 LSB;
5. the main path through `render_events`: 192 frames in 96-frame chunks;
   the kernel must launch once a chunk, its first frames must match the
   plain route; then a timed pass (frames/s, x realtime), and the kernel's
   and `plain_sweep`'s time on one 96-frame chunk.
Then a JSON line of the kernels and, last, the JSON result line.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, FPS, TRACKS, CHUNK, N_FRAMES = 1920, 1080, 30.0, 10, 96, 192


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def diff_stats(a, b):
    """(max |a-b|, share of differing values) of two u8 tensors."""
    d = (a.int() - b.int()).abs()
    return int(d.max().item()), float((d > 0).float().mean().item())


def first_chunk(el, device, n: int):
    """The first n frames of the timeline's first segment, as the renderer
    hands them to FrameGraph.run_batch: (plan, src ids, packed) on the
    device."""
    import numpy as np
    import torch

    from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
    from lives_tpu_torch.events.renderer import (_chain_for, _interp_arrays,
                                                 segment_events)
    from lives_tpu_torch.graph import SinkSpec, fused_sweep
    from lives_tpu_torch.graph.nodemodel import chain_spec_of, pack_params
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[:n]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(
        _interp_arrays(el, inits, chain, tcs),
        np.asarray(tcs, np.float64) / TICKS_PER_SECOND,
        [round(tc * el.fps / TICKS_PER_SECOND) for tc in tcs])
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), ids.shape[1], el.height, el.width, rows, el.fps,
        DeviceSyntheticSource(el.height, el.width, device=device),
        SinkSpec(el.width, el.height), device)
    assert plan is not None, "the main-path chain must qualify for the kernel"
    return (plan, torch.from_numpy(ids).to(device),
            torch.from_numpy(packed).to(device))


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from lives_tpu_torch.events.event_list import EventList
    from lives_tpu_torch.events.renderer import (render_events,
                                                 render_to_arrays)
    from lives_tpu_torch.graph import SinkSpec, fused_sweep
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    line("1 device", torch=torch.__version__, cuda=torch.version.cuda,
         name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())

    # 2. build
    built = fused_sweep.build()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    line("2 build", seconds=f"{built.seconds:.2f}", lib=built.path.name,
         ptxas=repr(" | ".join(ptxas)))

    # 3. kernel vs plain_sweep on the card
    max_err = 0
    for w, h, tracks in ((W, H, TRACKS), (1000, 562, 3)):
        el = multitrack_timeline(n_tracks=tracks, n_frames=N_FRAMES,
                                 width=w, height=h, fps=FPS)
        plan, ids, packed = first_chunk(el, dev, 4)
        got = fused_sweep.fused_sweep(plan, ids, packed)
        torch.cuda.synchronize()
        ref = fused_sweep.plain_sweep(plan, ids, packed)
        worst, share = diff_stats(got, ref)
        line("3 kernel_vs_plain", size=f"{w}x{h}", tracks=tracks,
             frames=ids.shape[2], max_abs_err=worst,
             differing_share=f"{share:.3g}")
        assert worst <= 1, f"kernel vs plain_sweep at {w}x{h}: {worst} LSB"
        max_err = max(max_err, worst)

    # 4. the card against the JAX golden
    g = np.load(ROOT / "tests" / "fixtures" / "render_golden.npz")
    gold = g["frames"]
    gel = EventList.from_json(str(g["timeline"]))
    before = fused_sweep.LAUNCHES
    out, _ = render_to_arrays(gel, DeviceSyntheticSource(
        gold.shape[2], gold.shape[3], device=dev),
        SinkSpec(gold.shape[3], gold.shape[2]),
        batch_size=int(g["batch_size"]))
    worst, share = diff_stats(torch.from_numpy(out), torch.from_numpy(gold))
    line("4 golden", frames=out.shape[0], launches=fused_sweep.LAUNCHES -
         before, max_abs_err=worst, differing_share=f"{share:.3g}")
    assert fused_sweep.LAUNCHES > before, "golden render missed the kernel"
    assert worst <= 1, f"kernel render vs JAX golden: {worst} LSB"
    max_err = max(max_err, worst)

    # 5. the main path through the user's entry points
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=N_FRAMES, width=W,
                             height=H, fps=FPS)
    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)
    fused_sweep.LAUNCHES = 0
    t0 = time.perf_counter()
    rendered, head = 0, None
    for tcs, lay in render_events(el, src, sink, batch_size=CHUNK):
        arr = lay.planes[0]
        assert arr.dtype == torch.uint8 and arr.device.type == "cuda"
        assert tuple(arr.shape) == (len(tcs), 3, H, W), tuple(arr.shape)
        if head is None:
            head = arr[:4].clone()
        rendered += len(tcs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fused_sweep.LAUNCHES
    line("5 main_path", frames=rendered, chunks=n_chunks, launches=launches,
         first_pass_s=f"{first_s:.3f}")
    assert rendered == N_FRAMES
    assert launches == n_chunks, f"{launches} launches for {n_chunks} chunks"

    class Materialised:
        """The same source without its LOAD step: run_batch gets layers
        and takes the plain chain (route b)."""
        get_batch = src.get_batch
    _, plain_head = next(iter(render_events(el, Materialised(), sink,
                                            batch_size=4)))
    worst, share = diff_stats(head, plain_head.planes[0])
    line("5 main_vs_plain_route", frames=4, max_abs_err=worst,
         differing_share=f"{share:.3g}")
    assert worst <= 1, f"main path vs plain route: {worst} LSB"
    max_err = max(max_err, worst)

    # timed pass (warm: the pass above built the plan and the library)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    rendered = 0
    for tcs, _lay in render_events(el, src, sink, batch_size=CHUNK):
        rendered += len(tcs)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fps = rendered / wall_s
    line("5 timed", card=repr(card), frames=rendered, wall_s=f"{wall_s:.4f}",
         event_ms=f"{start.elapsed_time(end):.2f}", frames_per_s=f"{fps:.1f}",
         x_realtime=f"{fps / FPS:.2f}")

    # one 96-frame chunk: kernel vs plain_sweep, in turns
    plan, ids, packed = first_chunk(el, dev, CHUNK)
    torch.cuda.reset_peak_memory_stats()
    plain = lambda: fused_sweep.plain_sweep(plan, ids, packed)  # noqa: E731
    kern = lambda: fused_sweep._launch(plan, ids, packed)  # noqa: E731
    p1, k1, k2, p2 = (time_ms(plain, 2), time_ms(kern, 5),
                      time_ms(kern, 5), time_ms(plain, 2))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    line("5 chunk_ms", card=repr(card), frames=CHUNK, kernel=f"{k1:.3f},"
         f"{k2:.3f}", plain=f"{p1:.3f},{p2:.3f}",
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")

    print(json.dumps({"kernels": [{
        "name": "fused_sweep", "route": "cuda",
        "source": "lives_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "lives_tpu/graph/pallas_composite.py:240",
        "launches": launches, "max_abs_err": max_err,
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
