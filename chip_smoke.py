#!/usr/bin/env python
"""Smoke run of lives_tpu_torch on one NVIDIA GPU: build, check, render.

Drives the port's paths through the entry points a user calls
(`events.renderer.render_events` -> `graph.nodemodel.FrameGraph.run_batch`
-> the kernels, and `transcode.render_to_encoder` over decoded clips) at
1920x1080, 30 fps, in 96-frame chunks, after building the five kernel
libraries from `lives_tpu_torch/csrc/` and holding every kernel against its
plain PyTorch version:

- the main path, the 10-track multitrack timeline (`scenes.
  multitrack_timeline`) through the fused sweep kernel;
- three stateful chains (ROADMAP Slice 4), recorded as init events:
  A "stateful-LED" (benchmarks/render_stateful_led.py:49-60; its 11-step
  tail runs the sweep in comp-in mode), B "stateful prefix"
  (benchmarks/render_stateful.py:33-40; its prefix runs the sweep in
  comp-out mode) and C "alien" (render_stateful_led.py:43-47; the fused
  stateful sweep under LIVES_TPU_FUSED_STATEFUL=1, the 3-phase route
  without it);
- config D, "decoded clips": 10 YUV4MPEG clips (C420jpeg, clamped BT.601)
  rendered through the main path's 13-effect chain into a YUV4MPEG file:
  K2 converts each track's chunk, K4 runs the 9 transitions, the eager
  tail the rest, K3 converts each chunk in the encoder;
- the roofline study (benchmarks/sweep_profile.py's counterpart): four
  chain variants through `render_events`, and the card's float32 ceiling
  read with K6, the fused-multiply-add probe;
- the single-frame live path at 4K60 (BASELINE row 5, as
  benchmarks/latency4k.py:40-80 drives it): `GeneratorClip`s through
  `FrameGraph.run`, eight chain configurations toggled every 25 frames.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --config-d   # config D alone (phase 11's render
                                       # and K4's time), no result line
    python3 chip_smoke.py --colour     # K2's and K3's times alone, no
                                       # result line
    python3 chip_smoke.py --roofline   # phase 13 alone, no result line
    python3 chip_smoke.py --live       # phase 14 alone, no result line

Phases, one line each:
1. require CUDA (exit 1 without it); the card's name and power limit;
2. build the five kernel libraries (one nvcc each, started together),
   build times, and each kernel entry's ptxas registers and spills;
3. the sweep vs `plain_sweep` on the card, max |diff| <= 1 LSB: the
   13-effect chain at 1920x1080 with 10 tracks (B=4), and a ragged 1000x562
   frame with 3 tracks;
4. `render_to_arrays` of the golden timeline on the card vs
   tests/fixtures/render_golden.npz (lives_tpu, f32 XLA path), <= 1 LSB;
5. the main path through `render_events`: 192 frames in 96-frame chunks;
   the kernel must launch once a chunk, its first frames must match the
   plain route; then a timed pass (frames/s, x realtime), and the kernel's
   and `plain_sweep`'s time on one 96-frame chunk; the geometry K1's
   launch chooses and K1's time at every tile (`fused_sweep.TILES`), and
   on crossfade alone and with one blur of r = 1, 3, 8, 16 at its chosen
   geometry and every tile; K1 on the chain without its blur (R = 0) in
   turns with the whole chain, which shows what the halo costs; a
   profiled pass of the main path (device busy and idle share);
6. the sweep's comp-out and comp-in modes vs their plain versions at
   1920x1080 (B=4) and 1000x562: the f32 comp within 1/255, u8 within
   1 LSB;
7. the fused stateful sweep vs `plain_stateful_sweep` over two chunks on
   config C, on life + gaussian_blur r=2, on gaussian_blur r=2 + fire and
   on the largest summed halo it takes (blur r=16 + fire + blur r=16,
   R = 33): frames within 1 LSB, final states within 1e-5 (f32) or exact
   (u8);
8. configs A, B and C (C with and without the pref) through
   `render_events`, 192 frames in 96-frame chunks: the launch counts of each
   path (C under the pref: one cooperative K5 launch a chunk), its first
   4 frames against the plain route (<= 1 LSB), a warm timed pass, and
   kernel vs plain ms on one 96-frame chunk for each new kernel; K5's
   chosen geometry (tile, run, blocks an SM, grid, rounds of tiles a frame)
   and its time at every tile and run, and on config C's chain with steps
   disabled (where its time goes);
9. the colour kernels K2 (`yuv420_to_rgb`) and K3 (`rgb_to_yuv420`) vs
   their plain versions at 1920x1080 (B=4) and at widths whose rows are no
   multiple of 16 bytes (1000, 1004, 1002, 994), clamped and full range,
   BT.601 and BT.709, K3 on RGB, RGBA and odd heights and widths; then on
   planes that are views at byte offsets 1-3 of one buffer at 1080p: K2
   within 1 LSB, K3 integer-identical, with the share of differing
   values, one line a size;
10. the composite kernel K4 vs `plain_composite`: config D's 9-transition
   prefix at 1920x1080 over 10 tracks (B=4), a 3-track prefix at 1000x562,
   and at 45x37 (H*W no multiple of 16) on tracks that are views at byte
   offsets 0-3 with a prefix that reads one track twice: within 1 LSB;
11. config D, decoded clips: 10 YUV4MPEG clips of 24 frames (synthetic
   frames through K3, written to a temporary directory removed at exit),
   opened with `open_clip`, rendered by `transcode.render_to_encoder(...,
   encoder="yuv4mpeg")` through `ClipFrameSource` under
   LIVES_TPU_PALLAS_COMPOSITE=1, 192 frames in 96-frame chunks: the launch
   counts (K2 10 a chunk, K4 1 a chunk, K3 1 a chunk), the written file
   reopened (192 frames at 1920x1080) and holding the route's first 4
   frames, which match the route on the plain versions (<= 1 LSB) and the
   route without the pref as closely as the JAX package's own two routes
   do (<= 6 LSB, at most 300 values above 2 LSB; it shows 6 and 281,
   tests/test_torch_routes.py), a warm timed pass with the host time in `get_batch` split from the
   rest, a profiled pass (device busy share, device-to-host copies), and
   K2, K3 and K4 vs plain ms on one 96-frame chunk (K2 and K3 at each run
   length of `yuv_kernels.RUNS`, K3 also as 96 one-frame launches, and a
   copy ceiling: `Tensor.copy_` moving K2's bytes, in TB/s; `--colour`
   prints these times alone); K4's geometry (span, staged bytes, blocks an
   SM),
   its time over the first 1, 3, 5 and 9 transitions beside their bytes,
   and over 9 crossfades (what bounds it);
12. the multi-device layer (`lives_tpu_torch.parallel`) on one card, as a
   4-entry mesh on cuda:0 (every band at its true rows):
   a. K1's band mode vs the whole-frame kernel over the main path's chain
      (B=4) at 1920x1080 in bands of 270, 540 and 1080 rows, and at a
      ragged 1000x562 with 3 tracks in bands of 281: every band bit for bit
      the whole frame's rows, and within 1 LSB of `plain_band_sweep`;
   b. `spatial_sweep_fn` over the main path's timeline, 192 frames in
      96-frame chunks (`chunk_of`): 4 band launches a chunk and no
      whole-frame launch, frames bit for bit those of `render_events`; a
      timed pass beside the main path's (in turns), and the 4 band launches
      of a chunk, one band launch and their plain version vs K1's launch;
   c. `sharded_batch_fn` (DP) equal to `run_batch`, and `spatial_batch_fn`
      (SP) within 1 LSB, over 10 RGB24 (8,3,1080,1920) tracks;
   d. `spatial_stateful_fn` on config A's chain over 10 layers at 1080p,
      two calls of 8 frames: frames within 1 LSB of `run_batch`, states
      within 1e-5 (f32) or exact (u8);
   e. `pipeline_chain_fn`, 4 stages of point filters over (8,3,1080,1920)
      f32 frames, within 1e-5 of the sequential chain;
   f. `dryrun_multichip` on the 4 entries (every path at a small size,
      each against the DP render);
13. the roofline study: the variants full, noblur, trans (10 tracks) and
   trans2 (2 tracks) of benchmarks/sweep_profile.py:68-72,102-107 through
   `render_events`, 192 frames in 96-frame chunks after a warm pass, one
   K1 launch a chunk asserted: ms a frame, x realtime, K1's time on one
   chunk; K6 (`ops/fma_chain.py`) against `plain_fma_chain` on
   (3,1080,1920) float32 at K = 32 and 128, within a relative error of
   K * 2^-23; the FFMA, FMUL and FADD count of its SASS (cuobjdump -sass:
   FFMA only); each K of 32, 128, 512 and 2048 timed by CUDA events over
   200 launches in a row queued behind one long launch (so the device, not
   the host's 30-40 us a launch, sets the time), the depths in turns up
   and down, with the host's time a launch; the ceiling, the difference
   in operations over the difference in time, from 32 -> 128 (as the
   reference reads it) and 512 -> 2048; each variant's K1 operations a
   chunk over K1's time, as a share of the measured ceiling and of 67
   TFLOP/s; the library call at K = 128, `x * c` with c = sum M^i for
   i <= K (the chain in closed form, within K * 2^-23 of the plain
   version), timed beside K6;
14. the live path at 3840x2160 and 60 fps: `GeneratorClip("plasma")` over
   `GeneratorClip("colour_bars")` on the card through eight `FrameGraph`s
   (benchmarks/latency4k.py:54-56), each warmed once; 480 frames
   switching configuration every 25: the host's time from the `run` call
   to `torch.cuda.synchronize()` a frame, as p50, p99 and max beside
   BASELINE row 5's target (p99 < 16 ms); the means over windows of 8
   frames (latency4k.py's reading) and frames/s; peak memory; a profiled
   pass (device busy and idle share, eager kernels a frame); checks:
   frame 0 of [saturation, vignette] and of [negate] on the card within
   1 LSB of the same `run` on the CPU at 1920x1080, `run([GenSlot(fg, n),
   bg])` bit for bit `run([fg.get_frame(n), bg])`, a GenSlot around
   beat_rings raises, and traced values that are tensors on the card give
   the host numbers' frame bit for bit, with no synchronizing call in
   either path (torch's sync debug mode).
Then a `resources` line for K1, K4, K5 and K6 (the main path's entry:
ptxas registers and spills, blocks an SM), a JSON line of the kernels
(with each one's bound: the larger of its bytes over 3.35 TB/s and its
float operations over 67 TFLOP/s, the H100 SXM's device memory and
float32 rates; K6's at K = 128, with its largest relative error besides)
and, last, the JSON result line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, FPS, TRACKS, CHUNK, N_FRAMES = 1920, 1080, 30.0, 10, 96, 192

TRANSITIONS = ["crossfade", "blend_screen", "blend_overlay", "blend_add",
               "blend_multiply", "blend_lighten", "blend_difference",
               "blend_darken", "crossfade"]
RGB_DELAY = ("rgb_delay", {"delay_r": 0.0, "delay_g": 1.0, "delay_b": 2.0})


def led_chain(second):
    """fire + `second` | 9 transitions | saturation + vignette."""
    return ([("fire", {"threshold": 0.6}, [0]), (*second, [0])]
            + [(TRANSITIONS[t - 1], {"amount": 0.5}, [0, t])
               for t in range(1, 10)]
            + [("saturation", {"saturation": 1.2}, [0]),
               ("vignette", {"amount": 0.5}, [0])])


#: name -> (tracks, [(filter, values, in_tracks)])
CONFIGS = {
    "A": (10, led_chain(RGB_DELAY)),
    "B": (4, [("crossfade", {"amount": 0.6}, [0, 1]),
              ("vignette", {"amount": 0.5}, [0]), (*RGB_DELAY, [0]),
              ("fire", {"threshold": 0.6}, [0]),
              ("saturation", {"saturation": 1.2}, [0])]),
    "C": (10, led_chain(("alien_overlay", {}))),
    "life_blur": (1, [("life", {"threshold": 0.15, "amount": 0.5}, [0]),
                      ("gaussian_blur", {"radius": 2}, [0])]),
    "blur_fire": (1, [("gaussian_blur", {"radius": 2}, [0]),
                      ("fire", {"threshold": 0.5}, [0]),
                      ("saturation", {"saturation": 1.2}, [0])]),
    # the largest summed halo the stateful sweep takes: 16 + 1 + 16 = 33
    "r33": (2, [("crossfade", {"amount": 0.4}, [0, 1]),
                ("gaussian_blur", {"radius": 16}, [0]),
                ("fire", {"threshold": 0.5}, [0]),
                ("box_blur", {"radius": 16}, [0]),
                ("saturation", {"saturation": 1.2}, [0])]),
}


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def diff_stats(a, b):
    """(max |a-b|, share of differing values) of two tensors."""
    d = (a.double() - b.double()).abs()
    return d.max().item(), float((d > 0).float().mean().item())


def timeline(name, n_frames, width=W, height=H):
    """A CONFIGS chain as recorded init events (as lives_tpu/scenes.py:
    105-142 records one): track t plays clip t+1, frame i at frame i."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    n_tracks, specs = CONFIGS[name]
    el = EventList(fps=FPS, width=width, height=height)
    inits = [filter_init_event(0, f, in_tracks=tr, out_tracks=[0],
                               values=v) for f, v, tr in specs]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = int(TICKS_PER_SECOND / FPS)
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, n_tracks + 1)),
                              [i] * n_tracks))
    return el


def config_d_timeline(n_frames):
    """Config D's timeline: the main path's 13-effect chain over 10 tracks
    (`scenes.multitrack_timeline`), track t playing clip t+1 at frame
    i % CLIP_FRAMES."""
    from lives_tpu_torch.scenes import multitrack_timeline
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=n_frames, width=W,
                             height=H, fps=FPS)
    for e in el.frame_events():
        e.props["frames"] = [f % CLIP_FRAMES for f in e.frames]
    return el


def _chain(el):
    """The instances of the timeline's first segment."""
    from lives_tpu_torch.events.renderer import _chain_for, segment_events
    seg = segment_events(el)[0]
    return _chain_for(seg.inits, el, seg.frames[0].tc)[1]


def chunk_of(el, device, n: int, k: int = 0):
    """Frames [k*n, (k+1)*n) of the timeline's first segment, as the
    renderer hands them to FrameGraph.run_batch: (chain spec, src ids,
    packed, rows_key) on the device."""
    import numpy as np
    import torch

    from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
    from lives_tpu_torch.events.renderer import (_chain_for, _interp_arrays,
                                                 segment_events)
    from lives_tpu_torch.graph.nodemodel import chain_spec_of, pack_params
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[k * n:(k + 1) * n]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(
        _interp_arrays(el, inits, chain, tcs),
        np.asarray(tcs, np.float64) / TICKS_PER_SECOND,
        [round(tc * el.fps / TICKS_PER_SECOND) for tc in tcs])
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    return (chain_spec_of(chain), torch.from_numpy(ids).to(device),
            torch.from_numpy(packed).to(device), rows)


def sweep_plan(el, spec, rows, device, n_tracks, **mode):
    """The fused sweep's plan for `spec` on the timeline's geometry."""
    from lives_tpu_torch.graph import SinkSpec, fused_sweep
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    plan = fused_sweep.build_fused_sweep(
        spec, n_tracks, el.height, el.width, rows, el.fps,
        DeviceSyntheticSource(el.height, el.width, device=device),
        SinkSpec(el.width, el.height), device, **mode)
    assert plan is not None, "the chain must qualify for the kernel"
    return plan


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


def in_turns(plain, kern, plain_reps=2, kern_reps=5):
    """(kernel ms, plain ms, text) timed in turns plain, kernel, kernel,
    plain."""
    p1, k1, k2, p2 = (time_ms(plain, plain_reps), time_ms(kern, kern_reps),
                      time_ms(kern, kern_reps), time_ms(plain, plain_reps))
    return ((k1 + k2) / 2, (p1 + p2) / 2,
            f"kernel={k1:.3f},{k2:.3f} plain={p1:.3f},{p2:.3f}")


#: a launch count (MODE_LAUNCHES entry, or the stateful sweep's) -> kernel
KERNEL_OF = {"u8": "fused_sweep", "comp_out": "fused_sweep_comp_out",
             "comp_in": "fused_sweep_comp_in", "stateful": "stateful_sweep",
             "band": "fused_sweep_band"}

#: each kernel of the kernels line: its source and the TPU kernel it
#: replaces
SOURCES = {
    "fused_sweep": ("lives_tpu_torch/csrc/fused_sweep.cu",
                    "lives_tpu/graph/pallas_composite.py:240"),
    "fused_sweep_comp_out": ("lives_tpu_torch/csrc/fused_sweep.cu",
                             "lives_tpu/graph/pallas_composite.py:240"),
    "fused_sweep_comp_in": ("lives_tpu_torch/csrc/fused_sweep.cu",
                            "lives_tpu/graph/pallas_composite.py:240"),
    "stateful_sweep": ("lives_tpu_torch/csrc/stateful_sweep.cu",
                       "lives_tpu/graph/pallas_stateful.py:94"),
    "yuv420_to_rgb": ("lives_tpu_torch/csrc/yuv420.cu",
                      "lives_tpu/ops/pallas_kernels.py:114"),
    "rgb_to_yuv420": ("lives_tpu_torch/csrc/yuv420.cu",
                      "lives_tpu/ops/pallas_kernels.py:185"),
    "composite": ("lives_tpu_torch/csrc/composite.cu",
                  "lives_tpu/graph/pallas_composite.py:120"),
    "fused_sweep_band": ("lives_tpu_torch/csrc/fused_sweep.cu",
                         "lives_tpu/graph/pallas_composite.py:240"),
    "fma_chain": ("lives_tpu_torch/csrc/fma_chain.cu",
                  "benchmarks/sweep_profile.py:146"),
}
NAMES = tuple(SOURCES)
#: config D's clips: 24 frames each, played at frame i % 24
CLIP_FRAMES = 24

#: the H100 SXM's device memory and float32 (non-tensor-core) rates
#: (NVIDIA's data sheet), for each kernel's bound
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
#: float operations a pixel of each opcode (graph/fused_sweep.py), counted
#: from csrc/sweep_common.cuh and csrc/stateful_sweep.cu: a multiply, add,
#: min, max, divide, sqrt, exp or floor counts one; the synthetic source's
#: integer formulas are not counted. A blend adds its mode's cost a channel
#: (_BLEND_MODES order), a stencil of radius r two passes of 2r+1 taps.
BLEND_COST = (1, 1, 1, 4, 1, 1, 2, 4, 5, 5, 3, 4, 2, 2)
OP_FLOPS = {0: lambda a: 16, 1: lambda a: 16 + 3 * BLEND_COST[a],
            2: lambda a: 25, 3: lambda a: 31, 4: lambda a: 9,
            5: lambda a: 20, 6: lambda a: 23,
            7: lambda r: 12 * (2 * r + 1) + 15,
            8: lambda a: 43, 9: lambda a: 30, 10: lambda a: 24}


def table_flops(ops, u8_stages=False) -> int:
    """Float operations a pixel of an op table: each op, 3 to bring in each
    track it reads besides track 0 and 3 for track 0, and with `u8_stages`
    (the composite kernel) a quantise (15) and a re-read (3) after each
    op."""
    n = 3
    for code, in0, in1, arg, *_ in ops.cpu().tolist():
        n += OP_FLOPS[code](arg) + 3 * (in0 != 0)
        n += 3 * (code <= 3 and in1 not in (0, in0))
        n += 18 * u8_stages
    return n


def ptxas_entries(log):
    """{kernel entry (mangled, namespace dropped): {registers, spill_stores,
    spill_loads}} from `nvcc -Xptxas -v` output."""
    import re
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            entry = m.group(1).replace("_ZN12_GLOBAL__N_1", "")
            out.setdefault(entry, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for `nbytes` of device memory traffic and `flops` float32
    operations."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def device_busy(prof):
    """(device ms, the 8 largest by name as text) of a torch.profiler
    trace."""
    import torch
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (sum(by_name.values()),
            repr("; ".join(f"{n[:48]} {t:.1f}" for n, t in top)))


def dtoh_copies(prof) -> int:
    """Device -> host copies in a torch.profiler trace."""
    import torch
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("Memcpy DtoH"))


def main_geometry(plan, ids, packed, card):
    """K1 on the main chain's chunk at the geometry its launch chooses, then
    at every tile of `fused_sweep.TILES`: ms each."""
    from lives_tpu_torch.graph import fused_sweep
    B = ids.shape[2]
    chosen = fused_sweep.plan_geometry(plan, B)
    line("5 geometry", tile=f"{chosen.tile_h}x{chosen.tile_w}",
         run=chosen.run, margin=chosen.margin, grid=chosen.grid,
         smem=chosen.smem, blocks_per_sm=fused_sweep.blocks_per_sm(chosen),
         phase1_cells_per_px=f"{fused_sweep.phase1_cells(chosen, plan.halo) / (B * plan.height * plan.width):.3f}")
    for tile in fused_sweep.TILES:
        geom = fused_sweep.plan_geometry(plan, B, tile)
        got = [time_ms(lambda: fused_sweep._launch(plan, ids, packed,
                                                   None, 0, geom), 3)
               for _ in range(2)]
        line("5 geometry_ms", card=repr(card), tile=f"{tile[0]}x{tile[1]}",
             run=geom.run, blocks_per_sm=fused_sweep.blocks_per_sm(geom),
             ms=",".join(f"{x:.3f}" for x in got))


def blur_geometry(el, ids, card):
    """K1 on crossfade alone (r = 0) and with one gaussian blur of radius
    1, 3, 8 and 16 (a cheap phase 1, the stencil's cost growing with r):
    ms at the geometry its launch chooses (runs of 8, of 4 from r = 8 on)
    and at every tile."""
    import torch

    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph import fused_sweep
    from lives_tpu_torch.graph.nodemodel import chain_spec_of
    B = ids.shape[2]
    packed = torch.zeros((2, B), device=ids.device)
    for r in (0, 1, 3, 8, 16):
        fade = instantiate("crossfade", amount=0.5)
        fade.in_tracks = (0, 1)
        chain = [fade, instantiate("gaussian_blur", radius=r, amount=0.6)]
        plan = sweep_plan(el, chain_spec_of(chain[:1 + (r > 0)]), (),
                          ids.device, ids.shape[1])
        chosen = fused_sweep.plan_geometry(plan, B)
        ms = {}
        for tile in (None, *fused_sweep.TILES):
            try:
                geom = fused_sweep.plan_geometry(plan, B, tile)
            except ValueError:  # over a block's shared memory
                continue
            key = "chosen" if tile is None else f"{tile[0]}x{tile[1]}"
            ms[key] = time_ms(lambda: fused_sweep._launch(
                plan, ids, packed, None, 0, geom), 3)
        line("5 blur_ms", card=repr(card), radius=r,
             tile=f"{chosen.tile_h}x{chosen.tile_w}", run=chosen.run,
             blocks_per_sm=fused_sweep.blocks_per_sm(chosen),
             ms=" ".join(f"{k}:{v:.3f}" for k, v in ms.items()))


def render_path(el, src, sink, check=True):
    """One pass of `render_events` over `el`, every launch count set to 0
    just before it and read just after: (frames, first 4 frames, the
    non-zero counts by KERNEL_OF key, wall s)."""
    import torch

    from lives_tpu_torch.events.renderer import render_events
    from lives_tpu_torch.graph import fused_sweep, stateful_sweep
    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    stateful_sweep.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rendered, head = 0, None
    for tcs, lay in render_events(el, src, sink, batch_size=CHUNK):
        if check:
            arr = lay.planes[0]
            assert arr.dtype == torch.uint8 and arr.device.type == "cuda"
            assert tuple(arr.shape) == (len(tcs), 3, el.height, el.width)
            if head is None:
                head = arr[:4].clone()
        rendered += len(tcs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**fused_sweep.MODE_LAUNCHES, "stateful": stateful_sweep.LAUNCHES}
    return rendered, head, {k: v for k, v in counts.items() if v}, wall


def phase12(dev, card0, card, el, src, sink, held, ms, bounds, launches):
    """12. the multi-device layer on one card: a 4-entry mesh on `card0`
    (cuda:0)."""
    import numpy as np
    import torch

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.host import FrameContext, instantiate
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.graph import FrameGraph, fused_sweep, stateful_sweep
    from lives_tpu_torch.parallel import (dryrun_multichip, frame_mesh,
                                          pipeline_chain_fn,
                                          sharded_batch_fn, spatial_batch_fn,
                                          spatial_stateful_fn,
                                          spatial_sweep_fn)
    from lives_tpu_torch.scenes import multitrack_timeline

    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"  # the float route
    mesh4 = frame_mesh([card0] * 4)
    n_chunks = -(-N_FRAMES // CHUNK)

    # 12a. the band kernel vs the whole-frame kernel and plain_band_sweep
    for w, h, tracks, bands in ((W, H, TRACKS, (270, 540, 1080)),
                                (1000, 562, 3, (281,))):
        tel = multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                  height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        whole = fused_sweep.fused_sweep(
            sweep_plan(tel, spec, rows, dev, tracks), ids, packed)
        for band_h in bands:
            plan = sweep_plan(tel, spec, rows, card0, tracks, band_h=band_h)
            for y0 in range(0, h, band_h):
                got = fused_sweep.fused_sweep(plan, ids, packed, y0=y0)
                torch.cuda.synchronize()
                same = torch.equal(got, whole[:, :, y0:y0 + band_h])
                line("12a band_vs_whole", size=f"{w}x{h}", band_h=band_h,
                     y0=y0, bit_identical=same)
                assert same, ("band", w, h, band_h, y0)
                held("fused_sweep_band", "12a band_vs_plain", got,
                     fused_sweep.plain_band_sweep(plan, ids, packed, y0), 1,
                     size=f"{w}x{h}", band_h=band_h, y0=y0, frames=4)
        del whole

    # 12b. the band sweep over the main path's timeline
    graph = FrameGraph(_chain(el), sink, fps=FPS)
    sweep = spatial_sweep_fn(graph, frame_mesh([card0] * 4, axis="s"), src,
                             CHUNK, H, W, axis="s")
    assert sweep is not None, "the main path must qualify for the band sweep"
    main = [lay.planes[0].clone() for _, lay in
            render_events_of(el, src, sink)]

    def band_pass():
        """The timeline's chunks as the renderer builds them, each through
        the band sweep."""
        return [sweep(ids, packed) for _, ids, packed, _ in
                (chunk_of(el, dev, CHUNK, k) for k in range(n_chunks))]

    fused_sweep.MODE_LAUNCHES.update(dict.fromkeys(fused_sweep.MODE_LAUNCHES,
                                                   0))
    stateful_sweep.LAUNCHES = 0
    outs = band_pass()
    torch.cuda.synchronize()
    counts = {k: v for k, v in fused_sweep.MODE_LAUNCHES.items() if v}
    counts.update({"stateful": stateful_sweep.LAUNCHES} if
                  stateful_sweep.LAUNCHES else {})
    line("12b band_sweep", frames=sum(o.shape[0] for o in outs),
         chunks=n_chunks, launches=counts)
    assert counts == {"band": 4 * n_chunks}, counts
    launches["fused_sweep_band"] = counts["band"]
    for k, (o, m) in enumerate(zip(outs, main)):
        same = torch.equal(o, m)
        line("12b band_sweep_vs_main_path", chunk=k, bit_identical=same)
        assert same, ("band sweep vs main path", k)
    del outs, main
    walls = {"main": [], "band": []}
    for kind in ("main", "band", "band", "main"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "main":
            for _ in render_events_of(el, src, sink):
                pass
        else:
            band_pass()
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
    rate = {k: N_FRAMES / (sum(v) / len(v)) for k, v in walls.items()}
    line("12b timed", card=repr(card), frames=N_FRAMES,
         band_wall_s=",".join(f"{x:.4f}" for x in walls["band"]),
         main_wall_s=",".join(f"{x:.4f}" for x in walls["main"]),
         band_frames_per_s=f"{rate['band']:.1f}",
         main_frames_per_s=f"{rate['main']:.1f}",
         band_over_main=f"{rate['band'] / rate['main']:.3f}")
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    whole_plan = sweep_plan(el, spec, rows, dev, TRACKS)
    band_h = H // 4
    band_plan = sweep_plan(el, spec, rows, card0, TRACKS, band_h=band_h)

    def four_bands():
        for i in range(4):
            fused_sweep._launch(band_plan, ids, packed, None, i * band_h)

    def four_plain():
        for i in range(4):
            fused_sweep.plain_band_sweep(band_plan, ids, packed, i * band_h)
    k1 = [time_ms(lambda: fused_sweep._launch(whole_plan, ids, packed,
                                               None), 5)]
    four = [time_ms(four_bands, 5), time_ms(four_bands, 5)]
    k1.append(time_ms(lambda: fused_sweep._launch(whole_plan, ids, packed,
                                                   None), 5))
    one = time_ms(lambda: fused_sweep._launch(band_plan, ids, packed, None,
                                              band_h), 5)
    plain = [time_ms(four_plain, 1), time_ms(four_plain, 1)]
    ms["fused_sweep_band"] = (sum(four) / 2, sum(plain) / 2, "")
    px = CHUNK * H * W
    # the 4 bands write the chunk's frames once: K1's bytes and operations
    bounds["fused_sweep_band"] = bound(
        px * 3, px * (table_flops(band_plan.ops) + 15))
    line("12b chunk_ms", card=repr(card), frames=CHUNK,
         four_bands=",".join(f"{x:.3f}" for x in four),
         whole_frame_k1=",".join(f"{x:.3f}" for x in k1),
         one_band=f"{one:.3f}",
         plain_four_bands=",".join(f"{x:.3f}" for x in plain),
         bound_ms=f"{bounds['fused_sweep_band'][0]:.4f}")

    # 12c. DP and SP over decoded-style layers
    B8 = 8
    tcs, frames = np.arange(B8) / FPS, np.arange(B8)
    layers = [src.get_batch([t + 1] * B8, range(B8)) for t in range(TRACKS)]
    ref = graph.run_batch(layers, tcs, frames).planes[0]
    dp = sharded_batch_fn(graph, mesh4)(layers, tcs, frames).planes[0]
    worst, share = diff_stats(dp, ref)
    line("12c dp_vs_run_batch", frames=B8, max_abs_err=f"{worst:.6g}",
         differing_share=f"{share:.3g}")
    assert worst == 0, ("DP", worst)
    sp = spatial_batch_fn(graph, mesh4)(layers, tcs, frames).planes[0]
    worst, share = diff_stats(sp, ref)
    line("12c sp_vs_run_batch", frames=B8, max_abs_err=f"{worst:.6g}",
         differing_share=f"{share:.3g}")
    assert worst <= 1, ("SP", worst)
    del layers, ref, dp, sp

    # 12d. stateful bands on config A's chain, two calls of 8 frames
    def config_a():
        chain = []
        for name, vals, tr in CONFIGS["A"][1]:
            inst = instantiate(name, **vals)
            inst.in_tracks = tuple(tr)
            chain.append(inst)
        return FrameGraph(chain, sink, fps=FPS)
    g_band, g_ref = config_a(), config_a()
    run = spatial_stateful_fn(g_band, mesh4)
    for k in range(2):
        fr = range(k * B8, (k + 1) * B8)
        layers = [src.get_batch([t + 1] * B8, fr) for t in range(TRACKS)]
        tcs, frames = np.asarray(fr) / FPS, np.asarray(fr)
        got = run(layers, tcs, frames).planes[0]
        ref = g_ref.run_batch(layers, tcs, frames).planes[0]
        worst, share = diff_stats(got, ref)
        line("12d stateful_bands_vs_run_batch", call=k, frames=B8,
             max_abs_err=f"{worst:.6g}", differing_share=f"{share:.3g}")
        assert worst <= 1, ("stateful bands", k, worst)
    for i, (a, b) in enumerate(zip(g_band.states, g_ref.states)):
        for key in (sorted(a) if isinstance(a, dict) else [None]):
            x, y = (a[key], b[key]) if key else (a, b)
            if x is None:
                continue
            worst, _ = diff_stats(x, y)
            tol = 1e-5 if x.is_floating_point() else 0
            line("12d state", step=g_band.chain[i].filter.name,
                 leaf=key or "-", dtype=str(x.dtype).split(".")[-1],
                 max_abs_err=f"{worst:.3g}")
            assert worst <= tol, (i, key, worst)
    del layers, got, ref

    # 12e. the pipeline over 4 point filters
    insts = [instantiate("colour_balance", red=1.1, blue=0.9),
             instantiate("saturation", saturation=1.3),
             instantiate("vignette", amount=0.7),
             instantiate("saturation", saturation=0.8)]
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = torch.rand((B8, 3, H, W), generator=gen, device=dev)
    tcs = np.arange(B8, dtype=np.float32) / FPS
    got = pipeline_chain_fn(insts, mesh4)(batch, tcs)
    seq = batch
    for inst in insts:
        seq = inst.filter.process([Layer(planes=(seq,), palette=int(
            Palette.RGBFLOAT))], inst.param_values(), FrameContext(
                tc=0.0, frame=0, fps=25.0, width=W, height=H)).planes[0]
    worst, _ = diff_stats(got, seq)
    line("12e pipeline_vs_sequential", stages=len(insts), frames=B8,
         max_abs_err=f"{worst:.3g}")
    assert worst <= 1e-5, ("pipeline", worst)

    # 12f. the dry run of every path at a small size
    t0 = time.perf_counter()
    dryrun_multichip([card0] * 4)
    line("12f dryrun_multichip", entries=4,
         seconds=f"{time.perf_counter() - t0:.2f}")
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"


def write_clips(tmp, src):
    """Config D's clips in directory `tmp`: TRACKS YUV4MPEG clips of
    CLIP_FRAMES synthetic frames of `src` each (clip c is the source's clip
    c, through K3), opened with `open_clip`: ({c: Clip}, bytes, s)."""
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.decoders import write_y4m
    from lives_tpu_torch.ops.colorspace import convert_layer
    t0 = time.perf_counter()
    clips, size = {}, 0
    for c in range(1, TRACKS + 1):
        yuv = [p.cpu().numpy() for p in convert_layer(
            src.get_batch([c] * CLIP_FRAMES, range(CLIP_FRAMES)),
            Palette.YUV420P).planes]
        path = os.path.join(tmp, f"clip{c}.y4m")
        write_y4m(path, [tuple(p[i] for p in yuv)
                         for i in range(CLIP_FRAMES)], FPS)
        size += os.path.getsize(path)
        clips[c] = open_clip(path, os.path.join(tmp, "work"))
        clips[c].unique_id = c  # the timeline's clip ids
    return clips, size, time.perf_counter() - t0


def decoded_pass(clips, el, out_path, dev):
    """One render of `el` from `clips` into `out_path` through
    `render_to_encoder`, every launch count set to 0 just before it and
    read just after: (non-zero counts, wall s, s in get_batch: the host
    read, upload and K2, on the host clock ended by a synchronise)."""
    import torch

    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.graph import composite, fused_sweep, stateful_sweep
    from lives_tpu_torch.ops import yuv_kernels
    from lives_tpu_torch.transcode import render_to_encoder

    class TimedSource(ClipFrameSource):
        host_s = 0.0

        def get_batch(self, clip_ids, frame_nums):
            t0 = time.perf_counter()
            out = super().get_batch(clip_ids, frame_nums)
            torch.cuda.synchronize()
            self.host_s += time.perf_counter() - t0
            return out

    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    stateful_sweep.LAUNCHES = 0
    yuv_kernels.LAUNCHES.update(dict.fromkeys(yuv_kernels.LAUNCHES, 0))
    composite.LAUNCHES = 0
    tsrc = TimedSource(clips, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert render_to_encoder(el, tsrc, out_path, encoder="yuv4mpeg",
                             batch_size=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**fused_sweep.MODE_LAUNCHES,
              "stateful": stateful_sweep.LAUNCHES,
              **yuv_kernels.LAUNCHES, "composite": composite.LAUNCHES}
    return {k: v for k, v in counts.items() if v}, wall, tsrc.host_s


def config_d_alone(dev, card, passes=3):
    """`--config-d`: config D alone, as phase 11 renders it (its clips,
    timeline and warm timed passes under LIVES_TPU_PALLAS_COMPOSITE=1, a
    profiled pass with its device-to-host copies), then K4 on one
    96-frame chunk against `plain_composite` and its time.
    It calls only entry points that every version of the port with config
    D has, so a copy of this script placed at the root of another checkout
    times that checkout's package."""
    from lives_tpu_torch import native
    from lives_tpu_torch.graph import composite
    from lives_tpu_torch.graph.nodemodel import composite_prefix
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    native.load_all(["yuv420", "composite"])
    src = DeviceSyntheticSource(H, W, device=dev)
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
    n_chunks = -(-N_FRAMES // CHUNK)
    want = {"yuv420_to_rgb": TRACKS * n_chunks, "composite": n_chunks}
    el = config_d_timeline(N_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src)
        line("d clips", clips=TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        out_path = os.path.join(tmp, "render.y4m")
        for k in range(passes + 1):  # the first pass builds and warms
            counts, wall_s, host_s = decoded_pass(clips, el, out_path, dev)
            # K3: once a chunk here, once a frame in a tree before the
            # encoder took chunks
            k3 = counts.pop("rgb_to_yuv420")
            assert counts == want and k3 in (n_chunks, N_FRAMES), (counts, k3)
            line("d timed", card=repr(card), root=ROOT.name, run=k,
                 frames=N_FRAMES, k3_launches=k3, wall_s=f"{wall_s:.4f}",
                 get_batch_s=f"{host_s:.4f}",
                 rest_s=f"{wall_s - host_s:.4f}",
                 frames_per_s=f"{N_FRAMES / wall_s:.1f}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall, _ = decoded_pass(clips, el, out_path, dev)
        busy, _ = device_busy(prof)
        line("d profiled", card=repr(card), root=ROOT.name,
             wall_ms=f"{prof_wall * 1e3:.1f}", device_busy_ms=f"{busy:.1f}",
             idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}",
             dtoh_copies=dtoh_copies(prof))
        for c in clips.values():
            c.close()
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    prefix, n_t = composite_prefix(spec[:9], TRACKS)
    plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
    trk = [src.traced_layer(ids[0, t], ids[1, t]).planes[0]
           for t in range(n_t)]
    worst, _ = diff_stats(composite._launch(plan, trk, packed, CHUNK, H, W),
                          composite.plain_composite(plan, trk, packed))
    assert worst <= 1, worst
    got = [time_ms(lambda: composite._launch(plan, trk, packed, CHUNK, H, W),
                   5) for _ in range(2)]
    line("d k4", card=repr(card), root=ROOT.name, frames=CHUNK,
         max_abs_err=f"{worst:.6g}", ms=",".join(f"{x:.3f}" for x in got))


def colour_chunk(dev):
    """One 96-frame 1080p chunk of the synthetic source's clip 1 on the
    card, as the RGB24 plane and as the YUV420P planes K3 makes of it."""
    from lives_tpu_torch.ops import yuv_kernels
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    rgb = DeviceSyntheticSource(H, W, device=dev).get_batch(
        [1] * CHUNK, range(CHUNK)).planes[0]
    return (rgb, *yuv_kernels.plain_rgb_to_yuv420(rgb))


def colour_calls(rgb, y, u, v):
    """{label: a call} on one chunk: K2 and K3 at each run length of
    `yuv_kernels.RUNS` (a tree without run lengths: its one kernel), and K3
    as CHUNK one-frame launches, as the encoder launched it before it took
    chunks. Only entry points every version of the port has are called, so
    a copy of this script at the root of another checkout times that
    checkout's kernels."""
    from lives_tpu_torch.ops import yuv_kernels as yk
    calls = {}
    for run in getattr(yk, "RUNS", (None,)):
        kw = {} if run is None else {"run": run}
        calls[f"k2 run={run}"] = lambda kw=kw: yk._launch_k2(y, u, v, 1, 0,
                                                             **kw)
        calls[f"k3 run={run}"] = lambda kw=kw: yk._launch_k3(rgb, 1, 0,
                                                             **kw)
    calls[f"k3 x{CHUNK}"] = lambda: [yk._launch_k3(rgb[k], 1, 0)
                                     for k in range(CHUNK)]
    return calls


def copy_ceiling(dev, nbytes):
    """(ms, TB/s) of `Tensor.copy_` between two u8 tensors of nbytes / 2
    bytes: a streaming pass that reads and writes `nbytes` in all."""
    import torch
    a = torch.empty(int(nbytes) // 2, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    t = time_ms(lambda: b.copy_(a), 20)
    return t, 2 * a.numel() / t / 1e9


def colour_alone(dev, card):
    """`--colour`: K2 and K3 on one 96-frame 1080p chunk, every call of
    `colour_calls` timed twice, K2 checked against its plain version, and
    the copy ceiling; a copy of this script at the root of another
    checkout times that checkout's kernels."""
    from lives_tpu_torch import native
    from lives_tpu_torch.ops import yuv_kernels as yk
    native.load_all(["yuv420"])
    rgb, y, u, v = colour_chunk(dev)
    worst, _ = diff_stats(yk._launch_k2(y, u, v, 1, 0),
                          yk.plain_yuv420_to_rgb(y, u, v))
    assert worst <= 1, worst
    for label, fn in colour_calls(rgb, y, u, v).items():
        reps = 2 if label == f"k3 x{CHUNK}" else 20
        got = [time_ms(fn, reps) for _ in range(2)]
        line("c colour", card=repr(card), root=ROOT.name, kernel=label,
             frames=CHUNK, ms=",".join(f"{x:.4f}" for x in got))
    t, rate = copy_ceiling(dev, CHUNK * H * W * 4.5)
    line("c copy_ceiling", card=repr(card), root=ROOT.name, ms=f"{t:.4f}",
         tb_per_s=f"{rate:.3f}")


#: phase 13's chain variants of the roofline study (benchmarks/
#: sweep_profile.py:68-72,102-107): (name, tracks, suffix effects)
FX_FULL = [("gaussian_blur", {"radius": 3, "amount": 0.6}),
           ("colour_balance", {"red": 1.1, "green": 1.0, "blue": 0.9}),
           ("saturation", {"saturation": 1.3}),
           ("vignette", {"amount": 0.7})]
ROOFLINE = [("full", 10, FX_FULL), ("noblur", 10, FX_FULL[1:]),
            ("trans", 10, []), ("trans2", 2, [])]
#: K6's depths: the reference's two (sweep_profile.py:169), then two that
#: no launch cost can hide; the ceiling is read from each pair
FMA_DEPTHS = (32, 128, 512, 2048)
#: launches a timing of K6 takes in a row
FMA_REPS = 200
#: the depth of K6's lead launch (about 14 ms on an H100): the device is
#: busy with it while the host queues a timing's launches
FMA_LEAD = 65536


def make_timeline(n_tracks, n_frames, width, height, fps, fx):
    """`scenes.multitrack_timeline` with a configurable suffix chain: a
    copy of benchmarks/sweep_profile.py:34-65 over the port's event
    list."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event,
                                                   param_change_event)
    el = EventList(fps=fps, width=width, height=height)
    tpf = int(TICKS_PER_SECOND / fps)
    inits = []
    trans = ["crossfade", "blend_screen", "blend_overlay", "luma_key",
             "blend_add", "blend_multiply", "chroma_key", "blend_lighten",
             "blend_difference"]
    for t in range(1, n_tracks):
        name = trans[(t - 1) % len(trans)]
        vals = {"amount": 0.5} if name.startswith(("crossfade", "blend")) \
            else {}
        init = filter_init_event(0, name, in_tracks=[0, t], out_tracks=[0],
                                 values=vals)
        el.insert(init)
        inits.append(init)
    for name, vals in fx:
        init = filter_init_event(0, name, values=vals)
        el.insert(init)
        inits.append(init)
    el.insert(filter_map_event(0, [i.event_id for i in inits]))
    el.insert(param_change_event(0, inits[0].event_id, "amount", 0.0))
    el.insert(param_change_event((n_frames - 1) * tpf,
                                 inits[0].event_id, "amount", 1.0))
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, n_tracks + 1)),
                              [i] * n_tracks))
    return el


def sass_counts(so_path, kernel):
    """{FFMA, FMUL, FADD: count} in `kernel`'s SASS (cuobjdump -sass of the
    built library)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts, inside = dict.fromkeys(("FFMA", "FMUL", "FADD"), 0), False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            for op in counts:
                counts[op] += len(re.findall(rf"\b{op}\b", ln))
    return counts


def queued_ms(fn, reps: int, lead):
    """(device ms a call, host us a call) of reps calls of fn timed by CUDA
    events behind `lead`, a long launch: the host queues the calls while
    the device runs it, so the events time the device alone, even where a
    call costs the host more than the device (K6 at small K)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lead()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host_us


def roofline(dev, card):
    """13. the port's roofline study (benchmarks/sweep_profile.py): the
    four chain variants through `render_events` at 1920x1080, K1's float
    operations over its time, and the card's float32 ceiling read with K6
    (`ops/fma_chain.py`). Returns K6's entry of the kernels line."""
    import numpy as np
    import torch

    from lives_tpu_torch import native
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.graph import fused_sweep
    from lives_tpu_torch.ops import fma_chain as fc
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    native.load_all(["fused_sweep", "fma_chain"])
    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)
    px = CHUNK * H * W
    k1 = {}
    for name, tracks, fx in ROOFLINE:
        render_path(make_timeline(tracks, CHUNK, W, H, FPS, fx), src, sink,
                    check=False)                                  # warm
        el = make_timeline(tracks, N_FRAMES, W, H, FPS, fx)
        rendered, _, counts, wall = render_path(el, src, sink, check=False)
        assert rendered == N_FRAMES and counts == {"u8": n_chunks}, counts
        ms_frame = wall / rendered * 1e3
        spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
        plan = sweep_plan(el, spec, rows, dev, tracks)
        t = time_ms(lambda: fused_sweep._launch(plan, ids, packed, None), 5)
        k1[name] = (px * (table_flops(plan.ops) + 15), t)
        line("13 variant", card=repr(card), variant=name, tracks=tracks,
             frames=rendered, launches=counts, ms_per_frame=f"{ms_frame:.4f}",
             x_realtime=f"{1000.0 / FPS / ms_frame:.2f}", k1_chunk_ms=f"{t:.3f}")

    # K6 against its plain version at the reference's depths
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.rand((3, H, W), device=dev, generator=g) + 0.5
    n = x.numel()
    worst_abs = worst_rel = 0.0
    for K in FMA_DEPTHS[:2]:
        got = fc.fma_chain(x, K)
        torch.cuda.synchronize()
        ref = fc.plain_fma_chain(x, K)
        d = (got.double() - ref.double()).abs()
        rel = (d / ref.double().abs()).max().item()
        line("13 fma_vs_plain", shape=tuple(x.shape), K=K,
             max_abs_err=f"{d.max().item():.6g}", max_rel_err=f"{rel:.3g}",
             tolerance=f"{fc.tolerance(K):.3g}")
        assert rel <= fc.tolerance(K), (K, rel)
        worst_abs, worst_rel = max(worst_abs, d.max().item()), max(worst_rel,
                                                                   rel)
    counts = sass_counts(fc.build().path, "fma_chain_kernel")
    line("13 sass", kernel="fma_chain_kernel", **counts)
    assert counts["FFMA"] >= 128 and counts["FMUL"] == counts["FADD"] == 0, \
        counts

    # the ceiling: each depth FMA_REPS launches in a row, the depths in
    # turns up and down; the launches of this study are K6's count
    fc.LAUNCHES = 0
    times = {K: [] for K in FMA_DEPTHS}
    host = {K: [] for K in FMA_DEPTHS}
    for order in (FMA_DEPTHS, FMA_DEPTHS[::-1]):
        for K in order:
            t, us = queued_ms(lambda: fc.fma_chain(x, K), FMA_REPS,
                              lambda: fc.fma_chain(x, FMA_LEAD))
            times[K].append(t)
            host[K].append(us)
    launches = fc.LAUNCHES
    mean = {K: sum(v) / len(v) for K, v in times.items()}
    for K in FMA_DEPTHS:
        line("13 fma_ms", card=repr(card), K=K, reps=FMA_REPS,
             ms=",".join(f"{t:.5f}" for t in times[K]),
             host_us_per_launch=",".join(f"{u:.1f}" for u in host[K]),
             tflops=f"{fc.flops(n, K) / mean[K] / 1e9:.2f}",
             bound_ms=f"{bound(8 * n, fc.flops(n, K))[0]:.5f}")
    ceiling = {}
    for lo, hi in (FMA_DEPTHS[:2], FMA_DEPTHS[2:]):
        ceiling[(lo, hi)] = (fc.flops(n, hi) - fc.flops(n, lo)) \
            / (mean[hi] - mean[lo]) / 1e9
        line("13 ceiling", card=repr(card), depths=f"{lo}->{hi}",
             tflops=f"{ceiling[(lo, hi)]:.2f}",
             share_of_67=f"{ceiling[(lo, hi)] / (F32_OPS_S / 1e12):.3f}")
    top = ceiling[FMA_DEPTHS[2:]]
    for name, (ops, t) in k1.items():
        rate = ops / t / 1e9
        line("13 k1_vs_ceiling", card=repr(card), variant=name,
             ops_per_chunk=ops, k1_ms=f"{t:.3f}", tops=f"{rate:.2f}",
             share_of_ceiling=f"{rate / top:.3f}",
             share_of_67=f"{rate / (F32_OPS_S / 1e12):.3f}")
    K = FMA_DEPTHS[1]       # the kernels line's: the reference's deeper K
    plain = time_ms(lambda: fc.plain_fma_chain(x, K), 2)
    # the library call: with acc_0 = a the chain is a * sum_{i<=K} M^i, one
    # multiply by a constant (summed in float64, rounded once); the probe
    # loses to it by design, since it exists to issue K dependent FFMAs
    c = float(np.float32(sum(fc.M ** i for i in range(K + 1))))
    lib = x * c
    ref = fc.plain_fma_chain(x, K)
    rel = ((lib.double() - ref.double()).abs() / ref.double().abs()).max() \
        .item()
    assert rel <= fc.tolerance(K), ("x * c", K, rel)
    library = time_ms(lambda: x * c, FMA_REPS)
    line("13 library", card=repr(card), call="x * c", K=K, c=repr(c),
         max_rel_err=f"{rel:.3g}", tolerance=f"{fc.tolerance(K):.3g}",
         ms=f"{library:.5f}", k6_ms=f"{mean[K]:.5f}")
    return {"launches": launches, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "ms": mean[K], "plain_ms": plain,
            "library_ms": library, "bound": bound(8 * n, fc.flops(n, K))}


#: phase 14, BASELINE row 5 as benchmarks/latency4k.py:35-80 drives it
LIVE_W, LIVE_H, LIVE_FPS = 3840, 2160, 60.0
LIVE_FRAMES, LIVE_WINDOW, LIVE_TOGGLE = 480, 8, 25
LIVE_CONFIGS = [["saturation"], ["saturation", "vignette"], ["vignette"],
                ["vignette", "brightness_contrast"], ["brightness_contrast"],
                ["saturation", "brightness_contrast"], [], ["negate"]]
#: BASELINE row 5's target: p99 under 16 ms a frame at 4K60
LIVE_P99_MS = 16.0


def live(dev, card):
    """14. the single-frame live path at 4K60: `GeneratorClip("plasma")`
    over `GeneratorClip("colour_bars")` through the eight configurations,
    one `FrameGraph.run` a frame."""
    import numpy as np
    import torch

    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph import FrameGraph, GenSlot, SinkSpec
    from lives_tpu_torch.io.genclip import GeneratorClip

    def clips(w, h, device):
        return (GeneratorClip("plasma", w, h, fps=LIVE_FPS, device=device),
                GeneratorClip("colour_bars", w, h, fps=LIVE_FPS,
                              device=device))

    def graph(names, w, h):
        return FrameGraph([instantiate(n) for n in names],
                          SinkSpec(width=w, height=h), fps=LIVE_FPS)

    fg, bg = clips(LIVE_W, LIVE_H, dev)
    graphs = [graph(names, LIVE_W, LIVE_H) for names in LIVE_CONFIGS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for g in graphs:                                              # warm
        out = g.run([fg, bg], 0.0, 0)
        torch.cuda.synchronize()
        arr = out.planes[0]
        assert arr.dtype == torch.uint8 and arr.device.type == fg.device.type
        assert tuple(arr.shape) == (3, LIVE_H, LIVE_W)

    def pick(i):
        return graphs[(i // LIVE_TOGGLE) % len(graphs)]

    lat = []
    for i in range(LIVE_FRAMES):
        g = pick(i)
        t0 = time.perf_counter()
        g.run([fg, bg], i / LIVE_FPS, i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    p = {q: float(np.percentile(lat, q)) for q in (50, 99)}
    line("14 latency", card=repr(card), size=f"{LIVE_W}x{LIVE_H}",
         frames=LIVE_FRAMES, configs=len(graphs), toggle_every=LIVE_TOGGLE,
         p50_ms=f"{p[50]:.3f}", p99_ms=f"{p[99]:.3f}",
         max_ms=f"{lat.max():.3f}", mean_ms=f"{lat.mean():.3f}",
         target_p99_ms=LIVE_P99_MS, meets_target=p[99] < LIVE_P99_MS)
    win = []
    t_all = t_win = time.perf_counter()
    for i in range(LIVE_FRAMES):
        pick(i).run([fg, bg], i / LIVE_FPS, i)
        if (i + 1) % LIVE_WINDOW == 0:
            torch.cuda.synchronize()
            now = time.perf_counter()
            win.append((now - t_win) / LIVE_WINDOW * 1e3)
            t_win = now
    win = np.asarray(win)
    line("14 windows", card=repr(card), window=LIVE_WINDOW,
         mean_ms=f"{win.mean():.3f}",
         p50_ms=f"{np.percentile(win, 50):.3f}",
         p99_ms=f"{np.percentile(win, 99):.3f}", max_ms=f"{win.max():.3f}",
         frames_per_s=f"{LIVE_FRAMES / (t_win - t_all):.1f}")
    line("14 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # a profiled pass: the device's busy share and its kernels a frame
    from torch.profiler import ProfilerActivity, profile
    n_prof = 2 * LIVE_TOGGLE
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            pick(i).run([fg, bg], i / LIVE_FPS, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top = device_busy(prof)
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    line("14 profiled", card=repr(card), frames=n_prof,
         wall_ms=f"{wall * 1e3:.1f}", device_busy_ms=f"{busy:.1f}",
         idle_share=f"{1 - busy / (wall * 1e3):.3f}",
         kernels_per_frame=f"{kernels / n_prof:.1f}", top=top)

    # checks: the card against the CPU at 1080p; GenSlot against get_frame;
    # a GenSlot around a stateful clip raises
    on = {d: clips(W, H, d) for d in ("cpu", dev)}
    for names in (["saturation", "vignette"], ["negate"]):
        got = graph(names, W, H).run(list(on[dev]), 0.0, 0).planes[0]
        ref = graph(names, W, H).run(list(on["cpu"]), 0.0, 0).planes[0]
        worst, share = diff_stats(got.cpu(), ref)
        line("14 card_vs_cpu", chain="+".join(names), size=f"{W}x{H}",
             frame=0, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= 1, (names, worst)
    g = graphs[1]
    n = 1234
    slot = g.run([GenSlot(fg, n), bg], 0.5, 30).planes[0]
    pulled = g.run([fg.get_frame(n), bg], 0.5, 30).planes[0]
    assert torch.equal(slot, pulled), "GenSlot differs from get_frame"
    line("14 genslot", n=n, bit_for_bit=True)
    rings = GeneratorClip("beat_rings", LIVE_W, LIVE_H, fps=LIVE_FPS,
                          device=dev)
    try:
        g.run([GenSlot(rings, 0), bg])
    except ValueError:
        line("14 genslot_stateful", raises="ValueError")
    else:
        raise AssertionError("a GenSlot around beat_rings must raise")

    # the unpacked path: traced values that are tensors on the card (the
    # chain's and plasma's) copied into the column there, bit for bit the
    # host numbers' frame; neither path makes a synchronizing call
    from lives_tpu_torch.effects.host import split_params
    cf, cb = clips(LIVE_W, LIVE_H, dev)
    g = graph(LIVE_CONFIGS[1], LIVE_W, LIVE_H)
    g.run([cf, cb], 0.0, 0)
    torch.cuda.synchronize()
    host, host_syncs = synced_calls(
        lambda: g.run([cf, cb], 0.5, 30).planes[0])
    for inst in (*g.chain, cf.inst):
        for k, v in split_params(inst)[1].items():
            inst.values[k] = torch.tensor(float(v), device=dev)
    got, dev_syncs = synced_calls(lambda: g.run([cf, cb], 0.5, 30).planes[0])
    _, control = synced_calls(lambda: got.sum().item())   # one sync, seen
    line("14 unpacked", chain="+".join(LIVE_CONFIGS[1]), keys=len(g.stats),
         bit_for_bit=bool(torch.equal(got, host)),
         syncs_packed=len(host_syncs), syncs_unpacked=len(dev_syncs),
         syncs_of_an_item_call=len(control))
    assert len(g.stats) == 2 and torch.equal(got, host)
    assert control and not host_syncs and not dev_syncs, \
        (control, host_syncs, dev_syncs)
    return p


def synced_calls(fn):
    """(fn's result, the synchronizing CUDA calls it made, as the warnings
    of torch's sync debug mode)."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def render_events_of(el, src, sink):
    """The main path's chunks through the user's entry point."""
    from lives_tpu_torch.events.renderer import render_events
    return render_events(el, src, sink, batch_size=CHUNK)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from lives_tpu_torch import native
    from lives_tpu_torch.events.event_list import EventList
    from lives_tpu_torch.events.renderer import (render_events,
                                                 render_to_arrays)
    from lives_tpu_torch.graph import (SinkSpec, composite, fused_sweep,
                                       stateful_sweep)
    from lives_tpu_torch.effects.host import FILTER_STATEFUL
    from lives_tpu_torch.ops import fma_chain, yuv_kernels
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)

    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    line("1 device", torch=torch.__version__, cuda=torch.version.cuda,
         name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())
    if argv == ["--config-d"]:
        config_d_alone(dev, card)
        return 0
    if argv == ["--colour"]:
        colour_alone(dev, card)
        return 0
    if argv == ["--roofline"]:
        roofline(dev, card)
        return 0
    if argv == ["--live"]:
        live(dev, card)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    # 2. build the five libraries, one nvcc each, started together
    t0 = time.perf_counter()
    native.load_all(["fused_sweep", "stateful_sweep", "yuv420", "composite",
                     "fma_chain"])
    wall = time.perf_counter() - t0
    ptxas = {}
    for mod in (fused_sweep, stateful_sweep, yuv_kernels, composite,
                fma_chain):
        built = mod.build()
        line("2 build", lib=built.path.name,
             seconds=f"{built.seconds:.2f}")
        for entry, res in ptxas_entries(built.log).items():
            ptxas[entry] = res
            line("2 ptxas", lib=built.path.name.split("-")[0], entry=entry,
                 **res)
    line("2 build", wall_s=f"{wall:.2f}")
    resources = {}  # kernel -> its main-path entry's ptxas and blocks an SM

    err = dict.fromkeys(NAMES, 0.0)
    # the library call's ms where one PyTorch call computes the same
    # function, and keys a kernel's entry of the kernels line adds
    library = dict.fromkeys(NAMES)
    extra = {name: {} for name in NAMES}
    bounds = {}
    px = CHUNK * H * W  # pixels of a timed 96-frame chunk

    def held(name, what, got, ref, tol, **kw):
        worst, share = diff_stats(got, ref)
        line(what, **kw, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= tol, f"{what} {kw}: max |diff| {worst} > {tol}"
        err[name] = max(err[name], worst)

    # 3. kernel vs plain_sweep on the card
    for w, h, tracks in ((W, H, TRACKS), (1000, 562, 3)):
        el = multitrack_timeline(n_tracks=tracks, n_frames=N_FRAMES,
                                 width=w, height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(el, dev, 4)
        plan = sweep_plan(el, spec, rows, dev, tracks)
        got = fused_sweep.fused_sweep(plan, ids, packed)
        torch.cuda.synchronize()
        held("fused_sweep", "3 kernel_vs_plain", got,
             fused_sweep.plain_sweep(plan, ids, packed), 1,
             size=f"{w}x{h}", tracks=tracks, frames=ids.shape[2])

    # 4. the card against the JAX golden
    g = np.load(ROOT / "tests" / "fixtures" / "render_golden.npz")
    gold = g["frames"]
    gel = EventList.from_json(str(g["timeline"]))
    before = fused_sweep.LAUNCHES
    out, _ = render_to_arrays(gel, DeviceSyntheticSource(
        gold.shape[2], gold.shape[3], device=dev),
        SinkSpec(gold.shape[3], gold.shape[2]),
        batch_size=int(g["batch_size"]))
    assert fused_sweep.LAUNCHES > before, "golden render missed the kernel"
    held("fused_sweep", "4 golden", torch.from_numpy(out),
         torch.from_numpy(gold), 1, frames=out.shape[0],
         launches=fused_sweep.LAUNCHES - before)

    class Materialised:
        """A source without its LOAD step: run_batch gets layers and takes
        the plain route."""

        def __init__(self, src):
            self.get_batch = src.get_batch

    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)

    # 5. the main path through the user's entry points
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=N_FRAMES, width=W,
                             height=H, fps=FPS)
    rendered, head, counts, first_s = render_path(el, src, sink)
    line("5 main_path", frames=rendered, chunks=n_chunks, launches=counts,
         first_pass_s=f"{first_s:.3f}")
    assert rendered == N_FRAMES
    assert counts == {"u8": n_chunks}, counts
    launches = {"fused_sweep": counts["u8"]}
    _, plain_head = next(iter(render_events(el, Materialised(src), sink,
                                            batch_size=4)))
    held("fused_sweep", "5 main_vs_plain_route", head, plain_head.planes[0],
         1, frames=4)
    rendered, _, _, wall_s = render_path(el, src, sink, check=False)
    line("5 timed", card=repr(card), frames=rendered, wall_s=f"{wall_s:.4f}",
         frames_per_s=f"{rendered / wall_s:.1f}",
         x_realtime=f"{rendered / wall_s / FPS:.2f}")
    main_el = el
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    plan = sweep_plan(el, spec, rows, dev, TRACKS)
    torch.cuda.reset_peak_memory_stats()
    ms = {}
    ms["fused_sweep"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed),
        lambda: fused_sweep._launch(plan, ids, packed, None))
    # the u8 write; the op table's float work with the sink quantise
    bounds["fused_sweep"] = bound(px * 3, px * (table_flops(plan.ops) + 15))
    line("5 chunk_ms", card=repr(card), frames=CHUNK,
         times=ms["fused_sweep"][2],
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    main_geometry(plan, ids, packed, card)
    geom = fused_sweep.plan_geometry(plan, CHUNK)
    resources["fused_sweep"] = (f"fused_sweep_kernelILi{geom.run}E",
                                fused_sweep.blocks_per_sm(geom))
    blur_geometry(el, ids, card)
    # what the halo costs: the chain without its blur (R = 0), in turns
    flat = sweep_plan(el, [s for s in spec if s[0].name not in
                           fused_sweep.STENCILS], rows, dev, TRACKS)
    times = {id(plan): [], id(flat): []}
    for p in (plan, flat, flat, plan):
        times[id(p)].append(time_ms(
            lambda: fused_sweep._launch(p, ids, packed, None), 5))
    full, r0 = times[id(plan)], times[id(flat)]
    line("5 no_blur", card=repr(card), frames=CHUNK,
         r0_ms=",".join(f"{x:.3f}" for x in r0),
         full_ms=",".join(f"{x:.3f}" for x in full),
         r0_over_full=f"{sum(r0) / sum(full):.3f}",
         r0_bound_ms=f"{bound(px * 3, px * (table_flops(flat.ops) + 15))[0]:.4f}",
         r0_tile=fused_sweep.plan_geometry(flat, CHUNK).tile_h)
    del flat
    # the main path under the profiler: device busy and idle share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, prof_wall = render_path(el, src, sink, check=False)
    busy, top = device_busy(prof)
    line("5 profiled", card=repr(card), wall_ms=f"{prof_wall * 1e3:.1f}",
         device_busy_ms=f"{busy:.1f}",
         idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}", top=top)

    # 6. the comp modes vs their plain versions
    gen = torch.Generator(device=dev).manual_seed(6)
    for w, h in ((W, H), (1000, 562)):
        for name, tracks, cut in (("main", TRACKS, 13), ("B", 4, 2)):
            tel = (multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                       height=h, fps=FPS) if name == "main"
                   else timeline(name, 8, w, h))
            spec, ids, packed, rows = chunk_of(tel, dev, 4)
            plan = sweep_plan(tel, spec[:cut], rows, dev, tracks,
                              emit="comp")
            got = fused_sweep.fused_sweep(plan, ids, packed)
            torch.cuda.synchronize()
            held("fused_sweep_comp_out", "6 comp_out_vs_plain", got,
                 fused_sweep.plain_sweep(plan, ids, packed), 1 / 255,
                 chain=f"{name}[:{cut}]", size=f"{w}x{h}", frames=4)
        tel = timeline("A", 8, w, h)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        plan = sweep_plan(tel, spec[2:], rows, dev, 10, consume="comp",
                          idx_base=2)
        comp = torch.rand((4, 3, h, w), generator=gen, device=dev)
        got = fused_sweep.fused_sweep(plan, ids, packed, comp)
        torch.cuda.synchronize()
        held("fused_sweep_comp_in", "6 comp_in_vs_plain", got,
             fused_sweep.plain_sweep(plan, ids, packed, comp), 1,
             chain="A[2:]", size=f"{w}x{h}", frames=4)

    # 7. the fused stateful sweep vs its plain version, two chunks
    for name in ("C", "life_blur", "blur_fire", "r33"):
        tel = timeline(name, 8)
        spec, _, _, rows = chunk_of(tel, dev, 4)
        plan = stateful_sweep.build_stateful_sweep(
            spec, CONFIGS[name][0], H, W, rows, FPS, src, sink, dev)
        assert plan is not None, f"{name} must qualify for the kernel"
        geom = stateful_sweep.plan_geometry(plan, 4)
        line("7 geometry", chain=name, halo=plan.halo,
             tile=f"{geom.tile_h}x{geom.tile_w}", run=geom.run,
             smem=geom.smem, blocks_per_sm=stateful_sweep.blocks_per_sm(geom))
        st_k = [f.init_state(W, H, None, dev) if f.init_state else None
                for f, *_ in spec]
        st_p = list(st_k)
        for k in range(2):
            _, ids, packed, _ = chunk_of(tel, dev, 4, k)
            got, st_k = stateful_sweep.stateful_sweep(plan, ids, packed,
                                                      st_k)
            torch.cuda.synchronize()
            ref, st_p = stateful_sweep.plain_stateful_sweep(plan, ids,
                                                            packed, st_p)
            held("stateful_sweep", "7 stateful_vs_plain", got, ref, 1,
                 chain=name, chunk=k, frames=4)
        for i, step, kind in plan.state_steps:
            worst, _ = diff_stats(st_k[i], st_p[i])
            line("7 state", chain=name, step=step, kind=kind,
                 max_abs_err=f"{worst:.3g}")
            assert worst <= (1e-5 if kind != "u8hw" else 0), (name, worst)

    # 8. configs A, B and C through render_events
    want = {"A": {"comp_in": n_chunks}, "B": {"comp_out": n_chunks},
            "C": {"comp_in": n_chunks}, "C+sf": {"stateful": n_chunks}}
    rates = {}
    for path, kinds in want.items():
        os.environ["LIVES_TPU_FUSED_STATEFUL"] = "1" if "sf" in path else "0"
        tel = timeline(path[0], N_FRAMES)
        rendered, head, counts, first_s = render_path(tel, src, sink)
        line("8 path", config=path, frames=rendered, launches=counts,
             first_pass_s=f"{first_s:.3f}")
        assert rendered == N_FRAMES and counts == kinds, (path, counts)
        for k, v in counts.items():
            launches.setdefault(KERNEL_OF[k], v)
        _, plain_head = next(iter(render_events(tel, Materialised(src), sink,
                                                batch_size=4)))
        held(KERNEL_OF[next(iter(kinds))], "8 path_vs_plain_route", head,
             plain_head.planes[0], 1, config=path, frames=4)
        rendered, _, _, wall_s = render_path(tel, src, sink, check=False)
        rates[path] = rendered / wall_s
        line("8 timed", card=repr(card), config=path, frames=rendered,
             wall_s=f"{wall_s:.4f}", frames_per_s=f"{rates[path]:.1f}",
             x_realtime=f"{rates[path] / FPS:.2f}")
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"

    # kernel vs plain ms on one 96-frame chunk for each new kernel
    torch.cuda.reset_peak_memory_stats()
    spec, ids, packed, rows = chunk_of(timeline("B", CHUNK), dev, CHUNK)
    plan = sweep_plan(timeline("B", 1), spec[:2], rows, dev, 4,
                      emit="comp")
    ms["fused_sweep_comp_out"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed),
        lambda: fused_sweep._launch(plan, ids, packed, None))
    bounds["fused_sweep_comp_out"] = bound(px * 12,
                                           px * table_flops(plan.ops))
    spec, ids, packed, rows = chunk_of(timeline("A", CHUNK), dev, CHUNK)
    plan = sweep_plan(timeline("A", 1), spec[2:], rows, dev, 10,
                      consume="comp", idx_base=2)
    comp = torch.rand((CHUNK, 3, H, W), generator=gen, device=dev)
    ms["fused_sweep_comp_in"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed, comp),
        lambda: fused_sweep._launch(plan, ids, packed, comp))
    bounds["fused_sweep_comp_in"] = bound(
        px * 15, px * (table_flops(plan.ops) + 15))
    spec, ids, packed, rows = chunk_of(timeline("C", CHUNK), dev, CHUNK)
    plan = stateful_sweep.build_stateful_sweep(spec, 10, H, W, rows, FPS,
                                               src, sink, dev)
    states = [f.init_state(W, H, None, dev) if f.init_state else None
              for f, *_ in spec]
    ms["stateful_sweep"] = in_turns(
        lambda: stateful_sweep.plain_stateful_sweep(plan, ids, packed,
                                                    states),
        lambda: stateful_sweep._launch(plan, ids, packed, states),
        plain_reps=1, kern_reps=3)
    geom = stateful_sweep.plan_geometry(plan, CHUNK)
    per_sm = stateful_sweep.blocks_per_sm(geom)
    resident = stateful_sweep.resident_blocks(geom)
    tiles = geom.grid[0] * geom.grid[1]
    line("8 k5_geometry", tile=f"{geom.tile_h}x{geom.tile_w}", run=geom.run,
         margin=geom.margin, smem=geom.smem, blocks_per_sm=per_sm,
         tiles_per_frame=tiles, grid=min(resident, tiles),
         rounds=fused_sweep.stateful_rounds(geom, resident))
    resources["stateful_sweep"] = (f"stateful_sweep_kernelILi{geom.run}E",
                                   per_sm)
    for tile in fused_sweep.TILES:
        for run in (8, 4):
            try:
                g = stateful_sweep.plan_geometry(plan, CHUNK, tile, run)
            except ValueError:  # over a block's shared memory
                continue
            got = [time_ms(lambda: stateful_sweep._launch(
                plan, ids, packed, states, g), 2) for _ in range(2)]
            cost = fused_sweep.stateful_cost(
                g, plan.halo, stateful_sweep.resident_blocks(g))
            line("8 k5_geometry_ms", card=repr(card),
                 tile=f"{tile[0]}x{tile[1]}", run=run,
                 blocks_per_sm=stateful_sweep.blocks_per_sm(g),
                 model_cost=f"{cost:.0f}",
                 ms=",".join(f"{x:.3f}" for x in got))
    # where K5's time goes: config C's chain with steps disabled, at the
    # launch's own geometry (K1 comp-in runs its 11-op tail alone)
    for keep in (("fire", "alien_overlay"), ("fire",), ("alien_overlay",),
                 ("fire", "alien_overlay", "tail"), ("fire", "tail"),
                 ("alien_overlay", "tail")):
        sub = [(f, st_, i_, o_, en and (f.name in keep or (
            "tail" in keep and not f.flags & FILTER_STATEFUL)))
               for f, st_, i_, o_, en in spec]
        sp_ = stateful_sweep.build_stateful_sweep(sub, 10, H, W, rows, FPS,
                                                  src, sink, dev)
        got = time_ms(lambda: stateful_sweep._launch(sp_, ids, packed,
                                                     states), 3)
        line("8 k5_by_steps", card=repr(card), steps="+".join(keep),
             ops=sp_.ops.shape[0], halo=sp_.halo, ms=f"{got:.3f}")
    # the u8 write, and each state plane read and written once a frame
    state_bytes = {"f32hw": 4, "u8hw": 1, "f32chw": 12}
    bounds["stateful_sweep"] = bound(
        px * (3 + sum(2 * state_bytes[k] for *_, k in plan.state_steps)),
        px * (table_flops(plan.ops) + 15))
    for name in ("fused_sweep_comp_out", "fused_sweep_comp_in",
                 "stateful_sweep"):
        line("8 chunk_ms", card=repr(card), kernel=name, frames=CHUNK,
             times=ms[name][2])
    line("8 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")

    # 9. the colour kernels vs their plain versions on the card
    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def flat(t):
        return t.reshape(-1)

    # rows of 1000, 1004, 1002 and 994 bytes: accesses of 8, 4 and 1 bytes
    for b, h, w in ((4, H, W), (2, 562, 1000), (2, 36, 1004), (2, 34, 1002),
                    (2, 20, 994)):
        k2, k3 = [], []
        for clamping in (0, 1):
            for subspace in (1, 2):
                y, u, v = rand(b, h, w), rand(b, h // 2, w // 2), \
                    rand(b, h // 2, w // 2)
                got = yuv_kernels.yuv420_to_rgb(y, u, v, subspace, clamping)
                torch.cuda.synchronize()
                k2.append((flat(got), flat(yuv_kernels.plain_yuv420_to_rgb(
                    y, u, v, subspace, clamping))))
                # RGB, RGBA, and RGBA with an odd height and width
                for c, hh, ww in ((3, h, w), (4, h, w), (4, h + 1, w + 1)):
                    rgb = rand(b, c, hh, ww)
                    got = yuv_kernels.rgb_to_yuv420(rgb, subspace, clamping)
                    torch.cuda.synchronize()
                    ref = yuv_kernels.plain_rgb_to_yuv420(rgb, subspace,
                                                          clamping)
                    k3.append((torch.cat([flat(p) for p in got]),
                               torch.cat([flat(p) for p in ref])))
        case = dict(size=f"{w}x{h}", frames=b)
        held("yuv420_to_rgb", "9 k2_vs_plain", torch.cat([g for g, _ in k2]),
             torch.cat([r for _, r in k2]), 1, cases=len(k2), **case)
        held("rgb_to_yuv420", "9 k3_vs_plain", torch.cat([g for g, _ in k3]),
             torch.cat([r for _, r in k3]), 0, cases=len(k3),
             channels="3,4,4 (odd +1)", **case)
    del k2, k3
    # planes that are views at byte offsets 1-3 of one buffer: one packed
    # YUV420P upload for K2, one RGBA chunk for K3
    b, fs = 4, H * W * 3 // 2
    for off in (1, 2, 3):
        buf = rand(b * fs + 16)[off:off + b * fs].view(b, fs)
        y = buf[:, :H * W].view(b, H, W)
        u = buf[:, H * W:H * W + fs // 6].view(b, H // 2, W // 2)
        v = buf[:, H * W + fs // 6:].view(b, H // 2, W // 2)
        got = yuv_kernels.yuv420_to_rgb(y, u, v)
        torch.cuda.synchronize()
        held("yuv420_to_rgb", "9 k2_vs_plain", got,
             yuv_kernels.plain_yuv420_to_rgb(y.contiguous(), u.contiguous(),
                                             v.contiguous()), 1,
             size=f"{W}x{H}", frames=b, byte_offset=off)
        rgba = rand(b * 4 * H * W + 16)[off:off + b * 4 * H * W].view(
            b, 4, H, W)
        got = yuv_kernels.rgb_to_yuv420(rgba)
        torch.cuda.synchronize()
        held("rgb_to_yuv420", "9 k3_vs_plain",
             torch.cat([flat(p) for p in got]),
             torch.cat([flat(p) for p in yuv_kernels.plain_rgb_to_yuv420(
                 rgba.contiguous())]), 0,
             size=f"{W}x{H}", frames=b, channels=4, byte_offset=off)
    del buf, y, u, v, rgba, got

    # 10. the composite kernel vs plain_composite on the card
    from lives_tpu_torch.graph.nodemodel import composite_prefix
    for w, h, tracks, n_pre in ((W, H, TRACKS, 9), (1000, 562, 4, 3)):
        tel = multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                  height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        assert composite.splittable_prefix(_chain(tel)) == n_pre
        prefix, n_t = composite_prefix(spec[:n_pre], tracks)
        plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
        tsrc = DeviceSyntheticSource(h, w, device=dev)
        trk = [tsrc.traced_layer(ids[0, t], ids[1, t]).planes[0]
               for t in range(n_t)]
        got = composite.composite(plan, trk, packed)
        torch.cuda.synchronize()
        held("composite", "10 k4_vs_plain", got,
             composite.plain_composite(plan, trk, packed), 1,
             prefix=n_pre, tracks=n_t, size=f"{w}x{h}", frames=4)

    # at 45x37 (H*W = 1665, no multiple of 16) on tracks that are views at
    # byte offsets 0-3, a prefix that reads track 1 three times
    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph.nodemodel import (_split_params,
                                                 chain_spec_of, pack_params)
    w, h, b4 = 45, 37, 4
    chain = []
    for name, tr in (("crossfade", (0, 1)), ("blend_screen", (0, 1)),
                     ("chroma_key", (2, 0)), ("luma_key", (1, 2)),
                     ("saturation", (0,))):
        inst = instantiate(name)
        inst.in_tracks = tr
        chain.append(inst)
    rng = np.random.default_rng(10)
    packed4, rows4 = pack_params(
        [{k: rng.uniform(i.filter.param(k).min, i.filter.param(k).max,
                         b4).astype(np.float32) for k in _split_params(i)[1]}
         for i in chain], np.arange(b4) / FPS, np.arange(b4))
    plan = composite.build_composite(chain_spec_of(chain), 3, rows4, FPS, dev)
    packed4 = torch.from_numpy(packed4).to(dev)
    flat = [torch.randint(0, 256, (b4 * 3 * h * w + 3,), dtype=torch.uint8,
                          device=dev, generator=gen) for _ in range(3)]
    for off in range(4):
        trk = [f[off:off + b4 * 3 * h * w].view(b4, 3, h, w) for f in flat]
        got = composite._launch(plan, trk, packed4, b4, h, w)
        torch.cuda.synchronize()
        held("composite", "10 k4_vs_plain", got,
             composite.plain_composite(plan, trk, packed4), 1,
             size=f"{w}x{h}", offset=off, read=len(plan.tracks_read),
             ops=plan.ops.shape[0], frames=b4)
    del flat, trk

    # 11. config D: decoded clips through render_to_encoder
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.ops.colorspace import convert_layer

    def yuv_head(lay):
        """The first 4 frames of an RGB24 layer as host YUV420P planes, as
        the encoder converts them."""
        return [p[:4].cpu() for p in
                convert_layer(lay, Palette.YUV420P).planes]

    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src)
        line("11 clips", clips=TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        el = config_d_timeline(N_FRAMES)
        out_path = os.path.join(tmp, "render.y4m")
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
        counts, first_s, _ = decoded_pass(clips, el, out_path, dev)
        want = {"yuv420_to_rgb": TRACKS * n_chunks, "composite": n_chunks,
                "rgb_to_yuv420": n_chunks}
        line("11 config_d", frames=N_FRAMES, chunks=n_chunks,
             launches=counts, first_pass_s=f"{first_s:.3f}")
        assert counts == want, counts
        launches.update(counts)
        cd = try_decoders(out_path)
        assert (cd.nframes, cd.width, cd.height) == (N_FRAMES, W, H), \
            (cd.nframes, cd.width, cd.height)
        head = [torch.stack([cd.decoder.get_frame(n).planes[i]
                             for n in range(4)]) for i in range(3)]
        cd.decoder.close()
        line("11 reopened", frames=cd.nframes, size=f"{cd.width}x{cd.height}")
        # the first 4 frames of the route as RGB; the file holds them
        _, lay = next(iter(render_events(
            el, ClipFrameSource(clips, device=dev), batch_size=4)))
        for plane, g, r in zip("yuv", head, yuv_head(lay)):
            worst, share = diff_stats(g, r)
            line("11 file_vs_route", plane=plane, frames=4,
                 max_abs_err=f"{worst:.6g}", differing_share=f"{share:.3g}")
            assert worst == 0, ("file", plane, worst)
        rgb = lay.planes[0].cpu()
        # the same route on the plain versions (CPU tensors)
        _, plain_lay = next(iter(render_events(
            el, ClipFrameSource(clips, device="cpu"), batch_size=4)))
        worst, share = diff_stats(rgb, plain_lay.planes[0])
        line("11 head_vs_plain_route", frames=4, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= 1, ("plain route", worst)
        # the route without the pref (the whole chain in float32): on these
        # 4 frames the JAX package's own two routes differ by up to 6 LSB,
        # in 281 values above 2 LSB (tests/test_torch_routes.py); the bound
        # leaves room for the float route's own 1-LSB noise
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"
        _, float_lay = next(iter(render_events(
            el, ClipFrameSource(clips, device=dev), batch_size=4)))
        d = (rgb.int() - float_lay.planes[0].cpu().int()).abs()
        over2 = int((d > 2).sum())
        line("11 head_vs_no_pref_route", frames=4,
             max_abs_err=int(d.max()), over_2_lsb=over2,
             differing_share=f"{float((d > 0).float().mean()):.3g}")
        assert int(d.max()) <= 6 and over2 <= 300, (int(d.max()), over2)
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
        # a warm timed pass, then a profiled one
        counts, wall_s, host_s = decoded_pass(clips, el, out_path, dev)
        assert counts == want, counts
        rates["D"] = N_FRAMES / wall_s
        line("11 timed", card=repr(card), frames=N_FRAMES,
             wall_s=f"{wall_s:.4f}", get_batch_s=f"{host_s:.4f}",
             rest_s=f"{wall_s - host_s:.4f}",
             frames_per_s=f"{rates['D']:.1f}",
             x_realtime=f"{rates['D'] / FPS:.2f}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall, _ = decoded_pass(clips, el, out_path, dev)
        busy, top = device_busy(prof)
        line("11 profiled", card=repr(card), wall_ms=f"{prof_wall * 1e3:.1f}",
             device_busy_ms=f"{busy:.1f}",
             idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}",
             dtoh_copies=dtoh_copies(prof), top=top)
        for c in clips.values():
            c.close()

    # kernel vs plain ms on one 96-frame chunk for K2, K3 and K4; K2 and
    # K3 at each run length, the launch's own (RUN) in the kernels line
    torch.cuda.reset_peak_memory_stats()
    rgb, y, u, v = colour_chunk(dev)
    calls = colour_calls(rgb, y, u, v)
    plain = {"k2": lambda: yuv_kernels.plain_yuv420_to_rgb(y, u, v),
             "k3": lambda: yuv_kernels.plain_rgb_to_yuv420(rgb)}
    for run in yuv_kernels.RUNS:
        for k, name in (("k2", "yuv420_to_rgb"), ("k3", "rgb_to_yuv420")):
            got = in_turns(plain[k], calls[f"{k} run={run}"], kern_reps=20)
            line("11 colour_run", card=repr(card), kernel=name, run=run,
                 frames=CHUNK, times=got[2])
            if run == yuv_kernels.RUN:
                ms[name] = got
    got = [time_ms(calls[f"k3 x{CHUNK}"], 2) for _ in range(2)]
    line("11 k3_per_frame", card=repr(card), launches=CHUNK,
         ms=",".join(f"{x:.4f}" for x in got))
    bounds["yuv420_to_rgb"] = bound(px * 4.5, px * 21)
    bounds["rgb_to_yuv420"] = bound(px * 4.5, px * 30)
    t, rate = copy_ceiling(dev, px * 4.5)
    line("11 copy_ceiling", card=repr(card), bytes=int(px * 4.5),
         ms=f"{t:.4f}", tb_per_s=f"{rate:.3f}")
    for name in ("yuv420_to_rgb", "rgb_to_yuv420"):
        resources[name] = (f"{name}_kernelILi{yuv_kernels.RUN}E",
                           "not queried")
    del rgb, y, u, v, calls, plain
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    prefix, n_t = composite_prefix(spec[:9], TRACKS)
    plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
    trk = [src.traced_layer(ids[0, t], ids[1, t]).planes[0]
           for t in range(n_t)]
    ms["composite"] = in_turns(
        lambda: composite.plain_composite(plan, trk, packed),
        lambda: composite._launch(plan, trk, packed, CHUNK, H, W),
        plain_reps=1, kern_reps=5)
    bounds["composite"] = bound(px * 3 * (n_t + 1),
                                px * table_flops(plan.ops, u8_stages=True))
    geom = composite.plan_geometry(plan, CHUNK, H, W)
    line("11 k4_geometry", span=geom.span,
         tracks_read=len(plan.tracks_read), smem=geom.smem, grid=geom.grid,
         blocks_per_sm=composite.blocks_per_sm(geom))
    resources["composite"] = ("composite_kernel",
                              composite.blocks_per_sm(geom))
    # the same 10 tracks through 9 crossfades: one op body in the loop
    xf = composite.build_composite(
        [(spec[0][0], {"amount": 0.5}, (0, t), (0,), True)
         for t in range(1, 10)], TRACKS, (), FPS, dev)
    assert spec[0][0].name == "crossfade"
    no_rows = torch.zeros((2, CHUNK), device=dev)
    got = time_ms(lambda: composite._launch(xf, trk, no_rows, CHUNK, H, W),
                  5)
    line("11 k4_crossfades", card=repr(card), ops=9, ms=f"{got:.3f}")
    # what bounds K4: its time over the first 1, 3, 5 and 9 transitions
    # (2 to 10 tracks staged) beside the bytes each moves
    for k in (1, 3, 5, 9):
        pre, nk = composite_prefix(spec[:k], TRACKS)
        pk = composite.build_composite(pre, nk, rows, FPS, dev)
        got = time_ms(lambda: composite._launch(pk, trk[:nk], packed, CHUNK,
                                                H, W), 5)
        nb = px * 3 * (len(pk.tracks_read) + 1)
        line("11 k4_by_ops", card=repr(card), ops=k,
             tracks_read=len(pk.tracks_read), ms=f"{got:.3f}",
             bytes_bound_ms=f"{bound(nb, 0)[0]:.3f}",
             tb_per_s=f"{nb / got / 1e9:.2f}")
    for name in ("yuv420_to_rgb", "rgb_to_yuv420", "composite"):
        line("11 chunk_ms", card=repr(card), kernel=name, frames=CHUNK,
             times=ms[name][2],
             bound_ms=f"{bounds[name][0]:.4f} ({bounds[name][1]})")
    line("11 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del trk

    phase12(dev, torch.device("cuda", 0), card, main_el, src, sink, held,
            ms, bounds, launches)

    k6 = roofline(dev, card)
    assert k6["launches"] > 0, "the roofline study missed K6"
    launches["fma_chain"] = k6["launches"]
    err["fma_chain"] = k6["max_abs_err"]
    extra["fma_chain"] = {"max_rel_err": k6["max_rel_err"]}
    library["fma_chain"] = round(k6["library_ms"], 6)
    ms["fma_chain"] = (k6["ms"], k6["plain_ms"])
    bounds["fma_chain"] = k6["bound"]
    resources["fma_chain"] = ("fma_chain_kernel", "not queried")
    live(dev, card)

    for name, (entry, per_sm) in resources.items():
        res = next((v for k, v in ptxas.items() if entry in k),
                   {"ptxas": "not in the build log"})
        line("resources", kernel=name, entry=entry, **res,
             blocks_per_sm=per_sm)
    for name in NAMES:
        line("bound", kernel=name, ms=f"{ms[name][0]:.4f}",
             bound_ms=f"{bounds[name][0]:.4f}", bound_by=bounds[name][1])
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": err[name], "ms": round(ms[name][0], 6),
        "plain_ms": round(ms[name][1], 6),
        "bound_ms": round(bounds[name][0], 6), "bound_by": bounds[name][1],
        "library_ms": library[name], **extra[name]} for name in NAMES]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
