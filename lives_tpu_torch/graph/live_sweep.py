"""The live sweep K7: its eligibility rule, plan encoding, kernel wrapper and
plain version.

One live frame of `FrameGraph.run` (route (d) of `graph/nodemodel.py`) in a
single launch: when every track is a stateless plasma or colour_bars
generator, every enabled instance of the chain a point op of the sweep's op
table and the sink RGB24 at the tracks' geometry, ONE kernel generates each
track per pixel, runs the chain in float32 and writes the ``(3, H, W)`` u8
sink frame (`csrc/live_sweep.cu`; its note says what bounds it). The JAX
package fuses the same plan by jitting it; the port's eager route runs some
150 elementwise kernels a 4K frame for it.

- `encode_live` is the eligibility rule and the op table, host side, a pure
  function of the chain, the generators, the rows, the sink and the
  geometry; `build_live_sweep` puts its tables on the device as a
  `LivePlan` (the plan cache keeps it), or returns None for a plan the
  kernel does not take, which then runs eagerly.
- `live_sweep(plan, packed)` launches the kernel on PyTorch's current
  stream for a CUDA column, counting it in `LAUNCHES`, and returns a fresh
  u8 frame each call (a caller may hold the previous one). On a CPU column
  it returns `plain_live_sweep`.
- `plain_live_sweep(plan, packed)` is the eager route over the same column:
  each track generated by its filter from the rows the plan names, then
  `run_chain`.
- `build()` compiles the kernel with nvcc on its first launch
  (`native.load`), so a process that never takes the route never builds it.

The packed column is `FrameGraph.run`'s: the chain's traced rows
(`rows_key`), then each generator's traced values (sorted by name), then
each generator's (tc, frame), then the frame's (tc, frame). The op table is
the fused sweep's (`fused_sweep.encode_point`): its whole point vocabulary,
`_POINT_OPS`; a stencil, a stateful instance or anything else keeps the
frame on the eager route.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import Gamma, Palette
from ..effects.host import FILTER_STATEFUL, FrameContext, split_params
from ..utils.transfer import upload
from . import fused_sweep

#: launches of the live sweep since the count was last set to 0
LAUNCHES = 0

#: the generators the kernel makes: name -> kind (csrc/live_sweep.cu GenKind)
GENERATORS = {"plasma": 0, "colour_bars": 1}
#: a track's row of the generator table: kind, tc row, then the packed rows
#: of the generator's parameters in this order (-1: none)
GEN_PARAMS = ("speed", "scale")
GEN_FIELDS = 2 + len(GEN_PARAMS)
# limits: keep in step with csrc/live_sweep.cu
MAX_TRACKS = 16
MAX_OPS = fused_sweep.MAX_SLOTS
#: threads a block (a thread computes a run of 4 adjacent pixels,
#: csrc/live_sweep.cu RUN; PERF.md, K7)
THREADS = 256


@dataclass(frozen=True, eq=False)
class LivePlan:
    """One live frame's plan encoded for the kernel, resident on
    `ops.device`."""
    chain_spec: tuple
    gens: tuple              # each track's generator Instance
    rows_key: tuple
    sink: object
    height: int
    width: int
    n_rows: int              # rows of the packed column
    fps: float
    gen_rows: tuple          # each track's generator table row, host side
    #: float32 of 2 / max(n - 1, 1) for W and H (the centred grid of
    #: `effects.util._normalise`), then of 1 / max(n - 1, 1) (`_grid`)
    scales: tuple
    ops: torch.Tensor        # (n_ops, OP_FIELDS) int32
    slot_rows: torch.Tensor  # (n_slots,) int32 packed row, -1 = constant
    slot_vals: torch.Tensor  # (n_slots, 3) f32: constant, min, max
    consts: torch.Tensor     # (n_consts,) f32: the point ops' constants
    gen_table: torch.Tensor  # (T, GEN_FIELDS) int32


def encode_live(chain_spec, gens, rows_key, sink, H: int, W: int):
    """The eligibility rule and the tables, host side: (ops, slot_rows,
    slot_vals, consts, gen_table, n_rows) numpy arrays and the column's row
    count, or None when a track, the chain or the sink is outside the
    kernel's contract. `gens`: each track's generator clip in slot order
    (an object with `inst`, `width` and `height`); every track is one."""
    T = len(gens)
    if not 1 <= T <= MAX_TRACKS:
        return None
    for clip in gens:
        filt = clip.inst.filter
        if filt.name not in GENERATORS or filt.flags & FILTER_STATEFUL:
            return None
        if (clip.height, clip.width) != (H, W):
            return None
    # the kernel writes quantised RGB24 at the tracks' geometry, with no
    # sink convert step; generated layers are SRGB-tagged
    if sink.palette != Palette.RGB24 or sink.letterbox \
            or sink.gamma != Gamma.SRGB:
        return None
    if sink.width not in (0, W) or sink.height not in (0, H):
        return None
    if any(filt.flags & FILTER_STATEFUL for filt, *_ in chain_spec):
        return None
    # the generators' rows, then their (tc, frame) pairs, then the frame's
    r = len(rows_key)
    gen_rows = []
    for clip in gens:
        names = sorted(split_params(clip.inst)[1])
        gen_rows.append({k: r + i for i, k in enumerate(names)})
        r += len(names)
    n_rows = r + 2 * T + 2
    table = []
    for g, (clip, rows) in enumerate(zip(gens, gen_rows)):
        kind = GENERATORS[clip.inst.filter.name]
        table.append((kind, r + 2 * g)
                     + tuple(rows.get(k, -1) for k in GEN_PARAMS))
    row_of = {k: i for i, k in enumerate(rows_key)}
    ops, slot_rows, slot_vals, consts = [], [], [], []
    for idx, (filt, static, in_tr, out_tr, enabled) in enumerate(chain_spec):
        if not enabled:
            continue
        if filt.name not in fused_sweep._POINT_OPS or tuple(out_tr) != (0,):
            return None
        used = tuple(in_tr[: filt.n_in])
        if len(used) != filt.n_in or max(used) >= T:
            return None
        # rand_replace's frame number is the column's last row
        ops.append(fused_sweep.encode_point(
            filt, static, used, idx, row_of, n_rows - 2, slot_rows,
            slot_vals, consts, H, W))
    if len(ops) > MAX_OPS or len(slot_rows) > fused_sweep.MAX_SLOTS:
        return None
    return (np.asarray(ops, np.int32).reshape(-1, fused_sweep.OP_FIELDS),
            np.asarray(slot_rows, np.int32),
            np.asarray(slot_vals, np.float32).reshape(-1, 3),
            np.asarray(consts, np.float32),
            np.asarray(table, np.int32).reshape(-1, GEN_FIELDS), n_rows)


def build_live_sweep(chain_spec, gens, rows_key, sink, H: int, W: int,
                     device: torch.device | str, *,
                     fps: float = 25.0) -> LivePlan | None:
    """Encode one live frame's plan for the kernel on `device`, or None
    when it does not qualify (`encode_live`). `chain_spec`: (filter, static
    values, in_tracks, out_tracks, enabled) tuples; `gens`: each track's
    generator clip; `rows_key`: the (instance, param) of each of the
    chain's packed rows; `fps`: the graph's, which the plain version's
    context carries."""
    enc = encode_live(chain_spec, gens, rows_key, sink, H, W)
    if enc is None:
        return None
    ops, slot_rows, slot_vals, consts, table, n_rows = enc
    dev = torch.device(device)
    return LivePlan(
        chain_spec=tuple(chain_spec), gens=tuple(c.inst for c in gens),
        rows_key=tuple(rows_key), sink=sink, height=H, width=W,
        n_rows=n_rows, fps=fps, gen_rows=tuple(map(tuple, table.tolist())),
        scales=tuple(float(np.float32(num / max(n - 1, 1)))
                     for num in (2.0, 1.0) for n in (W, H)),
        ops=upload(ops, dev), slot_rows=upload(slot_rows, dev),
        slot_vals=upload(slot_vals, dev), consts=upload(consts, dev),
        gen_table=upload(table, dev))


def plain_live_sweep(plan: LivePlan, packed: torch.Tensor) -> torch.Tensor:
    """The eager route over the plan's column: each track generated by its
    filter from the rows the plan's generator table names (its traced
    values, tc and frame), the chain through `run_chain`, the sink step.
    packed (n_rows, 1) f32 -> (3, H, W) u8."""
    from .nodemodel import run_chain
    layers = []
    for inst, row in zip(plan.gens, plan.gen_rows):
        filt = inst.filter
        rows = {k: packed[r] for k, r in zip(GEN_PARAMS, row[2:]) if r >= 0}
        params = {**{p.name: p.default for p in filt.params},
                  **split_params(inst)[0], **rows}
        tc = packed[row[1]]
        ctx = FrameContext(tc=tc, frame=packed[row[1] + 1].to(torch.int32),
                           fps=plan.fps, width=plan.width,
                           height=plan.height, device=packed.device)
        layers.append(filt.process([], params, ctx))
    out = run_chain(plan.chain_spec, layers, packed, plan.rows_key, plan.fps,
                    plan.sink)
    return out.planes[0][0]


@functools.lru_cache(maxsize=None)
def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("live_sweep")
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every pointer and the stream as c_void_p: ctypes would pass a bare
    # Python int as a 32-bit int and cut it
    lib.lives_live_sweep.argtypes = [p, p, i, p, p, i, p, p, i, p, i, i,
                                     f, f, f, f, i, p]
    lib.lives_live_sweep.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def live_sweep(plan: LivePlan, packed: torch.Tensor, *,
               threads: int = THREADS) -> torch.Tensor:
    """One live frame of `plan` from its packed (n_rows, 1) float32 column:
    a fresh (3, H, W) u8 tensor. The kernel for a CUDA column, on the
    current stream (`threads` overrides the block size, for
    measurements); the plain version for a CPU one."""
    global LAUNCHES
    if packed.device.type == "cpu":
        return plain_live_sweep(plan, packed)
    if packed.device.type != "cuda":
        raise ValueError(f"live_sweep: no kernel for {packed.device}")
    dev = plan.ops.device
    if packed.dtype != torch.float32 or packed.shape != (plan.n_rows, 1) \
            or packed.device != dev:
        raise ValueError(f"live_sweep: packed {tuple(packed.shape)} "
                         f"{packed.dtype} on {packed.device}, want "
                         f"({plan.n_rows}, 1) float32 on {dev}")
    packed = packed.contiguous()
    H, W = plan.height, plan.width
    out = torch.empty((3, H, W), dtype=torch.uint8, device=dev)
    lib = build().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lives_live_sweep(
            packed.data_ptr(), plan.ops.data_ptr(), plan.ops.shape[0],
            plan.slot_rows.data_ptr(), plan.slot_vals.data_ptr(),
            plan.slot_rows.shape[0], plan.consts.data_ptr(),
            plan.gen_table.data_ptr(), plan.gen_table.shape[0],
            out.data_ptr(), H, W, *plan.scales, threads, stream)
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"live_sweep launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return out
