"""The composite kernel K4: its eligibility rule, plan, wrapper and plain
version.

Counterpart of `lives_tpu/graph/pallas_composite.py:51-180` (`PALLAS_SAFE`,
`splittable_prefix`, `supported`, `build_composite`): for decoded tracks,
u8 layers in device memory, the leading run of coordinate-free point
effects of a chain (its "prefix") runs as ONE kernel per frame chunk that
reads each track once and writes the u8 comp once. The kernel is CUDA C++
for the H100 (`csrc/composite.cu`); its note says what bounds it.
`nodemodel.FrameGraph.run_batch` takes this route for layers under
`pref("pallas_composite") == "1"` (default "0", as in the JAX package).

- `splittable_prefix(chain)` and `supported(h, w)` decide eligibility
  before any launch. `supported` carries no Mosaic tile rule (the JAX
  version needs w % 128 == 0 and h % 8 == 0 and a TPU backend): the kernel
  masks the ragged end of a frame.
- `build_composite(prefix, n_tracks, rows_key, fps, device)` encodes the
  prefix once into an op table on the device (the point-op rows of the
  fused sweep's encoding, `fused_sweep.encode_point`), a `CompositePlan`,
  or returns None for a prefix outside the kernel's vocabulary, which is
  PALLAS_SAFE, as the JAX kernel's is.
- `composite(plan, tracks, packed)` launches the kernel on CUDA tensors,
  counting it in `LAUNCHES`, and returns `plain_composite` on CPU tensors;
  any other device raises. The kernel stages every byte it reads in shared
  memory first: `tracks_read` (each distinct track the prefix reads, track
  0 first) and `composite_geometry` (the span of pixels a block owns,
  within a staging budget) size that.
- `plain_composite(plan, tracks, packed)` is `run_chain` over the prefix
  with `float_chain=False`: each filter's process on u8 layers, u8 after
  every stage, as the JAX kernel traces them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..constants import Palette
from ..layer import Layer
from . import fused_sweep

#: launches of the composite kernel since the count was last set to 0
LAUNCHES = 0

MAX_TRACKS = 64  # keep in step with csrc/composite.cu
#: spans of pixels a block may own, largest first (multiples of 16 and of
#: the kernel's run of 4 pixels a thread)
SPANS = (4096, 2048, 1024, 512, 256)
#: the most bytes a block stages: with the largest op table (MAX_SLOTS
#: records of OP_REC_BYTES), the static shared memory (the parameter slots
#: and the segment offsets) and the system's reserve, two blocks fit an SM
STAGE_BUDGET = (fused_sweep.SM_SMEM // 2 - fused_sweep.BLOCK_RESERVED
                - 4 * fused_sweep.MAX_SLOTS - 4 * 3 * MAX_TRACKS
                - fused_sweep.OP_REC_BYTES * fused_sweep.MAX_SLOTS)

#: coordinate-free, reduction-free, gather-free per-pixel filters
#: (`pallas_composite.py:51`), the fused sweep's definition
PALLAS_SAFE = fused_sweep.PALLAS_SAFE

#: the kernel's vocabulary: PALLAS_SAFE, as `build_composite` of the JAX
#: package takes it (`pallas_composite.py:74,120-170`); the coordinate ops
#: of the fused sweep stay out, as they do there
VOCABULARY = PALLAS_SAFE


def splittable_prefix(chain) -> int:
    """Length of the leading run of chain instances the kernel can fuse:
    enabled PALLAS_SAFE filters writing to track 0 (disabled instances pass
    through) (`pallas_composite.py:65`)."""
    n = 0
    for inst in chain:
        if not inst.enabled:
            n += 1
            continue
        if inst.filter.name in PALLAS_SAFE and tuple(inst.out_tracks) == (0,):
            n += 1
            continue
        break
    return n


def supported(h: int, w: int) -> bool:
    """Any frame geometry: the kernel masks ragged tiles."""
    return h >= 1 and w >= 1


@dataclass(frozen=True, eq=False)
class CompositePlan:
    """A prefix encoded for the kernel, resident on `ops.device`."""
    prefix: tuple            # chain_spec tuples, tracks clamped
    n_tracks: int
    rows_key: tuple
    fps: float
    ops: torch.Tensor        # (n_ops, OP_FIELDS) int32
    slot_rows: torch.Tensor  # (n_slots,) int32 packed row, -1 = constant
    slot_vals: torch.Tensor  # (n_slots, 3) f32: constant, min, max
    tracks_read: tuple = (0,)  # the tracks the kernel stages, track 0 first


def build_composite(prefix: Sequence[tuple], n_tracks: int, rows_key,
                    fps: float, device: torch.device | str
                    ) -> CompositePlan | None:
    """Encode `prefix` (chain_spec tuples (filter, static, in_tracks,
    out_tracks, enabled) of instances 0.., reading tracks < n_tracks) for
    the kernel on `device`, or None when the kernel does not hold it."""
    if not 1 <= n_tracks <= MAX_TRACKS:
        return None
    row_of = {k: r for r, k in enumerate(rows_key)}
    ops, slot_rows, slot_vals = [], [], []
    for idx, (filt, static, in_tr, out_tr, enabled) in enumerate(prefix):
        if not enabled:
            continue
        used = tuple(in_tr[: filt.n_in])
        if (filt.name not in VOCABULARY or tuple(out_tr) != (0,)
                or len(used) != filt.n_in or max(used) >= n_tracks):
            return None
        ops.append(fused_sweep.encode_point(filt, static, used, idx, row_of,
                                            len(rows_key), slot_rows,
                                            slot_vals, None))
    # the kernel keeps one record an op in shared memory
    if max(len(slot_rows), len(ops)) > fused_sweep.MAX_SLOTS:
        return None
    dev = torch.device(device)
    return CompositePlan(
        prefix=tuple(prefix), n_tracks=n_tracks, rows_key=tuple(rows_key),
        fps=fps, tracks_read=tracks_read(ops),
        ops=torch.from_numpy(np.asarray(ops, np.int32).reshape(
            -1, fused_sweep.OP_FIELDS)).to(dev),
        slot_rows=torch.from_numpy(np.asarray(slot_rows, np.int32)).to(dev),
        slot_vals=torch.from_numpy(np.asarray(
            slot_vals, np.float32).reshape(-1, 3)).to(dev))


def tracks_read(ops) -> tuple:
    """The distinct tracks an op table reads, track 0 first (it is read
    even by an empty prefix), each once however many ops read it."""
    used = {0}
    for _, in0, in1, *_ in ops:
        used.update((int(in0), int(in1)))
    return tuple(sorted(used))


@dataclass(frozen=True)
class CompositeGeometry:
    """One launch of K4 (csrc/composite.cu): `span` pixels of a frame's
    plane a block, the grid (spans, frames) and the dynamic shared memory in
    bytes (the op records and 3 staged planes of span + 16 bytes each track
    read)."""
    span: int
    grid: tuple
    smem: int


def composite_geometry(n_read: int, n_ops: int, plane: int,
                       B: int) -> CompositeGeometry:
    """The launch of a prefix reading `n_read` distinct tracks with `n_ops`
    ops over B frames of `plane` pixels: the largest span of SPANS whose
    staged bytes stay within STAGE_BUDGET."""
    if not 1 <= n_read <= MAX_TRACKS:
        raise ValueError(f"composite_geometry: {n_read} tracks read, the "
                         f"kernel stages 1 to {MAX_TRACKS}")
    span = next(s for s in SPANS if 3 * n_read * (s + 16) <= STAGE_BUDGET)
    return CompositeGeometry(
        span, (-(-plane // span), B),
        fused_sweep.OP_REC_BYTES * n_ops + 3 * n_read * (span + 16))


def _check(plan: CompositePlan, tracks, packed: torch.Tensor):
    """Raise on what the kernel does not take; returns B, H, W."""
    if len(tracks) != plan.n_tracks:
        raise ValueError(f"composite: {len(tracks)} tracks, the plan was "
                         f"built for {plan.n_tracks}")
    shape = tuple(tracks[0].shape)
    if len(shape) != 4 or shape[1] != 3:
        raise ValueError(f"composite: track {shape}, want (B, 3, H, W)")
    for t in tracks:
        if t.dtype != torch.uint8 or tuple(t.shape) != shape:
            raise ValueError("composite: tracks must be u8 of one shape")
    B = shape[0]
    if packed.dtype != torch.float32 or \
            tuple(packed.shape) != (len(plan.rows_key) + 2, B):
        raise ValueError(f"composite: packed {tuple(packed.shape)} "
                         f"{packed.dtype}, want "
                         f"({len(plan.rows_key) + 2}, {B}) float32")
    return shape[0], shape[2], shape[3]


def plain_composite(plan: CompositePlan, tracks, packed: torch.Tensor
                    ) -> torch.Tensor:
    """The kernel's plain PyTorch version: the prefix's process functions
    on u8 layers. tracks: (B,3,H,W) u8 each; packed (P+2,B) f32 ->
    (B,3,H,W) u8."""
    from .nodemodel import SinkSpec, run_chain
    _check(plan, tracks, packed)
    layers = [Layer(planes=(t,), palette=int(Palette.RGB24)) for t in tracks]
    return run_chain(plan.prefix, layers, packed, plan.rows_key, plan.fps,
                     SinkSpec(), float_chain=False).planes[0]


def composite(plan: CompositePlan, tracks, packed: torch.Tensor
              ) -> torch.Tensor:
    """Run the prefix on one chunk: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    B, H, W = _check(plan, tracks, packed)
    kind = packed.device.type
    if kind == "cpu":
        return plain_composite(plan, tracks, packed)
    if kind != "cuda":
        raise ValueError(f"composite: no kernel for {packed.device}")
    return _launch(plan, tracks, packed, B, H, W)


def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("composite")
    lib = built.lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lives_composite.argtypes = [p, p, i, p, i, p, i, p, p, i, p, i, i, i,
                                    i, i, p]
    lib.lives_composite.restype = i
    lib.lives_composite_blocks_per_sm.argtypes = [i, p]
    lib.lives_composite_blocks_per_sm.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def _raise(lib, err: int, what: str):
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"composite {what} failed: CUDA error {err} "
                           f"({msg})")


def plan_geometry(plan: CompositePlan, B: int, H: int,
                  W: int) -> CompositeGeometry:
    """The geometry of a launch of `plan` over B frames of H x W."""
    return composite_geometry(len(plan.tracks_read), plan.ops.shape[0],
                              H * W, B)


def blocks_per_sm(geom: CompositeGeometry) -> int:
    """Blocks of a launch at `geom` one SM of the current card holds (the
    CUDA occupancy query)."""
    lib = build().lib
    n = ctypes.c_int(0)
    _raise(lib, lib.lives_composite_blocks_per_sm(geom.smem, ctypes.byref(n)),
           "occupancy query")
    return n.value


def _launch(plan: CompositePlan, tracks, packed, B: int, H: int, W: int):
    global LAUNCHES
    dev = plan.ops.device
    if packed.device != dev or any(t.device != dev for t in tracks):
        raise ValueError(f"composite: tensors must be on {dev}")
    tracks = [t.contiguous() for t in tracks]
    packed = packed.contiguous()
    out = torch.empty((B, 3, H, W), dtype=torch.uint8, device=dev)
    if B == 0 or H == 0 or W == 0:
        return out
    geom = plan_geometry(plan, B, H, W)
    lib = build().lib
    read = plan.tracks_read
    table = (ctypes.c_void_p * len(read))(*[tracks[t].data_ptr()
                                            for t in read])
    slot = [-1] * len(tracks)
    for k, t in enumerate(read):
        slot[t] = k
    slots = (ctypes.c_int * len(slot))(*slot)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lives_composite(
            packed.data_ptr(), table, len(read), slots, len(tracks),
            plan.ops.data_ptr(), plan.ops.shape[0], plan.slot_rows.data_ptr(),
            plan.slot_vals.data_ptr(), plan.slot_rows.shape[0],
            out.data_ptr(), B, H, W, geom.span, geom.smem, stream)
    _raise(lib, err, "launch")
    LAUNCHES += 1
    return out
