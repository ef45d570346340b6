"""The fused render sweep: its eligibility rule, plan encoding, kernel
wrapper and plain version.

Counterpart of `lives_tpu/graph/pallas_composite.py:240`
(`build_fused_sweep`, default mode): for a stateless chain over the
synthetic source, ONE kernel per frame chunk generates every track, runs
the whole chain in f32 and writes the RGB24 sink's u8 frames. The kernel is
CUDA C++ for the H100 (`csrc/fused_sweep.cu`); its note says what bounds it.

- `build_fused_sweep` decides eligibility as a pure function of chain,
  source and sink, before any launch, and returns None for a chain the
  kernel does not take (the caller then runs the plain chain, as the JAX
  package runs its XLA path). Otherwise it encodes the chain once into a
  small op table on the device: a `SweepPlan`, which the plan cache keeps.
- `fused_sweep(plan, src_ids, packed)` launches the kernel on CUDA tensors
  and counts the launch in `LAUNCHES`. On CPU tensors it returns
  `plain_sweep`, because the kernel cannot run there.
- `plain_sweep(plan, src_ids, packed)` computes the same frames with the
  ported effect functions (FrameGraph's plain route).
- `build()` compiles the kernel with nvcc on first use (`native.load`) and
  binds it with ctypes; `fused_sweep` calls it on its first launch.

The JAX kernel's `emit="comp"`, `consume="comp"` and `band_h` modes are not
ported yet (ROADMAP Queue 2, K1).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..constants import Gamma, Palette
from ..effects.builtin.blends import _BLEND_MODES
from ..effects.builtin.blur import _box_kernel, _gauss_kernel, shift_taps
from ..effects.host import FILTER_STATEFUL

#: launches of the sweep kernel since the count was last set to 0
LAUNCHES = 0

# kernel geometry and limits: keep in step with csrc/fused_sweep.cu
TILE_H = TILE_W = 32
MAX_SLOTS = 256
MAX_RADIUS = 16          # the JAX sweep's limit (pallas_composite.py:349)
SMEM_LIMIT = 232448      # 227 KB of shared memory a block can use
STATIC_SMEM = 4 * MAX_SLOTS

(OP_CROSSFADE, OP_BLEND, OP_LUMA_KEY, OP_CHROMA_KEY, OP_COLOUR_BALANCE,
 OP_SATURATION, OP_VIGNETTE, OP_STENCIL) = range(8)
OP_FIELDS = 7  # code, in0, in1, arg, taps offset, sharpen, first slot

_POINT_OPS = {"crossfade": OP_CROSSFADE, "luma_key": OP_LUMA_KEY,
              "chroma_key": OP_CHROMA_KEY,
              "colour_balance": OP_COLOUR_BALANCE,
              "saturation": OP_SATURATION, "vignette": OP_VIGNETTE,
              **{name: OP_BLEND for name in _BLEND_MODES}}
_BLEND_INDEX = {name: i for i, name in enumerate(_BLEND_MODES)}
#: separable stencils: name -> (taps of a radius, sharpen mode)
_STENCILS = {"gaussian_blur": (_gauss_kernel, False),
             "box_blur": (_box_kernel, False),
             "sharpen": (_gauss_kernel, True)}
#: the kernel's vocabulary
VOCABULARY = frozenset(_POINT_OPS) | frozenset(_STENCILS)


@dataclass(frozen=True, eq=False)
class SweepPlan:
    """One chain encoded for the kernel, resident on `ops.device`."""
    chain_spec: tuple
    n_tracks: int
    height: int
    width: int
    rows_key: tuple
    fps: float
    source: Any
    sink: Any
    halo: int                # R, the sum of the stencil radii
    n_stencils: int
    ops: torch.Tensor        # (n_ops, OP_FIELDS) int32
    slot_rows: torch.Tensor  # (n_slots,) int32 packed row, -1 = constant
    slot_vals: torch.Tensor  # (n_slots, 3) f32: constant, min, max
    taps: torch.Tensor       # (n_taps,) f32


def smem_bytes(halo: int, n_stencils: int) -> int:
    """Dynamic shared memory of one block: the composite and a vertical
    pass, 3 channels each, over the tile plus its halo."""
    if not n_stencils:
        return 0
    return 2 * 3 * (TILE_H + 2 * halo) * (TILE_W + 2 * halo) * 4


def _encode(chain_spec, n_tracks: int, H: int, W: int, rows_key, source,
            sink):
    """The eligibility rule and the op table, host side: (ops, slot_rows,
    slot_vals, taps, halo, n_stencils) numpy arrays, or None when the
    chain, source or sink is outside the kernel's contract
    (`lives_tpu/graph/pallas_composite.py:302-369`)."""
    from .nodemodel import _STATIC_KINDS
    key = source.source_key() if hasattr(source, "source_key") else None
    if key is None or key[0] != "synthetic" or source.alpha:
        return None
    if (source.h, source.w) != (H, W) or n_tracks < 1:
        return None
    if sink.palette != Palette.RGB24 or sink.letterbox:
        return None
    if sink.width not in (0, W) or sink.height not in (0, H):
        return None
    if sink.gamma != Gamma.SRGB:  # synthetic layers are SRGB-tagged
        return None
    row_of = {k: r for r, k in enumerate(rows_key)}
    ops, slot_rows, slot_vals, taps = [], [], [], []
    halo = n_stencils = 0
    for idx, (filt, static, in_tr, out_tr, enabled) in enumerate(chain_spec):
        if not enabled:
            continue
        if filt.flags & FILTER_STATEFUL or tuple(out_tr) != (0,):
            return None
        name = filt.name
        if name not in VOCABULARY:
            return None
        slot = len(slot_rows)
        for p in filt.params:
            if p.kind not in _STATIC_KINDS:
                slot_rows.append(row_of.get((idx, p.name), -1))
                slot_vals.append((static.get(p.name, p.default),
                                  p.min, p.max))
        if name in _STENCILS:
            kern_fn, sharpen = _STENCILS[name]
            rp = filt.param("radius")
            r = min(max(1, int(static.get("radius", rp.default))),
                    int(rp.max))
            if r > MAX_RADIUS:
                # XLA's sep_conv switches to the band-matrix form above 33
                # taps, which the shifted-add stencil does not reproduce
                return None
            ops.append((OP_STENCIL, 0, 0, r, len(taps), int(sharpen), slot))
            taps.extend(shift_taps(kern_fn(r)))
            halo += r
            n_stencils += 1
            continue
        used = tuple(in_tr[: filt.n_in])
        if len(used) != filt.n_in or max(used) >= n_tracks:
            return None
        if n_stencils and used != (0,):
            return None  # after a stencil only track 0 has a halo
        ops.append((_POINT_OPS[name], used[0], used[-1],
                    _BLEND_INDEX.get(name, 0), 0, 0, slot))
    if len(slot_rows) > MAX_SLOTS:
        return None
    if smem_bytes(halo, n_stencils) + STATIC_SMEM > SMEM_LIMIT:
        return None
    return (np.asarray(ops, np.int32).reshape(-1, OP_FIELDS),
            np.asarray(slot_rows, np.int32),
            np.asarray(slot_vals, np.float32).reshape(-1, 3),
            np.asarray(taps, np.float32), halo, n_stencils)


def build_fused_sweep(chain_spec, n_tracks: int, H: int, W: int, rows_key,
                      fps: float, source, sink,
                      device: torch.device | str) -> SweepPlan | None:
    """Encode a chain for the kernel on `device`, or None when it does not
    qualify. `chain_spec`: (filter, static values, in_tracks, out_tracks,
    enabled) tuples; `rows_key`: the (instance, param) of each packed row."""
    enc = _encode(chain_spec, n_tracks, H, W, rows_key, source, sink)
    if enc is None:
        return None
    ops, slot_rows, slot_vals, taps, halo, n_stencils = enc
    dev = torch.device(device)
    return SweepPlan(
        chain_spec=tuple(chain_spec), n_tracks=n_tracks, height=H, width=W,
        rows_key=tuple(rows_key), fps=fps, source=source, sink=sink,
        halo=halo, n_stencils=n_stencils,
        ops=torch.from_numpy(ops).to(dev),
        slot_rows=torch.from_numpy(slot_rows).to(dev),
        slot_vals=torch.from_numpy(slot_vals).to(dev),
        taps=torch.from_numpy(taps).to(dev))


def plain_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                packed: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: generate the tracks with the
    source and run the ported effect functions (FrameGraph's plain route).
    src_ids (2,T,B) int32, packed (P+2,B) f32 -> (B,3,H,W) u8."""
    from .nodemodel import run_chain
    layers = [plan.source.traced_layer(src_ids[0, t], src_ids[1, t])
              for t in range(plan.n_tracks)]
    out = run_chain(plan.chain_spec, layers, packed, plan.rows_key,
                    plan.fps, plan.sink)
    return out.planes[0]


def fused_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                packed: torch.Tensor) -> torch.Tensor:
    """Run the plan on one chunk: the kernel for CUDA tensors, the plain
    version for CPU tensors (where the kernel cannot run)."""
    if src_ids.device.type == "cpu":
        return plain_sweep(plan, src_ids, packed)
    if src_ids.device.type != "cuda":
        raise ValueError(f"fused_sweep: no kernel for {src_ids.device}")
    return _launch(plan, src_ids, packed)


def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("fused_sweep")
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every pointer and the stream as c_void_p: ctypes would pass a bare
    # Python int as a 32-bit int and cut it
    lib.lives_fused_sweep.argtypes = [p, p, p, i, p, p, i, p, p,
                                      i, i, i, i, i, i, f, f, p]
    lib.lives_fused_sweep.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def _launch(plan: SweepPlan, src_ids: torch.Tensor,
            packed: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    dev = plan.ops.device
    T = plan.n_tracks
    if src_ids.dtype != torch.int32 or packed.dtype != torch.float32:
        raise TypeError("fused_sweep: src_ids must be int32, packed float32")
    if src_ids.ndim != 3 or src_ids.shape[:2] != (2, T):
        raise ValueError(f"fused_sweep: src_ids {tuple(src_ids.shape)}, "
                         f"want (2, {T}, B)")
    B = src_ids.shape[2]
    if packed.shape != (len(plan.rows_key) + 2, B):
        raise ValueError(f"fused_sweep: packed {tuple(packed.shape)}, want "
                         f"({len(plan.rows_key) + 2}, {B})")
    if src_ids.device != dev or packed.device != dev:
        raise ValueError(f"fused_sweep: tensors must be on {dev}")
    src_ids = src_ids.contiguous()
    packed = packed.contiguous()
    H, W = plan.height, plan.width
    out = torch.empty((B, 3, H, W), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    lib = build().lib
    sx = float(np.float32(2.0 / max(W - 1, 1)))
    sy = float(np.float32(2.0 / max(H - 1, 1)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lives_fused_sweep(
            packed.data_ptr(), src_ids.data_ptr(), plan.ops.data_ptr(),
            plan.ops.shape[0], plan.slot_rows.data_ptr(),
            plan.slot_vals.data_ptr(), plan.slot_rows.shape[0],
            plan.taps.data_ptr(), out.data_ptr(), T, B, H, W, plan.halo,
            plan.n_stencils, sx, sy, stream)
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_sweep launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return out
