"""The fused render sweep: its eligibility rule, plan encoding, kernel
wrapper and plain version.

Counterpart of `lives_tpu/graph/pallas_composite.py:240-537`
(`build_fused_sweep`, `sweep_suffix_len`, `sweep_prefix_len`): for a
stateless chain over the synthetic source, ONE kernel per frame chunk
generates every track, runs the whole chain in f32 and writes the RGB24
sink's u8 frames. The kernel is CUDA C++ for the H100
(`csrc/fused_sweep.cu`); its note says what bounds it. Its two comp modes
serve stateful chains (`nodemodel.FrameGraph.run_batch`):

- `emit="comp"` (the prefix sweep, `pallas_composite.py:316-318,457-458`):
  no sink step; the kernel writes a ``(B, 3, H, W)`` f32 comp. The JAX
  package stores it bf16 by default, a TPU bandwidth choice; the port keeps
  f32.
- `consume="comp"` (the suffix sweep, `:329-331,343-344,398-402,418`):
  track 0 is read from an f32 comp, the other tracks are generated; no
  stencils (the comp carries no halo). `idx_base` is the global index of
  the suffix's first instance in `rows_key`.

- `build_fused_sweep` decides eligibility as a pure function of chain,
  source and sink, before any launch, and returns None for a chain the
  kernel does not take (the caller then runs the plain chain, as the JAX
  package runs its XLA path). Otherwise it encodes the chain once into a
  small op table on the device: a `SweepPlan`, which the plan cache keeps.
- `fused_sweep(plan, src_ids, packed, comp=None)` launches the kernel on
  CUDA tensors and counts the launch in `LAUNCHES` and in its mode's entry
  of `MODE_LAUNCHES`. On CPU tensors it returns `plain_sweep`, because the
  kernel cannot run there.
- `plain_sweep(plan, src_ids, packed, comp=None)` computes the same result
  with the ported effect functions (FrameGraph's plain route).
- `build(full)` compiles the kernel with nvcc on first use
  (`native.load`), its core build or with `full` its exact one, and binds
  it with ctypes; `fused_sweep` calls it on its first launch.
- `sweep_geometry(rows, W, halo, n_ops, n_taps, B)` is a launch's
  geometry: the run of pixels a thread computes (`sweep_run`, from the
  halo), the tile (the least halo work among `TILES`, a block that fills
  an SM alone weighing more), the shared row's margin, the grid and the
  shared memory.

The vocabulary is the JAX sweep's, `PALLAS_SAFE | COORD_SAFE | STENCILS`
(`pallas_composite.py:51-84,358`): 45 point ops, each a row of the op
table that K1, K4 (`graph/composite.py`) and K5 (`graph/stateful_sweep.py`)
share (`csrc/sweep_common.cuh`), and three stencils. `encode_point` writes
a point op's row: its opcode, its family member or static choice (a
blend's mode, wipe's direction) in `arg`, its parameter slots, the frame
number's row for rand_replace's salt, iris_circle's constants in the taps
array. The core (`CORE`, what the main chains hold) runs K1's contracted
build; a plan that holds any other op is `full` and runs K1's exact build
(`-fmad=false`, the whole vocabulary), so the ops that compare a float
with a threshold see the plain version's floats (csrc/fused_sweep.cu's
note), and K5's whole-vocabulary instantiation.

Band mode (`band_h`, `pallas_composite.py:242,286-297,302-311,332,367,
390-393,452,490`) serves the multi-device layer
(`parallel/mesh.spatial_sweep_fn`): the u8 mode over output rows
``[y0, y0+band_h)`` of the H-row frame, ``(B, 3, band_h, W)``. The plan
keeps H as the frame's height (the grid's scales and the clamps need it),
and `fused_sweep(plan, src_ids, packed, y0=...)` takes the band's first
row as a launch argument, where the JAX kernel reads it from a packed row.
Every band generates its own halo at global rows, so bands need no
exchange, and a band is bit-identical to those rows of the whole frame.
`plain_band_sweep` is its plain version. Eligibility is the u8 mode's; the
JAX package's `W % 128` lane rule is a TPU layout rule and is dropped, as
for the whole-frame kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..constants import Gamma, Palette
from ..effects.builtin.blends import _BLEND_MODES
from ..effects.builtin.blur import _box_kernel, _gauss_kernel, shift_taps
from ..effects.host import FILTER_STATEFUL
from ..layer import Layer

#: launches of the sweep kernel since the count was last set to 0, all
#: modes, and by mode
LAUNCHES = 0
MODE_LAUNCHES = {"u8": 0, "comp_out": 0, "comp_in": 0, "band": 0}

# kernel geometry and limits: keep in step with csrc/fused_sweep.cu
MAX_SLOTS = 256
MAX_RADIUS = 16          # the JAX sweep's limit (pallas_composite.py:349)
#: the largest summed stencil radius the sweep takes: the limit of its
#: first design (a 32x32 tile, two 3-channel buffers in 227 KB), kept so
#: that the chains it takes stay the same
MAX_HALO = 33
SMEM_LIMIT = 232448      # 227 KB of shared memory a block can use
SM_SMEM = 233472         # 228 KB of shared memory an SM holds
BLOCK_RESERVED = 1024    # shared memory the system keeps for each block
STATIC_SMEM = 4 * MAX_SLOTS + 16  # the parameter slots and track 0
OP_REC_BYTES = 112       # one op's record in shared memory (OpRec)
#: a thread computes a run of 8 adjacent pixels, or of 4 from this summed
#: stencil radius on (`sweep_run`): in chip_smoke.py phase 5 on an H100,
#: runs of 8 were the fastest on the main chain (R = 3; runs of 4 took
#: 1.09x, of 2 1.44x), runs of 4 12-22 % faster with one blur of r = 8
#: and 16
WIDE_HALO = 8
#: the tile shapes (rows, columns) a launch chooses from, in the order
#: that breaks a tie; the last fits any plan's halo
TILES = ((64, 128), (64, 64), (32, 128), (32, 64), (32, 32))
#: a phase-1 cell's cost when one block fills an SM, against two or more:
#: K1 on the main chain at 64x128 (one block, 1.24 cells a pixel) against
#: 32x128 (two, 1.346), 1.22-1.34 in chip_smoke.py phase 5 on an H100
ONE_BLOCK_COST = 1.3
#: a phase-1 cell of the stateful sweep in runs of 8 against runs of 4: on
#: config C (R = 1) K5 took 0.88x with runs of 8 (chip_smoke.py phase 8 on
#: an H100, 7.19-7.29 ms against 8.24-8.30 at 32x128; PERF.md)
STATEFUL_RUN8_COST = 0.88
#: the stateful sweep's op table: every op but alien_overlay has a slot
MAX_STATES = 8
MAX_STATEFUL_OPS = MAX_SLOTS + MAX_STATES

# opcodes and op fields: keep in step with csrc/sweep_common.cuh
(OP_CROSSFADE, OP_BLEND, OP_LUMA_KEY, OP_CHROMA_KEY, OP_ALPHA_OVER,
 OP_MASK_OVERLAY, OP_LUMA_SELECT, OP_WIPE, OP_IRIS, OP_DISSOLVE,
 OP_COLOUR_BALANCE, OP_SATURATION, OP_VIGNETTE, OP_NEGATE,
 OP_BRIGHTNESS_CONTRAST, OP_GAMMA_ADJUST, OP_LEVELS, OP_GREYSCALE, OP_SEPIA,
 OP_POSTERIZE, OP_SOLARIZE, OP_THRESHOLD, OP_SOFTLIGHT, OP_TINT,
 OP_HUE_ROTATE, OP_MODULATE, OP_COLOUR_REPLACE, OP_STENCIL, OP_FIRE, OP_LIFE,
 OP_ALIEN) = range(31)
#: codes up to this one read two tracks (fg in0 over bg in1)
OP_LAST_TWO_IN = OP_DISSOLVE
OP_FIELDS = 7  # code, in0, in1, arg, taps offset, sharpen, first slot

#: point op name -> (opcode, arg): arg picks a family's member (a blend's
#: mode, a luma overlay's test, an iris's shape, dissolve or rand_replace);
#: wipe's arg is its static direction (`encode_point`)
_POINT_OPS = {
    "crossfade": (OP_CROSSFADE, 0), "chroma_blend": (OP_CROSSFADE, 1),
    **{name: (OP_BLEND, i) for i, name in enumerate(_BLEND_MODES)},
    "luma_key": (OP_LUMA_KEY, 0), "chroma_key": (OP_CHROMA_KEY, 0),
    "alpha_over": (OP_ALPHA_OVER, 0), "mask_overlay": (OP_MASK_OVERLAY, 0),
    "luma_overlay": (OP_LUMA_SELECT, 0), "luma_underlay": (OP_LUMA_SELECT, 1),
    "negative_luma_overlay": (OP_LUMA_SELECT, 2), "wipe": (OP_WIPE, 0),
    "iris_circle": (OP_IRIS, 0), "iris_rectangle": (OP_IRIS, 1),
    "dissolve": (OP_DISSOLVE, 0), "rand_replace": (OP_DISSOLVE, 1),
    "colour_balance": (OP_COLOUR_BALANCE, 0),
    "saturation": (OP_SATURATION, 0), "vignette": (OP_VIGNETTE, 0),
    "negate": (OP_NEGATE, 0),
    "brightness_contrast": (OP_BRIGHTNESS_CONTRAST, 0),
    "gamma_adjust": (OP_GAMMA_ADJUST, 0), "levels": (OP_LEVELS, 0),
    "greyscale": (OP_GREYSCALE, 0), "sepia": (OP_SEPIA, 0),
    "posterize": (OP_POSTERIZE, 0), "solarize": (OP_SOLARIZE, 0),
    "threshold": (OP_THRESHOLD, 0), "softlight": (OP_SOFTLIGHT, 0),
    "tint": (OP_TINT, 0), "hue_rotate": (OP_HUE_ROTATE, 0),
    "modulate": (OP_MODULATE, 0), "colour_replace": (OP_COLOUR_REPLACE, 0),
}
#: the core vocabulary: what the main chains hold, and all the vocabulary
#: was before it grew. A plan of these ops alone runs K1's contracted build
#: and K5's core instantiation (`point_run<P, false>`); any other op makes
#: the plan `full` (csrc/sweep_common.cuh). K4 has one instantiation, the
#: whole vocabulary's (csrc/composite.cu).
CORE = frozenset({"crossfade", *_BLEND_MODES, "luma_key", "chroma_key",
                  "colour_balance", "saturation", "vignette"})
#: separable stencils: name -> (taps of a radius, sharpen mode)
_STENCILS = {"gaussian_blur": (_gauss_kernel, False),
             "box_blur": (_box_kernel, False),
             "sharpen": (_gauss_kernel, True)}
#: the JAX package's band-safe filter names (`pallas_composite.py:51-84`):
#: coordinate-free, reduction-free, gather-free per-pixel filters, and
#: pointwise filters that read their frame coordinates through
#: `effects.util.ctx_grid` or `_pixel_hash`. The multi-device layer's band
#: paths take these and the separable stencils
#: (`parallel.mesh.chain_band_halo`).
PALLAS_SAFE = frozenset({
    "crossfade", "blend_add", "blend_subtract", "blend_multiply",
    "blend_screen", "blend_darken", "blend_lighten", "blend_difference",
    "blend_exclusion", "blend_overlay", "blend_hardlight", "blend_dodge",
    "blend_burn", "blend_grain_extract", "blend_grain_merge",
    "luma_key", "chroma_key", "alpha_over", "mask_overlay",
    "negate", "brightness_contrast", "gamma_adjust", "saturation",
    "colour_balance", "levels", "greyscale", "sepia", "posterize",
    "solarize", "threshold", "softlight", "tint",
    "chroma_blend", "luma_overlay", "luma_underlay",
    "negative_luma_overlay", "hue_rotate", "modulate", "colour_replace",
})
COORD_SAFE = frozenset({"vignette", "wipe", "iris_circle", "iris_rectangle",
                        "dissolve", "rand_replace"})
#: the separable stencils' names
STENCILS = frozenset(_STENCILS)
#: the kernel's vocabulary: the JAX sweep's (`pallas_composite.py:358`)
VOCABULARY = PALLAS_SAFE | COORD_SAFE | STENCILS
#: the stateful steps of the fused stateful sweep (csrc/stateful_sweep.cu):
#: name -> (opcode, halo, state kind in the JAX state contract)
#: (`lives_tpu/graph/pallas_stateful.py:54-63`)
STATEFUL_STEPS = {"fire": (OP_FIRE, 1, "f32hw"),
                  "life": (OP_LIFE, 1, "u8hw"),
                  "alien_overlay": (OP_ALIEN, 0, "f32chw")}


def sweep_suffix_len(chain) -> int:
    """Length of the trailing run of enabled stateless point effects (no
    stencils: the suffix kernel's comp carries no halo), disabled instances
    passing (`pallas_composite.py:502`)."""
    n = 0
    for inst in reversed(list(chain)):
        if inst.enabled and (inst.filter.flags & FILTER_STATEFUL
                             or inst.filter.name not in _POINT_OPS):
            break
        n += 1
    return n


def sweep_prefix_len(chain) -> int:
    """Length of the leading run of enabled stateless effects of the
    kernel's vocabulary, disabled instances passing
    (`pallas_composite.py:520`); `build_fused_sweep` re-checks the track
    wiring."""
    n = 0
    for inst in chain:
        if inst.enabled and (inst.filter.flags & FILTER_STATEFUL
                             or inst.filter.name not in VOCABULARY):
            break
        n += 1
    return n


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
    halo: int                # R, the sum of the stencil (and state) halos
    n_stencils: int
    ops: torch.Tensor        # (n_ops, OP_FIELDS) int32
    slot_rows: torch.Tensor  # (n_slots,) int32 packed row, -1 = constant
    slot_vals: torch.Tensor  # (n_slots, 3) f32: constant, min, max
    taps: torch.Tensor       # (n_taps,) f32
    emit: str = "u8"         # "u8" or "comp" (f32 comp out)
    consume: str | None = None  # "comp": track 0 read from an f32 comp
    idx_base: int = 0        # rows_key index of chain_spec[0]
    #: the stateful sweep's steps: (chain index, name, state kind) each
    state_steps: tuple = ()
    #: band mode: the rows of one launch's output (None: the whole frame)
    band_h: int | None = None
    #: the chain holds an op past the core vocabulary (`CORE`): K1 runs its
    #: exact build, K5 its whole-vocabulary instantiation
    full: bool = False

    @property
    def mode(self) -> str:
        """The MODE_LAUNCHES entry of this plan."""
        if self.band_h is not None:
            return "band"
        if self.consume == "comp":
            return "comp_in"
        return "comp_out" if self.emit == "comp" else "u8"


def stateful_smem_bytes(halo: int, n_steps: int) -> int:
    """The first design's limit, kept as the eligibility rule of the fused
    stateful sweep: the dynamic shared memory of one block of that design,
    the composite and a second buffer, 3 channels each, over a 32x32 tile
    plus the halo. A chain whose bytes and the parameter slots exceed a
    block's shared memory (a summed halo over 33) is refused, so the kernel
    takes the chains it took before; its launch geometry is
    `stateful_geometry`'s."""
    if not n_steps:
        return 0
    return 2 * 3 * (32 + 2 * halo) ** 2 * 4


def stateful_eligible(halo: int, n_steps: int) -> bool:
    """The eligibility rule of the fused stateful sweep (`_encode`)."""
    return stateful_smem_bytes(halo, n_steps) + 4 * MAX_SLOTS <= SMEM_LIMIT


@dataclass(frozen=True)
class SweepGeometry:
    """One launch of the sweep kernel (csrc/fused_sweep.cu): a tile of
    `tile_h` x `tile_w` output pixels a block, `run` pixels a thread (4 or
    8),
    shared rows of tile_w + 2 * margin columns, the grid (column tiles,
    row tiles, frames) and the dynamic shared memory in bytes."""
    tile_h: int
    tile_w: int
    run: int
    margin: int
    grid: tuple
    smem: int


def _geometry(tile, run, rows, W, halo, n_ops, n_taps, B) -> SweepGeometry:
    th, tw = tile
    margin = -(-(halo + run - 1) // run) * run if halo else 0
    ws = tw + 2 * margin
    # A (3 channels) and V (one, in skewed rows) over the tile and its halo
    floats = (th + 2 * halo) * (3 * ws + v_stride(ws)) if halo else 0
    return SweepGeometry(th, tw, run, margin,
                         (-(-W // tw), -(-rows // th), B),
                         4 * floats + OP_REC_BYTES * n_ops + 4 * n_taps)


def v_stride(ws: int) -> int:
    """Floats a row of V takes: column c sits at c + c // 32 (the kernel's
    v_stride), rounded up to 4."""
    return (ws + (ws >> 5) + 3) & ~3


def blocks_per_sm(geom: SweepGeometry) -> int:
    """Blocks of `geom` one SM's shared memory holds."""
    return SM_SMEM // (geom.smem + STATIC_SMEM + BLOCK_RESERVED)


def phase1_cells(geom: SweepGeometry, halo: int) -> int:
    """Cells the launch evaluates in phase 1: the runs covering every tile
    and its halo, ragged tiles counted whole."""
    lo = (geom.margin - halo) // geom.run
    hi = -(-(geom.margin + geom.tile_w + halo) // geom.run)
    return (geom.grid[0] * geom.grid[1] * geom.grid[2]
            * (geom.tile_h + 2 * halo) * (hi - lo) * geom.run)


def sweep_run(halo: int) -> int:
    """The run of adjacent pixels a thread computes for a plan of summed
    stencil radius `halo`. It depends on the plan alone, so a band and the
    whole frame run the same arithmetic."""
    return 4 if halo >= WIDE_HALO else 8


@functools.lru_cache(maxsize=256)
def sweep_geometry(rows: int, W: int, halo: int, n_ops: int, n_taps: int,
                   B: int = 1, tile: tuple | None = None,
                   run: int | None = None) -> SweepGeometry:
    """The geometry of a launch over `rows` output rows (a band's, or the
    frame's) of a W-column frame for a plan of summed stencil radius
    `halo`, `n_ops` ops and `n_taps` taps: runs of `sweep_run(halo)`
    pixels, and the tile of `TILES` that fits a block and evaluates the
    fewest phase-1 cells, a cell weighing ONE_BLOCK_COST where one block
    fills an SM; or `tile` and `run` when given (for measurements). Raises
    when the launch does not fit a block's shared memory."""
    run = run or sweep_run(halo)
    args = (run, rows, W, halo, n_ops, n_taps, B)
    if tile is not None:
        geom = _geometry(tile, *args)
        if geom.tile_w % run:
            raise ValueError(f"sweep_geometry: tile {tile} for runs of {run}")
    else:
        fits = [g for g in (_geometry(t, *args) for t in TILES)
                if g.smem + STATIC_SMEM <= SMEM_LIMIT] or [
                    _geometry(TILES[-1], *args)]
        geom = min(fits, key=lambda g: phase1_cells(g, halo) * (
            ONE_BLOCK_COST if blocks_per_sm(g) < 2 else 1))
    if geom.smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"sweep_geometry: {geom} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return geom


def _stateful_geometry(tile, run, H, W, halo, n_ops, n_taps,
                       B) -> SweepGeometry:
    th, tw = tile
    margin = -(-(halo + run - 1) // run) * run if halo else 0
    ws = tw + 2 * margin
    # A (3 channels) and S (one, in skewed rows) over the tile and its halo
    floats = (th + 2 * halo) * (3 * ws + v_stride(ws))
    return SweepGeometry(th, tw, run, margin, (-(-W // tw), -(-H // th), B),
                         4 * floats + OP_REC_BYTES * n_ops + 4 * n_taps)


def stateful_rounds(geom: SweepGeometry, resident: int) -> int:
    """Rounds of tiles a frame takes when the card holds `resident` blocks
    of the launch at once: the grid (at most one block a tile) walks the
    frame's tiles in a strided loop, so the slowest block computes this
    many tiles a frame."""
    return -(-geom.grid[0] * geom.grid[1] // resident)


def stateful_cost(geom: SweepGeometry, halo: int, resident: int) -> float:
    """The tile cost model of the stateful sweep: the rounds of a frame
    times the phase-1 cells of one tile, a cell of a run of 8 weighing
    STATEFUL_RUN8_COST."""
    tiles = geom.grid[0] * geom.grid[1] * geom.grid[2]
    weight = STATEFUL_RUN8_COST if geom.run == 8 else 1.0
    return (stateful_rounds(geom, resident) * phase1_cells(geom, halo)
            / tiles * weight)


def stateful_geometry(H: int, W: int, halo: int, n_ops: int, n_taps: int,
                      resident, B: int = 1, tile: tuple | None = None,
                      run: int | None = None) -> SweepGeometry:
    """The geometry of a fused stateful sweep launch over an H x W frame for
    a plan of summed halo `halo`, `n_ops` ops and `n_taps` taps, on a card
    that holds `resident(geom)` blocks of a launch at `geom` at once (its
    SMs times the occupancy query's blocks an SM, the grid the launch
    takes): the tile of `TILES` and the run (8 or 4) of least
    `stateful_cost` that fit a block's shared memory and the card, or
    `tile` and `run` when given (for measurements). Raises for a plan the
    eligibility rule refuses, and when the launch does not fit."""
    if not stateful_eligible(halo, 1):
        raise ValueError(f"stateful_geometry: summed halo {halo} is over "
                         f"the fused stateful sweep's limit")
    fits = [(g, resident(g))
            for g in (_stateful_geometry(t, r, H, W, halo, n_ops, n_taps, B)
                      for t in ((tile,) if tile else TILES)
                      for r in ((run,) if run else (8, 4)))
            if g.tile_w % g.run == 0
            and g.smem + STATIC_SMEM <= SMEM_LIMIT]
    fits = [(g, n) for g, n in fits if n >= 1]
    if not fits:
        raise ValueError(f"stateful_geometry: no launch of tile {tile}, run "
                         f"{run} fits {SMEM_LIMIT} bytes of shared memory "
                         f"and the card")
    return min(fits, key=lambda gn: stateful_cost(gn[0], halo, gn[1]))[0]


def add_slots(filt, static, idx: int, row_of: dict, slot_rows: list,
              slot_vals: list) -> int:
    """Append the parameter slots of instance `idx` (its traced kinds, in
    the filter's order) to the op table's slot lists: each slot's packed
    row (-1 = the constant), constant, min and max. Returns its first
    slot."""
    from .nodemodel import _STATIC_KINDS
    slot = len(slot_rows)
    for p in filt.params:
        if p.kind not in _STATIC_KINDS:
            slot_rows.append(row_of.get((idx, p.name), -1))
            slot_vals.append((static.get(p.name, p.default), p.min, p.max))
    return slot


#: the frame-number slot's clamp: none (rand_replace's salt)
_NO_CLAMP = (0.0, float(np.finfo(np.float32).min),
             float(np.finfo(np.float32).max))


def encode_point(filt, static, used: tuple, idx: int, row_of: dict,
                 n_rows: int, slot_rows: list, slot_vals: list,
                 consts: list | None, H: int = 0, W: int = 0) -> tuple:
    """The op-table row of point op `filt` of instance `idx` reading tracks
    `used` (csrc/sweep_common.cuh `make_rec`, `point_run`), appending its
    parameter slots (`add_slots`) and what else it reads: rand_replace a
    slot for the frame number (packed row n_rows + 1, the salt of
    `_pixel_hash`), iris_circle its constants (float32 of the aspect W / H
    and of the largest radius sqrt(1 + (W/H)^2), as `blends._iris_mask`
    rounds them) in `consts`, at the row's taps offset. `consts` is None
    for an op table that has no constants (the composite kernel's)."""
    name = filt.name
    code, arg = _POINT_OPS[name]
    slot = add_slots(filt, static, idx, row_of, slot_rows, slot_vals)
    if name == "wipe":
        arg = int(static.get("direction", filt.param("direction").default))
        if not 0 <= arg <= 3:
            raise ValueError(f"wipe: direction {arg} is not 0-3")
    elif name == "rand_replace":
        slot_rows.append(n_rows + 1)
        slot_vals.append(_NO_CLAMP)
    at = 0
    if name == "iris_circle":
        at = len(consts)
        aspect = W / H
        consts.extend((np.float32(aspect),
                       np.float32(np.sqrt(1.0 + aspect ** 2))))
    return (code, used[0], used[-1], arg, at, 0, slot)


def _encode(chain_spec, n_tracks: int, H: int, W: int, rows_key, source,
            sink, *, emit: str = "u8", consume: str | None = None,
            idx_base: int = 0, stateful: bool = False):
    """The eligibility rule and the op table, host side: (ops, slot_rows,
    slot_vals, taps, halo, n_stencils, state_steps) numpy arrays and
    counts, or None when the chain, source or sink is outside the kernel's
    contract (`lives_tpu/graph/pallas_composite.py:302-369`; with
    `stateful`, the fused stateful sweep's, `pallas_stateful.py:106-160`)."""
    key = source.source_key() if hasattr(source, "source_key") else None
    if key is None or key[0] != "synthetic" or source.alpha:
        return None
    if (source.h, source.w) != (H, W) or n_tracks < 1:
        return None
    if emit != "comp":
        # the kernel writes quantised RGB24 with no sink convert step
        if sink.palette != Palette.RGB24 or sink.letterbox:
            return None
        if sink.width not in (0, W) or sink.height not in (0, H):
            return None
        if sink.gamma != Gamma.SRGB:  # synthetic layers are SRGB-tagged
            return None
    row_of = {k: r for r, k in enumerate(rows_key)}
    ops, slot_rows, slot_vals, taps, state_steps = [], [], [], [], []
    halo = n_stencils = 0
    for idx, (filt, static, in_tr, out_tr, enabled) in enumerate(chain_spec):
        if not enabled:
            continue
        if tuple(out_tr) != (0,):
            return None
        name = filt.name
        step = STATEFUL_STEPS.get(name) if stateful else None
        if filt.flags & FILTER_STATEFUL and (step is None
                                             or tuple(in_tr[:1]) != (0,)):
            return None
        if step is None and name not in VOCABULARY:
            return None
        if step is not None:
            slot = add_slots(filt, static, idx + idx_base, row_of, slot_rows,
                             slot_vals)
            code, step_halo, kind = step
            ops.append((code, 0, 0, len(state_steps), 0, 0, slot))
            state_steps.append((idx + idx_base, name, kind))
            halo += step_halo
            continue
        if name in _STENCILS:
            if consume == "comp":
                return None  # the comp carries no stencil halo
            kern_fn, sharpen = _STENCILS[name]
            rp = filt.param("radius")
            r = min(max(1, int(static.get("radius", rp.default))),
                    int(rp.max))
            if r > MAX_RADIUS:
                # XLA's sep_conv switches to the band-matrix form above 33
                # taps, which the shifted-add stencil does not reproduce
                return None
            slot = add_slots(filt, static, idx + idx_base, row_of, slot_rows,
                             slot_vals)
            ops.append((OP_STENCIL, 0, 0, r, len(taps), int(sharpen), slot))
            taps.extend(shift_taps(kern_fn(r)))
            halo += r
            n_stencils += 1
            continue
        used = tuple(in_tr[: filt.n_in])
        if len(used) != filt.n_in or max(used) >= n_tracks:
            return None
        if n_stencils and used != (0,) and not stateful:
            # after a stencil only track 0 has a halo; the stateful sweep
            # generates the other tracks at the halo left
            return None
        ops.append(encode_point(filt, static, used, idx + idx_base, row_of,
                                len(rows_key), slot_rows, slot_vals, taps,
                                H, W))
    if len(slot_rows) > MAX_SLOTS:
        return None
    if stateful:
        if not stateful_eligible(halo, n_stencils or len(state_steps)):
            return None
    elif halo > MAX_HALO:
        return None
    return (np.asarray(ops, np.int32).reshape(-1, OP_FIELDS),
            np.asarray(slot_rows, np.int32),
            np.asarray(slot_vals, np.float32).reshape(-1, 3),
            np.asarray(taps, np.float32), halo, n_stencils,
            tuple(state_steps))


def holds_full(chain_spec) -> bool:
    """Does the chain hold an enabled point op past the core vocabulary
    (`CORE`)?"""
    return any(enabled and filt.name in _POINT_OPS and filt.name not in CORE
               for filt, _, _, _, enabled in chain_spec)


def build_fused_sweep(chain_spec, n_tracks: int, H: int, W: int, rows_key,
                      fps: float, source, sink,
                      device: torch.device | str, *, emit: str = "u8",
                      consume: str | None = None, idx_base: int = 0,
                      stateful: bool = False,
                      band_h: int | None = None) -> SweepPlan | None:
    """Encode a chain for the kernel on `device`, or None when it does not
    qualify. `chain_spec`: (filter, static values, in_tracks, out_tracks,
    enabled) tuples; `rows_key`: the (instance, param) of each packed row,
    instances numbered from `idx_base` for chain_spec[0]. `stateful`
    encodes for the fused stateful sweep instead
    (`stateful_sweep.build_stateful_sweep`). `band_h` plans the band mode:
    u8 output rows [y0, y0+band_h) of the H-row frame, y0 given at each
    launch."""
    if emit == "comp" and consume == "comp":
        raise ValueError("a sweep reads a comp or writes one, not both")
    if band_h is not None:
        if emit == "comp" or consume == "comp" or stateful:
            raise ValueError("a band sweep writes u8 frames only")
        if not 1 <= band_h <= H:
            raise ValueError(f"band of {band_h} rows in a {H}-row frame")
    enc = _encode(chain_spec, n_tracks, H, W, rows_key, source, sink,
                  emit=emit, consume=consume, idx_base=idx_base,
                  stateful=stateful)
    if enc is None:
        return None
    ops, slot_rows, slot_vals, taps, halo, n_stencils, state_steps = enc
    dev = torch.device(device)
    return SweepPlan(
        chain_spec=tuple(chain_spec), n_tracks=n_tracks, height=H, width=W,
        rows_key=tuple(rows_key), fps=fps, source=source, sink=sink,
        halo=halo, n_stencils=n_stencils,
        ops=torch.from_numpy(ops).to(dev),
        slot_rows=torch.from_numpy(slot_rows).to(dev),
        slot_vals=torch.from_numpy(slot_vals).to(dev),
        taps=torch.from_numpy(taps).to(dev), emit=emit, consume=consume,
        idx_base=idx_base, state_steps=state_steps, band_h=band_h,
        full=holds_full(chain_spec))


def plain_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                packed: torch.Tensor,
                comp: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: generate the tracks with the
    source and run the ported effect functions (FrameGraph's plain route).
    src_ids (2,T,B) int32, packed (P+2,B) f32, comp (B,3,H,W) f32 in
    comp-in mode -> (B,3,H,W) u8, or the f32 comp in comp-out mode."""
    from .nodemodel import run_chain
    layers = [plan.source.traced_layer(src_ids[0, t], src_ids[1, t])
              for t in range(plan.n_tracks)]
    if plan.consume == "comp":
        layers[0] = Layer(planes=(comp,), palette=int(Palette.RGBFLOAT))
    emit_comp = plan.emit == "comp"
    out = run_chain(plan.chain_spec, layers, packed, plan.rows_key,
                    plan.fps, plan.sink, idx_base=plan.idx_base,
                    float_chain=emit_comp or None, emit_comp=emit_comp)
    return out.planes[0]


def plain_band_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                     packed: torch.Tensor, y0: int) -> torch.Tensor:
    """The band kernel's plain PyTorch version: rows [y0, y0+band_h) of
    what `plain_sweep` computes for the whole frame, (B,3,band_h,W) u8.

    Each track is generated over the band and R rows of halo on either
    side (R, the chain's summed stencil radii), at global rows and cut at
    the frame's edges, and the chain runs over that with its frame origin
    (`run_chain(origin=...)`); the halo is then cropped. Past a frame edge
    every stencil pads its input with the edge, as it does over the whole
    frame, so the band's rows agree with the whole frame's for any number
    of stencils."""
    from .nodemodel import run_chain
    H, R = plan.height, plan.halo
    check_band(plan, y0, "plain_band_sweep")
    lo, hi = max(y0 - R, 0), min(y0 + plan.band_h + R, H)
    layers = [plan.source.traced_rows(src_ids[0, t], src_ids[1, t], lo, hi)
              for t in range(plan.n_tracks)]
    out = run_chain(plan.chain_spec, layers, packed, plan.rows_key,
                    plan.fps, plan.sink, origin=(lo, H, plan.width))
    return out.planes[0][:, :, y0 - lo:y0 - lo + plan.band_h]


def check_band(plan: SweepPlan, y0: int | None, who: str):
    """Raise unless a band plan gets a first row y0 that keeps its band
    inside the frame, or a whole-frame plan gets none."""
    if plan.band_h is None:
        if y0 is not None:
            raise ValueError(f"{who}: y0 is for a band plan")
        return
    if y0 is None or not 0 <= y0 <= plan.height - plan.band_h:
        raise ValueError(f"{who}: band of {plan.band_h} rows at y0={y0} "
                         f"in a {plan.height}-row frame")


def fused_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                packed: torch.Tensor, comp: torch.Tensor | None = None,
                y0: int | None = None) -> torch.Tensor:
    """Run the plan on one chunk: the kernel for CUDA tensors, the plain
    version for CPU tensors (where the kernel cannot run). `comp`: the
    (B,3,H,W) f32 comp a comp-in plan reads; `y0`: a band plan's first
    output row."""
    if (comp is not None) != (plan.consume == "comp"):
        raise ValueError("fused_sweep: a comp-in plan takes a comp, and "
                         "only it")
    check_band(plan, y0, "fused_sweep")
    if src_ids.device.type == "cpu":
        if plan.band_h is not None:
            return plain_band_sweep(plan, src_ids, packed, y0)
        return plain_sweep(plan, src_ids, packed, comp)
    if src_ids.device.type != "cuda":
        raise ValueError(f"fused_sweep: no kernel for {src_ids.device}")
    return _launch(plan, src_ids, packed, comp, y0 or 0)


def build(full: bool = False):
    """Build (on first use) and bind the kernel library, the core build or
    with `full` the exact one (csrc/fused_sweep.cu's note); returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("fused_sweep_exact" if full else "fused_sweep")
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every pointer and the stream as c_void_p: ctypes would pass a bare
    # Python int as a 32-bit int and cut it
    lib.lives_fused_sweep.argtypes = [p, p, p, i, p, p, i, p, i, p, p, p,
                                      i, i, i, i, i, i, i, f, f,
                                      i, i, i, i, i, p]
    lib.lives_fused_sweep.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def check_inputs(plan: SweepPlan, src_ids: torch.Tensor,
                 packed: torch.Tensor, who: str):
    """Raise on what the kernel does not take; returns the contiguous
    (src_ids, packed) and the chunk's frame count B."""
    dev = plan.ops.device
    T = plan.n_tracks
    if src_ids.dtype != torch.int32 or packed.dtype != torch.float32:
        raise TypeError(f"{who}: src_ids must be int32, packed float32")
    if src_ids.ndim != 3 or src_ids.shape[:2] != (2, T):
        raise ValueError(f"{who}: src_ids {tuple(src_ids.shape)}, "
                         f"want (2, {T}, B)")
    B = src_ids.shape[2]
    if packed.shape != (len(plan.rows_key) + 2, B):
        raise ValueError(f"{who}: packed {tuple(packed.shape)}, want "
                         f"({len(plan.rows_key) + 2}, {B})")
    if src_ids.device != dev or packed.device != dev:
        raise ValueError(f"{who}: tensors must be on {dev}")
    return src_ids.contiguous(), packed.contiguous(), B


def grid_scales(plan: SweepPlan) -> tuple[float, float]:
    """float32(2 / max(W-1, 1)) and the same for H: the centred grid's
    scales of `effects.util._normalise`."""
    return (float(np.float32(2.0 / max(plan.width - 1, 1))),
            float(np.float32(2.0 / max(plan.height - 1, 1))))


def plan_geometry(plan: SweepPlan, B: int, tile: tuple | None = None,
                  run: int | None = None) -> SweepGeometry:
    """The geometry of a launch of `plan` over B frames (`tile` and `run`
    override the choice, for measurements)."""
    rows = plan.band_h if plan.band_h is not None else plan.height
    return sweep_geometry(rows, plan.width, plan.halo, plan.ops.shape[0],
                          plan.taps.shape[0], B, tile, run)


def _launch(plan: SweepPlan, src_ids: torch.Tensor, packed: torch.Tensor,
            comp: torch.Tensor | None, y0: int = 0,
            geom: SweepGeometry | None = None) -> torch.Tensor:
    global LAUNCHES
    src_ids, packed, B = check_inputs(plan, src_ids, packed, "fused_sweep")
    dev = plan.ops.device
    H, W = plan.height, plan.width
    band_h = plan.band_h if plan.band_h is not None else H
    if comp is not None:
        if comp.dtype != torch.float32 or comp.shape != (B, 3, H, W) \
                or comp.device != dev:
            raise ValueError(f"fused_sweep: comp {tuple(comp.shape)} "
                             f"{comp.dtype} on {comp.device}, want "
                             f"({B}, 3, {H}, {W}) float32 on {dev}")
        comp = comp.contiguous()
    emit_comp = plan.emit == "comp"
    out = torch.empty((B, 3, band_h, W), device=dev,
                      dtype=torch.float32 if emit_comp else torch.uint8)
    if B == 0:
        return out
    geom = geom or plan_geometry(plan, B)
    lib = build(plan.full).lib
    sx, sy = grid_scales(plan)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lives_fused_sweep(
            packed.data_ptr(), src_ids.data_ptr(), plan.ops.data_ptr(),
            plan.ops.shape[0], plan.slot_rows.data_ptr(),
            plan.slot_vals.data_ptr(), plan.slot_rows.shape[0],
            plan.taps.data_ptr(), plan.taps.shape[0],
            comp.data_ptr() if comp is not None else None,
            None if emit_comp else out.data_ptr(),
            out.data_ptr() if emit_comp else None,
            plan.n_tracks, B, H, W, y0, band_h, plan.halo, sx, sy,
            geom.tile_h, geom.tile_w, geom.run, geom.margin, geom.smem,
            stream)
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_sweep launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    MODE_LAUNCHES[plan.mode] += 1
    return out
