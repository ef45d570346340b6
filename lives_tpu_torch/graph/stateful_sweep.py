"""The fused stateful sweep: its eligibility rule, plan, kernel wrapper and
plain version.

Counterpart of `lives_tpu/graph/pallas_stateful.py:54-597`
(`_stateful_table`, `stateful_sweep_len`, `build_fused_stateful_sweep`):
for a stateful chain over the synthetic source whose every step the kernel
holds (the fused sweep's vocabulary plus fire, life and alien_overlay), the
kernel generates the tracks, runs the whole chain with its state planes and
writes the RGB24 sink's u8 frames. The kernel is CUDA C++ for the H100
(`csrc/stateful_sweep.cu`), one cooperative launch a chunk: CUDA runs a
grid's blocks in no order, so the kernel's blocks are all resident and meet
at a grid barrier between frames; frame b reads the previous frame's state
planes and writes the other plane of each pair. A card that cannot hold
the grid at once refuses the launch, and the wrapper raises.
`_state_reads_above` (`pallas_stateful.py:66`) decides the JAX kernel's
in-place versus ping-pong planes; this kernel always ping-pongs, so it has
no counterpart here.

- `stateful_sweep_len(chain)` decides, before any launch, whether the whole
  chain qualifies (`nodemodel.FrameGraph.run_batch` reads it under
  `pref("fused_stateful") == "1"`).
- `build_stateful_sweep(...)` encodes the chain (the fused sweep's
  encoding with the stateful steps) into a `SweepPlan` whose `state_steps`
  name each stateful step's chain index and state kind, or returns None.
- `stateful_sweep(plan, src_ids, packed, states)` launches the kernel on
  CUDA tensors, one launch a chunk counted in `LAUNCHES`, at the geometry
  of `plan_geometry` (`fused_sweep.stateful_geometry`); on CPU tensors it
  returns `plain_stateful_sweep`. A `full` plan (an op past the fused
  sweep's core) runs the kernel's whole-vocabulary instantiation, whose
  occupancy the geometry queries.
- `plain_stateful_sweep(plan, src_ids, packed, states)` is the frame loop of
  the whole chain over the ported filters (FrameGraph's plain route).

States follow the JAX package's contract, one entry per chain instance:
fire ``(H, W)`` f32, life ``(H, W)`` u8 0/1, alien_overlay ``(3, H, W)``
f32, None for a stateless instance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..effects.host import FILTER_STATEFUL
from . import fused_sweep
from .fused_sweep import STATEFUL_STEPS, VOCABULARY, SweepPlan

#: launches of the stateful sweep kernel (one a chunk) since the count was
#: last set to 0
LAUNCHES = 0

MAX_STATES = fused_sweep.MAX_STATES  # keep in step with csrc/stateful_sweep.cu


def _stateful_table() -> dict[str, tuple[int, str]]:
    """name -> (halo, state kind) (`pallas_stateful.py:54`)."""
    return {name: (halo, kind)
            for name, (_, halo, kind) in STATEFUL_STEPS.items()}


def stateful_sweep_len(chain) -> bool:
    """True when the WHOLE chain qualifies for the fused stateful sweep:
    every enabled step is in the kernel's vocabulary and one at least is
    stateful (`pallas_stateful.py:75`)."""
    any_stateful = False
    for inst in chain:
        if not inst.enabled:
            continue
        name = inst.filter.name
        if inst.filter.flags & FILTER_STATEFUL:
            if name not in STATEFUL_STEPS:
                return False
            any_stateful = True
        elif name not in VOCABULARY:
            return False
    return any_stateful


def build_stateful_sweep(chain_spec, n_tracks: int, H: int, W: int,
                         rows_key, fps: float, source, sink,
                         device: torch.device | str) -> SweepPlan | None:
    """Encode a chain for the kernel on `device`, or None when the chain,
    source or sink does not qualify (`pallas_stateful.py:94`)."""
    plan = fused_sweep.build_fused_sweep(chain_spec, n_tracks, H, W,
                                         rows_key, fps, source, sink, device,
                                         stateful=True)
    if plan is None or not plan.state_steps \
            or len(plan.state_steps) > MAX_STATES:
        return None
    return plan


def plain_stateful_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                         packed: torch.Tensor, states: list):
    """The kernel's plain PyTorch version: the frame loop of the whole
    chain, tracks generated frame by frame. Returns ((B,3,H,W) u8, new
    states list)."""
    from .nodemodel import frame_loop, source_frames
    out, states = frame_loop(
        plan.chain_spec, 0, len(plan.chain_spec),
        source_frames(plan.source, src_ids, plan.chain_spec),
        src_ids.shape[2], packed, plan.rows_key, plan.fps, plan.sink,
        states)
    return out.planes[0], states


def stateful_sweep(plan: SweepPlan, src_ids: torch.Tensor,
                   packed: torch.Tensor, states: list):
    """Run the plan on one chunk from `states` (one entry per chain
    instance): the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns ((B,3,H,W) u8, new states list)."""
    if src_ids.device.type == "cpu":
        return plain_stateful_sweep(plan, src_ids, packed, states)
    if src_ids.device.type != "cuda":
        raise ValueError(f"stateful_sweep: no kernel for {src_ids.device}")
    return _launch(plan, src_ids, packed, states)


def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("stateful_sweep")
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lives_stateful_sweep.argtypes = [p, p, p, i, p, p, i, p, i, p, p, p,
                                         i, p, i, i, i, i, i, f, f, i, i, i,
                                         i, i, i, p]
    lib.lives_stateful_sweep.restype = i
    lib.lives_stateful_blocks_per_sm.argtypes = [i, i, i, p]
    lib.lives_stateful_blocks_per_sm.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def _check(lib, err: int, what: str):
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"stateful_sweep {what} failed: CUDA error {err} "
                           f"({msg})")


def plan_geometry(plan: SweepPlan, B: int, tile: tuple | None = None,
                  run: int | None = None) -> fused_sweep.SweepGeometry:
    """The geometry of a launch of `plan` over B frames on its card (`tile`
    and `run` override the choice, for measurements)."""
    return fused_sweep.stateful_geometry(
        plan.height, plan.width, plan.halo, plan.ops.shape[0],
        plan.taps.shape[0],
        functools.partial(resident_blocks, device=plan.ops.device,
                          full=plan.full), B, tile, run)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, run: int, full: bool, smem: int) -> int:
    lib = build().lib
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _check(lib, lib.lives_stateful_blocks_per_sm(run, int(full), smem,
                                                     ctypes.byref(n)),
               "occupancy query")
    return n.value


def _index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def blocks_per_sm(geom: fused_sweep.SweepGeometry, device="cuda",
                  full: bool = False) -> int:
    """Blocks of a launch at `geom` that one SM of card `device` holds (the
    CUDA occupancy query, by registers and shared memory), of the core
    instantiation or with `full` the whole vocabulary's."""
    return _blocks_per_sm(_index(device), geom.run, full, geom.smem)


def resident_blocks(geom: fused_sweep.SweepGeometry, device="cuda",
                    full: bool = False) -> int:
    """Blocks of a launch at `geom` that card `device` holds at once: its
    SMs times `blocks_per_sm`. The kernel's launch takes the same query and
    SM count for its grid (or the tiles of a frame, when fewer)."""
    props = torch.cuda.get_device_properties(_index(device))
    return props.multi_processor_count * blocks_per_sm(geom, device, full)


def _launch(plan: SweepPlan, src_ids: torch.Tensor, packed: torch.Tensor,
            states: list, geom: fused_sweep.SweepGeometry | None = None):
    global LAUNCHES
    src_ids, packed, B = fused_sweep.check_inputs(plan, src_ids, packed,
                                                  "stateful_sweep")
    dev = plan.ops.device
    H, W = plan.height, plan.width
    first, pairs = [], []
    for i, name, kind in plan.state_steps:
        st = states[i]
        dtype = torch.uint8 if kind == "u8hw" else torch.float32
        shape = (3, H, W) if kind == "f32chw" else (H, W)
        if not isinstance(st, torch.Tensor) or st.dtype != dtype \
                or tuple(st.shape) != shape or st.device != dev:
            raise ValueError(f"stateful_sweep: state of {name} (instance "
                             f"{i}) must be {shape} {dtype} on {dev}")
        first.append(st.contiguous())
        # ping-pong: frame b writes plane b % 2 and reads the other (the
        # incoming state for frame 0); the caller's state is not written
        pairs.append((torch.empty_like(st), torch.empty_like(st)))
    out = torch.empty((B, 3, H, W), dtype=torch.uint8, device=dev)
    new_states = list(states)
    if B == 0:
        return out, new_states
    geom = geom or plan_geometry(plan, B)
    lib = build().lib
    sx, sy = fused_sweep.grid_scales(plan)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = len(pairs)

    def table(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
    with torch.cuda.device(dev):
        err = lib.lives_stateful_sweep(
            packed.data_ptr(), src_ids.data_ptr(), plan.ops.data_ptr(),
            plan.ops.shape[0], plan.slot_rows.data_ptr(),
            plan.slot_vals.data_ptr(), plan.slot_rows.shape[0],
            plan.taps.data_ptr(), plan.taps.shape[0], table(first),
            table([p[0] for p in pairs]), table([p[1] for p in pairs]), n,
            out.data_ptr(), plan.n_tracks, B, H, W, plan.halo, sx, sy,
            geom.tile_h, geom.tile_w, geom.run, geom.margin, geom.smem,
            int(plan.full), stream)
    _check(lib, err, "launch")
    LAUNCHES += 1
    for s, (i, _, _) in enumerate(plan.state_steps):
        new_states[i] = pairs[s][(B - 1) % 2]
    return out, new_states
