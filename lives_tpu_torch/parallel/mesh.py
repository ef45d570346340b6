"""Multi-device rendering: frame-batch DP, spatial bands, a DP x SP grid,
the zero-collective band sweep, a pipeline over the chain, and stateful
chains over row bands.

Counterpart of `lives_tpu/parallel/mesh.py:30-611`. The JAX package is
single-controller: one process holds a `Mesh` of devices and `shard_map`
runs a body on each. The port keeps that model without `shard_map`: a
`Mesh` is an explicit, ordered tuple of `torch.device`s over named axes,
and each function here runs its per-device work in a Python loop, one call
per mesh entry on that entry's device, then gathers the result on
`mesh.devices[0]`. CUDA launches are asynchronous, so entries on distinct
cards overlap; an entry may repeat a device, and then its calls run in
turn on that card, each band at its true place in the frame. What the JAX
package's `ppermute` moves over ICI (a neighbour band's edge rows) is a
slice of the neighbour's tensor copied with `.to(device, non_blocking=
True)`.

- `frame_mesh`, `grid_mesh`, `shard_layer_batch`, `sharded_batch_fn`:
  frame-batch DP (`mesh.py:30-56`).
- `spatial_blur_sharded`: the halo-exchange demonstration (`:63-96`).
- `chain_band_halo`, `spatial_batch_fn`, `grid_batch_fn`: the chain over
  H-bands of decoded layers with halo rows from the neighbours (`:99-244`).
- `spatial_sweep_fn`: the band sweep (`:247-318`), K1's band mode on every
  band; each band generates its own halo, so no rows move between devices.
- `pipeline_chain_fn`: GPipe over the chain's stages (`:325-425`).
- `BAND_SAFE_STATEFUL`, `chain_band_halo_stateful`, `spatial_stateful_fn`:
  stateful chains over row bands, frames and state planes extended by
  their neighbours' rows every frame (`:428-611`).

A band's halo stops at the frame's edges: an edge band reads no rows past
the frame, and every effect pads there as it pads a whole frame, so a band
computes what the whole frame computes for its rows, with any number of
stencils. (The JAX package replicates the edge row into the halo instead,
which agrees for chains of at most one stencil.)
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..constants import Palette
from ..effects.host import FILTER_STATEFUL, FrameContext
from ..graph.fused_sweep import (STENCILS, VOCABULARY, build_fused_sweep,
                                 fused_sweep)
from ..graph.nodemodel import (_split_params, chain_spec_of, pack_params,
                               run_chain)
from ..layer import Layer


class Mesh:
    """Devices laid out over named axes, row-major (the last axis varies
    fastest), as `jax.sharding.Mesh` lays out its device array.
    `mesh.shape[axis]` is an axis's length. An entry may repeat a device.
    Only CUDA and CPU devices are taken."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Sequence[int] | None = None):
        devs = tuple(torch.device(d) for d in devices)
        names = tuple(axis_names)
        shape = tuple(shape) if shape is not None else (len(devs),)
        if not devs or len(shape) != len(names) \
                or math.prod(shape) != len(devs):
            raise ValueError(f"{len(devs)} devices cannot form a mesh of "
                             f"shape {shape} over axes {names}")
        for d in devs:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"no kernels for {d}: a mesh holds CUDA "
                                 "or CPU devices")
        self.devices = devs
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    def device(self, **index: int) -> torch.device:
        """The device at one index per axis (0 for an axis not named)."""
        flat = 0
        for a in self.axis_names:
            flat = flat * self.shape[a] + index.get(a, 0)
        return self.devices[flat]

    def axis_devices(self, axis: str, **index: int) -> list[torch.device]:
        """The devices along `axis`, the other axes at `index` (0 when not
        named)."""
        return [self.device(**{**index, axis: i})
                for i in range(self.shape[axis])]


def frame_mesh(devices: Sequence, axis: str = "b") -> Mesh:
    """1-D mesh over the frame-batch (or spatial) axis of `devices`."""
    return Mesh(devices, (axis,))


def grid_mesh(devices: Sequence, n_batch: int, n_spatial: int,
              batch_axis: str = "b", spatial_axis: str = "s") -> Mesh:
    """2-D mesh, frame-batch DP x H-axis bands, over n_batch * n_spatial
    `devices` in row-major order."""
    if len(devices) != n_batch * n_spatial:
        raise ValueError(f"a {n_batch}x{n_spatial} grid needs "
                         f"{n_batch * n_spatial} devices, got {len(devices)}")
    return Mesh(devices, (batch_axis, spatial_axis), (n_batch, n_spatial))


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`; a copy to a card does not wait for the host."""
    return t.to(dev, non_blocking=dev.type == "cuda")


def _gather(parts: Sequence[torch.Tensor], dev: torch.device,
            dim: int) -> torch.Tensor:
    return torch.cat([_to(p, dev) for p in parts], dim)


def _meta(layer: Layer) -> dict:
    return dict(palette=layer.palette, clamping=layer.clamping,
                sampling=layer.sampling, subspace=layer.subspace,
                gamma=layer.gamma)


def _default_params(graph, B: int) -> list[dict]:
    """Each instance's traced values broadcast over the B frames."""
    return [{k: np.broadcast_to(np.float32(v), (B,))
             for k, v in _split_params(inst)[1].items()}
            for inst in graph.chain]


def shard_layer_batch(layer: Layer, mesh: Mesh, axis: str = "b"
                      ) -> list[Layer]:
    """A batched Layer (leading B axis on its planes) cut into one Layer
    per entry along `axis`, each on that entry's device."""
    devs = mesh.axis_devices(axis)
    B = layer.planes[0].shape[0]
    if B % len(devs):
        raise ValueError(f"batch {B} must divide axis {axis!r} of "
                         f"{len(devs)}")
    b = B // len(devs)
    return [layer.replace(planes=tuple(_to(p[i * b:(i + 1) * b], d)
                                       for p in layer.planes))
            for i, d in enumerate(devs)]


def _states_to(states: list, dev: torch.device) -> list:
    return [_rebuild(st, iter([_to(l, dev) for l in _leaves(st)]))
            for st in states]


def sharded_batch_fn(graph, mesh: Mesh, axis: str = "b"):
    """`FrameGraph.run_batch` with the frame batch cut over `axis`: each
    shard runs on its device (the plan cache keys plans by device), and
    the shards' frames are gathered on `mesh.devices[0]`. A stateful
    chain's frames depend on the frame before, so its shards run in frame
    order, the state handed from each device to the next."""
    devs = mesh.axis_devices(axis)

    def run(layers: Sequence[Layer], tcs, frames, params=None) -> Layer:
        tcs, frames = np.asarray(tcs), np.asarray(frames)
        B = len(tcs)
        if B % len(devs):
            raise ValueError(f"batch {B} must divide axis {axis!r} of "
                             f"{len(devs)}")
        b = B // len(devs)
        shards = [shard_layer_batch(l, mesh, axis) for l in layers]
        outs = []
        for i, dev in enumerate(devs):
            cut = slice(i * b, (i + 1) * b)
            p_i = None if params is None else [
                {k: np.broadcast_to(np.asarray(v, np.float32), (B,))[cut]
                 for k, v in d.items()} for d in params]
            if graph.has_stateful:
                graph.states = _states_to(graph.states, dev)
            outs.append(graph.run_batch([s[i] for s in shards], tcs[cut],
                                        frames[cut], p_i))
        if graph.has_stateful:
            graph.states = _states_to(graph.states, devs[0])
            for inst, st in zip(graph.chain, graph.states):
                inst.state = st
        return outs[0].replace(planes=tuple(
            _gather([o.planes[k] for o in outs], devs[0], 0)
            for k in range(len(outs[0].planes))))
    return run


# ---------------------------------------------------------------------------
# Spatial bands with halo rows from the neighbours
# ---------------------------------------------------------------------------

def _band_rows(si: int, Hl: int, H: int, R: int) -> tuple[int, int]:
    """Rows [lo, hi) of band si extended by R halo rows, cut at the
    frame's edges."""
    return max(si * Hl - R, 0), min((si + 1) * Hl + R, H)


def _extend(bands: Sequence[torch.Tensor], si: int, top: int, bot: int,
            dev: torch.device) -> torch.Tensor:
    """Band si (rows on axis -2) with the last `top` rows of band si-1 above
    it and the first `bot` rows of band si+1 below, on `dev`."""
    if not top and not bot:
        return bands[si]
    parts = [_to(bands[si - 1][..., -top:, :], dev)] if top else []
    parts.append(bands[si])
    if bot:
        parts.append(_to(bands[si + 1][..., :bot, :], dev))
    return torch.cat(parts, -2)


def spatial_blur_sharded(img: torch.Tensor, mesh: Mesh, radius: int = 2,
                         axis: str = "b") -> torch.Tensor:
    """Vertical box blur of a (C,H,W) image cut into H-bands over `axis`;
    each band reads `radius` rows of its neighbours, and the frame's edges
    repeat their row. The building block of banded processing, as
    `mesh.py:63-96`."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    C, H, W = img.shape
    if H % n or H // n < radius:
        raise ValueError(f"H={H} must divide into {n} bands of at least "
                         f"{radius} rows")
    Hl, k = H // n, 2 * radius + 1
    bands = [_to(img[:, i * Hl:(i + 1) * Hl], d) for i, d in enumerate(devs)]
    outs = []
    for i, d in enumerate(devs):
        x = bands[i]
        top = (_to(bands[i - 1][:, -radius:], d) if i
               else x[:, :1].expand(C, radius, W))
        bot = (_to(bands[i + 1][:, :radius], d) if i < n - 1
               else x[:, -1:].expand(C, radius, W))
        ext = torch.cat([top, x, bot], 1).to(torch.float32)
        cs = torch.cat([torch.zeros_like(ext[:, :1]), ext.cumsum(1)], 1)
        out = (cs[:, k:] - cs[:, :-k]) / float(k)
        outs.append(out.to(img.dtype) if img.is_floating_point()
                    else torch.clamp(out + 0.5, 0, 255).to(img.dtype))
    return _gather(outs, devs[0], 1)


def chain_band_halo(graph) -> int:
    """The summed stencil radius of a FrameGraph's chain, checking that
    every enabled effect is band-safe: pointwise, pointwise in its frame
    coordinates (`ctx_grid`), or a separable stencil. Raises ValueError
    otherwise, and for a stateful chain (`spatial_stateful_fn` takes
    those)."""
    R = 0
    for inst in graph.chain:
        if not inst.enabled:
            continue
        name = inst.filter.name
        if name in STENCILS:
            static, _ = _split_params(inst)
            dflt = inst.filter.param("radius").default
            R += max(1, int(static.get("radius", dflt)))
        elif name not in VOCABULARY:
            raise ValueError(
                f"{name!r} is not band-safe for spatial sharding")
    if graph.has_stateful:
        raise ValueError("stateful chains cannot spatially shard")
    return R


def _band_batch_fn(graph, mesh: Mesh, spatial_axis: str,
                   batch_axis: str | None):
    """spatial_batch_fn and grid_batch_fn: the chain over H-bands of every
    track (each band extended by the chain's halo from its neighbours,
    effects placed in the frame by `run_chain(origin=...)`), and with
    `batch_axis`, the frame batch cut over that axis too."""
    R = chain_band_halo(graph)
    ns = mesh.shape[spatial_axis]
    nb = mesh.shape[batch_axis] if batch_axis else 1
    sink = graph.sink
    spec = chain_spec_of(graph.chain)

    def run(layers: Sequence[Layer], tcs, frames, params=None) -> Layer:
        B = len(np.asarray(tcs))
        H, W = layers[0].height, layers[0].width
        if B % nb:
            raise ValueError(f"batch {B} must divide dp axis {nb}")
        if sink.width not in (0, W) or sink.height not in (0, H):
            raise ValueError("spatial sharding requires a same-geometry sink")
        if H % ns or H // ns < max(R, 1):
            raise ValueError(f"H={H} does not cut into {ns} bands of at "
                             f"least the halo {max(R, 1)}")
        Hl, Bl = H // ns, B // nb
        packed_np, rows_key = pack_params(
            params if params is not None else _default_params(graph, B),
            tcs, frames)
        metas = [_meta(l) for l in layers]
        rows_out = []
        for bi in range(nb):
            at = {batch_axis: bi} if batch_axis else {}
            devs = mesh.axis_devices(spatial_axis, **at)
            fr = slice(bi * Bl, (bi + 1) * Bl)
            bands = [[_to(l.planes[0][fr, :, si * Hl:(si + 1) * Hl], d)
                      for si, d in enumerate(devs)] for l in layers]
            outs = []
            for si, d in enumerate(devs):
                lo, hi = _band_rows(si, Hl, H, R)
                top, bot = si * Hl - lo, hi - (si + 1) * Hl
                ext = [Layer(planes=(_extend(bt, si, top, bot, d),), **m)
                       for bt, m in zip(bands, metas)]
                packed = torch.from_numpy(
                    np.ascontiguousarray(packed_np[:, fr])).to(d)
                out = run_chain(spec, ext, packed, rows_key, graph.fps,
                                sink, origin=(lo, H, W))
                outs.append(out.planes[0][..., top:top + Hl, :])
            rows_out.append(_gather(outs, mesh.devices[0], -2))
        out = _gather(rows_out, mesh.devices[0], 0)
        return Layer(planes=(out,), palette=sink.palette, gamma=sink.gamma)

    return run


def spatial_batch_fn(graph, mesh: Mesh, axis: str = "b"):
    """A FrameGraph's batch over H-bands of every (B,C,H,W) track plane:
    band i on the mesh's entry i, extended by the chain's halo from its
    neighbours, coordinate effects at their true frame rows
    (`FrameContext.y0`). The sink must keep the source geometry. Returns
    run(layers, tcs, frames, params=None) -> Layer."""
    return _band_batch_fn(graph, mesh, spatial_axis=axis, batch_axis=None)


def grid_batch_fn(graph, mesh: Mesh, batch_axis: str = "b",
                  spatial_axis: str = "s"):
    """spatial_batch_fn on a 2-D (dp x sp) mesh: the frame batch cut over
    `batch_axis`, each frame's rows over `spatial_axis`."""
    return _band_batch_fn(graph, mesh, spatial_axis=spatial_axis,
                          batch_axis=batch_axis)


def _as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    # int64 clip ids wrap to int32, as run_batch wraps them
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).astype(np_dtype)))


def spatial_sweep_fn(graph, mesh: Mesh, source, B: int, H: int, W: int,
                     axis: str = "s"):
    """The band sweep: K1's band mode (`graph.fused_sweep`, `band_h = H /
    n`) on each of the n bands along `axis`, band i (rows [i*band_h,
    (i+1)*band_h)) on the axis's entry i, the bands gathered on
    `mesh.devices[0]`. The source is a function of the pixel's frame
    coordinates, so every band generates its own halo and nothing moves
    between devices until the gather; a band is bit-identical to those
    rows of the whole-frame kernel.

    Returns run(src_ids (2,T,B) int32, packed (P+2,B) f32) -> (B,3,H,W)
    u8, or None when H does not divide into the bands. run returns None
    when the chain, the source or the sink does not qualify for the kernel,
    decided before any launch (the caller then takes spatial_batch_fn).
    On CUDA tensors it launches the kernel or raises; on CPU tensors the
    kernel's plain version runs."""
    ns = mesh.shape[axis]
    if H % ns:
        return None
    band_h = H // ns
    devs = mesh.axis_devices(axis)
    spec = chain_spec_of(graph.chain)
    rows_key = tuple((i, k) for i, inst in enumerate(graph.chain)
                     for k in sorted(_split_params(inst)[1]))
    plans: dict = {}

    def run(src_ids, packed):
        ids = _as_tensor(src_ids, torch.int32)
        pk = _as_tensor(packed, torch.float32)
        if ids.ndim != 3 or ids.shape[2] != B:
            raise ValueError(f"src_ids {tuple(ids.shape)}, want (2, T, {B})")
        T = ids.shape[1]
        for d in devs:
            key = (T, str(d))
            if key not in plans:
                plans[key] = build_fused_sweep(
                    spec, T, H, W, rows_key, graph.fps, source, graph.sink,
                    d, band_h=band_h)
            if plans[key] is None:
                return None
        outs = [fused_sweep(plans[(T, str(d))], _to(ids, d), _to(pk, d),
                            y0=i * band_h) for i, d in enumerate(devs)]
        return _gather(outs, devs[0], 2)

    return run


# ---------------------------------------------------------------------------
# Pipeline parallelism over the effect chain
# ---------------------------------------------------------------------------

def pipeline_chain_fn(instances, mesh: Mesh, axis: str = "b"):
    """GPipe over an effect chain: stage d (instances[d], None for the
    identity) lives on the mesh's entry d. At each step every stage applies
    its effect to the frame it holds, then hands it to the next stage's
    device; frame i enters stage 0 at step i and leaves the last stage at
    step i + n - 1, so the stages work on different frames at once.
    Stages keep geometry and palette and hold no state. Returns
    run(batch (B,C,H,W) float32, tcs (B,)) -> (B,C,H,W) on
    `mesh.devices[0]`, equal to the chain applied in sequence."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if len(instances) != n:
        raise ValueError(f"need {n} stages (got {len(instances)}); "
                         "pad with None")
    for inst in instances:
        if inst is not None and (inst.filter.flags & FILTER_STATEFUL
                                 or inst.filter.n_in != 1):
            raise ValueError(f"{inst.filter.name!r}: a pipeline stage "
                             "takes one input and holds no state")

    def stage(inst, a: torch.Tensor, t: float) -> torch.Tensor:
        if inst is None:
            return a
        ctx = FrameContext(tc=t, frame=0, fps=25.0, width=a.shape[-1],
                           height=a.shape[-2])
        out = inst.filter.process(
            [Layer(planes=(a,), palette=int(Palette.RGBFLOAT))],
            inst.param_values(), ctx)
        if isinstance(out, (tuple, list)):
            out = out[0]
        return (out.planes[0] if hasattr(out, "planes") else out).to(a.dtype)

    def run(batch, tcs) -> torch.Tensor:
        batch = _as_tensor(batch, torch.float32)
        tcs = [float(t) for t in np.asarray(tcs, np.float32)]
        B = batch.shape[0]
        held: list = [None] * n  # (frame index, frame) each stage holds
        out = [None] * B
        for step in range(B + n - 1):
            # the last stage first, so each stage hands on last step's frame
            for d in reversed(range(n)):
                if d == 0:
                    src = (step, batch[step:step + 1]) if step < B else None
                else:
                    src = held[d - 1]
                if src is None:
                    held[d] = None
                    continue
                i, x = src
                held[d] = (i, stage(instances[d], _to(x, devs[d]), tcs[i]))
            if held[n - 1] is not None:
                i, y = held[n - 1]
                out[i] = _to(y, devs[0])
        return torch.cat(out, 0)

    return run


# ---------------------------------------------------------------------------
# Stateful chains over row bands
# ---------------------------------------------------------------------------

#: spatially shardable stateful filters -> band halo radius (rows the step
#: reads beyond its own). Ring and ghost filters are pointwise in space
#: (0); fire and life read one row. Global warps (feedback, vertigo,
#: blurzoom) and cursor writers (onedtv) are not band-safe.
BAND_SAFE_STATEFUL = {"fire": 1, "life": 1, "alien_overlay": 0,
                      "rgb_delay": 0, "nervous": 0}


def chain_band_halo_stateful(graph) -> int:
    """The summed read radius of a stateful chain, checking that every
    enabled effect is band-safe; raises ValueError otherwise, and for a
    stencil (a stencil's value at a frame edge row would feed the next
    stateful step's shift)."""
    R = 0
    for inst in graph.chain:
        if not inst.enabled:
            continue
        name = inst.filter.name
        if inst.filter.flags & FILTER_STATEFUL:
            if name not in BAND_SAFE_STATEFUL:
                raise ValueError(
                    f"{name!r} is not band-safe for spatial sharding")
            R += BAND_SAFE_STATEFUL[name]
        elif name in STENCILS:
            raise ValueError(
                "stencils are not supported in spatially-sharded "
                f"STATEFUL chains ({name!r}); run blur before the "
                "recording or use the fused stateful sweep")
        elif name not in VOCABULARY:
            raise ValueError(
                f"{name!r} is not band-safe for spatial sharding")
    return R


def _leaves(st) -> list:
    """The tensors of one instance's state (None, a tensor, or a dict of
    them), in a fixed order."""
    if st is None:
        return []
    if isinstance(st, dict):
        return [l for k in sorted(st) for l in _leaves(st[k])]
    return [st]


def _rebuild(st, leaves):
    """`st`'s structure with its tensors taken from the iterator
    `leaves`."""
    if st is None:
        return None
    if isinstance(st, dict):
        return {k: _rebuild(st[k], leaves) for k in sorted(st)}
    return next(leaves)


def spatial_stateful_fn(graph, mesh: Mesh, axis: str = "b"):
    """A stateful chain over row bands: band i of every frame and of every
    state plane (a state tensor whose second-minor axis is the frame's
    height) lives on the axis's entry i; other state tensors (a ring's
    head) are replicated, one copy a band. Frames run in order; before
    each, every band's input rows and state planes are extended by R rows
    of its neighbours' (R, the chain's summed read radius), so a band
    computes exactly the whole frame's rows and state. Each band works on
    its own copies, so `rgb_delay`'s in-place ring write and the head's
    advance happen once a frame in every band.

    Returns run(layers, tcs, frames, params=None) -> Layer ((B,C,H,W) on
    `mesh.devices[0]`); the new state, whole again on `mesh.devices[0]`,
    is written to `graph.states` and each instance, and carries into the
    next call."""
    R = chain_band_halo_stateful(graph)
    devs = mesh.axis_devices(axis)
    ns = len(devs)
    sink = graph.sink
    spec = chain_spec_of(graph.chain)

    def run(layers: Sequence[Layer], tcs, frames, params=None) -> Layer:
        B = len(np.asarray(tcs))
        H, W = layers[0].height, layers[0].width
        if sink.width not in (0, W) or sink.height not in (0, H):
            raise ValueError(
                "spatial sharding requires a same-geometry sink")
        if H % ns or (H // ns) < max(R, 1):
            raise ValueError(f"H={H} unshardable over {ns} bands"
                             f" (halo {R})")
        Hl = H // ns
        # states at the frame geometry on first use (run_batch's rule)
        for i, inst in enumerate(graph.chain):
            if (inst.filter.flags & FILTER_STATEFUL
                    and graph.states[i] is None
                    and inst.filter.init_state is not None):
                graph.states[i] = inst.filter.init_state(W, H, None, devs[0])
        template = list(graph.states)
        flat = [l for st in template for l in _leaves(st)]
        rowwise = [l.ndim >= 2 and l.shape[-2] == H for l in flat]
        # each band's own copy of its rows of every state plane and of
        # every replicated tensor
        carry = [[(l[..., si * Hl:(si + 1) * Hl, :] if m else l)
                  .to(d, copy=True) for l, m in zip(flat, rowwise)]
                 for si, d in enumerate(devs)]
        packed_np, rows_key = pack_params(
            params if params is not None else _default_params(graph, B),
            tcs, frames)
        packs = [torch.from_numpy(packed_np).to(d) for d in devs]
        metas = [_meta(l) for l in layers]
        bands = [[_to(l.planes[0][:, :, si * Hl:(si + 1) * Hl], d)
                  for si, d in enumerate(devs)] for l in layers]
        outs: list[list] = [[] for _ in devs]
        for b in range(B):
            new_carry = []
            for si, d in enumerate(devs):
                lo, hi = _band_rows(si, Hl, H, R)
                top, bot = si * Hl - lo, hi - (si + 1) * Hl
                lyrs = [Layer(planes=(_extend([x[b:b + 1] for x in bt], si,
                                              top, bot, d),), **m)
                        for bt, m in zip(bands, metas)]
                ext = [_extend([c[j] for c in carry], si, top, bot, d)
                       if m else carry[si][j]
                       for j, m in enumerate(rowwise)]
                it = iter(ext)
                states = [_rebuild(st, it) for st in template]
                out = run_chain(spec, lyrs, packs[si][:, b:b + 1], rows_key,
                                graph.fps, sink, states=states,
                                origin=(lo, H, W))
                outs[si].append(out.planes[0][..., top:top + Hl, :])
                new = [l for st in states for l in _leaves(st)]
                new_carry.append([l[..., top:top + Hl, :] if m else l
                                  for l, m in zip(new, rowwise)])
            carry = new_carry
        whole = [_gather([c[j] for c in carry], devs[0], -2) if m
                 else _to(carry[0][j], devs[0])
                 for j, m in enumerate(rowwise)]
        it = iter(whole)
        graph.states = [_rebuild(st, it) for st in template]
        for inst, st in zip(graph.chain, graph.states):
            inst.state = st
        out = _gather([torch.cat(o, 0) for o in outs], devs[0], -2)
        return Layer(planes=(out,), palette=sink.palette, gamma=sink.gamma)

    return run
