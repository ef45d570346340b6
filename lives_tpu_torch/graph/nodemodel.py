"""Plan compiler: `SinkSpec`, `GenSlot`, `FrameGraph.run` and
`FrameGraph.run_batch`.

Counterpart of `lives_tpu/graph/nodemodel.py:53` (`SinkSpec`), `:82-88`
(`GenSlot`), `:264-356` (`FrameGraph.run`) and `:363-860`
(`FrameGraph.run_batch`, `_make_frame_fn`). A chunk of frames
arrives as one packed ``(P+2, B)`` float32 upload (every traced parameter
row in the order of `nodemodel.py:402-407`, then timecodes and frame
numbers) and takes one of these routes on the source's device:

(a) the fused sweep kernel (`graph/fused_sweep.py`), when the source is the
    synthetic source and a stateless chain and the sink are inside the
    kernel's contract;
(b) the plain batched chain (`run_chain`): tracks are generated as
    ``(B, C, H, W)`` tensors (or arrive as decoded layers) and every effect
    runs in float32 over the whole chunk, which mirrors the JAX package's
    XLA path. Over decoded RGB24 layers, under
    `pref("pallas_composite") == "1"`, the chain's leading point effects
    first run as the composite kernel (`graph/composite.py`, u8 after every
    stage, `nodemodel.py:486-506,588-610,723-736`) and the rest of the chain
    reads its comp as track 0; the sink step resizes or letterboxes,
    converts gamma and palette (`_to_sink`);
(c) a stateful chain (`nodemodel.py:409-485,611-719`): three phases, a
    prefix sweep (the kernel in comp-out mode over the leading stateless
    run) -> a Python frame loop over the stateful middle at B=1, standing
    in for `lax.scan` (without a prefix, each frame's tracks are generated
    inside the loop) -> a suffix sweep (the kernel in comp-in mode over the
    trailing point ops, then the sink quantise). Under
    `pref("fused_stateful") == "1"` a chain the fused stateful sweep holds
    runs that kernel instead (`graph/stateful_sweep.py`), one launch a
    chunk. A materialised source runs the frame loop over the whole chain.

State lives on the graph (`FrameGraph.states`, one entry per instance, in
the JAX package's state contract), made at the frame geometry on the first
chunk and written back to each `inst.state` after every chunk;
`states_from_numpy`/`states_to_numpy` carry it between the packages.

The single-frame live path, `FrameGraph.run` (`nodemodel.py:82-88,
264-356`), applies the chain to one frame: entries are Layers, bare
`GeneratorClip`s (generated on the graph's clock) or `GenSlot(clip, n)`s
(generated on the clip's clock), each generated in the slot it holds;
every traced scalar rides in one (P+2, 1) float32 column (the host numbers
in one upload through pinned memory, so the host is not held; a device
value copied in on the device, never read back). The frame takes one of
two routes:

(d) the live sweep kernel (`graph/live_sweep.py`), one launch a frame,
    when the device is CUDA, every entry is a bare `GeneratorClip` or a
    `GenSlot` of plasma or colour_bars at one geometry (no decoded layer),
    the graph has no cconx and no stateful instance, every enabled
    instance is a point op of the sweep's op table (no stencil) writing
    track 0, and the sink is RGB24 and SRGB at the tracks' geometry or
    none. The JAX package jits the whole frame into one program, which
    XLA fuses; this kernel is the port's fusion of the plans it takes.
    `PLAIN_FRAMES` counts the frames of generators alone on a CUDA device
    that it did not take.
(e) otherwise the tracks are generated in their slots (or arrive as
    layers) and the chain goes through `run_chain` at B = 1, eagerly.

PyTorch runs eagerly, so the JAX package's jitted plan template becomes a
cached plan: `_PLANS` maps the template key of `nodemodel.py:507` to the
sweep kernel's op table on the device (route a), to None or the composite
kernel's `CompositePlan` (route b), or to a `StatefulRoute` of op tables
(route c); and ("live", a configuration key of `run`, the device) to the
live sweep's `LivePlan` or None (routes d and e). A plan never holds
state. The
inter-stage comps are float32 (the JAX package's bf16 comp is a TPU
bandwidth choice).

A graph's `cconx` (`nodemodel.py:110-131`) wires alpha out-channels into
later instances' alpha in-channels: (src_idx, out_channel, dst_idx,
in_slot) edges over the chain, forward only, validated at construction.
`run_chain` carries each frame's exported channels to their destinations
(`nodemodel.py:811-829`). The wiring is part of every plan key, and a
graph with cconx takes none of the kernels' routes, as in the JAX package
(`nodemodel.py:436,488`): no fused sweep, no composite kernel, no fused
stateful sweep; its chain runs on route (b) or, stateful, through the
frame loop over the whole chain.
"""

from __future__ import annotations

import dataclasses
import numbers
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..constants import Gamma, Palette, has_alpha, is_rgb_palette
from ..diagnostics import span
from ..effects.host import STATIC_KINDS as _STATIC_KINDS
from ..effects.host import (FILTER_STATEFUL, FrameContext, Instance,
                            apply_instance)
from ..effects.host import split_params as _split_params
from ..layer import Layer
from ..ops.colorspace import convert_layer
from ..ops.gamma import gamma_convert_layer
from ..ops.resize import letterbox_layer, resize_layer
from ..prefs import pref
from ..utils.transfer import pack_column
from . import composite, fused_sweep, live_sweep, stateful_sweep

#: process-wide plans, keyed like the JAX package's plan templates:
#: the sweep kernel's SweepPlan (route a), None (route b) or a
#: StatefulRoute (route c); the live sweep's LivePlan (route d) or None
#: (route e)
_PLANS: dict = {}

#: chunks of a traceable source that ran a stateless chain on the plain
#: route (b) since the count was last set to 0: the fused sweep did not
#: take the chain, its source or its sink
PLAIN_CHUNKS = 0

#: `FrameGraph.run` calls on a CUDA device whose entries were all
#: generators but which ran eagerly (route e) since the count was last set
#: to 0: the live sweep did not take the chain, a generator, the sink or
#: the cconx; with `live_sweep.LAUNCHES` it gives the route's share
PLAIN_FRAMES = 0


@dataclass(frozen=True)
class StatefulRoute:
    """Route (c) of a stateful chain: the fused stateful sweep's plan, or
    the prefix and suffix sweeps around the frame loop (None where the
    route has no such phase)."""
    sf: Any = None
    pre: Any = None
    suf: Any = None

    @property
    def npre(self) -> int:
        return len(self.pre.chain_spec) if self.pre is not None else 0

    @property
    def nsuf(self) -> int:
        return len(self.suf.chain_spec) if self.suf is not None else 0


@dataclass(frozen=True)
class SinkSpec:
    """Output requirements (display / encoder / stream sink)."""
    width: int = 0            # 0 = keep source geometry
    height: int = 0
    palette: int = Palette.RGB24
    gamma: int = Gamma.SRGB
    letterbox: bool = False
    method: str = "smooth"

    def key(self):
        return dataclasses.astuple(self)


@dataclass(frozen=True)
class GenSlot:
    """A (GeneratorClip, frame number) pair for `FrameGraph.run`: the
    clip's frame n, generated in its slot on the clip's own clock
    (tc = n / clip.fps), as `clip.get_frame(n)` makes it."""
    clip: Any
    n: int


def _chain_static_key(chain: Sequence[Instance]):
    parts = []
    for inst in chain:
        static, _ = _split_params(inst)
        parts.append((inst.filter.hashname, tuple(sorted(static.items())),
                      inst.in_tracks, inst.out_tracks, inst.enabled,
                      inst.filter.flags))
    return tuple(parts)


def chain_spec_of(chain: Sequence[Instance]) -> list[tuple]:
    """(filter, static values, in_tracks, out_tracks, enabled) per instance,
    the form the sweep kernel's encoder and `run_chain` read."""
    out = []
    for inst in chain:
        static, _ = _split_params(inst)
        out.append((inst.filter, static, tuple(inst.in_tracks),
                    tuple(inst.out_tracks), inst.enabled))
    return out


def pack_params(traced_params: Sequence[dict], tcs, frames):
    """(packed (P+2, B) float32 host array, rows_key): every traced
    parameter stream, rows ordered by (instance, sorted name)
    (`nodemodel.py:402-407`), then timecodes and frame numbers. Frame
    numbers ride as f32, exact to 2^24."""
    rows = [(i, k) for i, d in enumerate(traced_params) for k in sorted(d)]
    packed = np.stack(
        [np.asarray(traced_params[i][k], np.float32) for i, k in rows]
        + [np.asarray(tcs, np.float32), np.asarray(frames, np.float32)])
    return packed, tuple(rows)


def _to_sink(out: Layer, sink: SinkSpec, geometry: bool = True) -> Layer:
    """The sink step (`lives_tpu/graph/nodemodel.py:247-261`): letterbox or
    resize to the sink's geometry (unless `geometry` is False), then gamma,
    then palette."""
    if geometry and sink.width and sink.height and \
            (out.width, out.height) != (sink.width, sink.height):
        if sink.letterbox:
            out = letterbox_layer(out, sink.width, sink.height,
                                  method=sink.method)
        else:
            out = resize_layer(out, sink.width, sink.height,
                               method=sink.method)
    if out.gamma != sink.gamma:
        out = gamma_convert_layer(out, sink.gamma)
    if out.palette != sink.palette:
        out = convert_layer(out, sink.palette)
    return out


def run_chain(chain_spec: Sequence[tuple], layers: Sequence[Layer | None],
              packed: torch.Tensor, rows_key: Sequence[tuple], fps: float,
              sink: SinkSpec, *, idx_base: int = 0,
              states: list | None = None, float_chain: bool | None = None,
              emit_comp: bool = False, origin: tuple | None = None,
              cconx: Sequence[tuple] = (), batched: bool = False) -> Layer:
    """Route (b): a chain over batched track layers.

    `packed` (P+2, B) float32 holds the traced rows named by `rows_key`
    ((instance index, param name) each, chain_spec[0] being instance
    `idx_base`), then timecodes and frame numbers. Chains of two or more
    effects run on float32 layers (`float_chain` overrides), converted once
    at entry and quantised once at the sink (`nodemodel.py:785-807`);
    `emit_comp` returns the f32 comp instead of the sink's frames
    (`:831-840`). `states` (one entry per instance) is updated in place
    with each stateful instance's new state. `origin=(y0, full_h, full_w)`
    says the layers are rows [y0, y0 + h) of a full_h x full_w frame (a
    band, with its halo): the effects see the frame's geometry and their
    rows' place in it, and the sink step is pointwise only (gamma,
    palette), since the frame's geometry belongs to the caller
    (`nodemodel.py:773-783,841-847`). `cconx` edges (over chain indices,
    chain_spec[0] being `idx_base`) hand each alpha out-channel an
    instance exports to the alpha in-slots of the later instances wired
    to it, within the call (`nodemodel.py:811-829`). `batched` marks
    the call as the JAX package's batch plan (`run_batch`), which XLA
    fuses otherwise than a one-frame plan (`FrameContext.batched`)."""
    tps: list[dict[str, Any]] = [dict() for _ in chain_spec]
    for r, (i, k) in enumerate(rows_key):
        if 0 <= i - idx_base < len(chain_spec):
            tps[i - idx_base][k] = packed[r]
    tc, frame = packed[-2], packed[-1].to(torch.int32)
    lead = next((l for l in layers if l is not None), None)
    w0 = lead.width if lead is not None else sink.width
    h0 = lead.height if lead is not None else sink.height
    if origin is not None:
        y0, full_h, full_w = origin
        ctx = FrameContext(tc=tc, frame=frame, fps=fps, width=full_w,
                           height=full_h, y0=y0, device=packed.device,
                           batched=batched)
    else:
        ctx = FrameContext(tc=tc, frame=frame, fps=fps,
                           width=w0 or sink.width, height=h0 or sink.height,
                           device=packed.device, batched=batched)
    layers = list(layers)
    if float_chain is None:
        float_chain = len(chain_spec) >= 2
    if float_chain:
        layers = [convert_layer(l, Palette.RGBAFLOAT if has_alpha(l.palette)
                                else Palette.RGBFLOAT)
                  if l is not None and is_rgb_palette(l.palette) else l
                  for l in layers]
    if not layers:
        layers = [None]
    alpha_store: dict[tuple[int, str], Layer] = {}
    for j, ((filt, static, in_tr, out_tr, enabled), tp) in enumerate(
            zip(chain_spec, tps)):
        i = j + idx_base
        a_ins = {slot: alpha_store[(si, name)]
                 for (si, name, di, slot) in cconx
                 if di == i and (si, name) in alpha_store} or None
        inst = Instance(filter=filt, values={**static, **tp}, enabled=enabled,
                        in_tracks=in_tr, out_tracks=out_tr,
                        state=states[j] if states is not None else None)
        with span("lives.fx.", filt.name):
            layers = apply_instance(inst, layers, ctx, alpha_ins=a_ins)
        if states is not None:
            states[j] = inst.state
        for name, lay in inst.out_channels.items():
            alpha_store[(i, name)] = lay
    if emit_comp:
        return convert_layer(layers[0], Palette.RGBFLOAT)
    with span("lives.sink"):
        return _to_sink(layers[0], sink, geometry=origin is None)


def source_frames(source, src_ids: torch.Tensor, chain_spec):
    """frame b -> the track layers of frame b, generated inside the frame
    loop (`nodemodel.py:685-709`): (1, C, H, W) each, only the tracks the
    chain reads (track 0 always), None for the rest."""
    used = {0} | {t for (filt, _, in_tr, _, enabled) in chain_spec
                  if enabled for t in in_tr[: filt.n_in]}

    def frame(b):
        return [source.traced_layer(src_ids[0, t, b:b + 1],
                                    src_ids[1, t, b:b + 1])
                if t in used else None for t in range(src_ids.shape[1])]
    return frame


def frame_loop(chain_spec, start: int, stop: int, frame_layers, B: int,
               packed: torch.Tensor, rows_key, fps: float, sink: SinkSpec,
               states: list, emit_comp: bool = False,
               cconx: Sequence[tuple] = ()):
    """The stateful middle, frame by frame: instances [start, stop) of the
    chain run at B=1 on `frame_layers(b)`, with frame b's columns of
    `packed`, threading `states` (one entry per chain instance) from frame
    to frame, as `lax.scan` does in the JAX package (`nodemodel.py:
    644-719`). Returns (the chunk's Layer, new states list)."""
    sub = list(chain_spec[start:stop])
    st = list(states[start:stop])
    outs = [run_chain(sub, frame_layers(b), packed[:, b:b + 1], rows_key,
                      fps, sink, idx_base=start, states=st,
                      emit_comp=emit_comp, cconx=cconx, batched=True)
            for b in range(B)]
    planes = tuple(torch.cat([o.planes[i] for o in outs])
                   for i in range(len(outs[0].planes)))
    return (outs[0].replace(planes=planes),
            list(states[:start]) + st + list(states[stop:]))


def states_from_numpy(chain: Sequence[Instance], states: Sequence,
                      device: torch.device | str) -> list:
    """The JAX package's `FrameGraph.states` (per instance: None, an
    array, a dict such as rgb_delay's {"ring", "head"}, or a compound's
    tuple of its steps' states) as host numpy arrays -> the port's, on
    `device`."""
    if len(states) != len(chain):
        raise ValueError(f"{len(states)} states for {len(chain)} instances")

    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, tuple):   # a compound's steps' states
            return tuple(conv(x) for x in v)
        return torch.from_numpy(np.array(v)).to(device)
    out = []
    for inst, st in zip(chain, states):
        if st is not None and not inst.filter.flags & FILTER_STATEFUL:
            raise ValueError(f"{inst.filter.name} holds no state")
        out.append(conv(st))
    return out


def states_to_numpy(states: Sequence) -> list:
    """The port's states -> host numpy arrays, in the JAX package's
    contract (the inverse of `states_from_numpy`)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v.detach().cpu().numpy()
    return [conv(st) for st in states]


def _one_frame(layer: Layer) -> Layer:
    """A frame's Layer as a batch of one: (1, ...) planes."""
    return layer.replace(planes=tuple(p.unsqueeze(0) for p in layer.planes))


def _copy_state(st):
    """A copy of one instance's state (None, a tensor, or a dict or tuple
    of them) that an in-place write cannot reach."""
    if isinstance(st, torch.Tensor):
        return st.clone()
    if isinstance(st, dict):
        return {k: _copy_state(v) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(_copy_state(v) for v in st)
    return st


def composite_prefix(prefix_spec, n_avail: int):
    """(prefix, comp_tracks) for the composite kernel: a track the stack
    lacks clamps to track 0, as `apply_instance`'s short-stack rule reads
    it, and comp_tracks is the highest track read, plus one
    (`nodemodel.py:591-605`)."""
    out, maxtrack = [], 0
    for filt, static, in_tr, out_tr, enabled in prefix_spec:
        in_tr = tuple(t if t < n_avail else 0 for t in in_tr)
        out.append((filt, static, in_tr, out_tr, enabled))
        maxtrack = max([maxtrack, *in_tr])
    return out, maxtrack + 1


class FrameGraph:
    """A (chain, sink) configuration rendered one frame at a time or over
    frame batches.

    Usage:
        g = FrameGraph(chain, sink, fps=30.0)
        out = g.run([fg_clip, layer], tc=0.04, frame=1)
        out = g.run_batch([], tcs, frames, params, source=src,
                          src_args=(clip_ids, frame_nums))
    """

    def __init__(self, chain: Sequence[Instance], sink: SinkSpec | None = None,
                 fps: float = 25.0, cconx: Sequence[tuple] = ()):
        """`cconx`: alpha-channel wiring (reference cconx,
        effects-data.c:1730) as (src_idx, out_channel_name, dst_idx,
        in_slot) edges over chain indices, run forward (src_idx <
        dst_idx), the channel named among the source's alpha_outs, the
        slot among the destination's alpha_ins (`nodemodel.py:110-131`)."""
        self.chain = list(chain)
        self.cconx = tuple(tuple(c) for c in cconx)
        for (si, name, di, slot) in self.cconx:
            if not si < di:
                raise ValueError(
                    f"cconx edge {si}->{di} must run forward in the chain "
                    "(effects apply in key order; a backward edge would "
                    "read a frame-stale channel)")
            if not any(t.name == name
                       for t in self.chain[si].filter.alpha_outs):
                raise KeyError(f"{self.chain[si].filter.name}: no alpha "
                               f"out-channel {name!r}")
            if not 0 <= slot < len(self.chain[di].filter.alpha_ins):
                raise IndexError(f"{self.chain[di].filter.name}: no alpha "
                                 f"in-channel slot {slot}")
        self.sink = sink or SinkSpec()
        self.fps = fps
        self.states: list[Any] = [inst.state for inst in self.chain]
        #: calls of `run` by configuration key
        self.stats: dict[Any, int] = {}

    @property
    def has_stateful(self) -> bool:
        return any(inst.filter.flags & FILTER_STATEFUL
                   for inst in self.chain)

    @staticmethod
    def _is_genclip(obj) -> bool:
        """A GeneratorClip (or a GenSlot around one) whose frames are
        generated inside `run`: a stateless generator filter
        (`nodemodel.py:264-278`)."""
        if isinstance(obj, GenSlot):
            obj = obj.clip  # the wrapped clip must itself qualify
        inst = getattr(obj, "inst", None)
        return (inst is not None and hasattr(obj, "get_frame")
                and inst.filter.is_generator
                and not (inst.filter.flags & FILTER_STATEFUL))

    def run(self, layers: Sequence, tc: float = 0.0, frame: int = 0,
            mirror_state: bool = True, *, device=None) -> Layer:
        """One plan cycle on one frame (`nodemodel.py:280-356`).

        Entries of `layers` are one-frame Layers (planes without a batch
        axis), bare GeneratorClips, generated on the graph's clock (tc and
        frame as given), or `GenSlot(clip, n)`s, generated on the clip's
        clock (tc = n / clip.fps, frame n), as `clip.get_frame(n)` would;
        each is generated in the slot it holds. A GenSlot around a
        stateful or non-generator clip raises ValueError. `device` is needed
        only when no layer or clip gives one (a chain that starts with a
        generator instance).

        The chain's traced params, then each generator's, then each
        generator's (tc, frame), then (tc, frame) make one (P+2, 1) float32
        column (`nodemodel.py:311-339`): the host numbers go to the device
        in one upload, and a value that is already a device tensor is
        copied into its row on the device, never read back. Frame numbers
        ride as float32, exact to 2^24. The frame runs as one launch of the
        live sweep kernel where route (d) takes it (a fresh u8 frame each
        call), else through `run_chain` at B = 1. Nothing here waits on the
        device. With `mirror_state` the chain's new
        states are kept on the graph and its instances; without it they are
        dropped, and the states the call started from stay as they were
        (it runs on copies, since rgb_delay writes its ring in place).
        Returns a one-frame Layer with the planes the JAX package's `run`
        returns: no batch axis."""
        with span("lives.frame"):
            return self._run(layers, tc, frame, mirror_state, device)

    def _run(self, layers, tc, frame, mirror_state, device) -> Layer:
        gens, real = [], []          # gens: (slot, clip, n or None)
        for i, lay in enumerate(layers):
            if self._is_genclip(lay):
                gens.append((i, lay.clip, lay.n) if isinstance(lay, GenSlot)
                            else (i, lay, None))
            elif isinstance(lay, GenSlot):
                raise ValueError(
                    "GenSlot wraps a stateful/non-generator clip; pull its "
                    "frames via get_frame instead")
            else:
                real.append(lay)
        if device is None:
            device = (real[0].device if real else
                      gens[0][1].device if gens else None)
        if device is None:
            raise ValueError("FrameGraph.run: no layer or clip to take a "
                             "device from; pass device=")
        with span("lives.frame.pack"):
            traced = [_split_params(inst)[1] for inst in self.chain]
            gen_traced = [_split_params(c.inst)[1] for _, c, _ in gens]
            # keyed as the JAX package keys its templates: a value that is
            # not a host number makes another configuration
            packable = all(isinstance(v, numbers.Number)
                           for d in (*traced, *gen_traced)
                           for v in d.values())
            key = (_chain_static_key(self.chain), self.cconx,
                   tuple(l.config for l in real), self.sink.key(), self.fps,
                   tuple((i, c.inst.filter.hashname, c.width, c.height,
                          n is None,
                          tuple(sorted(_split_params(c.inst)[0].items())))
                         for i, c, n in gens), packable)
            self.stats[key] = self.stats.get(key, 0) + 1
            vals = [d[k] for d in (*traced, *gen_traced) for k in sorted(d)]
            for _, c, n in gens:
                vals += [tc, frame] if n is None else [n / (c.fps or 25.0),
                                                       n]
            packed = pack_column(vals + [tc, frame], device)
            rows_key = tuple((i, k) for i, d in enumerate(traced)
                             for k in sorted(d))
        plan = self._live_plan(key, [c for _, c, _ in gens], real, rows_key,
                               device)
        if plan is not None:
            with span("lives.frame.launch"):
                u8 = live_sweep.live_sweep(plan, packed)
            return Layer(planes=(u8,), palette=int(Palette.RGB24),
                         gamma=self.sink.gamma)
        if torch.device(device).type == "cuda" and gens and not real:
            global PLAIN_FRAMES
            PLAIN_FRAMES += 1
        r = len(rows_key)
        t0 = r + sum(len(d) for d in gen_traced)
        made = {}
        for g, (slot, clip, _) in enumerate(gens):
            names = sorted(gen_traced[g])
            # no clamp: get_frame does not clamp, and the two must agree
            made[slot] = clip.generate(
                dict(zip(names, packed[r:r + len(names)])),
                packed[t0 + 2 * g], packed[t0 + 2 * g + 1],
                getattr(clip, "fps", self.fps) or self.fps)
            r += len(names)
        real_it = iter(real)
        lays = [made[i] if i in made else _one_frame(next(real_it))
                for i in range(len(real) + len(gens))]
        states = list(self.states) if mirror_state else \
            [_copy_state(st) for st in self.states]
        out = run_chain(chain_spec_of(self.chain), lays, packed, rows_key,
                        self.fps, self.sink, states=states, cconx=self.cconx)
        if mirror_state:
            self.states = states
            for inst, st in zip(self.chain, states):
                inst.state = st
        return out.replace(planes=tuple(p[0] for p in out.planes))

    def _live_plan(self, key, clips, real, rows_key, device):
        """Route (d)'s rule and plan for configuration `key` of `run`: the
        live sweep's LivePlan, built once, where the device is CUDA, the
        entries are the generator `clips` alone (no `real` layer), the graph
        has no cconx and `live_sweep.encode_live` takes the chain, the
        generators and the sink; else None, and the frame runs eagerly."""
        if torch.device(device).type != "cuda" or real or not clips \
                or self.cconx:
            return None
        pkey = ("live", key, str(device))
        if pkey not in _PLANS:
            with span("lives.plan.build"):
                _PLANS[pkey] = live_sweep.build_live_sweep(
                    chain_spec_of(self.chain), clips, rows_key, self.sink,
                    clips[0].height, clips[0].width, device, fps=self.fps)
        return _PLANS[pkey]

    def _route(self, n_tracks: int) -> tuple[int, int, bool]:
        """(pre_n, suf_n, sf_eligible) of a stateful chain over a
        traceable source (`nodemodel.py:444-485`); (0, 0, False) with
        cconx, which keeps the chain off the kernels (`:436`)."""
        if self.cconx:
            return 0, 0, False
        chain = self.chain
        pre_n = suf_n = 0
        cand_s = fused_sweep.sweep_suffix_len(chain)
        if cand_s >= 2:
            suf_n = cand_s
        cand = fused_sweep.sweep_prefix_len(chain)
        # after a fused prefix the loop sees ONLY the comp layer, so the
        # middle must read track 0 alone; the suffix regenerates its other
        # tracks in the kernel
        mid_hi = len(chain) - suf_n
        tail_ok = all(
            tuple(inst.in_tracks[: inst.filter.n_in]) in ((), (0,))
            for inst in chain[cand:mid_hi] if inst.enabled)
        if cand >= 1 and tail_ok:
            pre_n = cand
        elif suf_n:
            # no prefix: the in-loop generation middle still needs its
            # multi-track reads inside the track count
            mid_ok = all(
                max(inst.in_tracks[: inst.filter.n_in], default=0)
                < n_tracks for inst in chain[:mid_hi] if inst.enabled)
            if not mid_ok:
                suf_n = 0
        if pre_n + suf_n > len(chain):
            suf_n = len(chain) - pre_n
        sf = (pref("fused_stateful") == "1"
              and stateful_sweep.stateful_sweep_len(chain))
        return pre_n, suf_n, sf

    def run_batch(self, layers: Sequence[Layer], tcs, frames,
                  traced_params: list[dict] | None = None,
                  source=None, src_args=None) -> Layer:
        """One plan cycle over a frame batch (`nodemodel.py:363`).

        `layers`: per-track Layers with a leading batch axis B, or `[]` with
        a traceable `source` and src_args=(clip_ids (T,B), frame_nums (T,B))
        host arrays, when generation is the plan's LOAD step. `tcs`/`frames`:
        (B,) host arrays. `traced_params`: per-instance dicts of (B,) host
        arrays; default: instance values broadcast over B. The result lies
        on the device of the source or of the layers; a stateful chain's
        state carries over to the next call."""
        with span("lives.plan.batch"):
            return self._run_batch(layers, tcs, frames, traced_params,
                                   source, src_args)

    def _run_batch(self, layers, tcs, frames, traced_params, source,
                   src_args) -> Layer:
        layers = list(layers)
        if source is not None and layers:
            raise ValueError("run_batch: pass layers or a source, not both")
        if source is not None:
            device = source.device
        elif layers:
            device = layers[0].device
        else:
            raise ValueError("run_batch: no layers and no source")
        B = len(tcs)
        if traced_params is None:
            traced_params = [
                {k: np.broadcast_to(np.float32(v), (B,))
                 for k, v in _split_params(inst)[1].items()}
                for inst in self.chain]
        with span("lives.plan.pack"):
            packed_np, rows_key = pack_params(traced_params, tcs, frames)
        with span("lives.plan.upload"):
            # the chunk's one parameter upload
            packed = torch.from_numpy(packed_np).to(device)
            src_dev = None
            if source is not None:
                # int64 clip ids wrap to int32, as in the JAX package
                src_dev = torch.from_numpy(
                    np.stack(src_args).astype(np.int32)).to(device)
        spec = chain_spec_of(self.chain)
        if self.has_stateful:
            return self._run_stateful(spec, layers, packed, rows_key, source,
                                      src_dev, device)
        comp_n = self._composite_len(layers) if source is None else 0
        key = ("batch", _chain_static_key(self.chain), self.cconx,
               tuple(l.config for l in layers), self.sink.key(), self.fps,
               rows_key,
               source.source_key() if source is not None else None,
               tuple(src_dev.shape[:2]) if src_dev is not None else None,
               str(device), comp_n)
        if key not in _PLANS:
            with span("lives.plan.build"):
                plan = None
                if source is not None and not self.cconx:
                    plan = fused_sweep.build_fused_sweep(
                        spec, src_dev.shape[1], source.h, source.w, rows_key,
                        self.fps, source, self.sink, device)
                elif comp_n:
                    plan = composite.build_composite(
                        *composite_prefix(spec[:comp_n], len(layers)),
                        rows_key, self.fps, device)
                _PLANS[key] = plan
        plan = _PLANS[key]
        if isinstance(plan, fused_sweep.SweepPlan):
            with span("lives.plan.launch"):
                u8 = fused_sweep.fused_sweep(plan, src_dev, packed)
            return Layer(planes=(u8,), palette=int(Palette.RGB24),
                         gamma=self.sink.gamma)
        if source is not None:
            global PLAIN_CHUNKS
            PLAIN_CHUNKS += 1
            layers = [source.traced_layer(src_dev[0, t], src_dev[1, t])
                      for t in range(src_dev.shape[1])]
        start = 0
        if plan is not None:
            # the prefix as one kernel over the decoded tracks; its u8 comp
            # replaces track 0 and the chain goes on from instance comp_n
            # (`nodemodel.py:723-736`)
            with span("lives.plan.launch"):
                comp = composite.composite(
                    plan, [l.planes[0] for l in layers[:plan.n_tracks]],
                    packed)
            layers = [Layer(planes=(comp,), palette=int(Palette.RGB24))] \
                + layers[1:]
            start = comp_n
        return run_chain(spec[start:], layers, packed, rows_key, self.fps,
                         self.sink, idx_base=start, cconx=self.cconx,
                         batched=True)

    def _composite_len(self, layers: Sequence[Layer]) -> int:
        """comp_n, the prefix the composite kernel takes over decoded
        layers, or 0 (`nodemodel.py:486-506`): a stateless chain without
        cconx under `pref("pallas_composite") == "1"`, every layer RGB24
        u8 (B, 3, H, W), a splittable prefix of three or more."""
        if pref("pallas_composite") != "1" or not layers or self.cconx:
            return 0
        if not all(l.palette == Palette.RGB24 and l.dtype == torch.uint8
                   and l.planes[0].ndim == 4 for l in layers):
            return 0
        if not composite.supported(layers[0].height, layers[0].width):
            return 0
        n = composite.splittable_prefix(self.chain)
        return n if n >= 3 else 0

    def _run_stateful(self, spec, layers, packed, rows_key, source, src_dev,
                      device) -> Layer:
        """Route (c) (`nodemodel.py:409-485,611-741`)."""
        B = packed.shape[1]
        # states at the FRAME geometry (source dims for in-template tracks:
        # the default SinkSpec is 0x0 and may differ from the source)
        if layers:
            w0, h0, pal0 = layers[0].width, layers[0].height, \
                layers[0].palette
        else:
            w0 = getattr(source, "w", 0) or self.sink.width
            h0 = getattr(source, "h", 0) or self.sink.height
            pal0 = None
        for i, inst in enumerate(self.chain):
            if (inst.filter.flags & FILTER_STATEFUL and self.states[i] is None
                    and inst.filter.init_state is not None):
                self.states[i] = inst.filter.init_state(w0, h0, pal0, device)
        route = (0, 0, False)
        if source is not None:
            route = self._route(src_dev.shape[1])
        key = ("batch", _chain_static_key(self.chain), self.cconx,
               tuple(l.config for l in layers), self.sink.key(), self.fps,
               rows_key,
               source.source_key() if source is not None else None,
               tuple(src_dev.shape[:2]) if src_dev is not None else None,
               str(device), route)
        if key not in _PLANS:
            with span("lives.plan.build"):
                pre_n, suf_n, sf = route
                plans = {}
                if source is not None:
                    args = (src_dev.shape[1], source.h, source.w, rows_key,
                            self.fps, source, self.sink, device)
                    if sf:
                        plans["sf"] = stateful_sweep.build_stateful_sweep(
                            spec, *args)
                    if plans.get("sf") is None and pre_n:
                        plans["pre"] = fused_sweep.build_fused_sweep(
                            spec[:pre_n], *args, emit="comp")
                    if plans.get("sf") is None and suf_n:
                        plans["suf"] = fused_sweep.build_fused_sweep(
                            spec[-suf_n:], *args, consume="comp",
                            idx_base=len(spec) - suf_n)
                _PLANS[key] = StatefulRoute(**plans)
        route = _PLANS[key]
        if route.sf is not None:
            with span("lives.plan.launch"):
                u8, self.states = stateful_sweep.stateful_sweep(
                    route.sf, src_dev, packed, self.states)
            out = Layer(planes=(u8,), palette=int(Palette.RGB24),
                        gamma=self.sink.gamma)
        else:
            start, stop = route.npre, len(spec) - route.nsuf
            if route.pre is not None:
                # generation + the stateless prefix: one kernel, f32 comp
                with span("lives.plan.launch"):
                    comp = fused_sweep.fused_sweep(route.pre, src_dev,
                                                   packed)
                frame_layers = lambda b: [Layer(  # noqa: E731
                    planes=(comp[b:b + 1],), palette=int(Palette.RGBFLOAT))]
            elif source is not None:
                frame_layers = source_frames(source, src_dev,
                                             spec[start:stop])
            else:
                frame_layers = lambda b: [l.replace(  # noqa: E731
                    planes=tuple(p[b:b + 1] for p in l.planes))
                    for l in layers]
            out, self.states = frame_loop(
                spec, start, stop, frame_layers, B, packed, rows_key,
                self.fps, self.sink, self.states,
                emit_comp=route.suf is not None, cconx=self.cconx)
            if route.suf is not None:
                # the suffix: the other tracks regenerated in the kernel,
                # the trailing point ops, the sink quantise
                with span("lives.plan.launch"):
                    u8 = fused_sweep.fused_sweep(route.suf, src_dev, packed,
                                                 out.planes[0])
                out = Layer(planes=(u8,), palette=int(Palette.RGB24),
                            gamma=self.sink.gamma)
        for inst, st in zip(self.chain, self.states):
            inst.state = st
        return out
