"""Plan compiler, batch form: `SinkSpec` and `FrameGraph.run_batch`.

Counterpart of `lives_tpu/graph/nodemodel.py:53` (`SinkSpec`) and `:363`
(`FrameGraph.run_batch`), for stateless chains. A chunk of frames arrives
as one packed ``(P+2, B)`` float32 upload (every traced parameter row in
the order of `nodemodel.py:402-407`, then timecodes and frame numbers) and
takes one of two routes on the source's device:

(a) the fused sweep kernel (`graph/fused_sweep.py`), when the source is the
    synthetic source and the chain and sink are inside the kernel's
    contract;
(b) the plain batched chain (`run_chain`): tracks are generated as
    ``(B, C, H, W)`` tensors and every effect runs in float32 over the
    whole chunk, which mirrors the JAX package's XLA path.

PyTorch runs eagerly, so the JAX package's jitted plan template becomes a
cached plan: `_PLANS` maps the template key of `nodemodel.py:507` to the
sweep kernel's op table on the device (route a) or to None (route b). The
inter-stage comps are float32 (the JAX package's bf16 comp is a TPU
bandwidth choice). Stateful chains, cconx wiring and the single-frame
`FrameGraph.run` raise `NotImplementedError` naming the ROADMAP item that
brings them; nothing quietly runs another path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..constants import Gamma, Palette, has_alpha, is_rgb_palette
from ..effects.host import (FILTER_STATEFUL, FrameContext, Instance,
                            apply_instance)
from ..layer import Layer
from ..ops.colorspace import convert_layer
from . import fused_sweep

_STATIC_KINDS = ("int", "string", "string_list", "bool", "color")

#: process-wide plans, keyed like the JAX package's plan templates:
#: the sweep kernel's SweepPlan (route a) or None (route b)
_PLANS: dict = {}


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


def _split_params(inst: Instance):
    """(static_values, traced_values) for an instance."""
    static, traced = {}, {}
    for p in inst.filter.params:
        v = inst.values.get(p.name, p.default)
        if p.kind in _STATIC_KINDS:
            static[p.name] = v
        else:
            traced[p.name] = v
    return static, traced


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


def _to_sink(out: Layer, sink: SinkSpec) -> Layer:
    """The sink step (`lives_tpu/graph/nodemodel.py:247`): geometry, gamma,
    palette. Only the palette step is ported."""
    if sink.width and sink.height and \
            (out.width, out.height) != (sink.width, sink.height):
        raise NotImplementedError(
            "sink resize/letterbox is not ported yet (ROADMAP Queue 1 "
            "item 11)")
    if out.gamma != sink.gamma:
        raise NotImplementedError(
            "sink gamma conversion is not ported yet (ROADMAP Queue 1 "
            "item 11)")
    if out.palette != sink.palette:
        out = convert_layer(out, sink.palette)
    return out


def run_chain(chain_spec: Sequence[tuple], layers: Sequence[Layer],
              packed: torch.Tensor, rows_key: Sequence[tuple], fps: float,
              sink: SinkSpec) -> Layer:
    """Route (b): a stateless chain over batched track layers.

    `packed` (P+2, B) float32 holds the traced rows named by `rows_key`
    ((instance index, param name) each), then timecodes and frame numbers.
    Chains of two or more effects run on float32 layers, converted once at
    entry and quantised once at the sink (`nodemodel.py:785-807`)."""
    tps: list[dict[str, Any]] = [dict() for _ in chain_spec]
    for r, (i, k) in enumerate(rows_key):
        tps[i][k] = packed[r]
    tc, frame = packed[-2], packed[-1].to(torch.int32)
    w0 = layers[0].width if layers else sink.width
    h0 = layers[0].height if layers else sink.height
    ctx = FrameContext(tc=tc, frame=frame, fps=fps, width=w0 or sink.width,
                       height=h0 or sink.height)
    layers = list(layers)
    if len(chain_spec) >= 2:
        layers = [convert_layer(l, Palette.RGBAFLOAT if has_alpha(l.palette)
                                else Palette.RGBFLOAT)
                  if is_rgb_palette(l.palette) else l for l in layers]
    if not layers:
        layers = [None]
    for (filt, static, in_tr, out_tr, enabled), tp in zip(chain_spec, tps):
        inst = Instance(filter=filt, values={**static, **tp}, enabled=enabled,
                        in_tracks=in_tr, out_tracks=out_tr)
        layers = apply_instance(inst, layers, ctx)
    return _to_sink(layers[0], sink)


class FrameGraph:
    """A (chain, sink) configuration rendered over frame batches.

    Usage:
        g = FrameGraph(chain, sink, fps=30.0)
        out = g.run_batch([], tcs, frames, params, source=src,
                          src_args=(clip_ids, frame_nums))
    """

    def __init__(self, chain: Sequence[Instance], sink: SinkSpec | None = None,
                 fps: float = 25.0, cconx: Sequence[tuple] = ()):
        if cconx:
            raise NotImplementedError(
                "cconx channel wiring is not ported yet (ROADMAP Queue 1 "
                "item 21)")
        self.chain = list(chain)
        self.sink = sink or SinkSpec()
        self.fps = fps

    @property
    def has_stateful(self) -> bool:
        return any(inst.filter.flags & FILTER_STATEFUL
                   for inst in self.chain)

    def run(self, *args, **kw):
        raise NotImplementedError(
            "FrameGraph.run (single-frame live path) is not ported yet "
            "(ROADMAP Queue 1 item 12)")

    def run_batch(self, layers: Sequence[Layer], tcs, frames,
                  traced_params: list[dict] | None = None,
                  source=None, src_args=None) -> Layer:
        """One plan cycle over a frame batch (`nodemodel.py:363`).

        `layers`: per-track Layers with a leading batch axis B, or `[]` with
        a traceable `source` and src_args=(clip_ids (T,B), frame_nums (T,B))
        host arrays, when generation is the plan's LOAD step. `tcs`/`frames`:
        (B,) host arrays. `traced_params`: per-instance dicts of (B,) host
        arrays; default: instance values broadcast over B. The result lies
        on the device of the source or of the layers."""
        if self.has_stateful:
            raise NotImplementedError(
                "stateful chains are not ported yet (ROADMAP Queue 1 "
                "items 15-17)")
        layers = list(layers)
        if source is not None and layers:
            raise ValueError("run_batch: pass layers or a source, not both")
        if source is not None:
            device = source.device
        elif layers:
            device = layers[0].device
        else:
            raise ValueError("run_batch: no layers and no source")
        if traced_params is None:
            B = len(tcs)
            traced_params = [
                {k: np.broadcast_to(np.float32(v), (B,))
                 for k, v in _split_params(inst)[1].items()}
                for inst in self.chain]
        packed_np, rows_key = pack_params(traced_params, tcs, frames)
        # the chunk's one parameter upload
        packed = torch.from_numpy(packed_np).to(device)
        src_dev = None
        if source is not None:
            # int64 clip ids wrap to int32, as in the JAX package
            src_dev = torch.from_numpy(
                np.stack(src_args).astype(np.int32)).to(device)
        key = ("batch", _chain_static_key(self.chain),
               tuple(l.config for l in layers), self.sink.key(), self.fps,
               rows_key,
               source.source_key() if source is not None else None,
               tuple(src_dev.shape[:2]) if src_dev is not None else None,
               str(device))
        spec = chain_spec_of(self.chain)
        if key not in _PLANS:
            plan = None
            if source is not None:
                plan = fused_sweep.build_fused_sweep(
                    spec, src_dev.shape[1], source.h, source.w, rows_key,
                    self.fps, source, self.sink, device)
            _PLANS[key] = plan
        plan = _PLANS[key]
        if plan is not None:
            u8 = fused_sweep.fused_sweep(plan, src_dev, packed)
            return Layer(planes=(u8,), palette=int(Palette.RGB24),
                         gamma=self.sink.gamma)
        if source is not None:
            layers = [source.traced_layer(src_dev[0, t], src_dev[1, t])
                      for t in range(src_dev.shape[1])]
        return run_chain(spec, layers, packed, rows_key, self.fps, self.sink)

