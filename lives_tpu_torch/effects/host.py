"""Effect host: filter classes, instances, palette negotiation, chains.

Counterpart of `lives_tpu/effects/host.py:40-351` (reference
`src/effects-weed.c`). Process functions are plain PyTorch functions on
batched layers: planes are ``(B, C, H, W)`` and a per-frame parameter is a
``(B,)`` tensor, so one call processes a whole chunk of frames where the
JAX package vmaps a single-frame function.

Ported for the render slice: `Param` (with `clamp`), `Filter`, `Instance`,
`FrameContext`, the registry, `negotiate_layer` (palette, size, gamma),
and `apply_instance` with the short-stack rule of `host.py:283-288`.
Stateful filters (`host.py:80-91,136-140,319-331`) take one frame at a
time, ``(1, C, H, W)``: `FrameGraph.run_batch` loops a chunk's frames and
threads the state, where the JAX package scans. A stateful filter's
`init_state(width, height, palette, device)` makes its state at the frame
geometry on first use, and `process(ins, params, ctx, state)` returns
``(out, new_state)``. Alpha in-channels (cconx) and analysers come with
Slice 6 (ROADMAP Queue 1 item 21).

A generator has no input layer to take its device from, so `FrameContext`
carries one (`device`, None by default): `apply_instance` fills it from
the layer stack when the caller left it None, and a generator that runs
without one raises. Nothing picks a device on its own.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

from ..constants import (Palette, has_alpha, is_float_palette,
                         is_rgb_palette, is_yuv_palette)
from ..layer import Layer
from ..ops.colorspace import convert_layer
from ..ops.gamma import gamma_convert_layer
from ..ops.resize import resize_layer

# Filter flags (semantic parity with weed-effects.h:105-114)
FILTER_NON_REALTIME = 1 << 0
FILTER_IS_CONVERTER = 1 << 1
FILTER_STATEFUL = 1 << 2        # carries state between frames
FILTER_IS_TRANSITION = 1 << 3
FILTER_IS_GENERATOR = 1 << 4
FILTER_MAY_RESIZE = 1 << 5


@dataclass(frozen=True)
class ChannelTemplate:
    """Channel template (weed chantmpl)."""
    name: str = "in"
    palettes: tuple[int, ...] | None = None  # None = any
    optional: bool = False
    can_alpha: bool = True


@dataclass(frozen=True)
class Param:
    """Parameter template (weed paramtmpl). On an instance the value may be
    a Python scalar or a ``(B,)`` tensor of per-frame values."""
    name: str
    kind: str = "num"  # num | int | bool | color | string | string_list
    default: Any = 0.0
    min: float = 0.0
    max: float = 1.0
    choices: tuple[str, ...] = ()
    group: int = 0
    label: str = ""

    def clamp(self, v):
        if self.kind in ("num", "int"):
            if isinstance(v, torch.Tensor):
                return torch.clamp(v, self.min, self.max)
            return min(max(v, self.min), self.max)
        return v


@dataclass(frozen=True)
class Filter:
    """A filter class: `process(inputs, params, ctx) -> Layer`, or for a
    stateful filter `process(inputs, params, ctx, state) -> (Layer,
    state)`."""
    name: str
    process: Callable
    in_channels: tuple[ChannelTemplate, ...] = (ChannelTemplate("in"),)
    out_channels: tuple[ChannelTemplate, ...] = (ChannelTemplate("out"),)
    params: tuple[Param, ...] = ()
    flags: int = 0
    # the JAX package's author string, so hashnames (the serialised
    # identity of a filter) are the same in both packages
    author: str = "lives_tpu"
    version: int = 1
    description: str = ""
    # (width, height, palette, device) -> state, for FILTER_STATEFUL
    init_state: Callable | None = None
    preferred_gamma: int | None = None

    @property
    def hashname(self) -> str:
        """Registry key (reference hashnames, effects-weed.c:10605)."""
        return f"{self.name}|{self.author}|{self.version}"

    @property
    def is_transition(self) -> bool:
        return bool(self.flags & FILTER_IS_TRANSITION)

    @property
    def is_generator(self) -> bool:
        return bool(self.flags & FILTER_IS_GENERATOR) or not self.in_channels

    @property
    def n_in(self) -> int:
        return len(self.in_channels)

    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"{self.name}: no param {name!r}")


@dataclass
class Instance:
    """A filter instance: filter + current param values
    (weed_instance_from_filter, effects-weed.c:6299)."""
    filter: Filter
    values: dict[str, Any] = field(default_factory=dict)
    state: Any = None
    enabled: bool = True
    in_tracks: tuple[int, ...] = (0,)
    out_tracks: tuple[int, ...] = (0,)

    def param_values(self) -> dict[str, Any]:
        return {p.name: self.values.get(p.name, p.default)
                for p in self.filter.params}

    def set(self, **kw) -> "Instance":
        for k, v in kw.items():
            self.filter.param(k)  # validate
            self.values[k] = v
        return self


#: parameter kinds fixed at plan time: they never ride in a packed upload
#: (`lives_tpu/graph/nodemodel.py:77`)
STATIC_KINDS = ("int", "string", "string_list", "bool", "color")


def split_params(inst: Instance):
    """(static_values, traced_values) for an instance: a traced value rides
    in the packed upload, a static one shapes the plan."""
    static, traced = {}, {}
    for p in inst.filter.params:
        v = inst.values.get(p.name, p.default)
        if p.kind in STATIC_KINDS:
            static[p.name] = v
        else:
            traced[p.name] = v
    return static, traced


@dataclass(frozen=True)
class FrameContext:
    """Per-frame info handed to process fns. `tc`/`frame` may be ``(B,)``
    tensors. width/height are the FULL frame dims; (y0, x0) is the origin
    of a tile inside it (0 for a whole frame). `device` is where a
    generator makes its frame."""
    tc: Any = 0.0
    frame: Any = 0
    fps: float = 25.0
    width: int = 0
    height: int = 0
    y0: int = 0
    x0: int = 0
    device: Any = None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Filter] = {}


def register_filter(f: Filter) -> Filter:
    _REGISTRY[f.name] = f
    return f


def get_filter(name: str) -> Filter:
    _ensure_builtins()
    return _REGISTRY[name]


def list_filters() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


_BUILTINS_LOADED = False


def _ensure_builtins():
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        _BUILTINS_LOADED = True
        from . import builtin  # noqa: F401  (registers on import)


def instantiate(name_or_filter, **values) -> Instance:
    f = name_or_filter if isinstance(name_or_filter, Filter) \
        else get_filter(name_or_filter)
    inst = Instance(filter=f, in_tracks=tuple(range(max(f.n_in, 1))))
    if values:
        inst.set(**values)
    return inst


# ---------------------------------------------------------------------------
# Application: negotiation + dispatch
# ---------------------------------------------------------------------------

def negotiate_layer(layer: Layer, tmpl: ChannelTemplate,
                    width: int | None = None, height: int | None = None,
                    gamma: int | None = None) -> Layer:
    """Convert a layer to a palette the template accepts, then to the
    size and gamma asked for (`lives_tpu/effects/host.py:228-262`). Float
    RGB layers satisfy integer RGB templates directly (a precision
    superset), which keeps the chain in float between effects; otherwise
    the target stays in the layer's colour family where the template
    allows."""
    if (tmpl.palettes and is_float_palette(layer.palette)
            and is_rgb_palette(layer.palette)
            and any(is_rgb_palette(p) for p in tmpl.palettes)):
        need_alpha = all(has_alpha(p) for p in tmpl.palettes
                         if is_rgb_palette(p))
        if need_alpha and not has_alpha(layer.palette):
            layer = convert_layer(layer, Palette.RGBAFLOAT)
    elif tmpl.palettes and layer.palette not in tmpl.palettes:
        pals = tmpl.palettes
        if is_rgb_palette(layer.palette):
            target = next((p for p in pals if is_rgb_palette(p)), pals[0])
        elif is_yuv_palette(layer.palette):
            target = next((p for p in pals if is_yuv_palette(p)), pals[0])
        else:
            target = pals[0]
        layer = convert_layer(layer, target)
    if width and height and (layer.width, layer.height) != (width, height):
        layer = resize_layer(layer, width, height)
    if gamma is not None and layer.gamma != gamma:
        layer = gamma_convert_layer(layer, gamma)
    return layer


def apply_instance(inst: Instance, layers: Sequence[Layer],
                   ctx: FrameContext | None = None) -> list[Layer]:
    """Apply one instance to a layer stack; returns the new stack
    (`lives_tpu/effects/host.py:265`, weed_apply_instance). inst.in_tracks
    selects the inputs; the result replaces the layer at out_tracks[0]. A
    stateful instance takes one frame, creates its state on first use at
    the input's geometry and device, and stores the new state in
    inst.state. A ctx without a device takes the stack's."""
    f = inst.filter
    layers = list(layers)
    if not inst.enabled:
        return layers
    # missing tracks fall back to the front layer (the reference drops or
    # reuses tracks when a multi-input filter has fewer layers than
    # channels)
    ins = [layers[t] if t < len(layers) and layers[t] is not None
           else layers[0]
           for t in inst.in_tracks[: f.n_in]] if f.n_in else []
    if ins:
        w, h = ins[0].width, ins[0].height
        ins = [negotiate_layer(l, f.in_channels[min(i, f.n_in - 1)], w, h,
                               f.preferred_gamma)
               for i, l in enumerate(ins)]
    if ctx is None:
        ctx = FrameContext(width=ins[0].width if ins else 0,
                           height=ins[0].height if ins else 0)
    if ctx.device is None:
        lead = next((l for l in layers if l is not None), None)
        if lead is not None:
            ctx = dataclasses.replace(ctx, device=lead.device)
    params = {k: f.param(k).clamp(v) for k, v in inst.param_values().items()}
    if f.flags & FILTER_STATEFUL:
        lead = ins[0] if ins else None
        if lead is not None and lead.planes[0].shape[0] != 1:
            raise ValueError(f"{f.name}: a stateful filter takes one frame "
                             f"at a time, got {lead.planes[0].shape[0]}")
        state = inst.state
        if state is None and f.init_state is not None:
            # a stateful generator: the frame's geometry and the ctx's device
            state = (f.init_state(lead.width, lead.height, lead.palette,
                                  lead.device) if lead is not None else
                     f.init_state(ctx.width, ctx.height, None, ctx.device))
        out, inst.state = f.process(ins, params, ctx, state)
    else:
        out = f.process(ins, params, ctx)
    outs = out if isinstance(out, (list, tuple)) else [out]
    for t, o in zip(inst.out_tracks, outs):
        while len(layers) <= t:
            layers.append(None)
        layers[t] = o
    return layers
