"""Compound filters: a fixed sub-chain packaged as one Filter.

Counterpart of `lives_tpu/effects/compound.py:18-194` (reference
`plugins/effects/compound/*`; host support in effects-weed.c's compound
handling). `make_compound` wires sub-filters in series over track 0,
re-exports chosen sub-parameters under new names (`Export`), adds
compound-level parameters (`extra_params`) and wires a step's out-parameter
into a later step's parameter (`connections`). A compound of stateless
filters takes a batch, as they do; a compound with a stateful step is
stateful, its state the tuple of its steps' states, one frame at a time.

`register_builtin_compounds` registers the JAX package's six: dream,
night_vision, comic, vhs (stateful through rgb_delay), and
image_stabilizer and neural_net, which wire an analyser's and the data
plugins' out-params into later steps through `connections`, the
transforms reading a compound-level param and the frame geometry. A
connection's value is a tensor on the frame's device and its transform
stays there.
"""

from __future__ import annotations

from typing import Sequence

from .host import (FILTER_STATEFUL, Filter, Instance, Param, apply_instance,
                   get_filter, register_filter)


class Export:
    """Marks a sub-filter param as exposed on the compound."""

    def __init__(self, name: str):
        self.name = name


def make_compound(name: str, steps: Sequence[tuple[str, dict]],
                  description: str = "",
                  connections: Sequence[tuple] = (),
                  extra_params: Sequence[Param] = ()) -> Filter:
    """steps: [(filter_name, {param: value | Export("exposed_name")})].

    Values fix sub-params; Export(...) re-exports them on the compound.
    `extra_params` are compound-level params a connection's transform may
    read. `connections`: (src_step, out_name, dst_step, in_name[,
    transform]); after src_step runs, its out-param value (through
    `transform(value, params, ctx)` when given) overrides dst_step's
    param. Connections must feed forward."""
    sub_filters = [get_filter(fname) for fname, _ in steps]
    exported: list[Param] = []
    export_map: list[tuple[int, str, str]] = []  # (step, sub_param, name)
    for i, (fname, binds) in enumerate(steps):
        f = sub_filters[i]
        for pname, v in binds.items():
            if isinstance(v, Export):
                src = f.param(pname)
                exported.append(Param(v.name, src.kind, src.default,
                                      src.min, src.max, src.choices))
                export_map.append((i, pname, v.name))

    stateful = any(f.flags & FILTER_STATEFUL for f in sub_filters) \
        or bool(sub_filters[-1].out_params)
    n_in = max(f.n_in for f in sub_filters)
    in_channels = sub_filters[0].in_channels if n_in <= 1 else \
        max((f.in_channels for f in sub_filters), key=len)

    conns = [(c[0], c[1], c[2], c[3], c[4] if len(c) > 4 else None)
             for c in connections]
    for (ss, on, ds, inn, _t) in conns:
        if ds <= ss:
            raise ValueError("connections must feed forward (src < dst)")
        sub_filters[ds].param(inn)  # validate destination
        if not any(q.name == on for q in sub_filters[ss].out_params):
            raise ValueError(
                f"{name}: step {ss} ({sub_filters[ss].name}) has no "
                f"out-param {on!r}")

    def _sub_params(i: int, params: dict, outs, ctx) -> dict:
        out = {p.name: p.default for p in sub_filters[i].params}
        for pname, v in steps[i][1].items():
            if not isinstance(v, Export):
                out[pname] = v
        for (si, sp, en) in export_map:
            if si == i:
                out[sp] = params[en]
        for (ss, on, ds, inn, tf) in conns:
            if ds == i and on in outs[ss]:
                v = outs[ss][on]
                out[inn] = tf(v, params, ctx) if tf is not None else v
        return out

    def _run(ins, params, ctx, state):
        layers = list(ins)
        outs = [{} for _ in sub_filters]
        for i, f in enumerate(sub_filters):
            inst = Instance(filter=f, values=_sub_params(i, params, outs, ctx),
                            state=state[i], in_tracks=tuple(range(f.n_in)))
            layers = apply_instance(inst, layers, ctx)
            outs[i] = inst.out_values
            state[i] = inst.state
        return layers[0], outs[-1]

    def process_stateless(ins, params, ctx):
        return _run(ins, params, ctx, [None] * len(sub_filters))[0]

    def process_stateful(ins, params, ctx, state):
        state = list(state) if state is not None \
            else [None] * len(sub_filters)
        out, last = _run(ins, params, ctx, state)
        if sub_filters[-1].out_params:
            # the compound re-exports its final step's out-params
            return out, tuple(state), last
        return out, tuple(state)

    def init_state(w, h, pal, device):
        return tuple(f.init_state(w, h, pal, device) if f.init_state
                     else None for f in sub_filters)

    return register_filter(Filter(
        name=name,
        process=process_stateful if stateful else process_stateless,
        in_channels=in_channels,
        params=tuple(exported) + tuple(extra_params),
        out_params=sub_filters[-1].out_params if stateful else (),
        flags=FILTER_STATEFUL if stateful else 0,
        init_state=init_state if stateful else None,
        description=description or
        f"compound: {' -> '.join(f.name for f in sub_filters)}"))


def register_builtin_compounds():
    """The stock compounds of `lives_tpu/effects/compound.py:134-194`."""
    from .host import _REGISTRY
    if "dream" in _REGISTRY:
        return
    make_compound("dream", [
        ("gaussian_blur", {"radius": 6, "amount": Export("haze")}),
        ("softlight", {"amount": 0.8}),
        ("saturation", {"saturation": 1.4}),
    ], description="soft hazy glow")
    make_compound("night_vision", [
        ("greyscale", {}),
        ("brightness_contrast", {"brightness": 0.15,
                                 "contrast": Export("gain")}),
        ("tint", {"red": 0.1, "green": 1.0, "blue": 0.2, "amount": 1.0}),
        ("vignette", {"amount": 0.9, "strength": 1.5}),
    ], description="green NV goggles look")
    make_compound("vhs", [
        ("rgb_delay", {"delay_r": 0.0, "delay_g": 1.0, "delay_b": 2.0}),
        ("saturation", {"saturation": Export("colour")}),
        ("motion_blur", {"radius": 3, "amount": 0.5}),
    ], description="chroma-shifted tape look")
    # weed-plugins/scripts/comic.script: comic-book look (edge-boosted
    # posterised colour)
    make_compound("comic", [
        ("posterize", {"levels": 5}),
        ("sharpen", {"radius": 2, "amount": Export("strength")}),
        ("saturation", {"saturation": 1.4}),
    ], description="comic-book look (comic.script)")
    # plugins/effects/compound/image_stabilizer: motion estimate -> EMA
    # smoothing -> counter-shift
    make_compound("image_stabilizer", [
        ("motion_analyser", {}),
        ("integrator", {"decay": 0.95}),
        ("shift", {"dx": 0.0, "dy": 0.0}),
    ], connections=[
        (0, "flow_x", 1, "in0"),
        (0, "flow_y", 1, "in1"),
        # flow is measured on 8x-downsampled luma: x8 to full-res pixels,
        # then to a frame fraction
        (1, "o0", 2, "dx",
         lambda v, p, c: -v * 8.0 * p["strength"] / max(c.width, 1)),
        (1, "o1", 2, "dy",
         lambda v, p, c: -v * 8.0 * p["strength"] / max(c.height, 1)),
    ], extra_params=(Param("strength", "num", 1.0, 0.0, 4.0),),
       description="counter-shift accumulated motion "
                   "(compound/image_stabilizer)")
    # plugins/effects/compound/neural_net: unpack -> evolving net -> sigmoid
    make_compound("neural_net", [
        ("data_unpacker", {"in0": Export("a"), "in1": Export("b"),
                           "in2": Export("c"), "in3": Export("d")}),
        ("nn_programmer", {"fitness": Export("fitness")}),
        ("log_sig", {}),
    ], connections=[
        (0, "o0", 1, "a"), (0, "o1", 1, "b"),
        (0, "o2", 1, "c"), (0, "o3", 1, "d"),
        (1, "o0", 2, "in0"), (1, "o1", 2, "in1"),
        (1, "o2", 2, "in2"), (1, "o3", 2, "in3"),
    ], description="evolving net over unpacked data "
                   "(compound/neural_net)")
