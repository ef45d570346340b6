"""Data connections: analyser out-params into downstream in-params (pconx)
and alpha out-channels into downstream alpha in-channels (cconx).

Counterpart of `lives_tpu/effects/data.py:1-205` (reference
`src/effects-data.c`: `pconx_chain_data`, `cconx_new` :1730,
`cconx_add_connection` :2106, `cconx_chain_data` :2283). Connections hold
the Instance objects themselves. `autoscale` maps the source's declared
out-param range onto the destination param's [min, max]; an `ACTIVATE`
destination toggles the instance instead of a parameter.

An out-value is a tensor on the layers' device (or a number): pushing it
into a parameter stays on the device, so `chain_data` never reads one
back to the host. A tensor value cannot toggle an instance (`ACTIVATE`):
the JAX package skips array values there (`data.py:117-119`), and so does
the port. A channel connection's layer is negotiated at the destination
by `apply_instance(..., alpha_ins=)`; inside a `FrameGraph` the same
wiring is the graph's `cconx` (graph/nodemodel.py).

`save_datacons` writes the JAX package's `datacons.map` byte for byte
(`"lives_tpu_datacons"`, version 2), and `load_datacons` reads either
package's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Sequence

from .host import FrameContext, Instance, apply_instance

ACTIVATE = "__activate__"  # special in-param: enables/disables the instance


@dataclass
class Connection:
    src: Instance
    out_param: str
    dst: Instance
    in_param: str
    autoscale: bool = False


@dataclass
class ChannelConnection:
    """Alpha out-channel -> alpha in-channel slot (lives_cconnect_t)."""
    src: Instance
    out_channel: str      # name of a template in src.filter.alpha_outs
    dst: Instance
    in_slot: int          # index into dst.filter.alpha_ins


class DataConnections:
    """The datacons map: out-param connections (`conns`) and channel
    connections (`chan_conns`)."""

    def __init__(self):
        self.conns: list[Connection] = []
        self.chan_conns: list[ChannelConnection] = []

    def add(self, src: Instance, out_param: str, dst: Instance,
            in_param: str, autoscale: bool = False) -> Connection:
        if in_param != ACTIVATE:
            dst.filter.param(in_param)  # validate
        c = Connection(src, out_param, dst, in_param, autoscale)
        self.conns.append(c)
        return c

    def add_channel(self, src: Instance, out_channel: str, dst: Instance,
                    in_slot: int) -> ChannelConnection:
        """An in-channel slot accepts one source, so a connection to
        (dst, in_slot) replaces the one there (cconx_add_connection_private,
        effects-data.c:1982)."""
        if not any(t.name == out_channel for t in src.filter.alpha_outs):
            raise KeyError(f"{src.filter.name}: no alpha out-channel "
                           f"{out_channel!r}")
        if not 0 <= in_slot < len(dst.filter.alpha_ins):
            raise IndexError(f"{dst.filter.name}: no alpha in-channel slot "
                             f"{in_slot}")
        self.chan_conns = [c for c in self.chan_conns
                           if not (c.dst is dst and c.in_slot == in_slot)]
        c = ChannelConnection(src, out_channel, dst, in_slot)
        self.chan_conns.append(c)
        return c

    def remove(self, c):
        if isinstance(c, ChannelConnection):
            self.chan_conns.remove(c)
        else:
            self.conns.remove(c)

    def prune(self, live: set[int]) -> int:
        """Drop connections whose endpoints are no longer live instances
        (`live` holds their id()s); returns the number removed."""
        before = len(self.conns) + len(self.chan_conns)
        self.conns = [c for c in self.conns
                      if id(c.src) in live and id(c.dst) in live]
        self.chan_conns = [c for c in self.chan_conns
                           if id(c.src) in live and id(c.dst) in live]
        return before - len(self.conns) - len(self.chan_conns)

    def alpha_ins_for(self, dst: Instance) -> dict[int, Any]:
        """The connected alpha layers of a destination, by slot: the most
        recent Layer each source exported (cconx_chain_data)."""
        out = {}
        for c in self.chan_conns:
            if c.dst is dst and c.out_channel in c.src.out_channels:
                out[c.in_slot] = c.src.out_channels[c.out_channel]
        return out

    def chain_data(self, dst: Instance):
        """Push connected source out-values into dst (pconx_chain_data),
        on the values' device."""
        for c in self.conns:
            if c.dst is not dst or c.out_param not in c.src.out_values:
                continue
            v = c.src.out_values[c.out_param]
            if c.in_param == ACTIVATE:
                if not hasattr(v, "shape"):
                    dst.enabled = bool(v)
                continue
            p = dst.filter.param(c.in_param)
            if c.autoscale:
                src_p = next((q for q in c.src.filter.out_params
                              if q.name == c.out_param), None)
                if src_p is not None and src_p.max > src_p.min:
                    v = (v - src_p.min) / (src_p.max - src_p.min) \
                        * (p.max - p.min) + p.min
            dst.values[c.in_param] = p.clamp(v)


def save_datacons(conns: DataConnections, keymap, path):
    """Persist connections keyed by (key, mode) slots, as the JAX package
    writes them (`data.py:133-166`); a connection whose endpoint is not
    a keymap instance is left out."""
    def slot_of(inst):
        for k, cand in enumerate(keymap.instances):
            if cand is inst:
                return k, keymap.mode[k]
        return None

    out = []
    for c in conns.conns:
        src, dst = slot_of(c.src), slot_of(c.dst)
        if src is None or dst is None:
            continue
        out.append({"src_key": src[0], "src_mode": src[1],
                    "out_param": c.out_param,
                    "dst_key": dst[0], "dst_mode": dst[1],
                    "in_param": c.in_param, "autoscale": c.autoscale})
    chans = []
    for c in conns.chan_conns:
        src, dst = slot_of(c.src), slot_of(c.dst)
        if src is None or dst is None:
            continue
        chans.append({"src_key": src[0], "src_mode": src[1],
                      "out_channel": c.out_channel,
                      "dst_key": dst[0], "dst_mode": dst[1],
                      "in_slot": c.in_slot})
    with open(path, "w") as fh:
        json.dump({"format": "lives_tpu_datacons", "version": 2,
                   "connections": out, "channel_connections": chans},
                  fh, indent=1)


def load_datacons(keymap, path) -> DataConnections:
    """Rebuild connections against a keymap, instantiating the filters of
    slots that have no instance yet (`data.py:169-192`)."""
    with open(path) as fh:
        d = json.load(fh)
    conns = DataConnections()

    def endpoints(c):
        for k in (c["src_key"], c["dst_key"]):
            if keymap.instances[k] is None:
                keymap.toggle(k, True)
                keymap.toggle(k, False)  # instantiate without enabling
        return keymap.instances[c["src_key"]], keymap.instances[c["dst_key"]]

    for c in d["connections"]:
        src, dst = endpoints(c)
        if src is None or dst is None:
            continue
        conns.add(src, c["out_param"], dst, c["in_param"], c["autoscale"])
    for c in d.get("channel_connections", ()):
        src, dst = endpoints(c)
        if src is None or dst is None:
            continue
        conns.add_channel(src, c["out_channel"], dst, c["in_slot"])
    return conns


def apply_chain_connected(instances: Sequence[Instance], layers,
                          ctx: FrameContext | None = None,
                          connections: DataConnections | None = None):
    """`apply_chain` with pconx and cconx between the instances
    (`data.py:195-205`)."""
    layers = list(layers)
    for inst in instances:
        alpha = None
        if connections is not None:
            connections.chain_data(inst)
            alpha = connections.alpha_ins_for(inst) or None
        layers = apply_instance(inst, layers, ctx, alpha_ins=alpha)
    return layers[0]
