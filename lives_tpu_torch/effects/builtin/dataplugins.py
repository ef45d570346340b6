"""Data-plugin family: parameter-stream utilities that wire through data
connections (`effects/data.py`) to automate other filters.

Counterpart of `lives_tpu/effects/builtin/dataplugins.py:49-310`, its
seven filters: data_unpacker (`:49-75`), log_sig (`:80-95`), data_counter
(`:100-148`), nn_programmer (`:153-210`), smoother (`:215-244`),
integrator (`:249-275`) and timer (`:280-310`). Each takes a
pass-through video input; its work is in its out-params.

data_unpacker and log_sig are stateless and take a batch: an in-param is
a number, a (B,) tensor of per-frame values or a (B, k) tensor of k
values a frame, and each out-value is (B,). The five stateful ones take
one frame, report 0-d tensors and keep their states in the JAX package's
contract. Nothing is read back to the host.

nn_programmer draws its initial weights and its per-frame walk with
JAX's threefry through `utils.prng` (`fold_in(PRNGKey(2121), frame)`),
bit for bit. log_sig's sigmoid is `1 / (1 + exp(-x))` with XLA's CPU
`exp` (`utils.xla_exp.expf`); smoother's and integrator's updates are
the FMAs XLA contracts them into (`fma32`).
"""

from __future__ import annotations

import functools

import torch

from ...constants import Palette
from ...utils import prng
from ...utils.xla_exp import expf, fma32
from ..host import (ChannelTemplate, FILTER_STATEFUL, Filter, Param,
                    register_filter)
from .alpha import scalar
from .extra import _frame_device

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)

_N_UNPACK_IN = 8
_N_UNPACK_OUT = 16
_N_SIG = 8
_N_COUNT = 4
_NN_IN = 4
_NN_HIDDEN = 16
_NN_OUT = 4
_N_SMOOTH = 4


def _pass(ins, p, ctx):
    return ins[0] if ins else None


def _columns(v, device) -> torch.Tensor:
    """An in-param as float32 (B or 1, k): a number or a per-frame (B,)
    tensor is one column, a (B, k) tensor k."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.reshape(-1, 1) if t.ndim <= 1 else t.reshape(t.shape[0], -1)


# -- data_unpacker ------------------------------------------------------------

def _unpack_analyse(ins, p, ctx):
    """data_unpacker.c:39 dunpack_process: the inputs' values in order,
    one scalar an out slot, clamped to [-range, range] when `clamp`."""
    dev = _frame_device(ins, ctx)
    cols = [_columns(p[f"in{i}"], dev) for i in range(_N_UNPACK_IN)]
    B = max(c.shape[0] for c in cols)
    flat = torch.cat([c.expand(B, -1) for c in cols], 1)
    rng = _columns(p["range"], dev)
    flat = torch.where(_columns(p["clamp"], dev) > 0.5,
                       torch.clamp(flat, -rng, rng), flat)
    n = min(_N_UNPACK_OUT, flat.shape[1])
    return {f"o{j}": flat[:, j] for j in range(n)}


register_filter(Filter(
    name="data_unpacker", process=_pass, in_channels=_ONE_IN,
    params=tuple(Param(f"in{i}", "num", 0.0, -1e12, 1e12)
                 for i in range(_N_UNPACK_IN))
    + (Param("clamp", "num", 1.0, 0.0, 1.0),
       Param("range", "num", 1.0, 0.0, 1e12)),
    out_params=tuple(Param(f"o{j}", "num", 0.0, -1e12, 1e12)
                     for j in range(_N_UNPACK_OUT)),
    analyse=_unpack_analyse,
    description="flatten array params to scalar outs (data_unpacker.c)"))


# -- log_sig ------------------------------------------------------------------

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA's CPU code computes it: 1 / (1 + exp(-x))
    with its `exp`."""
    return 1.0 / (1.0 + expf(-x))


def _log_sig_analyse(ins, p, ctx):
    """log_sig.c:41 logsig_process: out = 1 / (1 + exp(-in)), the eight
    inputs in one tensor."""
    dev = _frame_device(ins, ctx)
    x = torch.stack(torch.broadcast_tensors(*(
        torch.as_tensor(p[f"in{i}"], dtype=torch.float32, device=dev)
        for i in range(_N_SIG))))
    return dict(zip((f"o{i}" for i in range(_N_SIG)), sigmoid(x).unbind(0)))


register_filter(Filter(
    name="log_sig", process=_pass, in_channels=_ONE_IN,
    params=tuple(Param(f"in{i}", "num", 0.0, -1e12, 1e12)
                 for i in range(_N_SIG)),
    out_params=tuple(Param(f"o{i}", "num", 0.5, 0.0, 1.0)
                     for i in range(_N_SIG)),
    analyse=_log_sig_analyse,
    description="sigmoid squash of in params (log_sig.c)"))


# -- data_counter -------------------------------------------------------------

def _counter_init(w, h, palette, device):
    return {"counts": torch.zeros(_N_COUNT, dtype=torch.int32, device=device),
            "ovals": torch.zeros(_N_COUNT, dtype=torch.bool, device=device),
            "outs": torch.zeros(_N_COUNT, dtype=torch.bool, device=device)}


def _counter_process(ins, p, ctx, state):
    """data_counter.c:61 dcount_process: per slot, count the boolean
    input's transitions (rising and/or falling); after `oncount{j}` of
    them the out flips on, after `offcount{j}` more back off."""
    dev = state["counts"].device
    cur = torch.stack([scalar(p[f"input{j}"], dev) > 0.5
                       for j in range(_N_COUNT)])
    oncnt, offcnt = (torch.stack([
        torch.full((), int(p[f"{kind}count{j}"]), dtype=torch.int32,
                   device=dev) for j in range(_N_COUNT)])
        for kind in ("on", "off"))
    rising = cur & ~state["ovals"]
    falling = ~cur & state["ovals"]
    counted = (rising & (scalar(p["count_rising"], dev) > 0.5)) \
        | (falling & (scalar(p["count_falling"], dev) > 0.5))
    counts = state["counts"] + counted.to(torch.int32)
    target = torch.where(state["outs"], offcnt, oncnt)
    flip = counts >= target
    outs = torch.where(flip, ~state["outs"], state["outs"])
    counts = torch.where(flip, 0, counts).to(torch.int32)
    new_state = {"counts": counts, "ovals": cur, "outs": outs}
    out_values = {f"out{j}": outs[j].to(torch.float32)
                  for j in range(_N_COUNT)}
    return _pass(ins, p, ctx), new_state, out_values


register_filter(Filter(
    name="data_counter", process=_counter_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_counter_init,
    params=tuple(Param(f"input{j}", "num", 0.0, 0.0, 1.0)
                 for j in range(_N_COUNT))
    + tuple(Param(f"oncount{j}", "int", 8, 1, 256)
            for j in range(_N_COUNT))
    + tuple(Param(f"offcount{j}", "int", 8, 1, 256)
            for j in range(_N_COUNT))
    + (Param("count_rising", "num", 1.0, 0.0, 1.0),
       Param("count_falling", "num", 0.0, 0.0, 1.0)),
    out_params=tuple(Param(f"out{j}", "num", 0.0, 0.0, 1.0)
                     for j in range(_N_COUNT)),
    description="boolean transition counters (data_counter.c)"))


# -- nn_programmer ------------------------------------------------------------

def _nn_init(w, h, palette, device):
    k1, k2, k3 = prng.split(prng.prng_key(4242, device), 3)
    return {"w1": prng.uniform(k1, (_NN_HIDDEN, _NN_IN), -1.0, 1.0),
            "w2": prng.uniform(k2, (_NN_OUT, _NN_HIDDEN), -1.0, 1.0),
            "c": prng.uniform(k3, (_NN_HIDDEN + _NN_OUT,), -1.0, 1.0)}


@functools.lru_cache(maxsize=8)
def _walk_key(device: str) -> torch.Tensor:
    """`PRNGKey(2121)` on `device`, made once: the walk's key a frame
    folds its frame number into."""
    return prng.prng_key(2121, device)


def _nn_walk(v, rval):
    """nn_programmer.c:112-136: a bounded random walk, positive steps
    pulling toward +1, negative toward -1, never leaving [-1, 1]."""
    return torch.clamp(v + torch.where(rval > 0, (1.0 - v) * rval,
                                       (1.0 + v) * rval), -1.0, 1.0)


def _nn_process(ins, p, ctx, state):
    """nn_programmer.c: a random 2-layer net over the inputs a..d whose
    weights walk each frame by steps scaled by (1 - fitness)."""
    dev = state["w1"].device
    fit = 1.0 - scalar(p["fitness"], dev)
    frame = torch.as_tensor(ctx.frame, device=dev).reshape(-1)[0]
    kw1, kw2, kc = prng.split(prng.fold_in(_walk_key(str(dev)),
                                           frame.to(torch.int32)), 3)

    def step(k, shape):
        # four uniforms summed: a gaussian-ish step
        u = prng.uniform(k, shape + (4,), -1.0, 1.0)
        return (((u[..., 0] + u[..., 1]) + u[..., 2]) + u[..., 3]) \
            * fit / 4.0
    w1 = _nn_walk(state["w1"], step(kw1, tuple(state["w1"].shape)))
    w2 = _nn_walk(state["w2"], step(kw2, tuple(state["w2"].shape)))
    c = _nn_walk(state["c"], step(kc, tuple(state["c"].shape)))
    x = torch.stack([scalar(p[n], dev) for n in ("a", "b", "c", "d")])
    hidden = torch.tanh(w1 @ x + c[:_NN_HIDDEN])
    outs = torch.tanh(w2 @ hidden + c[_NN_HIDDEN:])
    out_values = {f"o{i}": outs[i] * 0.5 + 0.5 for i in range(_NN_OUT)}
    return _pass(ins, p, ctx), {"w1": w1, "w2": w2, "c": c}, out_values


register_filter(Filter(
    name="nn_programmer", process=_nn_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_nn_init,
    params=(Param("fitness", "num", 0.9, 0.0, 1.0),
            Param("a", "num", 0.0, -1.0, 1.0),
            Param("b", "num", 0.0, -1.0, 1.0),
            Param("c", "num", 0.0, -1.0, 1.0),
            Param("d", "num", 0.0, -1.0, 1.0)),
    out_params=tuple(Param(f"o{i}", "num", 0.5, 0.0, 1.0)
                     for i in range(_NN_OUT)),
    description="evolving random net data mapper (nn_programmer.c)"))


# -- smoother and integrator --------------------------------------------------

def _stream_init(w, h, palette, device):
    return torch.zeros(_N_SMOOTH, dtype=torch.float32, device=device)


def _inputs(p, dev):
    return torch.stack([scalar(p[f"in{j}"], dev) for j in range(_N_SMOOTH)])


def _smooth_process(ins, p, ctx, state):
    """An EMA of each stream: state + (in - state) * rate; `rate` 1
    follows instantly, 0 freezes."""
    dev = state.device
    rate = torch.clamp(scalar(p["rate"], dev), 0.0, 1.0)
    new = fma32(_inputs(p, dev) - state, rate, state)
    return _pass(ins, p, ctx), new, {f"o{j}": new[j]
                                     for j in range(_N_SMOOTH)}


register_filter(Filter(
    name="smoother", process=_smooth_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_stream_init,
    params=tuple(Param(f"in{j}", "num", 0.0, -1e6, 1e6)
                 for j in range(_N_SMOOTH))
    + (Param("rate", "num", 0.5, 0.0, 1.0),),
    out_params=tuple(Param(f"o{j}", "num", 0.0, -1e6, 1e6)
                     for j in range(_N_SMOOTH)),
    description="EMA smoothing of param streams (data_processor s[] role)"))


def _integ_process(ins, p, ctx, state):
    """A leaky integrator of each stream: state * decay + in (per-frame
    velocities to positions)."""
    dev = state.device
    decay = torch.clamp(scalar(p["decay"], dev), 0.0, 1.0)
    new = fma32(state, decay, _inputs(p, dev))
    return _pass(ins, p, ctx), new, {f"o{j}": new[j]
                                     for j in range(_N_SMOOTH)}


register_filter(Filter(
    name="integrator", process=_integ_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_stream_init,
    params=tuple(Param(f"in{j}", "num", 0.0, -1e6, 1e6)
                 for j in range(_N_SMOOTH))
    + (Param("decay", "num", 0.95, 0.0, 1.0),),
    out_params=tuple(Param(f"o{j}", "num", 0.0, -1e6, 1e6)
                     for j in range(_N_SMOOTH)),
    description="leaky integrator (velocity -> position accumulator)"))


# -- timer --------------------------------------------------------------------

def _timer_init(w, h, palette, device):
    return {"started": torch.zeros((), dtype=torch.bool, device=device),
            "start": torch.zeros((), dtype=torch.float32, device=device),
            "reset_at": torch.zeros((), dtype=torch.float32, device=device),
            "was_reset": torch.zeros((), dtype=torch.bool, device=device)}


def _timer_process(ins, p, ctx, state):
    """scripts/timer.script: absolute, relative and since-reset clocks,
    with an edge-triggered reset input."""
    dev = state["start"].device
    tc = scalar(ctx.tc, dev)
    started = state["started"]
    start = torch.where(started, state["start"], tc)
    reset_req = scalar(p["reset"], dev) > 0.5
    do_reset = reset_req & ~state["was_reset"]
    reset_at = torch.where(started, torch.where(do_reset, tc,
                                                state["reset_at"]), tc)
    new_state = {"started": torch.ones((), dtype=torch.bool, device=dev),
                 "start": start, "reset_at": reset_at,
                 "was_reset": reset_req}
    outs = {"relative": tc - start, "absolute": tc,
            "sincereset": tc - reset_at,
            "was_reset": reset_req.to(torch.float32)}
    return _pass(ins, p, ctx), new_state, outs


register_filter(Filter(
    name="timer", process=_timer_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_timer_init,
    params=(Param("reset", "num", 0.0, 0.0, 1.0),),
    out_params=(Param("relative", "num", 0.0, 0.0, 1e9),
                Param("absolute", "num", 0.0, 0.0, 1e9),
                Param("sincereset", "num", 0.0, 0.0, 1e9),
                Param("was_reset", "num", 0.0, 0.0, 1.0)),
    description="timecode clocks for data connections "
                "(scripts/timer.script)"))
