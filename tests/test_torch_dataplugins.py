"""`dataplugins.py`'s seven filters and `utils.prng.uniform`'s bounds of
lives_tpu_torch against lives_tpu, on the same seeded parameters.

The reference is the JITTED JAX filter (test_torch_alpha.py's helpers).
data_unpacker and log_sig take the port's batch of B frames; the five
stateful ones run several frames with their states carried.

Tolerances: the video passes through unchanged; data_counter's counts,
flags and outputs, timer's flags and nn_programmer's threefry draws exact
(its initial weights bit for bit); float out-values and carried float
state within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu_torch.effects.builtin import dataplugins as td
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.utils import prng
from test_torch_alpha import (B, FPS, close, frames, jax_step, port_step,
                              run_stateful, same_state)

H, W = 24, 40


def _batch(name, vals):
    ins = [frames(40, B, H, W)]
    got, inst = port_step(name, ins, vals, slice(0, B), range(B),
                          np.arange(B) / FPS)
    np.testing.assert_array_equal(got, ins[0])
    refs = [jax_step(name, ins, vals, b, b, b / FPS)[2] for b in range(B)]
    assert set(inst.out_values) == set(refs[0])
    return inst.out_values, refs


def test_data_unpacker():
    rng = np.random.default_rng(41)
    vals = {f"in{i}": rng.uniform(-3, 3, B).astype(np.float32)
            for i in range(8)}
    vals["clamp"] = np.array([1.0, 0.0, 0.7], np.float32)
    vals["range"] = np.array([1.0, 1.0, 2.5], np.float32)
    got, refs = _batch("data_unpacker", vals)
    for k, v in got.items():
        close(v.numpy(), np.stack([r[k] for r in refs]))


def test_data_unpacker_array_inputs():
    """An in-param of k values a frame ((B, k)) unpacks to k outs, in
    order, as the JAX filter flattens an array-valued parameter."""
    f = t_get_filter("data_unpacker")
    p = {p.name: p.default for p in f.params}
    p["in0"] = torch.tensor([[0.1, 0.2, 0.3]] * B)
    p["in1"] = torch.tensor([5.0] * B)
    p["clamp"] = 0.0
    out = f.analyse([], p, TContext(device="cpu"))
    jp = {p_.name: p_.default for p_ in j_get_filter("data_unpacker").params}
    jp["in0"], jp["in1"], jp["clamp"] = jnp.array([0.1, 0.2, 0.3]), 5.0, 0.0
    ref = j_get_filter("data_unpacker").analyse([], jp, None)
    assert set(out) == set(ref) and len(out) == 10
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(),
                                      np.full(B, np.asarray(ref[k])))


def test_log_sig_matches_jitted_sigmoid():
    rng = np.random.default_rng(42)
    vals = {f"in{i}": rng.uniform(-30, 30, B).astype(np.float32)
            for i in range(8)}
    vals["in0"] = np.array([0.0, -88.0, 1e-3], np.float32)
    got, refs = _batch("log_sig", vals)
    for k, v in got.items():
        close(v.numpy(), np.stack([r[k] for r in refs]))
    x = jnp.asarray(rng.uniform(-40, 40, 4096).astype(np.float32))
    np.testing.assert_array_equal(
        td.sigmoid(torch.from_numpy(np.array(x))).numpy(),
        np.asarray(jax.jit(jax.nn.sigmoid)(x)))


def _stream(name, n, vals):
    out = []
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            name, vals, n, H, W, seed=43):
        np.testing.assert_array_equal(got[0], ref)
        assert set(inst.out_values) == set(ov)
        out.append((inst, st, ov))
    return out


def test_data_counter():
    rng = np.random.default_rng(44)
    n = 12
    vals = {f"input{j}": (rng.uniform(0, 1, n) > 0.5).astype(np.float32)
            for j in range(4)}
    for j, (on, off) in enumerate(((1, 1), (2, 3), (3, 1), (8, 8))):
        vals[f"oncount{j}"], vals[f"offcount{j}"] = on, off
    vals["count_rising"] = np.ones(n, np.float32)
    vals["count_falling"] = (np.arange(n) % 3 == 0).astype(np.float32)
    flips = 0
    for inst, st, ov in _stream("data_counter", n, vals):
        for k, v in ov.items():
            np.testing.assert_array_equal(inst.out_values[k].numpy(), v)
        same_state(inst.state, st)
        flips += int(sum(v for v in ov.values()))
    assert flips > 0


def test_nn_programmer():
    rng = np.random.default_rng(45)
    n = 5
    vals = {k: rng.uniform(-1, 1, n).astype(np.float32)
            for k in ("a", "b", "c", "d")}
    vals["fitness"] = np.array([0.0, 0.5, 0.9, 1.0, 0.2], np.float32)
    init_t = t_get_filter("nn_programmer").init_state(W, H, None, "cpu")
    init_j = j_get_filter("nn_programmer").init_state(W, H, None)
    for k in init_j:   # the threefry draws, bit for bit
        np.testing.assert_array_equal(init_t[k].numpy(),
                                      np.asarray(init_j[k]))
    for inst, st, ov in _stream("nn_programmer", n, vals):
        for k, v in ov.items():
            close(inst.out_values[k].numpy(), v)
        same_state(inst.state, st)


@pytest.mark.parametrize("name,knob", [("smoother", "rate"),
                                       ("integrator", "decay")])
def test_smoother_and_integrator(name, knob):
    rng = np.random.default_rng(46)
    n = 6
    vals = {f"in{j}": rng.uniform(-5, 5, n).astype(np.float32)
            for j in range(4)}
    vals[knob] = rng.uniform(0, 1, n).astype(np.float32)
    for inst, st, ov in _stream(name, n, vals):
        for k, v in ov.items():
            close(inst.out_values[k].numpy(), v)
        same_state(inst.state, st)


def test_timer():
    vals = {"reset": np.array([0, 1, 1, 0, 1, 0], np.float32)}
    for inst, st, ov in _stream("timer", 6, vals):
        for k, v in ov.items():
            close(inst.out_values[k].numpy(), v)
        same_state(inst.state, st)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (-3.5, 7.25),
                                   (2.0, 2.5)])
def test_prng_uniform_bounds(lo, hi):
    """`uniform(key, shape, minval, maxval)` as `jax.random.uniform`, bit
    for bit, under keys folded with several frame numbers."""
    for seed, data in ((2121, 0), (2121, 7), (4242, 100_000), (7, 2 ** 31)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed),
                                np.uint32(data))
        tk = prng.fold_in(prng.prng_key(seed, "cpu"), data)
        ref = np.asarray(jax.random.uniform(jk, (16, 4, 4), minval=lo,
                                            maxval=hi))
        got = prng.uniform(tk, (16, 4, 4), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
