"""`FrameGraph.run_batch` of the port against the JAX package's jitted
batch plan, on the CPU, where a hard select reads a value the two plans
round differently.

spread's hash argument rounds one way in the JAX batch plan and another in
a one-frame plan (`FrameContext.batched`). In a stateful chain the port's
frame loop runs each frame through `run_chain`, which must say it is the
batch plan: `[rgb_delay, spread]` and `[spread, rgb_delay]` over layers and
over a synthetic source (through `render_events`) are within 1 LSB of the
JAX scan path, at 135x240 over four frames and 72x128 over three.

dream (gaussian_blur r=6, softlight, saturation 1.4, a compound) quantises
to u8 between its steps. On the 72x128 seed-0 case the JAX package's jitted
plan rounds two of gaussian_blur's outputs one LSB up where its eager plan
does not (XLA contracts the blur's horizontal taps and the amount blend
into FMAs); softlight and saturation carry the flip to 2 LSB at one value.
The port computes the eager plan bit for bit on every case, and the
jitted one within 1 LSB on every case but that one (ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.effects import instantiate as j_inst
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import apply_instance as j_apply
from lives_tpu.events import event_list as j_elmod
from lives_tpu.events.renderer import render_events as j_render_events
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.layer import Layer as JLayer
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import apply_instance as t_apply
from lives_tpu_torch.effects.host import instantiate as t_inst
from lives_tpu_torch.events import event_list as t_elmod
from lives_tpu_torch.events.renderer import render_events as t_render_events
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource

RGB24 = 4
SIZES = [(135, 240, 4), (72, 128, 3)]
ORDERS = [("rgb_delay", "spread"), ("spread", "rgb_delay")]


@pytest.fixture(autouse=True)
def scan_env(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def frames(h, w, b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, 3, h, w),
                                                np.uint8)


def run_batch(pkg, names, fr, eager=False):
    """One run_batch of `names` over the u8 frames `fr`: (B, 3, H, W)."""
    b, _, h, w = fr.shape
    tcs = (np.arange(b) / 30.0).astype(np.float32)
    nums = np.arange(b, dtype=np.int32)
    if pkg == "t":
        g = TGraph([t_inst(n) for n in names], TSink(w, h), fps=30.0)
        return g.run_batch([TLayer(planes=(torch.from_numpy(fr),),
                                   palette=RGB24)], tcs, nums)\
            .planes[0].numpy()
    g = JGraph([j_inst(n) for n in names], JSink(w, h), fps=30.0)
    lay = [JLayer(planes=(jnp.asarray(fr),), palette=RGB24)]
    if eager:
        with jax.disable_jit():
            return np.asarray(g.run_batch(lay, tcs, nums).planes[0])
    return np.asarray(g.run_batch(lay, tcs, nums).planes[0])


def gap(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), int((d > 0).sum())


# -- spread in a stateful chain ------------------------------------------------

@pytest.mark.parametrize("h,w,b", SIZES)
@pytest.mark.parametrize("names", ORDERS)
def test_spread_in_a_stateful_chain_over_layers(names, h, w, b):
    fr = frames(h, w, b)
    worst, _ = gap(run_batch("t", names, fr), run_batch("j", names, fr))
    assert worst <= 1


def _timeline(m, names, b):
    el = m.EventList(fps=30.0, width=0, height=0)
    inits = [m.filter_init_event(0, n) for n in names]
    for i in inits:
        el.insert(i)
    el.insert(m.filter_map_event(0, [i.event_id for i in inits]))
    for i in range(b):
        el.insert(m.frame_event(i * 3_333_333, [1], [i]))
    return el


@pytest.mark.parametrize("h,w,b", SIZES)
@pytest.mark.parametrize("names", ORDERS)
def test_spread_in_a_stateful_chain_over_a_source(names, h, w, b):
    """The same chains as a timeline over the synthetic source through
    `render_events`, two chunks with the state carried."""
    got = np.concatenate([lay.planes[0].numpy() for _, lay in
                          t_render_events(_timeline(t_elmod, names, 2 * b),
                                          TSource(h, w, device="cpu"),
                                          TSink(w, h), batch_size=b)])
    ref = np.concatenate([np.asarray(lay.planes[0]) for _, lay in
                          j_render_events(_timeline(j_elmod, names, 2 * b),
                                          JSource(h, w), JSink(w, h),
                                          batch_size=b)])
    assert got.shape == (2 * b, 3, h, w)
    assert gap(got, ref)[0] <= 1


# -- dream ------------------------------------------------------------------------

DREAM = [(72, 128, 3, 0), (72, 128, 3, 1), (72, 128, 3, 2),
         (135, 240, 3, 0), (41, 67, 3, 0)]


@pytest.mark.parametrize("h,w,b,seed", DREAM)
def test_dream_is_the_jax_eager_plan_bit_for_bit(h, w, b, seed):
    fr = frames(h, w, b, seed)
    assert gap(run_batch("t", ["dream"], fr),
               run_batch("j", ["dream"], fr, eager=True)) == (0, 0)


@pytest.mark.parametrize("h,w,b,seed", DREAM[1:])
def test_dream_matches_the_jax_jitted_plan(h, w, b, seed):
    fr = frames(h, w, b, seed)
    assert gap(run_batch("t", ["dream"], fr),
               run_batch("j", ["dream"], fr))[0] <= 1


def test_dream_gap_is_born_in_the_jitted_blur_step():
    """The 72x128 seed-0 case: the JAX jitted plan is 2 LSB from the eager
    one at one value (3 values differ), as the port is; step by step, the
    port equals the JAX eager steps, and the jitted gaussian_blur step
    differs from both by 1 LSB at exactly the values where dream's flips
    start."""
    fr = frames(72, 128, 3, 0)
    jit, eager = run_batch("j", ["dream"], fr), \
        run_batch("j", ["dream"], fr, eager=True)
    port = run_batch("t", ["dream"], fr)
    assert gap(jit, eager) == (2, 3) and gap(port, jit) == (2, 3)
    flips = {tuple(i) for i in np.argwhere(jit != eager)}

    def jax_blur(x):
        inst = j_inst("gaussian_blur", radius=6, amount=1.0)
        return j_apply(inst, [JLayer(planes=(x,), palette=RGB24)],
                       JContext(width=128, height=72))[0].planes[0]
    blur_jit = np.asarray(jax.jit(jax.vmap(jax_blur))(jnp.asarray(fr)))
    blur_eager = np.asarray(jax.vmap(jax_blur)(jnp.asarray(fr)))
    blur_port = t_apply(t_inst("gaussian_blur", radius=6, amount=1.0),
                        [TLayer(planes=(torch.from_numpy(fr),),
                                palette=RGB24)],
                        TContext(width=128, height=72))[0].planes[0].numpy()
    assert gap(blur_port, blur_eager) == (0, 0)
    assert gap(blur_jit, blur_eager)[0] == 1
    born = {tuple(i) for i in np.argwhere(blur_jit != blur_eager)}
    assert {(b, y, x) for b, _, y, x in flips} <= \
        {(b, y, x) for b, _, y, x in born}
