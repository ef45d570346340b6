"""The single-frame live path of lives_tpu_torch against lives_tpu:
`FrameGraph.run`, `GenSlot`, `GeneratorClip`, the generators, `negate`
and `brightness_contrast`, `stable_uid`.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs its float32 chain (LIVES_TPU_CHAIN_DTYPE=f32), the port
runs on the CPU. u8 frames agree within +/-1 LSB (torch's and XLA's sin,
cos, exp, sqrt and atan2 differ by an ulp; a u8 value is floor(v * 255 +
0.5)); carried f32 state within 1e-5; uids, integer state and u8 state
exactly. The BASELINE row 5 configurations are those of
benchmarks/latency4k.py:54-56, at 64x36."""

import copy
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import apply_instance as j_apply
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.graph import FrameGraph as JGraph
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import GenSlot as JGenSlot
from lives_tpu.io.genclip import GeneratorClip as JClip
from lives_tpu.layer import Layer as JLayer
from lives_tpu.utils.uid import stable_uid as j_stable_uid
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import apply_instance as t_apply
from lives_tpu_torch.effects.host import get_filter, instantiate
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import GenSlot, SinkSpec
from lives_tpu_torch.graph.nodemodel import states_to_numpy
from lives_tpu_torch.io.genclip import GeneratorClip
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.utils.uid import stable_uid

GENERATORS = ["solid_colour", "plasma", "gradient", "checkerboard",
              "colour_bars", "vu_bars", "spectrascope", "noise"]
#: benchmarks/latency4k.py:54-56
LIVE_CONFIGS = [["saturation"], ["saturation", "vignette"], ["vignette"],
                ["vignette", "brightness_contrast"], ["brightness_contrast"],
                ["saturation", "brightness_contrast"], [], ["negate"]]
W, H, FPS = 64, 36, 60.0


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def within_1(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.size == 0 or d.max() <= 1, (d.max(), float((d > 0).mean()))


def same_planes(t_layer, j_layer):
    assert t_layer.palette == j_layer.palette
    assert len(t_layer.planes) == len(j_layer.planes)
    for tp, jp in zip(t_layer.planes, j_layer.planes):
        within_1(tp.numpy(), jp)


def rand_layer(rng, h=H, w=W, channels=3):
    arr = rng.integers(0, 256, (channels, h, w), dtype=np.uint8)
    pal = JPalette.RGBA32 if channels == 4 else JPalette.RGB24
    return (Layer(planes=(torch.from_numpy(arr),), palette=int(pal)),
            JLayer(planes=(jnp.asarray(arr),), palette=int(pal)))


def rand_params(name, rng):
    """A value in [min, max] for every parameter of the generator."""
    return {p.name: float(np.float32(rng.uniform(p.min, p.max)))
            for p in get_filter(name).params}


def gen_pair(name, params, tc, frame, w, h, fps=25.0):
    """One frame of generator `name` from both packages' process
    functions: (port (3, H, W), JAX (3, H, W)) numpy u8."""
    defaults = {p.name: p.default for p in get_filter(name).params}
    vals = {**defaults, **params}
    tctx = TContext(tc=torch.tensor([tc], dtype=torch.float32),
                    frame=torch.tensor([frame], dtype=torch.int32), fps=fps,
                    width=w, height=h, device="cpu")
    got = get_filter(name).process(
        [], {k: torch.tensor([v], dtype=torch.float32)
             for k, v in vals.items()}, tctx)
    jctx = JContext(tc=jnp.float32(tc), frame=jnp.int32(frame), fps=fps,
                    width=w, height=h)
    ref = j_get_filter(name).process(
        [], {k: jnp.float32(v) for k, v in vals.items()}, jctx)
    assert got.planes[0].shape == (1, 3, h, w)
    return got.planes[0][0].numpy(), np.asarray(ref.planes[0])


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("w,h", [(64, 32), (37, 23)])
@pytest.mark.parametrize("tc,frame", [(0.0, 0), (1.37, 41),
                                      (100000 / 60.0, 100000)])
@pytest.mark.parametrize("values", ["defaults", "random"])
def test_generator_matches_jax(name, w, h, tc, frame, values):
    rng = np.random.default_rng(zlib.crc32(f"{name} {w} {frame}".encode()))
    params = rand_params(name, rng) if values == "random" else {}
    got, ref = gen_pair(name, params, tc, frame, w, h)
    within_1(got, ref)


def test_generator_makes_a_batch():
    """B frames at once: each the frame its own (tc, params) makes."""
    tcs, speeds = [0.0, 0.5, 3.0], [0.5, 1.0, 2.0]
    ctx = TContext(tc=torch.tensor(tcs), frame=torch.tensor([0, 12, 75]),
                   width=W, height=H, device="cpu")
    out = get_filter("plasma").process(
        [], {"speed": torch.tensor(speeds), "scale": 0.5}, ctx).planes[0]
    assert out.shape == (3, 3, H, W)
    for b in range(3):
        got, _ = gen_pair("plasma", {"speed": speeds[b]}, tcs[b], 0, W, H)
        np.testing.assert_array_equal(out[b].numpy(), got)


def test_generator_needs_a_device():
    with pytest.raises(ValueError, match="device"):
        get_filter("plasma").process(
            [], {"speed": 0.5, "scale": 0.5},
            TContext(tc=0.0, width=W, height=H))


def test_noise_raises_naming_its_item():
    """noise was deferred to the threefry port (ROADMAP item 15); it is
    ported: frames 0, 1 and 100,000 bit for bit the JAX package's
    `get_frame`, mono (the default) and colour."""
    for mono in (1.0, 0.0):
        tclip = GeneratorClip("noise", W, H, device="cpu")
        jclip = JClip("noise", W, H)
        tclip.inst.values["mono"] = jclip.inst.values["mono"] = mono
        for n in (0, 1, 100_000):
            np.testing.assert_array_equal(
                tclip.get_frame(n).planes[0].numpy(),
                np.asarray(jclip.get_frame(n).planes[0]))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("name,values", [
    ("negate", {}),
    ("brightness_contrast", {}),
    ("brightness_contrast", {"brightness": 0.2, "contrast": 1.7}),
    ("brightness_contrast", {"brightness": -0.35, "contrast": 0.4}),
    ("brightness_contrast", {"brightness": 0.9, "contrast": 3.5})])
def test_colour_filters_match_jax(name, values, channels):
    rng = np.random.default_rng(7)
    tl, jl = rand_layer(rng, channels=channels)
    got = t_apply(instantiate(name, **values),
                  [tl.replace(planes=(tl.planes[0][None],))])[0]
    ref = j_apply(j_instantiate(name, **values), [jl])[0]
    assert got.palette == ref.palette
    within_1(got.planes[0][0].numpy(), ref.planes[0])


@pytest.mark.parametrize("parts", [("gen", "plasma", 3840, 2160),
                                   ("gen", "colour_bars", 64, 36),
                                   ("clip", 7, "x"), ()])
def test_stable_uid_matches(parts):
    assert stable_uid(*parts) == j_stable_uid(*parts)


@pytest.mark.parametrize("name", ["plasma", "colour_bars", "beat_rings"])
def test_clip_uid_matches(name):
    assert GeneratorClip(name, W, H, device="cpu").unique_id == \
        JClip(name, W, H).unique_id


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("fps", [25.0, 60.0])
def test_get_frame_matches_jax(name, fps):
    """The clip's frame against the JAX package's jitted get_frame, within
    1 LSB. XLA fuses the jitted frame (a multiply and an add become one
    fused multiply-add), so at a point where the formula is singular
    (spectrascope's atan2 at the frame's centre pixel on an odd
    geometry, where cx and cy are rounding residues) the JAX package's
    jitted and eager frames disagree by tens of LSB; there, and only
    there, the port is held to the eager frame, which it also meets within
    1 LSB."""
    rng = np.random.default_rng(3)
    params = rand_params(name, rng)
    tc = GeneratorClip(name, 37, 23, fps=fps, device="cpu", **params)
    jc = JClip(name, 37, 23, fps=fps, **params)
    for n in (0, 7, 100000):
        got = tc.get_frame(n).planes[0].numpy()
        assert got.shape == (3, 23, 37)
        jit = np.asarray(jc.get_frame(n).planes[0])
        _, eager = gen_pair(name, params, n / fps, n, 37, 23, fps)
        split = np.abs(jit.astype(int) - eager.astype(int)) > 1
        assert split.mean() < 0.005, split.mean()
        within_1(got[~split], jit[~split])
        within_1(got[split], eager[split])


def test_beat_rings_state_over_six_frames():
    """The stateful generator through get_frame: state threads frame to
    frame; cur exact, ages within 1e-5, frames within 1 LSB."""
    tc = GeneratorClip("beat_rings", 48, 32, fps=25.0, device="cpu",
                       speed=0.7)
    jc = JClip("beat_rings", 48, 32, fps=25.0, speed=0.7)
    for n, beat in enumerate([1.0, 0.0, 0.8, 0.2, 1.0, 0.9]):
        tc.inst.values["beat"] = beat
        jc.inst.values["beat"] = beat
        within_1(tc.get_frame(n).planes[0].numpy(),
                 jc.get_frame(n).planes[0])
        ages, cur = tc._state
        j_ages, j_cur = (np.asarray(v) for v in jc._state)
        assert ages.dtype == torch.float32 and cur.dtype == torch.int32
        assert int(cur) == int(j_cur)
        np.testing.assert_allclose(ages.numpy(), j_ages, atol=1e-5, rtol=0)


def test_switch_restarts_the_state():
    clip = GeneratorClip("beat_rings", 16, 8, device="cpu", beat=1.0)
    clip.get_frame(0)
    assert clip._state is not None
    clip.switch("plasma")
    assert clip._state is None and clip.version == 1
    assert clip.get_frame(1).planes[0].shape == (3, 8, 16)
    with pytest.raises(ValueError):
        clip.switch("negate")


def _clips(w=W, h=H):
    return ((GeneratorClip("plasma", w, h, fps=FPS, device="cpu"),
             GeneratorClip("colour_bars", w, h, fps=FPS, device="cpu")),
            (JClip("plasma", w, h, fps=FPS), JClip("colour_bars", w, h,
                                                   fps=FPS)))


@pytest.mark.parametrize("cfg", range(len(LIVE_CONFIGS)))
def test_live_configs_match_jax(cfg):
    """latency4k.py's graph path at 64x36: [plasma, colour_bars] through
    each configuration, frames 0, 1, 25 and 100,000 (tc in float32)."""
    (fg, bg), (jfg, jbg) = _clips()
    names = LIVE_CONFIGS[cfg]
    tg = TGraph([instantiate(n) for n in names], SinkSpec(width=W, height=H),
                fps=FPS)
    jg = JGraph([j_instantiate(n) for n in names], JSink(width=W, height=H),
                fps=FPS)
    for i in (0, 1, 25, 100000):
        out = tg.run([fg, bg], i / FPS, i)
        assert out.planes[0].shape == (3, H, W)
        same_planes(out, jg.run([jfg, jbg], i / FPS, i))
    assert len(tg.stats) == 1 and next(iter(tg.stats.values())) == 4


def test_genslot_matches_get_frame():
    (fg, bg), (jfg, jbg) = _clips()
    tg = TGraph([instantiate("saturation", saturation=1.4),
                 instantiate("vignette")], SinkSpec(width=W, height=H),
                fps=30.0)
    jg = JGraph([j_instantiate("saturation", saturation=1.4),
                 j_instantiate("vignette")], JSink(width=W, height=H),
                fps=30.0)
    for n in (0, 13, 100000):
        slot = tg.run([GenSlot(fg, n), bg], 0.25, 3)
        pulled = tg.run([fg.get_frame(n), bg], 0.25, 3)
        np.testing.assert_array_equal(slot.planes[0].numpy(),
                                      pulled.planes[0].numpy())
        same_planes(slot, jg.run([JGenSlot(jfg, n), jbg], 0.25, 3))


def test_genslot_and_device_raises():
    g = TGraph([instantiate("negate")])
    rings = GeneratorClip("beat_rings", W, H, device="cpu")
    with pytest.raises(ValueError, match="GenSlot"):
        g.run([GenSlot(rings, 0)])
    tl, _ = rand_layer(np.random.default_rng(0))
    with pytest.raises(ValueError, match="GenSlot"):
        g.run([GenSlot(tl, 0)])
    with pytest.raises(ValueError, match="device"):
        TGraph([instantiate("plasma")], SinkSpec(W, H)).run([], 0.5, 12)


def test_transition_over_layers():
    """tests/test_graph.py:81-90 on both packages."""
    rng = np.random.default_rng(1234)
    (tf, jf), (tb, jb) = rand_layer(rng, 32, 64), rand_layer(rng, 32, 64)
    out = TGraph([instantiate("crossfade", amount=0.25)]).run([tf, tb])
    a, b = (np.asarray(x.planes[0], np.float32) for x in (jf, jb))
    expect = np.floor((a * 0.25 + b * 0.75) / 255.0 * 255.0 + 0.5)
    assert np.abs(expect - out.planes[0].numpy()).max() <= 1.0
    same_planes(out, JGraph([j_instantiate("crossfade", amount=0.25)]).run(
        [jf, jb]))


@pytest.mark.parametrize("sink", [
    dict(width=48, height=24, palette=int(Palette.YUV420P)),
    dict(width=64, height=64, letterbox=True),
    dict(width=50, height=20),
    dict(palette=int(Palette.RGBA32))])
def test_sink_step_matches_jax(sink):
    tl, jl = rand_layer(np.random.default_rng(5), 32, 64)
    out = TGraph([instantiate("negate")], SinkSpec(**sink)).run([tl])
    ref = JGraph([j_instantiate("negate")], JSink(**sink)).run([jl])
    same_planes(out, ref)
    if sink.get("palette") == int(Palette.YUV420P):
        assert out.planes[1].shape == (12, 24)
    if sink.get("letterbox"):
        assert (out.planes[0][:, :16].numpy() == 0).all()


def test_generator_instance_chain():
    """tests/test_graph.py:74-78: a chain that starts with a generator
    instance, no layers; the device comes from the caller."""
    out = TGraph([instantiate("plasma")], SinkSpec(width=64, height=32)).run(
        [], tc=0.5, frame=12, device="cpu")
    ref = JGraph([j_instantiate("plasma")], JSink(width=64, height=32)).run(
        [], tc=0.5, frame=12)
    assert (out.width, out.height) == (64, 32)
    same_planes(out, ref)


def _states_close(t_states, j_states):
    for ts, js in zip(states_to_numpy(t_states), j_states):
        if ts is None:
            assert js is None
        elif isinstance(ts, dict):
            for k in ("head", "ring"):
                np.testing.assert_array_equal(ts[k], np.asarray(js[k]))
        else:
            np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5, rtol=0)


def test_stateful_chain_through_run():
    """fire and rgb_delay through 6 calls of run: frames within 1 LSB,
    fire's state within 1e-5, rgb_delay's head and u8 ring exactly;
    mirror_state=False leaves the states as they were."""
    def chain(make):
        return [make("fire", threshold=0.4, cooling=0.2),
                make("rgb_delay", delay_r=0.0, delay_g=1.0, delay_b=3.0),
                make("saturation", saturation=1.2)]
    tg, jg = TGraph(chain(instantiate), fps=25.0), \
        JGraph(chain(j_instantiate), fps=25.0)
    rng = np.random.default_rng(11)
    for i in range(6):
        tl, jl = rand_layer(rng, 24, 40)
        same_planes(tg.run([tl], i / 25.0, i), jg.run([jl], i / 25.0, i))
        _states_close(tg.states, jg.states)
        assert tg.chain[0].state is tg.states[0]
    before = copy.deepcopy(states_to_numpy(tg.states))
    ring_obj = tg.states[1]["ring"]
    tl, jl = rand_layer(rng, 24, 40)
    same_planes(tg.run([tl], 0.3, 6, mirror_state=False),
                jg.run([jl], 0.3, 6, mirror_state=False))
    assert tg.states[1]["ring"] is ring_obj
    for a, b in zip(states_to_numpy(tg.states), before):
        if a is None:
            assert b is None
        elif isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def test_device_valued_param_takes_the_unpacked_path():
    """A traced value that is a tensor is copied into its row of the
    column on its device, not read back: the same frame, another
    configuration key."""
    rng = np.random.default_rng(2)
    tl, _ = rand_layer(rng)
    sat = instantiate("saturation", saturation=1.6)
    g = TGraph([sat])
    packed = g.run([tl])
    sat.values["saturation"] = torch.tensor(1.6)
    unpacked = g.run([tl])
    np.testing.assert_array_equal(packed.planes[0].numpy(),
                                  unpacked.planes[0].numpy())
    assert len(g.stats) == 2


def test_stats_count_configurations():
    """tests/test_graph.py:19-45: one key for many frames and for a traced
    param change, a new key for a static param or a geometry change."""
    rng = np.random.default_rng(4)
    tl, _ = rand_layer(rng)
    vign = instantiate("vignette", amount=0.1)
    g = TGraph([vign])
    for i in range(3):
        g.run([tl], i / 25.0, i)
    vign.values["amount"] = 0.9
    g.run([tl])
    assert len(g.stats) == 1
    g.run([rand_layer(rng, 16, 32)[0]])
    assert len(g.stats) == 2
    blur = instantiate("gaussian_blur", radius=2)
    gb = TGraph([blur])
    gb.run([tl])
    blur.values["radius"] = 5
    gb.run([tl])
    assert len(gb.stats) == 2
