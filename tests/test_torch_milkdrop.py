"""The MilkDrop preset interpreter of lives_tpu_torch
(`effects/milkdrop.py`) against lives_tpu's (`effects/milkdrop.py`).

Every case of tests/test_milkdrop.py runs on the port, and where that
case computes a value the JAX package computes it too on the same inputs:
expressions as Python floats (bit for bit) and as traced float32 values
against `jax.jit` of the JAX compiler (bit for bit where the port's
function is XLA's twin: + - * /, sin, cos, exp, rand; within an ulp for
the float64 ones), presets frame by frame against the JAX process under
`jax.jit`, as `GeneratorClip` runs it. A preset's u8 frames agree within
+-1 LSB, its q-vars and megabufs exactly and its f32 canvas (the feedback
state) within CANVAS_ATOL. Audio levels are drawn from numpy seeds.
"""

import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import milkdrop as jm
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.io.genclip import GeneratorClip as JClip
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects import milkdrop as tm
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import get_filter, list_filters
from lives_tpu_torch.io.genclip import GeneratorClip

#: the feedback canvas's bound, float32 in [0, 1]: the splats' exp and the
#: float64 atan2 round within an ulp of XLA's, and the bilinear feedback
#: carries those ulps from frame to frame (8 frames at 64x48 stay below
#: 2e-5 on the four built-in presets)
CANVAS_ATOL = 1e-4
H, W = 48, 64
BANDS = ("bass", "mid", "treb", "vol")


# ---------------------------------------------------------------------------
# helpers


@pytest.fixture(autouse=True)
def registries():
    """Each test's presets leave both filter registries as they were, so
    the filter listings of other test files keep their counts."""
    from lives_tpu.effects import host as j_host
    from lives_tpu_torch.effects import host as t_host
    list_filters()
    j_host.list_filters()
    saved = [(m._REGISTRY, dict(m._REGISTRY)) for m in (j_host, t_host)]
    yield
    for reg_, before in saved:
        reg_.clear()
        reg_.update(before)


def reg(text, name):
    """Register the preset in both packages; its filter name."""
    jm.register_milk_preset(text, name)
    return tm.register_milk_preset(text, name).name


def audio(seed, n):
    """n frames of band levels in [0, 1.5) from a numpy seed."""
    a = np.random.default_rng(seed).uniform(0.0, 1.5, (n, 4))
    return [dict(zip(BANDS, map(float, np.float32(r)))) for r in a]


def _params(filt, p):
    out = {q.name: q.default for q in filt.params}
    out.update(p or {})
    return out


def run_jax(name, n, h=H, w=W, params=None, fps=30.0):
    """The JAX package's frames and states, its process under jax.jit as
    GeneratorClip runs it (tc float32(i / fps), frame int32 i)."""
    filt = j_get_filter(name)
    state = filt.init_state(w, h, int(JPalette.RGB24))

    def fn(tc, frame, p, st):
        ctx = JContext(tc=tc, frame=frame, fps=fps, width=w, height=h)
        return filt.process([], p, ctx, st)
    fj = jax.jit(fn)
    outs, states = [], []
    for i in range(n):
        p = _params(filt, params[i] if isinstance(params, list) else params)
        layer, state = fj(jnp.float32(i / fps), jnp.int32(i),
                          {k: jnp.float32(v) for k, v in p.items()}, state)
        outs.append(np.asarray(layer.planes[0]))
        states.append([np.asarray(s) for s in state])
    return outs, states


def run_port(name, n, h=H, w=W, params=None, fps=30.0, device="cpu"):
    """The port's frames ((3, H, W) u8) and states on `device`."""
    filt = get_filter(name)
    state = filt.init_state(w, h, int(Palette.RGB24), device)
    outs, states = [], []
    for i in range(n):
        p = _params(filt, params[i] if isinstance(params, list) else params)
        ctx = TContext(tc=torch.tensor(np.float32(i / fps)),
                       frame=torch.tensor(i, dtype=torch.int32), fps=fps,
                       width=w, height=h, device=torch.device(device))
        layer, state = filt.process([], p, ctx, state)
        assert layer.planes[0].shape == (1, 3, h, w)
        outs.append(layer.planes[0][0].cpu().numpy())
        states.append([s.cpu().numpy() for s in state])
    return outs, states


def assert_frames_match(j, t):
    """u8 within 1 LSB, q-vars and megabufs exact, canvas within
    CANVAS_ATOL; returns the largest u8 and canvas gaps."""
    (jo, js), (to, ts) = j, t
    lsb = gap = 0
    for i, (a, b, sa, sb) in enumerate(zip(jo, to, js, ts)):
        assert a.shape == b.shape and b.dtype == np.uint8
        d = np.abs(a.astype(int) - b.astype(int)).max()
        assert d <= 1, (i, d)
        lsb = max(lsb, d)
        gap = max(gap, float(np.abs(sa[0] - sb[0]).max()))
        assert gap <= CANVAS_ATOL, (i, gap)
        np.testing.assert_array_equal(sa[1], sb[1])      # q-vars
        np.testing.assert_array_equal(sa[2], sb[2])      # inited
        for x, y in zip(sa[3:], sb[3:]):                 # megabufs
            np.testing.assert_array_equal(x, y)
    return lsb, gap


def both(name, n, h=H, w=W, params=None):
    """Run both packages, hold them together, return the port's run."""
    t = run_port(name, n, h, w, params)
    assert_frames_match(run_jax(name, n, h, w, params), t)
    return t


# ---------------------------------------------------------------------------
# expression compiler


def run_expr(src, **env):
    return tm.compile_expressions(src)(env)


@pytest.mark.parametrize("src,env,expect", [
    ("y = 2 + 3*4;", {}, {"y": 14.0}),
    ("y = (2 + 3)*4;", {}, {"y": 20.0}),
    ("y = 2^10;", {}, {"y": 1024.0}),
    ("y = -2^2;", {}, {"y": -4.0}),            # unary binds looser than ^
    ("y = 7 % 3;", {}, {"y": 1.0}),
    ("y = 7.9 % 3.9;", {}, {"y": 1.0}),        # eel %: integer modulo
    ("y = 5 / 0;", {}, {"y": 0.0}),            # eel x/0 == 0
    ("y = 5 % 0;", {}, {"y": 0.0}),
    ("y = if(above(3,2), 10, 20);", {}, {"y": 10.0}),
    ("y = if(equal(1,2), 10, 20);", {}, {"y": 20.0}),
    ("y = band(1, 0) + bor(1, 0)*2 + bnot(0)*4;", {}, {"y": 6.0}),
    ("y = 2 < 3 && 3 < 2;", {}, {"y": 0.0}),
    ("y = 2 < 3 || 3 < 2;", {}, {"y": 1.0}),
    ("y = !1 + !0*2;", {}, {"y": 2.0}),
    ("y = min(3, x); z = max(3, x);", {"x": 5.0}, {"y": 3.0, "z": 5.0}),
    ("y = abs(-3) + sign(-2) + floor(2.7) + ceil(2.1);", {},
     {"y": 3.0 - 1.0 + 2.0 + 3.0}),
    ("y = sqr(3) + sqrt(16);", {}, {"y": 13.0}),
    ("y = x > 1 ? 5 : 6;", {"x": 2.0}, {"y": 5.0}),
    ("a = 2; b = a*3; b = b + 1;", {}, {"a": 2.0, "b": 7.0}),
])
def test_expr_scalar_constants(src, env, expect):
    out = run_expr(src, **env)
    ref = jm.compile_expressions(src)(dict(env))
    for k, v in expect.items():
        assert out[k] == pytest.approx(v), (src, k)
        assert out[k] == ref[k] and isinstance(out[k], float), (src, k)


def test_expr_transcendentals_match_math():
    src = ("s = sin(x); c = cos(x); t2 = atan2(x, 2); "
           "e = exp(x); l = log(x); p = pow(x, 2.5); sg = sigmoid(x,1);")
    x = 0.7
    out = run_expr(src, x=x)
    ref = jm.compile_expressions(src)({"x": x})
    assert out["s"] == pytest.approx(math.sin(x))
    assert out["c"] == pytest.approx(math.cos(x))
    assert out["t2"] == pytest.approx(math.atan2(x, 2))
    assert out["e"] == pytest.approx(math.exp(x))
    assert out["l"] == pytest.approx(math.log(x))
    assert out["p"] == pytest.approx(math.pow(x, 2.5))
    assert out["sg"] == pytest.approx(1 / (1 + math.exp(-x)))
    for k in ("s", "c", "t2", "e", "l", "p", "sg"):
        assert out[k] == float(ref[k]), k      # both fold in Python


def _traced_pair(src, names, vals):
    """(port values, JAX jitted values) of `src` on float32 inputs."""
    f = jm.compile_expressions(src)
    fj = jax.jit(lambda *a: {k: v for k, v in f(dict(zip(names, a))).items()
                             if k not in names})
    ref = fj(*[jnp.float32(v) for v in vals])
    got = tm.compile_expressions(src)(
        {k: torch.tensor(np.float32(v)) for k, v in zip(names, vals)})
    return {k: float(tm.val(v)) for k, v in got.items() if k in ref}, \
        {k: float(v) for k, v in ref.items()}


def test_expr_traced_values_match_constant_path():
    """The same statements over float32 scalars agree with the float path,
    and bit for bit with the JAX compiler under jax.jit."""
    src = ("y = if(above(x, 0.5), x^2.0, -x); z = x % 3; w = x / d; "
           "r = min(x, 2) + max(x, 2);")
    for x in (0.25, 0.75, 4.0, -2.5):
        const = run_expr(src, x=x, d=0.0)
        got, ref = _traced_pair(src, ("x", "d"), (x, 0.0))
        for k in ("y", "z", "w", "r"):
            assert got[k] == pytest.approx(const[k], abs=1e-5), (k, x)
            assert got[k] == ref[k], (k, x)


@pytest.mark.parametrize("src", [
    "y = x*0.9 + b*0.3; z = b*0.3 + x*1.7; w = x*b - 0.25*x + b;",
    "y = sin(x*1.7 + b) + cos(b*0.3 - x); z = exp(x*0.5 - b*0.25);",
    "y = x/3 + b/7; z = (x - b) % 4; w = if(below(x*b, 0.5), x, b*2);",
    "y = 0.5 + 0.5*sin(x*12.57 + b*2); z = sqr(x) + sqr(b)*0.5 + 1;",
    "y = rand(10)*x; z = int(x*7.3) + abs(b - 1.5) - rand(3)*0.5;",
    "y = x^1.5 + b^0.5; z = atan2(x, b) + log(x + 1) + sqrt(b);",
])
def test_expr_traced_against_jax_jit(src):
    """Traced expressions against the JAX compiler in a jitted plan: the
    twins' functions and the FMA contractions bit for bit, the float64
    ones within 2 ulps."""
    exact = not any(f in src for f in ("atan2", "log", "sqrt", "^"))
    rng = np.random.default_rng(len(src))
    for x, b in rng.uniform(0.05, 3.0, (12, 2)).astype(np.float32):
        got, ref = _traced_pair(src, ("x", "b", "frame"),
                                (x, b, float(rng.integers(0, 5000))))
        for k in ref:
            if exact:
                assert got[k] == ref[k], (src, k, x, b)
            else:
                assert got[k] == pytest.approx(ref[k], rel=3e-7,
                                               abs=1e-30), (src, k)


def test_expr_arrays_broadcast():
    out = tm.compile_expressions("y = x*2 + 1;")(
        {"x": torch.arange(4, dtype=torch.float32)})
    np.testing.assert_allclose(tm.val(out["y"]).numpy(), [1, 3, 5, 7])


def test_expr_rand_deterministic_per_frame():
    f = tm.compile_expressions("y = rand(1); z = rand(1);")

    def draw(fr):
        o = f({"frame": torch.tensor(np.float32(fr))})
        return float(tm.val(o["y"])), float(tm.val(o["z"]))
    a, b, c = draw(3), draw(3), draw(4)
    assert a[0] == b[0]              # same frame -> same draw
    assert a[0] != a[1]              # distinct call sites
    assert a[0] != c[0]              # frames decorrelate
    assert 0.0 <= a[0] < 1.0


def test_rand_hash_integer_exact():
    """The int32 hash wraps like int32: every draw equals the JAX
    package's, over frames past 2^31 / 0x9E3779B1 and negative ones."""
    frames = np.concatenate([np.arange(0, 300), [1e4, 2.5e5, 3.7e6, 1.6e7,
                                                 -1.0, -77.0, -4.1e6]])
    fr = torch.tensor(frames.astype(np.float32))
    for site in (1, 2, 55, 101, 104, 999):
        got = tm.rand_hash(fr, site, "cpu").numpy()
        ref = np.asarray(jax.jit(lambda f: jm._rand_hash(f, site))(
            jnp.asarray(frames, jnp.float32)))
        np.testing.assert_array_equal(got, ref)
    assert float(tm.rand_hash(1234.0, 55, "cpu")) == \
        float(jm._rand_hash(1234, 55))


def test_expr_unknown_vars_default_zero():
    assert run_expr("y = nosuchvar + 1;")["y"] == 1.0


def test_expr_errors():
    for src in ("y = $bad;", "y = nosuchfn(1);", "y = (1 + 2;"):
        with pytest.raises(ValueError):
            tm.compile_expressions(src)
        with pytest.raises(ValueError):
            jm.compile_expressions(src)


# ---------------------------------------------------------------------------
# preset parsing


MILK_TEXT = """[preset00]
fRating=4.0
fGammaAdj=1.5
fDecay=0.97
zoom=1.01
rot=0.0
nWaveMode=2
per_frame_init_1=q1 = 7;
per_frame_2=rot = rot + 0.01*sin(time);
per_frame_1=zoom = zoom + 0.1*bass;
per_pixel_1=zoom = zoom + rad*0.05;
wavecode_0_enabled=1
shapecode_0_x=0.5
warp_1=`shader body line to ignore
"""


def assert_same_preset(a, b):
    for f in ("name", "init", "per_frame_init", "per_frame", "per_pixel",
              "shapes", "waves", "warp_code", "comp_code"):
        assert getattr(a, f) == getattr(b, f), f


def test_parse_preset():
    pre = tm.parse_preset(MILK_TEXT, "demo")
    assert_same_preset(pre, jm.parse_preset(MILK_TEXT, "demo"))
    assert pre.init["fdecay"] == pytest.approx(0.97)
    assert pre.init["zoom"] == pytest.approx(1.01)
    assert pre.per_frame.index("bass") < pre.per_frame.index("sin")
    assert "q1 = 7" in pre.per_frame_init
    assert "rad*0.05" in pre.per_pixel
    assert "shader" not in pre.per_frame + pre.per_pixel
    assert pre.value("nwavemode") == 2
    assert pre.value("fgammaadj") == pytest.approx(1.5)
    assert pre.value("echo_zoom") == 1.0  # default


@pytest.mark.parametrize("name", sorted(tm.BUILTIN_PRESETS))
def test_parse_builtin_presets_field_for_field(name):
    assert tm.BUILTIN_PRESETS[name] == jm.BUILTIN_PRESETS[name]
    assert_same_preset(tm.parse_preset(tm.BUILTIN_PRESETS[name], name),
                       jm.parse_preset(jm.BUILTIN_PRESETS[name], name))


# ---------------------------------------------------------------------------
# renderer


def test_identity_preset_preserves_frame():
    name = reg("[p]\nfDecay=1.0\nzoom=1.0\nwarp=0.0\nwave_a=0.0\n"
               "fGammaAdj=1.0\n", "ident")
    outs, states = both(name, 3)
    assert np.all(states[-1][0] == 0.0)
    assert all(np.all(o == 0) for o in outs)


def test_wave_then_decay():
    name = reg("[p]\nfDecay=0.5\nzoom=1.0\nwarp=0.0\nwave_a=1.0\n"
               "wave_r=1.0\nwave_g=1.0\nwave_b=1.0\nnWaveMode=5\n", "wv")
    outs, states = both(name, 4)
    assert outs[0].max() > 0
    assert all(o.dtype == np.uint8 for o in outs)
    assert states[-1][0].max() <= 1.0 and states[-1][0].min() >= 0.0


def test_zoom_preset_moves_energy_and_stays_finite():
    name = reg(tm.BUILTIN_PRESETS["tunnel"], "tunnel_t")
    outs, states = both(name, 6, params={"bass": 0.8, "mid": 0.4,
                                         "treb": 0.4, "vol": 0.5})
    assert np.isfinite(states[-1][0]).all()
    assert any(not np.array_equal(outs[i], outs[i + 1]) for i in range(5))


def test_q_vars_persist_and_init_runs_once():
    name = reg("[p]\nfDecay=0.9\nwave_a=0.0\nper_frame_init_1=q1 = 5;\n"
               "per_frame_1=q1 = q1 + 1;\n"
               "per_frame_2=zoom = 1.0 + q1*0.001;\n", "qtest")
    _outs, states = both(name, 3)
    assert states[-1][1][0] == pytest.approx(8.0)


def test_determinism():
    name = reg(tm.BUILTIN_PRESETS["spin"], "spin_t")
    a, sa = run_port(name, 4)
    b, sb = run_port(name, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(sa[-1][0], sb[-1][0])


@pytest.mark.parametrize("name", ["geometry", "pulse", "spin", "tunnel"])
def test_builtin_preset_clip_against_jax(name):
    """8 frames at 64x48 through both packages' GeneratorClip.get_frame
    (the JAX clip jits its process), the band levels drawn from a seed
    each frame: u8 within 1 LSB, q-vars exact, canvas within
    CANVAS_ATOL."""
    levels = audio(sorted(tm.BUILTIN_PRESETS).index(name), 8)
    j = JClip(f"milk_{name}", W, H, fps=30.0)
    t = GeneratorClip(f"milk_{name}", W, H, fps=30.0, device="cpu")
    jo, js, to, ts = [], [], [], []
    for i, lv in enumerate(levels):
        j.inst.set(**lv)
        t.inst.set(**lv)
        jo.append(np.asarray(j.get_frame(i).planes[0]))
        to.append(t.get_frame(i).planes[0].numpy())
        js.append([np.asarray(s) for s in j._state])
        ts.append([s.numpy() for s in t._state])
    assert_frames_match((jo, js), (to, ts))
    assert any(not np.array_equal(to[i], to[i + 1]) for i in range(7))


def test_builtins_registered_and_run_in_graph():
    """The shipped presets registered at import; one runs as a clip source
    through the FrameGraph, as the JAX package's does."""
    from lives_tpu.graph import FrameGraph as JGraph
    from lives_tpu.graph import SinkSpec as JSink
    from lives_tpu_torch.graph import FrameGraph, SinkSpec
    for name in tm.BUILTIN_PRESETS:
        assert f"milk_{name}" in list_filters()
    clip = GeneratorClip("milk_pulse", width=W, height=H, fps=30.0,
                         device="cpu")
    jclip = JClip("milk_pulse", width=W, height=H, fps=30.0)
    g = FrameGraph([], sink=SinkSpec(width=W, height=H), fps=30.0)
    jg = JGraph([], sink=JSink(width=W, height=H), fps=30.0)
    frames = []
    for i in range(3):
        out = g.run([clip.get_frame(i)], tc=i / 30.0, frame=i)
        ref = jg.run([jclip.get_frame(i)], tc=i / 30.0, frame=i)
        got = out.planes[0].numpy()
        assert np.abs(got.astype(int) - np.asarray(ref.planes[0])
                      .astype(int)).max() <= 1
        frames.append(got)
    assert frames[0].shape[-2:] == (H, W)
    assert any(not np.array_equal(frames[i], frames[i + 1])
               for i in range(2))


def test_load_milk_preset_file(tmp_path):
    p = tmp_path / "My Cool Preset.milk"
    p.write_text(MILK_TEXT)
    f = tm.load_milk_preset(p)
    assert f.name == "milk_my cool preset" == jm.load_milk_preset(p).name
    outs, _ = both(f.name, 2)
    assert outs[0].shape == (3, 48, 64)


def test_open_generator_and_milk_clips(tmp_path):
    """What the JAX OSC endpoints /clip/open/generator and /clip/open/milk
    do (the port has no OSC server yet): a generator clip by filter name,
    and a .milk file loaded live then opened as a clip; frames equal the
    JAX clips' within 1 LSB."""
    p = tmp_path / "osc_preset.milk"
    p.write_text(MILK_TEXT)
    for name in ("milk_tunnel", None):
        if name is None:
            name = tm.load_milk_preset(str(p)).name
            assert name == jm.load_milk_preset(str(p)).name \
                == "milk_osc_preset"
        c = GeneratorClip(name, 64, 48, fps=30.0, device="cpu")
        jc = JClip(name, 64, 48, fps=30.0)
        assert c.name == name
        f0 = c.get_frame(0).planes[0].numpy()
        assert f0.shape == (3, 48, 64)
        assert np.abs(f0.astype(int) - np.asarray(
            jc.get_frame(0).planes[0]).astype(int)).max() <= 1


def test_audio_fft_drives_milk_preset_via_pconx():
    """tone -> audio_fft analyser -> pconx autoscale -> the milk
    generator's 'bass' param."""
    from lives_tpu_torch.audio import audio_instantiate
    from lives_tpu_torch.effects.data import DataConnections
    RATE = 44100
    t = np.arange(4096)
    loud = np.stack([np.sin(2 * np.pi * 80 * t / RATE)] * 2, -1) \
        .astype(np.float32) * 0.9
    quiet = loud * 0.01

    def bass_after(block, n):
        fft = audio_instantiate("audio_fft", freq=80.0, rate=RATE)
        clip = GeneratorClip("milk_tunnel", width=64, height=48, fps=30.0,
                             device="cpu")
        dc = DataConnections()
        dc.add(fft, "value", clip.inst, "bass", autoscale=True)
        for i in range(n):
            fft.apply(block)
            dc.chain_data(clip.inst)
            clip.get_frame(i)
        return float(clip.inst.values.get("bass", 0.0))
    assert bass_after(loud, 2) > bass_after(quiet, 1)


def test_post_filters_and_echo_affect_display_not_state():
    base = ("[p]\nfDecay=0.8\nwave_a=1.0\nwave_r=1.0\nwave_g=1.0\n"
            "wave_b=1.0\nnWaveMode=5\nfGammaAdj=1.0\n")
    a = reg(base, "plainpf")
    b = reg(base + "bInvert=1\nbSolarize=1\necho_alpha=0.4\n"
                   "echo_zoom=2.0\n", "postpf")
    outs_a, st_a = both(a, 3)
    outs_b, st_b = both(b, 3)
    np.testing.assert_allclose(st_a[-1][0], st_b[-1][0], atol=1e-6)
    assert any(not np.array_equal(x, y) for x, y in zip(outs_a, outs_b))


def test_invert_flips_display():
    name = reg("[p]\nfDecay=1.0\nzoom=1.0\nwarp=0.0\nwave_a=0.0\n"
               "fGammaAdj=1.0\nbInvert=1\n", "inv")
    outs, _ = both(name, 2)
    assert np.all(outs[0] == 255)


def test_wrap_toroidal_sampling():
    base = ("[p]\nfDecay=1.0\nzoom=0.62\nwarp=0.0\nwave_a=1.0\n"
            "wave_r=1.0\nwave_g=1.0\nwave_b=1.0\nnWaveMode=5\n"
            "wave_y=0.95\nfGammaAdj=1.0\n")
    a, _ = both(reg(base + "bWrap=1\n", "wr1"), 3)
    b, _ = both(reg(base + "bWrap=0\n", "wr0"), 3)
    assert any(not np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))


def test_player_pulls_stateful_generator_without_precache_race():
    """A milk preset as the fg clip with precache on: frames come from
    live per-tick pulls on the player's thread."""
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.player import CollectSink, Player
    clip = GeneratorClip("milk_pulse", width=64, height=48, fps=30.0,
                         device="cpu")
    pulls = []
    orig = clip.get_frame
    main = threading.get_ident()

    def spy(n):
        pulls.append((n, threading.get_ident()))
        return orig(n)
    clip.get_frame = spy
    p = Player(sink=CollectSink(), sink_spec=SinkSpec(), device="cpu")
    p.precache_depth = 4
    p.state.fg_clip = clip
    p.start()
    for i in range(5):
        p.state.frame = -1
        p._clock0 = time.monotonic()
        p._frame0 = float(i)
        p.process_one()
    time.sleep(0.1)
    p.stop()
    assert len(pulls) >= 5
    assert all(t == main for _n, t in pulls)
    assert len(p.sink.frames) >= 5


def test_authentic_milk_key_spellings():
    text = """[preset00]
fRating=3.0
fGammaAdj=1.0
fDecay=0.9
fVideoEchoZoom=2.0
fVideoEchoAlpha=0.5
nVideoEchoOrientation=1
nWaveMode=5
bTexWrap=0
bDarkenCenter=1
fWaveAlpha=1.0
fWaveScale=1.2
fWaveParam=0.3
fZoomExponent=2.5
fWarpAnimSpeed=1.5
fWarpScale=1.3
zoom=1.02
rot=0.0
warp=0.1
per_frame_1=zoom = zoom + 0.01*sin(time*0.7);
per_pixel_1=zoom = zoom + 0.02*rad;
"""
    name = reg(text, "authentic")
    outs, states = both(name, 4)
    assert np.isfinite(states[-1][0]).all()
    assert outs[0].max() > 0
    shown = outs[-1].astype(np.float32) / 255.0
    assert not np.allclose(shown, np.clip(states[-1][0], 0, 1),
                           atol=1 / 255.0)


# ---------------------------------------------------------------------------
# custom waves / shapes


SHAPE_TEXT = """[preset00]
fDecay=1.0
zoom=1.0
warp=0.0
wave_a=0.0
fGammaAdj=1.0
shapecode_1_enabled=1
shapecode_1_sides=4
shapecode_1_x=0.5
shapecode_1_y=0.5
shapecode_1_rad=0.4
shapecode_1_r=0
shapecode_1_g=1
shapecode_1_b=0
shapecode_1_a=1
shapecode_1_r2=0
shapecode_1_g2=1
shapecode_1_b2=0
shapecode_1_a2=1
shapecode_1_border_a=0
shapecode_2_enabled=0
shapecode_2_rad=0.9
shape_1_per_frame1=t1 = t1 + 1;
"""

WAVE_TEXT = """[preset00]
fDecay=1.0
zoom=1.0
warp=0.0
wave_a=0.0
fGammaAdj=1.0
wavecode_0_enabled=1
wavecode_0_bAdditive=0
wavecode_0_bDrawThick=1
wavecode_0_r=1
wavecode_0_g=0
wavecode_0_b=1
wavecode_0_a=1
wave_0_init1=t1 = 0.25;
wave_0_per_frame1=r = 1;
wave_0_per_point1=x = sample;
wave_0_per_point2=y = t1 + 0.0*value1;
"""


def test_parse_custom_objects():
    pre = tm.parse_preset(SHAPE_TEXT, "sh")
    assert_same_preset(pre, jm.parse_preset(SHAPE_TEXT, "sh"))
    assert 1 in pre.shapes and 2 in pre.shapes
    assert pre.shapes[1]["cfg"]["rad"] == pytest.approx(0.4)
    assert "t1 + 1" in pre.shapes[1]["frame"]
    pre2 = tm.parse_preset(WAVE_TEXT, "wv")
    assert_same_preset(pre2, jm.parse_preset(WAVE_TEXT, "wv"))
    assert pre2.waves[0]["cfg"]["bdrawthick"] == 1
    assert "t1 = 0.25" in pre2.waves[0]["init"]
    assert "y = t1" in pre2.waves[0]["point"]
    assert "t1" not in pre2.per_frame


def test_custom_shape_renders_gradient_fill():
    outs, _ = both(reg(SHAPE_TEXT, "cshape"), 2, h=64, w=64)
    o = outs[0].astype(np.float32)
    assert o[1, 32, 32] > 200 and o[0, 32, 32] < 30 and o[2, 32, 32] < 30
    assert o[:, 2, 2].max() == 0


def test_custom_shape_disabled_is_skipped():
    outs, _ = both(reg(SHAPE_TEXT, "cshape2"), 1, h=64, w=64)
    assert outs[0][:, 2, 2].max() == 0


def test_custom_wave_renders_along_per_point_path():
    outs, _ = both(reg(WAVE_TEXT, "cwave"), 2, h=64, w=64)
    o = outs[0].astype(np.float32)
    row = int(round(0.75 * 63))
    band = o[:, row - 3:row + 4, 8:56]
    assert band[0].max() > 120 and band[2].max() > 120
    assert band[1].max() < 60
    assert o[:, 4:12, :].max() < 10


def test_custom_shape_instances_and_code_animate():
    text = """[p]
fDecay=1.0
zoom=1.0
warp=0.0
wave_a=0.0
fGammaAdj=1.0
shapecode_0_enabled=1
shapecode_0_sides=32
shapecode_0_num_inst=2
shapecode_0_rad=0.18
shapecode_0_a=1
shapecode_0_a2=1
shapecode_0_r=1
shapecode_0_g=0
shapecode_0_b=0
shapecode_0_r2=1
shapecode_0_g2=0
shapecode_0_b2=0
shapecode_0_border_a=0
shape_0_per_frame1=x = 0.25 + 0.5*instance;
shape_0_per_frame2=y = 0.5 + 0.2*sin(time);
"""
    outs, _ = both(reg(text, "cinst"), 3, h=64, w=64)
    o0 = outs[0].astype(np.float32)
    assert o0[0, 32, 16] > 200 and o0[0, 32, 48] > 200
    assert o0[0, 32, 32] < 50
    assert not np.array_equal(outs[0], outs[2])


def test_textured_shape_samples_previous_frame():
    text = """[p]
fDecay=1.0
zoom=1.0
warp=0.0
wave_a=0.8
wave_r=1
wave_g=1
wave_b=1
nWaveMode=5
fGammaAdj=1.0
shapecode_0_enabled=1
shapecode_0_sides=4
shapecode_0_textured=1
shapecode_0_rad=0.3
shapecode_0_tex_zoom=0.5
shapecode_0_r=1
shapecode_0_g=1
shapecode_0_b=1
shapecode_0_a=1
shapecode_0_a2=1
shapecode_0_r2=1
shapecode_0_g2=1
shapecode_0_b2=1
shapecode_0_border_a=0
"""
    outs, states = both(reg(text, "ctex"), 3, h=64, w=64)
    assert np.isfinite(states[-1][0]).all()
    assert outs[2].max() > 0


def test_custom_objects_deterministic():
    name = reg(WAVE_TEXT, "cwdet")
    a, _ = run_port(name, 3)
    b, _ = run_port(name, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_motion_vector_grid_draws_lattice():
    text = """[p]
fDecay=1.0
zoom=1.02
warp=0.0
wave_a=0.0
fGammaAdj=1.0
nMotionVectorsX=4
nMotionVectorsY=3
mv_a=1.0
mv_r=1
mv_g=0
mv_b=0
"""
    outs, _ = both(reg(text, "cmv"), 2, h=96, w=96)
    o = outs[0].astype(np.float32)
    lit = (o[0] > 100).mean()
    assert o[0].max() > 150
    assert o[1].max() < 40
    assert 0.0 < lit < 0.2


def test_motion_vectors_off_by_default():
    outs, _ = both(reg("[p]\nfDecay=1.0\nzoom=1.0\nwarp=0.0\nwave_a=0.0\n"
                       "fGammaAdj=1.0\n", "nomv"), 2, h=64, w=64)
    assert all(o.max() == 0 for o in outs)


def test_geometry_builtin_runs_with_audio():
    name = reg(tm.BUILTIN_PRESETS["geometry"], "geom_t")
    outs, states = both(name, 5, params={"bass": 0.9, "mid": 0.4,
                                         "treb": 0.5, "vol": 0.6})
    assert np.isfinite(states[-1][0]).all()
    assert outs[2].max() > 0
    assert any(not np.array_equal(outs[i], outs[i + 1]) for i in range(4))


MEGABUF_TEXT = """[p]
fDecay=0.9
wave_a=0.6
per_frame_1=megabuf(frame%7) = bass + frame;
per_frame_2=q3 = megabuf((frame+3)%7) + gmegabuf(2);
per_frame_3=gmegabuf(2) = gmegabuf(2) + 0.5;
per_frame_4=zoom = 1.0 + 0.01*q3;
per_pixel_1=megabuf(int(x*5)) = y;
per_pixel_2=gmegabuf(1048576 + x) = 9;
"""


def test_megabuf_scatter_colliding_indices():
    """megabuf/gmegabuf persist frame to frame in the state; the per-pixel
    write hits 5 indices from 3,072 pixels, and the last writer in
    row-major order wins (the bottom row's y), as XLA's CPU scatter;
    an out-of-range write changes nothing."""
    name = reg(MEGABUF_TEXT, "mbuf")
    outs, states = both(name, 4, params=audio(7, 4))
    mb, gmb = states[-1][3], states[-1][4]
    assert mb.shape == gmb.shape == (tm.BUF_N,)
    # the bottom row wrote last: y = 1 - 47 / 47, an FMA away from 0
    assert np.all(mb[:5] == mb[0]) and 0.0 <= mb[0] < 1e-7
    assert gmb[2] == pytest.approx(2.0)
    assert gmb[1048575] == 0.0
    t = torch.zeros(8)
    idx = torch.tensor([[1, 3, 1], [3, 1, 5]], dtype=torch.float32)
    v = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = tm.buf_write(t, idx, v)
    np.testing.assert_array_equal(got.numpy(), [0, 4, 0, 3, 0, 5, 0, 0])


def test_milkdir_playlist_cycle(tmp_path):
    """projectM's preset-directory role on the clip: a playlist cycles in
    place; frames keep flowing and `version` counts each switch (the JAX
    OSC method /clip/open/milkdir sets `playlist` the same way)."""
    (tmp_path / "a_first.milk").write_text(
        "[p]\nfDecay=0.9\nzoom=1.0\nwarp=0.0\nwave_a=1.0\nnWaveMode=5\n")
    (tmp_path / "b_second.milk").write_text(
        "[p]\nfDecay=0.5\nzoom=1.01\nwarp=0.1\nwave_a=0.6\n")
    names = [tm.load_milk_preset(f).name
             for f in sorted(tmp_path.glob("*.milk"))]
    for f in sorted(tmp_path.glob("*.milk")):
        jm.load_milk_preset(f)
    clip = GeneratorClip(names[0], 64, 48, 25.0, device="cpu")
    jclip = JClip(names[0], 64, 48, 25.0)
    clip.playlist = jclip.playlist = names
    assert clip.name == "milk_a_first"
    f0 = clip.get_frame(0).planes[0].numpy()
    v0 = clip.version
    assert clip.cycle() == jclip.cycle() == 1
    assert clip.name == "milk_b_second" and clip.version == v0 + 1
    f1 = clip.get_frame(1).planes[0].numpy()
    assert f1.shape == f0.shape
    assert np.abs(f1.astype(int) - np.asarray(jclip.get_frame(1).planes[0])
                  .astype(int)).max() <= 1
    clip.cycle()
    assert clip.name == "milk_a_first"
    clip.switch("milk_b_second")
    assert clip.name == "milk_b_second"


def test_milk_parser_fuzz_no_crash():
    """Untrusted preset files parse-or-raise ValueError and build-or-raise
    ValueError in both packages alike; good builds render."""
    import random
    rng = random.Random(7)
    frags = [
        "[preset00]", "fDecay=abc", "fDecay=", "=5", "zoom=1.01",
        "shapecode_0_enabled=1", "shapecode_0_sides=-3",
        "shapecode_0_sides=1000000", "shapecode_99_rad=nan",
        "shapecode_0_num_inst=99", "shape_0_per_frame1=x = x + ",
        "shape_0_per_frame1=x = q1*2;", "shape_0_init1=t1 = rand(1);",
        "wavecode_0_enabled=1", "wavecode_0_samples=0",
        "wave_0_per_point1=y = value1/0;", "wave_0_per_point1=x = (",
        "wave_0_per_frame1=r = unknownfn(1);",
        "per_frame_1=zoom = zoom + bass*;", "per_pixel_1=rot = rad*ang;",
        "per_frame_abc=zoom=2", "warp_1=shader { }", "comp_1=float4 x;",
        "nMotionVectorsX=9999", "mv_a=2", "mv_l=-5",
        "fDecay=nan", "zoom=inf", "shapecode_0_rad=nan", "mv_a=inf",
        "\x00\x01binary=1", "a" * 500 + "=1",
    ]
    built = 0
    for trial in range(60):
        text = "\n".join(rng.choice(frags)
                         for _ in range(rng.randrange(1, 14)))
        pre = tm.parse_preset(text, f"fuzz{trial}")
        assert_same_preset(pre, jm.parse_preset(text, f"fuzz{trial}"))
        try:
            process, init_state = tm.build_preset_process(pre)
        except ValueError:
            with pytest.raises(ValueError):
                jm.build_preset_process(jm.parse_preset(text, "f"))
            continue
        jpre = jm.parse_preset(text, "f")
        jm.build_preset_process(jpre)
        assert sorted(pre.shader_fallback) == sorted(jpre.shader_fallback)
        state = init_state(32, 24, int(Palette.RGB24), "cpu")
        ctx = TContext(tc=torch.tensor(0.1), frame=torch.tensor(1),
                       fps=30.0, width=32, height=24, device="cpu")
        p = {"bass": 0.5, "mid": 0.5, "treb": 0.5, "vol": 0.5}
        layer, state = process([], p, ctx, state)
        arr = layer.planes[0].numpy()
        assert arr.dtype == np.uint8 and np.isfinite(state[0].numpy()).all()
        built += 1
    assert built > 10


def test_milkdir_skips_out_of_subset_presets(tmp_path):
    """An unloadable preset (unknown function) raises ValueError at load
    in both packages, which the JAX directory opener skips; a good one
    loads."""
    (tmp_path / "good.milk").write_text("[p]\nfDecay=0.9\nwave_a=1\n")
    (tmp_path / "bad.milk").write_text(
        "[p]\nper_frame_1=q1 = freembuf(0);\n")
    for load in (tm.load_milk_preset, jm.load_milk_preset):
        with pytest.raises(ValueError):
            load(tmp_path / "bad.milk")
        assert load(tmp_path / "good.milk").name == "milk_good"


def test_generator_switch_race_with_live_pulls():
    """switch() on another thread while frames are pulled never feeds the
    new filter the old filter's state."""
    reg("[p]\nfDecay=0.9\nwave_a=1\nnWaveMode=5\n", "ra")
    reg("[p]\nfDecay=0.5\nzoom=1.01\nwave_a=0.4\n", "rb")
    clip = GeneratorClip("milk_ra", width=48, height=32, fps=30.0,
                         device="cpu")
    errs = []
    stop = threading.Event()

    def puller():
        n = 0
        while not stop.is_set():
            try:
                clip.get_frame(n)
                n += 1
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                return
    th = threading.Thread(target=puller)
    th.start()
    try:
        for i in range(30):
            clip.switch("milk_rb" if i % 2 == 0 else "milk_ra")
    finally:
        stop.set()
        th.join(timeout=30)
    assert not errs, errs


def test_autocycle_switches_presets_during_playback(tmp_path):
    """projectM presetDuration role: with autocycle set, the player
    switches the playlist at safe points on its own clock."""
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.player import NullSink, Player
    reg("[p]\nfDecay=0.9\nwave_a=1\n", "a")
    reg("[p]\nfDecay=0.5\nzoom=1.01\n", "b")
    p = Player(sink=NullSink(), sink_spec=SinkSpec(width=48, height=32),
               fps=30.0, device="cpu")
    clip = GeneratorClip("milk_a", 48, 32, 30.0, device="cpu")
    clip.playlist = ["milk_a", "milk_b"]
    clip.autocycle_secs = 0.2
    p.state.fg_clip = clip
    p.set_pb_fps(30.0)
    p.start()
    names = {clip.name}
    t0 = time.monotonic()
    while time.monotonic() - t0 < 20.0 and len(names) < 2:
        p.process_one()
        names.add(clip.name)
        time.sleep(0.002)
    p.stop()
    assert names == {"milk_a", "milk_b"}
    clip.autocycle_secs = 0
    assert not clip.maybe_autocycle(time.monotonic() + 100)
