"""The HLSL-subset evaluator of lives_tpu_torch (`effects/milkshader.py`)
against lives_tpu's, and MilkDrop 2 presets through both packages.

Each case of tests/test_milkshader.py runs on the port, and the JAX
evaluator runs the same shader under `jax.jit` (the plan its presets run
in) on the same uniforms and canvas: values agree within SHADER_ATOL (a
few ulps of values near 1: the samplers' float64 box-blur sums and the
float64 atan2/tan/asin round otherwise than XLA; the rest is bit for
bit). The corpus of `tools/milk_corpus.build_corpus(20)` (imported, not
edited) parses, builds and falls back alike in both packages, and two
presets of each era run 3 frames within +-1 LSB of the JAX jitted plan.
"""

import jax
import numpy as np
import pytest
import torch

from lives_tpu.effects import milkdrop as jm
from lives_tpu.effects import milkshader as js
from lives_tpu_torch.effects import milkdrop as tm
from lives_tpu_torch.effects import milkshader as ts
from test_torch_milkdrop import (assert_frames_match,  # noqa: F401
                                 registries, run_jax, run_port)
from tools.milk_corpus import build_corpus

SHADER_ATOL = 2e-6


def _grid(h=12, w=16):
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None] * np.ones(
        (1, w), np.float32)
    xs = np.linspace(0, 1, w, dtype=np.float32)[None] * np.ones(
        (h, 1), np.float32)
    return xs, ys


def _uniforms(vec, xs, ys, rad, ang, h, w):
    env = {"uv": vec([xs, ys]), "uv_orig": vec([xs, ys]),
           "rad": rad, "ang": ang,
           "time": 1.5, "frame": 10.0, "fps": 30.0, "decay": 0.97,
           "gamma": 2.0, "progress": 0.0,
           "texsize": vec([float(w), float(h), 1. / w, 1. / h]),
           "aspect": vec([1.0, w / h, 1.0, h / w]),
           "hue_shader": vec([1.0, 0.8, 0.6]),
           "rand_frame": vec([.1, .2, .3, .4]),
           "rand_preset": vec([.5, .6, .7, .8]),
           "roam_cos": vec([.5] * 4), "roam_sin": vec([.5] * 4),
           "slow_roam_cos": vec([.5] * 4),
           "slow_roam_sin": vec([.5] * 4),
           "bass": 1.0, "mid": 1.0, "treb": 1.0, "vol": 1.0,
           "bass_att": 1.0, "mid_att": 1.0, "treb_att": 1.0,
           "vol_att": 1.0}
    for k in range(32):
        env[f"q{k + 1}"] = 0.25
    return env


def _run(src, canvas=None, extra=None, h=12, w=16):
    """The port's output of `src` (3, h, w), held against the JAX
    evaluator jitted over the grid and canvas."""
    xs, ys = _grid(h, w)
    rad = np.sqrt((xs - .5) ** 2 + (ys - .5) ** 2).astype(np.float32)
    ang = np.arctan2(ys - .5, xs - .5).astype(np.float32)
    if canvas is None:
        canvas = np.zeros((3, h, w), np.float32)
    canvas = np.array(canvas, np.float32)

    jprog = js.compile_hlsl(src)

    def jrun(xs_, ys_, rad_, ang_, canvas_):
        env = _uniforms(js.Vec, xs_, ys_, rad_, ang_, h, w)
        env.update(extra or {})
        return jprog.run(env, lambda name: canvas_)
    ref = np.asarray(jax.jit(jrun)(xs, ys, rad, ang, canvas))

    t = torch.from_numpy
    env = _uniforms(ts.Vec, t(xs), t(ys), t(rad), t(ang), h, w)
    env.update(extra or {})
    tcanvas = t(canvas)
    got = ts.compile_hlsl(src).run(env, lambda name: tcanvas).numpy()
    assert got.shape == ref.shape == (3, h, w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SHADER_ATOL)
    return got


def test_constant_ret():
    out = _run("shader_body { ret = float3(0.25, 0.5, 0.75); }")
    assert np.allclose(out[0], 0.25) and np.allclose(out[2], 0.75)


def test_swizzle_read_write_and_compound_ops():
    out = _run("""shader_body {
        float3 c = float3(0.1, 0.2, 0.3);
        c.xy = c.yx;
        c *= 2;
        c.z += 0.4;
        ret = c;
    }""")
    assert np.allclose(out[0], 0.4)
    assert np.allclose(out[1], 0.2)
    assert np.allclose(out[2], 1.0)


def test_tex2d_samples_canvas():
    h, w = 12, 16
    canvas = np.broadcast_to(np.linspace(0, 1, w, dtype=np.float32),
                             (3, h, w))
    out = _run("shader_body { ret = tex2D(sampler_fc_main, uv).xyz; }",
               canvas=canvas, h=h, w=w)
    assert np.allclose(out[0, 0], np.linspace(0, 1, w), atol=1e-4)


def test_tex2d_unprefixed_sampler_follows_btexwrap():
    h, w = 12, 16
    canvas = np.broadcast_to(np.linspace(0, 1, w, dtype=np.float32),
                             (3, h, w))
    src = """shader_body {
        float2 uv2 = uv + float2(1.25 - uv.x, 0);
        ret = tex2D(sampler_main, uv2).xyz;
    }"""
    wrapped = _run(src, canvas=canvas, h=h, w=w)
    assert np.allclose(wrapped[0], 0.25, atol=0.05)
    clamped = _run(src, canvas=canvas, h=h, w=w, extra={"_texwrap": 0.0})
    assert np.allclose(clamped[0], 1.0, atol=1e-4)


def test_intrinsics_lerp_dot_saturate_pow():
    out = _run("""shader_body {
        float3 a = float3(1, 0.5, 0);
        float g = dot(a, float3(0.32, 0.49, 0.29));
        ret = lerp(a, float3(g, g, g), 0.5);
        ret = pow(saturate(ret), 2.0);
    }""")
    g = 0.32 + 0.5 * 0.49
    exp = ((np.array([1.0, 0.5, 0.0]) + g) / 2) ** 2
    assert np.allclose(out[:, 0, 0], exp, atol=1e-5)


def test_uniforms_and_ternary():
    out = _run("shader_body { ret = (q1 > 0.2) ? float3(1,1,1)"
               " : float3(0,0,0); }")
    assert np.allclose(out, 1.0)


def test_getblur_and_noise_run():
    h, w = 16, 16
    canvas = np.zeros((3, h, w), np.float32)
    canvas[:, 8, 8] = 1.0
    out = _run("""shader_body {
        ret = GetBlur1(uv) + 0.1 * tex2D(sampler_noise_lq, uv*4).xyz;
    }""", canvas=canvas, h=h, w=w)
    assert np.isfinite(out).all()
    assert out.max() > 0


@pytest.mark.parametrize("name,r", [("sampler_noise_lq", 1),
                                    ("sampler_noise_hq", 3),
                                    ("sampler_noisevol_lq", 8)])
def test_noise_and_blur_against_jax(name, r):
    """The value-noise lattice (int32 hashes that wrap) bit for bit, and
    the box blur within SHADER_ATOL (its float64 prefix sums against
    XLA's float32 scan: a few ulps), at 40x56 with a 3-D noise
    coordinate."""
    rng = np.random.default_rng(r)
    u = rng.uniform(-2, 3, (40, 56)).astype(np.float32)
    v = rng.uniform(-2, 3, (40, 56)).astype(np.float32)
    z = rng.uniform(0, 1, (40, 56)).astype(np.float32)
    cells = {"lq": 32, "hq": 256}[name[-2:]]
    ref = jax.jit(lambda a, b, c: js._value_noise(a, b, cells, t3=c,
                                                  seed=r))(u, v, z)
    got = ts._value_noise(torch.from_numpy(u), torch.from_numpy(v), cells,
                          "cpu", t3=torch.from_numpy(z), seed=r)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tex = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: js._box_blur(x, r))(tex))
    got = ts._box_blur(torch.from_numpy(tex), r).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SHADER_ATOL)


def test_control_flow_out_of_subset():
    for src in ("shader_body { while (q1 > 0) { ret = uv.xyx; } }",
                "shader_body { return; }"):
        for mod in (ts, js):
            with pytest.raises(ValueError, match="control flow"):
                mod.compile_hlsl(src)


def test_empty_compiles_to_none():
    assert ts.compile_hlsl("") is None
    assert ts.compile_hlsl("   \n") is None


SHADER_PRESET = """[preset00]
fDecay=0.96
wave_a=0.9
warp_1=`shader_body {
warp_2=`  float3 ret = tex2D(sampler_main, uv).xyz * decay;
warp_3=`}
comp_1=`shader_body {
comp_2=`  float3 ret = tex2D(sampler_main, uv).xyz;
comp_3=`  ret *= gamma;
comp_4=`}
"""


def test_preset_with_shaders_renders_and_falls_back_cleanly():
    pre = tm.parse_preset(SHADER_PRESET, "sh")
    tm.build_preset_process(pre)
    assert pre.shader_fallback == {}
    name = tm.register_milk_preset(SHADER_PRESET, "sh").name
    jm.register_milk_preset(SHADER_PRESET, "sh")
    bands = {"bass": 1.0, "mid": 1.0, "treb": 1.0, "vol": 1.0}
    port = run_port(name, 3, 24, 32, params=bands)
    assert_frames_match(run_jax(name, 3, 24, 32, params=bands), port)
    assert port[0][-1].max() > 0
    bad = SHADER_PRESET.replace("ret *= gamma;",
                                "while (ret.x < 4) { ret.x += 0.1; }")
    pre2 = tm.parse_preset(bad, "sh2")
    process2, init2 = tm.build_preset_process(pre2)
    jpre2 = jm.parse_preset(bad, "sh2")
    jm.build_preset_process(jpre2)
    assert pre2.shader_fallback == jpre2.shader_fallback
    assert "comp" in pre2.shader_fallback
    from lives_tpu_torch.effects.host import FrameContext
    lay2, _ = process2([], {"bass": 1.0, "mid": 1.0, "treb": 1.0,
                            "vol": 1.0},
                       FrameContext(tc=0.0, frame=0, fps=30.0, width=32,
                                    height=24), init2(32, 24, None, "cpu"))
    assert lay2.planes[0].shape == (1, 3, 24, 32)


def test_eval_time_shader_error_falls_back_at_build():
    txt = """[preset00]
fDecay=0.96
comp_1=`shader_body {
comp_2=`  float3 ret = tex2D(sampler_main, uv).xyz * no_such_uniform;
comp_3=`}
"""
    pre = tm.parse_preset(txt, "ev")
    process, init_state = tm.build_preset_process(pre)
    assert "comp" in pre.shader_fallback
    assert "no_such_uniform" in pre.shader_fallback["comp"]
    from lives_tpu_torch.effects.host import FrameContext
    lay, _ = process([], {"bass": 1.0, "mid": 1.0, "treb": 1.0, "vol": 1.0},
                     FrameContext(tc=0.0, frame=0, fps=30.0, width=32,
                                  height=24), init_state(32, 24, None, "cpu"))
    assert lay.planes[0].shape == (1, 3, 24, 32)


def test_blur_minmax_uniforms_available():
    txt = """[preset00]
comp_1=`shader_body {
comp_2=`  float3 ret = tex2D(sampler_blur1, uv).xyz * blur1_max + blur2_min;
comp_3=`}
"""
    pre = tm.parse_preset(txt, "bl")
    tm.build_preset_process(pre)
    assert pre.shader_fallback == {}


def test_ternary_vector_condition_is_componentwise():
    out = _run("""shader_body {
        float3 c = float3(1, 0, 1);
        ret = c ? float3(0.2, 0.4, 0.6) : float3(0.9, 0.8, 0.7);
    }""")
    assert np.allclose(out[0], 0.2)
    assert np.allclose(out[1], 0.8)
    assert np.allclose(out[2], 0.6)


def test_ternary_scalar_condition_broadcasts():
    out = _run("""shader_body {
        ret = (q1 > 0.2) ? float3(0.1, 0.2, 0.3) : float3(1, 1, 1);
    }""")
    assert np.allclose(out[0], 0.1) and np.allclose(out[2], 0.3)


def test_if_static_condition_picks_branch():
    out = _run("""shader_body {
        float3 c = float3(0, 0, 0);
        if (q1 > 0.2) { c = float3(0.3, 0.3, 0.3); }
        else c = float3(0.9, 0.9, 0.9);
        ret = c;
    }""")
    assert np.allclose(out, 0.3)


def test_if_traced_condition_merges_per_pixel():
    out = _run("""shader_body {
        float3 c = float3(0.1, 0.1, 0.1);
        float k = 0;
        if (uv.x > 0.5) { c.x = 0.9; k = 1; }
        else { c.y = 0.7; }
        ret = float3(c.x, c.y, k);
    }""")
    xs = np.linspace(0, 1, 16)
    left, right = xs <= 0.5, xs > 0.5
    assert np.allclose(out[0, 0, right], 0.9)
    assert np.allclose(out[0, 0, left], 0.1)
    assert np.allclose(out[1, 0, left], 0.7)
    assert np.allclose(out[1, 0, right], 0.1)
    assert np.allclose(out[2, 0, right], 1.0)
    assert np.allclose(out[2, 0, left], 0.0)


def test_for_loop_unrolls_statically():
    out = _run("""shader_body {
        float s = 0;
        for (int i = 0; i < 5; i++) { s += 0.1; }
        float t = 0;
        for (int j = 1; j <= 3; j += 1) t += j;
        ret = float3(s, t, 0.5);
    }""")
    assert np.allclose(out[0], 0.5, atol=1e-6)
    assert np.allclose(out[1], 6.0)


def test_for_loop_var_usable_in_body():
    h, w = 12, 16
    out = _run("""shader_body {
        float3 acc = float3(0, 0, 0);
        for (int i = 0; i < 4; i++) {
            acc += tex2D(sampler_fc_main, uv + float2(i * 0.01, 0)).xyz;
        }
        ret = acc * 0.25;
    }""", canvas=np.full((3, h, w), 0.5, np.float32), h=h, w=w)
    assert np.allclose(out, 0.5, atol=1e-5)


def test_for_unroll_budget_rejected():
    for mod in (ts, js):
        with pytest.raises(ValueError, match="unrolled"):
            mod.compile_hlsl("""shader_body {
                float s = 0;
                for (int i = 0; i < 100; i++)
                    for (int j = 0; j < 100; j++) s += 0.001;
            }""")
        with pytest.raises(ValueError, match="constant"):
            mod.compile_hlsl("shader_body { for (int i = 0; i < q1; i++) "
                             "{ ret.x += 1; } }")


def test_nested_if_in_for():
    out = _run("""shader_body {
        float odd = 0;
        for (int i = 0; i < 4; i++) {
            if (i % 2 == 1) odd += 1;
        }
        ret = float3(odd, odd, odd);
    }""")
    assert np.allclose(out, 2.0)


@pytest.mark.parametrize("src", [
    "shader_body { ret = sin(uv.x*6.28 + time) * cos(uv.y*3 - rad) + "
    "exp(-rad*2) + log(uv.x + 0.5) + frac(uv*7.3).xyx; }",
    "shader_body { float2 d = uv - 0.5; ret = smoothstep(0.1, 0.6, "
    "length(d)) + step(0.5, uv.y) + fmod(uv.x*5, 0.7) + lum(float3(uv, "
    "q1)) + normalize(float3(d, 0.3)); }",
    "shader_body { float3 c = tex2D(sampler_main, uv*1.3 - 0.1).xyz; "
    "ret = clamp(c*gamma, 0.2, 0.8) + max(c, q2) - min(c.zyx, 0.5) + "
    "cross(c, float3(0.2, 0.4, 0.6)) * 0.5; }",
    "shader_body { float3 c = GetBlur2(uv) - GetBlur3(uv.yx) + "
    "GetPixel(uv); c = (c.x > 0.4) ? c.yzx : 1 - c; ret = c / (rad + "
    "0.1) % 0.9; }",
])
def test_intrinsics_against_jax(src):
    """Mixed intrinsics, samplers and arithmetic on a random canvas."""
    canvas = np.random.default_rng(len(src)).uniform(
        0, 1, (3, 24, 32)).astype(np.float32)
    out = _run(src, canvas=canvas, h=24, w=32)
    assert np.isfinite(out).all()


# ---------------------------------------------------------------------------
# the corpus (tools/milk_corpus.py)


CORPUS = build_corpus(20)


def test_corpus_decisions_match_jax():
    """All 80 presets: the same parse, the same build outcome and the same
    shader fallbacks (which blocks, and why) as the JAX package."""
    counts = {}
    for name, era, text in CORPUS:
        pre, jpre = tm.parse_preset(text, name), jm.parse_preset(text, name)
        for f in ("init", "per_frame_init", "per_frame", "per_pixel",
                  "shapes", "waves", "warp_code", "comp_code"):
            assert getattr(pre, f) == getattr(jpre, f), (name, f)
        tm.build_preset_process(pre)
        jm.build_preset_process(jpre)
        assert pre.shader_fallback == jpre.shader_fallback, name
        c = counts.setdefault(era, [0, 0])
        c[0] += 1
        c[1] += bool(pre.warp_code.strip() or pre.comp_code.strip()) \
            and not pre.shader_fallback
    # tools/milk_corpus.py's table: 20 a era; era3/era3b's 40 shaders in
    # subset
    assert counts == {"era1": [20, 0], "era2": [20, 0], "era3": [20, 20],
                      "era3b": [20, 20]}


@pytest.mark.parametrize("idx", [0, 7, 20, 33, 40, 45, 60, 71])
def test_corpus_presets_run_against_jax(idx):
    """Two presets of each era, 3 frames at 64x48: u8 within 1 LSB, q-vars
    and megabufs exact, canvas within CANVAS_ATOL."""
    name, era, text = CORPUS[idx]
    jm.register_milk_preset(text, name)
    fname = tm.register_milk_preset(text, name).name
    params = {"bass": 1.0, "mid": 0.8, "treb": 0.6, "vol": 0.9}
    outs, states = run_port(fname, 3, params=params)
    assert_frames_match(run_jax(fname, 3, params=params), (outs, states))
    assert all(np.isfinite(s[0]).all() for s in states)
