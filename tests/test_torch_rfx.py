"""Rendered effects of lives_tpu_torch against lives_tpu's on the CPU:
`rfx.apply_rendered_effect` and its undo, `resize_all`, the RFX param and
special parsers, every script of the `rfx_scripts` registry (as
tests/test_rfx_scripts2.py::test_full_reference_coverage counts them: the
registry and the `gen_*` generators) against the JITTED JAX script, and
`rfx_builder`.

Inputs are seeded numpy frames: a YUV4MPEG2 clip opened by both packages
(virtual frames, converted to RGB on the way in) or a clip of image
frames, 48x32, 8 frames; the port runs with `device="cpu"`. The JAX
package renders through its jitted `FrameGraph.run_batch` and jitted
transition steps, with its float32 chain (`LIVES_TPU_CHAIN_DTYPE=f32`).
Tolerances: 0 LSB where the port computes the jit's arithmetic (every
point script, the hard selects posterize, solarize, noise, spread, edge,
bwthresh and jumble's order: 0 flips), at most 1 LSB for the warps and
resamplers whose bilinear taps or resize products round an ulp apart
(`MAX_LSB`); PNG files byte for byte wherever the pixels are equal;
headers and the undo trees byte for byte.
"""

import numpy as np
import pytest
from PIL import Image

from lives_tpu import rfx as jrfx
from lives_tpu import rfx_builder as jbuild
from lives_tpu import rfx_scripts as jrs
from lives_tpu_torch import rfx as trfx
from lives_tpu_torch import rfx_builder as tbuild
from lives_tpu_torch import rfx_scripts as trs
from test_torch_clips import assert_clips_match, image_pair, tree, y4m_pair

CPU = "cpu"


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


#: scripts whose frames may differ by one LSB: bilinear warps (rotate by a
#: ramp, zooms, swirl, spread's taps, deinterlace's and emboss's taps,
#: pixelate's block means, dream's blur-and-screen) and resizes, where
#: torch and XLA round a coordinate, a sum or a product an ulp apart;
#: every other script is bit for bit
MAX_LSB = {name: 1 for name in (
    "cycle", "deinterlace", "dream", "emboss", "pan_and_zoom", "pixilate",
    "randomzoom", "resize", "spin", "swirl", "trim_frames", "spread")}


def _overlay_png(tmp_path):
    p = tmp_path / "ov.png"
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (10, 12, 4), np.uint8), "RGBA").save(p)
    return p


def _script_args(name, tmp_path, kind):
    """(JAX kwargs, port kwargs) that exercise a script."""
    if name.startswith("transition_"):
        pair = (y4m_pair if kind == "y4m" else image_pair)(
            tmp_path / "other", seed=9)
        extra = {"transition_fade": {"pstart": 0.1, "pend": 0.9},
                 "transition_bwthresh": {"thresh": 0.45},
                 "transition_checkerboard": {"tiles": 3},
                 "transition_splice": {"keep": 2, "insert": 3}}[name]
        return {"other": pair[0], **extra}, {"other": pair[1], **extra}
    kw = {"image_overlay": {"image": str(_overlay_png(tmp_path)), "x": 5,
                            "y": -3, "alpha": 0.7, "dx": 1.5,
                            "dscale": 0.1, "dalpha": -0.05},
          "jumble": {"seed": 7},
          "resize": {"width": 40, "height": 24},
          "textover": {"text": "hi", "size": 12},
          "trim_frames": {"x": 4, "y": 2, "width": 20, "height": 10},
          "skip_forwards": {"skip": 3, "pc_start": 30.0, "pc_step": 15.0},
          "photo_still": {"flash": 1, "hold": 3},
          "fade_in_out": {"direction": 1},
          "modulate": {"bstart": 80.0, "bend": 1.2, "sstart": 0.5},
          "cycle": {"shift": 20.0, "step": 35.0},
          "pan_and_zoom": {"zend": 3.0, "xend": 0.2, "yend": 0.3},
          "posterize": {"levels": 3},
          "noisify": {"mono": True},
          "spin": {"turns": 0.5}}.get(name, {})
    return kw, dict(kw)


SCRIPTS = jrs.list_scripts()


def test_registry_matches_jax():
    """Every script of the JAX registry, with the same filter, defaults
    and advertised params; runners take the same params."""
    assert trs.list_scripts() == SCRIPTS
    for name in SCRIPTS:
        j, t = jrs.get_script(name), trs.get_script(name)
        assert (t.filter, t.defaults, t.runner is None) == \
            (j.filter, j.defaults, j.runner is None), name
        assert t.params_spec() == j.params_spec(), name
        assert trs.script_specials(name) == jrs.script_specials(name) == []
    for v in ("3", "-2", "0.5", "x", 4):
        assert trs.parse_param_value(v) == jrs.parse_param_value(v)


@pytest.mark.parametrize("kind", ["y4m", "images"])
@pytest.mark.parametrize("name", SCRIPTS)
def test_script_matches_jitted_jax(tmp_path, name, kind):
    jc, tc = (y4m_pair if kind == "y4m" else image_pair)(tmp_path / "c")
    jkw, tkw = _script_args(name, tmp_path, kind)
    if name == "tunnel":
        # the JAX mapping names a param lens does not have: both refuse
        with pytest.raises(KeyError, match="amount"):
            jrs.apply_script(jc, name, **jkw)
        with pytest.raises(KeyError, match="amount"):
            trs.apply_script(tc, name, device=CPU, **tkw)
        return
    start, end = (1, 7) if name not in ("resize",) else (0, None)
    nj = jrs.apply_script(jc, name, start=start, end=end, **jkw)
    nt = trs.apply_script(tc, name, start=start, end=end, device=CPU, **tkw)
    assert nt == nj
    assert_clips_match(jc, tc, tol=MAX_LSB.get(name, 0))


def test_apply_script_batches_and_progress(tmp_path):
    """Batches of 3 against the JAX package's 32, a per-frame ramp
    (`fade_in_out`) and progress calls as the JAX engine makes them."""
    jc, tc = y4m_pair(tmp_path)
    jp, tp = [], []
    jrs.apply_script(jc, "fade_in_out", 2, 8,
                     progress=lambda a, b: jp.append((a, b)))
    trs.apply_script(tc, "fade_in_out", 2, 8, batch_size=3, device=CPU,
                     progress=lambda a, b: tp.append((a, b)))
    assert tp == jp == [(k, 6) for k in range(1, 7)]
    assert_clips_match(jc, tc)


def test_rendered_effect_and_undo_trees_match_jax(tmp_path):
    """apply + undo: the clip directories are the JAX package's byte for
    byte after each step, and the undo restores the tree it started
    from (virtual entries back to the decoder, images back)."""
    jc, tc = y4m_pair(tmp_path)
    for c in (jc, tc):
        c.realize(0, 2) if c is jc else c.realize(0, 2, device=CPU)
        c.save_header()
    start_t = tree(tc.clip_dir)
    vals = {"saturation": lambda f: 0.25 * f}
    nj = jrfx.apply_rendered_effect(jc, "saturation", 1, 6, values=vals)
    nt = trfx.apply_rendered_effect(tc, "saturation", 1, 6, values=vals,
                                    batch_size=2, device=CPU)
    assert nt == nj == 5
    assert_clips_match(jc, tc)
    assert tree(tc.clip_dir / trfx.UNDO_DIR) == \
        tree(jc.clip_dir / jrfx.UNDO_DIR)
    assert trfx.undo_rendered_effect(tc) and jrfx.undo_rendered_effect(jc)
    assert tree(tc.clip_dir) == start_t == tree(jc.clip_dir)
    assert not trfx.undo_rendered_effect(tc)


def test_resize_all_matches_jax(tmp_path):
    jc, tc = y4m_pair(tmp_path, n=5)
    assert trfx.resize_all(tc, 36, 20, batch_size=2, device=CPU) == \
        jrfx.resize_all(jc, 36, 20) == 5
    assert (tc.width, tc.height) == (36, 20)
    assert_clips_match(jc, tc, tol=1)


SCRIPT_TEXT = """
<params>
amount|_Amount|num2|0.5|0.|1.
passes|_Passes|num0|2|1|10
invert|_Invert|bool|1
col|_Colour|colRGB24|255|0|128
mode|_Mode|string_list|1|fast|slow|best
name|_Name|string|hello
</params>
<param_window>
special|aspect|0|1|
special|fileread|5|
special|framedraw|rectdemask|0|1|7|
special|password|name|
layout|p0|p1|
</param_window>
"""


def test_rfx_param_and_special_parsers_match_jax():
    tp = trfx.parse_rfx_params(SCRIPT_TEXT)
    assert tp == jrfx.parse_rfx_params(SCRIPT_TEXT)
    assert [p["name"] for p in tp] == ["amount", "passes", "invert", "col",
                                      "mode", "name"]
    assert trfx.parse_rfx_specials(SCRIPT_TEXT, tp) == \
        jrfx.parse_rfx_specials(SCRIPT_TEXT, tp)
    assert trfx.parse_rfx_params("no params") == []


# -- generators ---------------------------------------------------------------

@pytest.mark.parametrize("gen", ["coloured", "blank", "text", "image"])
def test_generators_match_jax(tmp_path, gen):
    if gen == "coloured":
        kw = dict(width=24, height=16, frames=3, red=0.2, green=0.71,
                  blue=1.0)
        jc = jrs.gen_coloured_frames(tmp_path / "j", **kw)
        tc = trs.gen_coloured_frames(tmp_path / "t", device=CPU, **kw)
    elif gen == "blank":
        jc = jrs.gen_blank_frames(tmp_path / "j", width=16, height=8,
                                  frames=2)
        tc = trs.gen_blank_frames(tmp_path / "t", width=16, height=8,
                                  frames=2, device=CPU)
    elif gen == "text":
        kw = dict(width=64, height=32, frames=2, size=14,
                  colour=(250, 200, 10), bg=(0.1, 0.3, 0.7))
        jc = jrs.gen_text(tmp_path / "j", "Title", **kw)
        tc = trs.gen_text(tmp_path / "t", "Title", device=CPU, **kw)
    else:
        src = tmp_path / "pic.png"
        Image.fromarray(np.random.default_rng(3).integers(
            0, 256, (20, 30, 3), np.uint8)).save(src)
        jc = jrs.gen_clip_from_image(tmp_path / "j", str(src), frames=2,
                                     width=16, height=12)
        tc = trs.gen_clip_from_image(tmp_path / "t", str(src), frames=2,
                                     width=16, height=12)
    tc.unique_id = jc.unique_id
    tc.save_header()
    assert_clips_match(jc, tc)
    assert trs.frame_calculator(25.0, minutes=1, seconds=2.5) == \
        jrs.frame_calculator(25.0, minutes=1, seconds=2.5) == 1564


def test_transitions_take_a_clipboard_and_refuse_without_other(tmp_path):
    """A Clipboard as the second source (its frames looped), and the
    refusal without one, as in the JAX runners."""
    from lives_tpu.clipedit import copy_frames as j_copy
    from lives_tpu_torch.clipedit import copy_frames as t_copy
    jc, tc = image_pair(tmp_path / "a", seed=1)
    jo, to = image_pair(tmp_path / "b", seed=2)
    jcb, tcb = j_copy(jo, 0, 3), t_copy(to, 0, 3, device=CPU)
    jrs.apply_script(jc, "transition_fade", other=jcb)
    trs.apply_script(tc, "transition_fade", other=tcb, device=CPU)
    assert_clips_match(jc, tc)
    with pytest.raises(ValueError, match="other"):
        trs.apply_script(tc, "transition_checkerboard", device=CPU)


# -- rfx_builder --------------------------------------------------------------

def _builders(mod):
    return (mod.RFXBuilder("my_pulse_blur", description="pulsing blur")
            .add_param("strength", "num2", default=0.5, min=0.0, max=1.0)
            .add_param("radius", "num0", default=3, min=1, max=16)
            .set_filter("gaussian_blur", radius="radius",
                        amount="strength * (0.5 + 0.5 * sin(t * 6.28318))")
            .layout("layout|p0|p1|"))


def test_builder_script_files_match_jax_and_apply_alike(tmp_path):
    """The .script text byte for byte; registered, the script animates per
    frame and renders the JAX package's frames; reloaded from the file it
    registers again."""
    tb, jb = _builders(tbuild), _builders(jbuild)
    assert tb.to_script() == jb.to_script()
    name = tb.register()
    jb.register()
    try:
        assert trs.get_script(name).params_spec() == \
            jrs.get_script(name).params_spec()
        jc, tc = image_pair(tmp_path / "c", n=6)
        jrs.apply_script(jc, name, strength=1.0, radius=2)
        trs.apply_script(tc, name, strength=1.0, radius=2, device=CPU)
        # the blur's per-frame amount mixes blur and frame in a
        # multiply-add XLA fuses: an LSB where it rounds the other way
        assert_clips_match(jc, tc, tol=1)
        path = tb.save(tmp_path / "s" / f"{name}.script")
        del trs._SCRIPTS[name]
        del jrs._SCRIPTS[name]
        assert tbuild.load_script_file(path) == name == \
            jbuild.load_script_file(path)
        assert trs.get_script(name).params_spec() == \
            jrs.get_script(name).params_spec()
    finally:
        trs._SCRIPTS.pop(name, None)
        jrs._SCRIPTS.pop(name, None)


HOSTILE = ["__import__('os')", "open('x')", "a.b", "[1,2]", "'s'",
           "lambda: 1", "9**9**9", "x" * 1100, "(" * 300 + "1" + ")" * 300]


@pytest.mark.parametrize("expr", HOSTILE, ids=range(len(HOSTILE)))
def test_builder_rejects_hostile_expressions_like_jax(expr):
    def outcome(mod):
        try:
            fn = mod.compile_mapping_expr(expr)
            return ("ok", fn({"x": 1.0}))
        except Exception as e:   # noqa: BLE001
            return (type(e).__name__,)
    got = outcome(tbuild)
    assert got == outcome(jbuild) and got[0] != "ok"


def test_builder_mapping_values_match_jax():
    for expr, names in (("clip(t * 2, 0, 1) + floor(frame / 3)",
                         {"t", "frame"}), ("max(a, 0.2) ** 2", {"a"})):
        t, j = tbuild.compile_mapping_expr(expr), \
            jbuild.compile_mapping_expr(expr)
        assert t.names == j.names == frozenset(names)
        env = {"t": 0.7, "frame": 8, "a": 0.5}
        assert t(env) == j(env)


def test_load_user_scripts_skips_perl_and_bad_files(tmp_path):
    d = tmp_path / "scripts"
    d.mkdir()
    (d / "perl.script").write_text("<name>\nperl_fx\n</name>\n")
    (d / "bad.script").write_text("<name>\n1bad\n</name>\n")
    _builders(tbuild).save(d / "ok.script")
    with pytest.warns(UserWarning, match="not loaded"):
        names = tbuild.load_user_scripts(d)
    try:
        assert names == ["my_pulse_blur"]
        with pytest.raises(ValueError, match="<filter>"):
            tbuild.load_script_file(d / "perl.script")
    finally:
        trs._SCRIPTS.pop("my_pulse_blur", None)
    with pytest.raises(ValueError):
        tbuild.RFXBuilder("n").add_param("t")
    with pytest.raises(ValueError, match="set_filter"):
        tbuild.RFXBuilder("n").to_script()
