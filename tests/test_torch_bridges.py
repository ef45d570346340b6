"""The JAX package's native bridges as the port's tests reach them, and
the frei0r and LADSPA hosts of lives_tpu_torch against lives_tpu's on
the plugins compiled from `native/test_plugins/`.

The JAX loaders (`lives_tpu/io/jpeg_ingest.py:44-101`,
`lives_tpu/io/av.py:43-106`) build their library in place with `g++ -o`
and cache a failure as None for the life of the process. Under xdist
every worker collects `tests/test_jpeg_ingest.py`, which calls the loader
at collection, and imports `lives_tpu.io.encoders`, which calls both: on
a tree without the libraries six workers build the same file at once,
and a worker that read it half written keeps None. Every port test that
compares against a JAX bridge therefore takes it through `jax_bridge`:
under a file lock it calls the loader, resets the loader's cache and
calls it once more where it returned None, and fails naming the bridge
where it is still None. The JAX encoder registry is decided at import,
so `jax_encoder` builds a fresh copy of that module's registry once the
bridge has loaded, where the import-time one lost an encoder.
"""

import fcntl
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PLUGINS = ROOT / "native" / "test_plugins"

#: bridge -> (JAX module, loader)
JAX_BRIDGES = {"jpegcoef": ("lives_tpu.io.jpeg_ingest", "load_jpegcoef"),
               "avbridge": ("lives_tpu.io.av", "load_avbridge")}
#: JAX encoder -> the bridge its registration needs
ENCODER_BRIDGE = {"mjpeg": "jpegcoef", "av": "avbridge"}


def jax_bridge(name: str):
    """The JAX package's `name` bridge, loaded under a lock on
    `build/jax_<name>.lock`; a cached None is reset and the loader called
    once more; the test fails naming the bridge if it is still None."""
    modname, fn = JAX_BRIDGES[name]
    mod = importlib.import_module(modname)
    lock = ROOT / "build" / f"jax_{name}.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            lib = getattr(mod, fn)()
            if lib is None:
                mod._TRIED, mod._LIB = False, None
                lib = getattr(mod, fn)()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if lib is None:
        pytest.fail(f"the JAX package's {name} bridge ({modname}.{fn}) "
                    f"did not load")
    return lib


_FRESH = None


def jax_encoders_module():
    """`lives_tpu.io.encoders` as an import now makes it, with its bridges
    loaded through `jax_bridge`: a second copy of the module, executed
    beside the first, whose registry holds what the first lost."""
    global _FRESH
    if _FRESH is None:
        jenc = importlib.import_module("lives_tpu.io.encoders")
        name = "lives_tpu.io._encoders_registered_again"
        spec = importlib.util.spec_from_file_location(name, jenc.__file__)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _FRESH = mod
    return _FRESH


def jax_encoder(name: str):
    """An instance of the JAX package's `name` encoder, its bridge loaded
    through `jax_bridge`."""
    jenc = importlib.import_module("lives_tpu.io.encoders")
    jax_bridge(ENCODER_BRIDGE[name])
    if name in jenc.list_encoders():
        return jenc.get_encoder(name)
    return jax_encoders_module().get_encoder(name)


def jax_registry_in_subprocess(bridges, env=None) -> dict:
    """The JAX encoder registry as a fresh process imports it once
    `jax_bridge` has loaded `bridges`: {name: [format dicts]}."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from test_torch_bridges import jax_bridge\n"
        f"for b in {list(bridges)!r}:\n"
        "    jax_bridge(b)\n"
        "from lives_tpu.io import encoders as jenc\n"
        "print(json.dumps({n: [f.__dict__ for f in "
        "jenc.get_encoder(n).get_formats()] "
        "for n in jenc.list_encoders()}))\n")
    full = dict(os.environ, JAX_PLATFORMS="cpu")
    full.update(env or {})
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=full, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- the helper itself --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JAX_BRIDGES))
def test_jax_bridge_reloads_a_cached_failure(name, monkeypatch):
    """A worker that lost the build race holds `_TRIED` True and `_LIB`
    None: the helper loads the library all the same."""
    modname, fn = JAX_BRIDGES[name]
    from lives_tpu_torch import native
    if name == "avbridge" and native.load_avbridge() is None:
        pytest.skip("libav is absent here: neither package has the bridge")
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, "_TRIED", True)
    monkeypatch.setattr(mod, "_LIB", None)
    lib = jax_bridge(name)
    assert lib is not None and getattr(mod, fn)() is lib


def test_jax_bridge_fails_naming_the_bridge(monkeypatch):
    mod = importlib.import_module("lives_tpu.io.jpeg_ingest")
    monkeypatch.setattr(mod, "load_jpegcoef", lambda: None)
    with pytest.raises(pytest.fail.Exception, match="jpegcoef bridge"):
        jax_bridge("jpegcoef")


# -- frei0r and LADSPA on the test plugins -----------------------------------

@pytest.fixture(scope="module")
def plugin_dirs(tmp_path_factory):
    """The two test plugins compiled by gcc, each in a search directory
    of its own (`tests/test_bridges.py:22-35`)."""
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc is not None, "no C compiler to build native/test_plugins"
    dirs = {}
    for kind, src in (("frei0r", "f0r_testinvert.c"),
                      ("ladspa", "ladspa_testgain.c")):
        d = tmp_path_factory.mktemp(kind)
        r = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o",
                            str(d / (src[:-2] + ".so")), str(PLUGINS / src)],
                           capture_output=True)
        assert r.returncode == 0, r.stderr.decode()[:400]
        dirs[kind] = d
    return dirs


@pytest.fixture
def frei0r_mods(plugin_dirs, monkeypatch):
    """Both packages' frei0r hosts with `f0r_testinvert` registered."""
    monkeypatch.setenv("FREI0R_PATH", str(plugin_dirs["frei0r"]))
    from lives_tpu.effects import frei0r as jf
    from lives_tpu_torch.effects import frei0r as tf
    assert jf.register_frei0r_filters() == 1
    assert tf.register_frei0r_filters() == 1
    return {"jax": jf, "torch": tf}


def rgba_frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                np.uint8)


def test_frei0r_scan_matches_jax(frei0r_mods):
    j, t = (frei0r_mods[k].scan_plugins() for k in ("jax", "torch"))
    assert [p.__dict__ for p in t] == [p.__dict__ for p in j]
    assert [p.name for p in t] == ["testinvert"]
    assert t[0].params == [("amount", frei0r_mods["torch"].F0R_PARAM_DOUBLE)]
    for name in ("F0R_PLUGIN_TYPE_FILTER", "F0R_COLOR_MODEL_RGBA8888",
                 "F0R_PARAM_DOUBLE", "F0R_PARAM_STRING"):
        assert getattr(frei0r_mods["torch"], name) == \
            getattr(frei0r_mods["jax"], name)


@pytest.mark.parametrize("amount", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("geom", [(8, 16), (13, 7)])
def test_frei0r_instance_update_matches_jax(frei0r_mods, amount, geom):
    """`Frei0rInstance.update` on the same seeded RGBA frame: exact."""
    h, w = geom
    frame = rgba_frame(h, w, 1)
    outs = {}
    for pkg, mod in frei0r_mods.items():
        (plug,) = mod.scan_plugins()
        inst = mod.Frei0rInstance(plug, w, h)
        inst.set_param_double(0, amount)
        outs[pkg] = inst.update(frame, 0.5)
        inst.close()
        inst.close()                      # idempotent
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    np.testing.assert_array_equal(outs["torch"][..., 3], frame[..., 3])


def test_frei0r_registered_filter_matches_jax(frei0r_mods):
    from lives_tpu.effects.host import get_filter as j_get
    from lives_tpu_torch.effects.host import get_filter as t_get
    j, t = j_get("f0r_testinvert"), t_get("f0r_testinvert")
    assert t.description == j.description == "frei0r: testinvert"
    assert [(p.name, p.kind, p.default, p.min, p.max) for p in t.params] \
        == [(p.name, p.kind, p.default, p.min, p.max) for p in j.params]
    assert [c.palettes for c in t.in_channels] == \
        [c.palettes for c in j.in_channels]


def jax_layer(arr, pal):
    import jax.numpy as jnp

    from lives_tpu.layer import Layer as JLayer
    return JLayer(planes=(jnp.asarray(arr),), palette=int(pal))


def port_layer(arr, pal):
    import torch

    from lives_tpu_torch.layer import Layer
    return Layer(planes=(torch.from_numpy(np.ascontiguousarray(arr)),),
                 palette=int(pal))


@pytest.mark.parametrize("channels", [3, 4])
def test_f0r_apply_instance_matches_jax(frei0r_mods, channels):
    """`apply_instance`, the JAX package's one route that runs a bridged
    filter (`tests/test_bridges.py:55-66`): an RGB24 or RGBA32 layer to
    the host, through the plugin, back; exact, RGBA32 out."""
    from lives_tpu.constants import Palette
    from lives_tpu.effects import apply_instance as j_apply
    from lives_tpu.effects import instantiate as j_inst
    from lives_tpu_torch.effects.host import apply_instance, instantiate
    pal = Palette.RGB24 if channels == 3 else Palette.RGBA32
    arr = np.moveaxis(rgba_frame(9, 14, 2)[..., :channels], -1, 0).copy()
    j = j_apply(j_inst("f0r_testinvert", amount=0.6),
                [jax_layer(arr, pal)])[0]
    t = apply_instance(instantiate("f0r_testinvert", amount=0.6),
                       [port_layer(arr, pal)])[0]
    assert t.palette == j.palette == int(Palette.RGBA32)
    assert t.planes[0].device.type == "cpu"
    np.testing.assert_array_equal(t.planes[0].numpy(),
                                  np.asarray(j.planes[0]))


#: the routes' chain; its values are float32-exact, so a route's traced
#: float32 parameters and the eager reference's Python floats agree
ROUTE_CHAIN = (("saturation", {"saturation": 1.5}),
               ("f0r_testinvert", {"amount": 0.75}),
               ("colour_balance", {"red": 1.125}))


def jax_eager(frames, chain=ROUTE_CHAIN):
    """The JAX package's eager `apply_instance` over the chain, frame by
    frame, as its graph runs a chain of two or more effects
    (`lives_tpu/graph/nodemodel.py:785-807`): on float32 layers from
    entry, the bridged filter handed RGBA32 bytes (its template's
    palette), RGB24 at the sink. What the jitted routes would compute,
    were the plugin given bytes and not a tracer."""
    from lives_tpu.constants import Palette
    from lives_tpu.effects import apply_instance as j_apply
    from lives_tpu.effects import instantiate as j_inst
    from lives_tpu.ops.colorspace import convert_layer as j_convert
    out = []
    for f in frames:
        lay = [j_convert(jax_layer(f, Palette.RGB24), Palette.RGBFLOAT)]
        for name, vals in chain:
            if name.startswith("f0r_"):
                lay = [j_convert(lay[0], Palette.RGBA32)]
            lay = j_apply(j_inst(name, **vals), lay)
        out.append(np.asarray(j_convert(lay[0], Palette.RGB24).planes[0]))
    return out


def within_1(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def seeded_frames(n, h=12, w=20, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, h, w), np.uint8) for _ in range(n)]


def chains(pkg):
    if pkg == "jax":
        from lives_tpu.effects import instantiate
    else:
        from lives_tpu_torch.effects.host import instantiate
    return [instantiate(n, **v) for n, v in ROUTE_CHAIN]


def test_f0r_frame_graph_run(frei0r_mods, monkeypatch):
    """`FrameGraph.run`: the JAX plan is jitted and hands the plugin a
    tracer (TypeError, ROADMAP Queue 3); the port runs eagerly and gives
    the JAX eager chain's frames, within 1 LSB."""
    from lives_tpu.constants import Palette as JP
    from lives_tpu.graph import FrameGraph as JGraph
    from lives_tpu.graph import SinkSpec as JSpec
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.graph import FrameGraph, SinkSpec
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    frames = seeded_frames(3)
    jg = JGraph(chains("jax"), JSpec(width=20, height=12))
    with pytest.raises(TypeError):
        jg.run([jax_layer(frames[0], JP.RGB24)], 0.0, 0)
    g = FrameGraph(chains("torch"), SinkSpec(width=20, height=12))
    got = [g.run([port_layer(f, Palette.RGB24)], i / 25.0, i).planes[0]
           for i, f in enumerate(frames)]
    for a, b in zip(got, jax_eager(frames)):
        within_1(a.numpy(), b)


def test_f0r_takes_a_float_layer_as_its_bytes(frei0r_mods):
    """A float RGB layer satisfies the RGBA32 template in negotiation; the
    port hands the plugin its RGBA32 bytes (JAX `convert_layer`'s within
    1 LSB). The JAX host casts the floats to bytes, truncating [0, 1] to
    0 or 1 (ROADMAP Queue 3), so its frame is not the reference here."""
    from lives_tpu.constants import Palette as JP
    from lives_tpu.effects import apply_instance as j_apply
    from lives_tpu.effects import instantiate as j_inst
    from lives_tpu.ops.colorspace import convert_layer as j_convert
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.host import apply_instance, instantiate
    f = np.random.default_rng(8).random((3, 6, 10), np.float32)
    got = apply_instance(instantiate("f0r_testinvert", amount=0.9),
                         [port_layer(f, Palette.RGBFLOAT)])[0]
    ref = j_apply(j_inst("f0r_testinvert", amount=0.9),
                  [j_convert(jax_layer(f, JP.RGBFLOAT), JP.RGBA32)])[0]
    within_1(got.planes[0].numpy(), np.asarray(ref.planes[0]))
    bad = j_apply(j_inst("f0r_testinvert", amount=0.9),
                  [jax_layer(f, JP.RGBFLOAT)])[0]
    assert set(np.unique(np.asarray(bad.planes[0])[3])) <= {0, 1}


def test_f0r_frame_graph_run_batch(frei0r_mods, monkeypatch):
    """`FrameGraph.run_batch`: the JAX batch plan raises TypeError; the
    port's chunk gives the eager frames, per-frame parameters taken frame
    by frame."""
    import torch

    from lives_tpu.constants import Palette as JP
    from lives_tpu.graph import FrameGraph as JGraph
    from lives_tpu.graph import SinkSpec as JSpec
    from lives_tpu.layer import Layer as JLayer
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.graph import FrameGraph, SinkSpec
    from lives_tpu_torch.layer import Layer
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    frames = seeded_frames(4, seed=4)
    stack = np.stack(frames)
    import jax.numpy as jnp
    jg = JGraph(chains("jax"), JSpec(width=20, height=12))
    with pytest.raises(TypeError):
        jg.run_batch([JLayer(planes=(jnp.asarray(stack),),
                             palette=int(JP.RGB24))],
                     np.zeros(4, np.float32), np.arange(4))
    g = FrameGraph(chains("torch"), SinkSpec(width=20, height=12))
    out = g.run_batch([Layer(planes=(torch.from_numpy(stack),),
                             palette=int(Palette.RGB24))],
                      np.arange(4, dtype=np.float32) / 25, np.arange(4))
    assert tuple(out.planes[0].shape) == (4, 3, 12, 20)
    for a, b in zip(out.planes[0], jax_eager(frames)):
        within_1(a.numpy(), b)


def test_f0r_renderer(frei0r_mods, monkeypatch):
    """The renderer (`render_to_arrays`, run_batch a segment): the JAX
    package's raises TypeError on a timeline holding the plugin; the
    port's frames are the eager chain's over the same source frames."""
    import chip_smoke as cs
    from lives_tpu.events import EventList as JEventList
    from lives_tpu.events.renderer import render_to_arrays as j_render
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.events.renderer import render_to_arrays
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setitem(cs.CONFIGS, "f0r", (1, [(n, v, [0])
                                                for n, v in ROUTE_CHAIN]))
    el = cs.timeline("f0r", 5, width=20, height=12)
    with pytest.raises(TypeError):
        j_render(JEventList.from_json(el.to_json()), JSource(12, 20))
    src = DeviceSyntheticSource(12, 20, device="cpu")
    got, _ = render_to_arrays(el, src)
    assert got.shape == (5, 3, 12, 20)
    srcf = src.get_batch([1] * 5, range(5)).planes[0].numpy()
    for a, b in zip(got, jax_eager(list(srcf))):
        within_1(a, b)


def test_f0r_player(frei0r_mods, monkeypatch):
    """The player (its graph's `run`): the JAX player raises TypeError at
    the first frame; the port's shows the eager chain's frames."""
    import chip_smoke as cs
    import lives_tpu.player.player as j_player_mod
    import lives_tpu_torch.player.player as t_player_mod
    from lives_tpu.player import CollectSink as JCollect
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.player import CollectSink, Player
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    frames = seeded_frames(6, seed=5)

    class Clip:
        width, height, fps = 20, 12, 25.0

        def __init__(self, pkg):
            self.pkg, self.frames = pkg, len(frames)

        def get_frame(self, n):
            from lives_tpu.constants import Palette as JP
            return jax_layer(frames[n], JP.RGB24) if self.pkg == "jax" \
                else port_layer(frames[n], Palette.RGB24)
    shown = {}
    for pkg, P, S, mod in (("jax", JPlayer, JCollect, j_player_mod),
                           ("torch", Player, CollectSink, t_player_mod)):
        clock = cs.ScriptedClock()
        monkeypatch.setattr(mod, "time", clock)
        sink = S()
        p = P(sink=sink) if pkg == "jax" else P(sink=sink, device="cpu")
        p.async_compile = False
        p.state.fg_clip = Clip(pkg)
        for k, (name, vals) in enumerate(ROUTE_CHAIN):
            p.keymap.set_key(k, 0, name)
            p.keymap.set_key_defaults(k, 0, **vals)
            p.key_toggle(k, True)
        p.start()
        seq = (0, 3, 5)
        if pkg == "jax":
            p.state.frame = -1
            p._clock0, p._frame0 = clock.now, 0.0
            with pytest.raises(TypeError):
                p.process_one()
        else:
            for i in seq:
                p.state.frame = -1
                p._clock0, p._frame0 = clock.now, float(i)
                assert p.process_one()
            shown[pkg] = list(sink.frames)
        p.stop()
    ref = jax_eager([frames[i] for i in seq])
    assert len(shown["torch"]) == len(seq)
    for a, b in zip(shown["torch"], ref):
        within_1(a, b)


def test_f0r_never_reaches_a_fused_kernel(frei0r_mods):
    """K1, K4 and K5 hold no `f0r_` name: a chain holding the plugin has
    no fused prefix or suffix, and the composite's leading run stops at
    it."""
    from lives_tpu_torch.graph import composite, fused_sweep
    from lives_tpu_torch.graph import stateful_sweep  # noqa: F401
    chain = chains("torch")
    assert "f0r_testinvert" not in fused_sweep.VOCABULARY
    assert "f0r_testinvert" not in fused_sweep.STATEFUL_STEPS
    assert "f0r_testinvert" not in composite.VOCABULARY
    assert fused_sweep.sweep_prefix_len(chain[1:]) == 0
    assert fused_sweep.sweep_suffix_len(chain[:2]) == 0
    assert fused_sweep.sweep_prefix_len(chain) == 1


@pytest.fixture
def ladspa_mods(plugin_dirs, monkeypatch):
    monkeypatch.setenv("LADSPA_PATH", str(plugin_dirs["ladspa"]))
    from lives_tpu.audio import ladspa as jl
    from lives_tpu_torch.audio import ladspa as tl
    return {"jax": jl, "torch": tl}


def test_ladspa_scan_matches_jax(ladspa_mods):
    j, t = (ladspa_mods[k].scan_plugins() for k in ("jax", "torch"))
    assert [p.__dict__ for p in t] == [p.__dict__ for p in j]
    assert [p.label for p in t] == ["testgain"]
    assert t[0].n_audio_in == t[0].n_audio_out == 1
    assert t[0].controls[0][1] == "Gain"
    for name in ("PORT_INPUT", "PORT_OUTPUT", "PORT_CONTROL", "PORT_AUDIO"):
        assert getattr(ladspa_mods["torch"], name) == \
            getattr(ladspa_mods["jax"], name)


@pytest.mark.parametrize("gain", [None, 0.0, 0.5, 2.0])
@pytest.mark.parametrize("channels", [1, 2])
def test_ladspa_instance_run_matches_jax(ladspa_mods, gain, channels):
    """`LadspaInstance.run` over seeded blocks (the control at its range's
    middle where not set): exact."""
    rng = np.random.default_rng(7)
    blocks = [rng.uniform(-1, 1, (n, channels)).astype(np.float32)
              for n in (256, 1, 1000)]
    outs = {}
    for pkg, mod in ladspa_mods.items():
        (plug,) = mod.scan_plugins()
        inst = mod.LadspaInstance(plug, rate=8000)
        if gain is not None:
            inst.set_control("Gain", gain)
        outs[pkg] = [inst.run(b) for b in blocks]
        outs[pkg + "_ctl"] = inst.controls["Gain"].value
        inst.close()
        inst.close()
    assert outs["torch_ctl"] == outs["jax_ctl"]
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    if gain == 0.5:
        np.testing.assert_allclose(outs["torch"][0][:, 0],
                                   0.5 * blocks[0][:, 0], atol=1e-6)
