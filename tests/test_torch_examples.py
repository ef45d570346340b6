"""The port's examples (`lives_tpu_torch.examples`: embed_demo,
export_demo, multichip_render) against the JAX package's `examples/*.py`,
on the CPU, each at its own size.

- embed_demo: both demos on a `chip_smoke.AdvancingClock` (the player
  modules' clock; the demo's paced sleeps advance it), their apps'
  players without async compiles or dropped precache misses, event ids
  and clip handles counted from 0 and `random` seeded alike: the work
  directories hold the same files, the saved set's and the clips'; every
  file but the PNG frames byte for byte, the frames within 1 LSB and byte
  for byte where their pixels agree.
- export_demo: both AVIs of the 60-frame timeline. The timeline's vignette
  (frames 10-59) computes `exp`, where torch and XLA differ by an ulp, so
  the rendered frames agree within 1 LSB; each frame whose pixels agree
  has the same JPEG bytes in both files.
- multichip_render: the three modes over `[cpu] * 4` against the JAX
  example over four of the tests' virtual devices (its band sweep in
  Pallas interpret mode), within 1 LSB.
"""

import importlib.util
import random
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import lives_tpu.api as j_api
import lives_tpu.events.event_list as j_elmod
import lives_tpu.io.clips as j_clips
import lives_tpu_torch.api as t_api
import lives_tpu_torch.events.event_list as t_elmod
import lives_tpu_torch.io.clips as t_clips
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch.examples import embed_demo, export_demo, multichip_render
from lives_tpu_torch.player import player as t_player_mod
from test_torch_bridges import jax_bridge, jax_encoders_module
from test_torch_weed_binary import _Counter

ROOT = Path(__file__).resolve().parents[1]


def jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def test_embed_demo(tmp_path, monkeypatch):
    # the JAX Y4M decoder's native prefetch cache stalls seconds a seek
    # (the multitrack render's): plain reads, as tests/test_torch_player.py
    # reads
    from lives_tpu.io.decoders import Y4MDecoder
    monkeypatch.setattr(Y4MDecoder, "enable_prefetch", lambda self: None)
    tops = {}
    for pkg, api, elmod, clips, player_mod in (
            ("jax", j_api, j_elmod, j_clips, j_player_mod),
            ("torch", t_api, t_elmod, t_clips, t_player_mod)):
        # a nanosecond a reading: the JAX player's stats divide by the
        # mean frame time (`lives_tpu/player/player.py:1635`)
        clock = cs.AdvancingClock(tick=1e-9)
        monkeypatch.setattr(player_mod, "time", clock)
        monkeypatch.setattr(elmod, "uuid", _Counter())
        monkeypatch.setattr(clips, "_handle_counter", 0)
        init = api.LiVESApp.__init__

        def init_sync(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            pl = self.player._player
            pl.async_compile = pl.prewarm_compile = pl.drop_on_miss = False
        monkeypatch.setattr(api.LiVESApp, "__init__", init_sync)
        root = tmp_path / pkg
        root.mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(root))
        random.seed(27)
        mod = jax_example("embed_demo") if pkg == "jax" else embed_demo
        if pkg == "jax":
            # the JAX demo paces its cycles with `time.sleep` of the module
            # it imports inside main: that module's sleep advances the clock
            fake = types.ModuleType("time")
            fake.__dict__.update(sys.modules["time"].__dict__)
            fake.sleep = clock.advance
            with monkeypatch.context() as m:
                m.setitem(sys.modules, "time", fake)
                mod.main()
        else:
            embed_demo.demo("cpu", sleep=clock.advance)
        (top,) = root.glob("lives_tpu_demo_*")
        tops[pkg] = cs.work_tree(top)
    j, t = tops["jax"], tops["torch"]
    assert any(k.startswith("workdir/sets/demo_set/") for k in j)
    n_png = sum(k.endswith(".png") for k in j)
    assert n_png > 100
    worst, same_px, same_bytes, other = cs.tree_gap(j, t)
    assert other == 0 and worst <= 1 and same_bytes == same_px > 0


def test_export_demo(tmp_path, monkeypatch):
    from lives_tpu.events.renderer import render_to_arrays as j_render
    from lives_tpu.io import encoders as jenc
    from lives_tpu.multitrack import Multitrack as JMultitrack
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    import lives_tpu.transcode as j_transcode
    from lives_tpu_torch.events.renderer import render_to_arrays
    from lives_tpu_torch.scenes import DeviceSyntheticSource

    jax_bridge("jpegcoef")
    if "mjpeg" not in jenc.list_encoders():
        monkeypatch.setattr(j_transcode, "get_encoder",
                            jax_encoders_module().get_encoder)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert jax_example("export_demo").main() == 0
    (javi,) = tmp_path.glob("lives_tpu_export_*/timeline.avi")
    tavi, clip, frame = export_demo.export("cpu")
    assert Path(tavi).parent.parent == tmp_path
    j, t = cs.avi_jpegs(javi), cs.avi_jpegs(tavi)
    assert len(j) == len(t) == clip.frames == 60
    assert frame.shape == (3, 360, 640)

    # the JAX example's timeline (`examples/export_demo.py:34-37`)
    jmt = JMultitrack(n_tracks=3, width=640, height=360)
    jmt.insert_block(0, clip=1, start=0, length=60)
    jmt.insert_block(1, clip=2, start=15, length=30)
    jmt.add_effect("vignette", [0], 10, 50)
    jf, _ = j_render(jmt.el, JSource(360, 640), batch_size=32)
    tf, _ = render_to_arrays(export_demo.timeline().el, DeviceSyntheticSource(
        360, 640, device="cpu"), batch_size=32)
    gap = np.abs(np.asarray(jf).astype(int) - tf.astype(int)).reshape(
        60, -1).max(1)
    assert gap.max() <= 1 and (gap[:10] == 0).all()
    equal = np.flatnonzero(gap == 0)
    assert all(j[i] == t[i] for i in equal)
    # the port's own decode of the reopened frame is the JPEG's
    assert int(np.abs(frame.astype(int) - clip.get_frame(30).planes[0]
                      .numpy().astype(int)).max()) == 0


def test_multichip_render(monkeypatch):
    import jax

    import lives_tpu.parallel as jpar
    import lives_tpu.parallel.mesh as jmesh

    devs = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: list(devs))
    monkeypatch.setenv("LIVES_TPU_PALLAS_INTERPRET", "1")
    got = {}

    def recording(make, key):
        def wrapped(*a, **kw):
            fn = make(*a, **kw)
            if fn is None:
                return None

            def run(*ra, **rk):
                out = fn(*ra, **rk)
                if out is not None:
                    got[key] = np.asarray(getattr(out, "planes", (out,))[0])
                return out
            return run
        return wrapped
    monkeypatch.setattr(jpar, "sharded_batch_fn",
                        recording(jpar.sharded_batch_fn, "dp"))
    monkeypatch.setattr(jpar, "spatial_batch_fn",
                        recording(jpar.spatial_batch_fn, "spatial"))
    monkeypatch.setattr(jmesh, "spatial_sweep_fn",
                        recording(jmesh.spatial_sweep_fn, "sweep"))
    jax_example("multichip_render").main()
    port = multichip_render.render([torch.device("cpu")] * 4)
    assert sorted(got) == ["dp", "spatial", "sweep"]
    for k, ref in got.items():
        ours = port[k].numpy()
        assert ours.shape == ref.shape == (8, 3, 64, 256), k
        assert int(np.abs(ours.astype(int) - ref.astype(int)).max()) <= 1, k


def test_examples_run_as_modules(tmp_path):
    import subprocess
    for name in ("multichip_render",):
        r = subprocess.run(
            [sys.executable, "-m", f"lives_tpu_torch.examples.{name}",
             "--device", "cpu"], capture_output=True, text=True,
            timeout=300, cwd=str(ROOT))
        assert r.returncode == 0, r.stderr[-2000:]
        assert "band sweep" in r.stdout
