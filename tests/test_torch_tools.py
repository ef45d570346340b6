"""The port's user tools (`lives_tpu_torch.tools`: batchproc, monitor,
rte_test, soaktest, mt_edit_soak) against the JAX package's `tools/*.py`,
on the CPU.

- batchproc: the JAX `test_batchproc_tool` cases (`tests/test_control.py:
  412`) against the port's `OSCServer` over real UDP.
- rte_test: the JAX `test_rte_test_tool` cases (`:442`), then one case a
  filter of the port's registry, named by the filter, at 32x18 with one
  frame: the port's sweep of that filter reports no error. Where the JAX
  package fails at a setting too (`chip_smoke.RTE_REFERENCE_FAULTS`,
  `RTE_SMALL_FRAME_FAULTS`), the same filter swept over a JAX self-hosted
  player fails at the same settings, and the JAX tool's own `test_filter`
  meets the failure at its first render.
- The two faults of the JAX tool the port repairs: it maps each filter
  onto the key's next free mode, so the key keeps serving the first
  filter, and its pump calls `process_one` back to back, so most pumped
  cycles render nothing (the clock's frame is the one shown).
- soaktest for 3 s at 64x32 with the port's monitor subscribed.
- mt_edit_soak, 40 ops, seed 0, in both packages: the same endpoint calls
  with the same replies, the same final `/api/timeline`, renders within
  1 LSB. Effect ids come from a counter in both event_list modules.
- Each self-hosting program raises without CUDA unless `--device cpu` is
  given.
"""

import importlib.util
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import lives_tpu.events.event_list as j_elmod
import lives_tpu_torch.events.event_list as t_elmod
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import list_filters
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.osc.client import OSCClient
from lives_tpu_torch.osc.protocol import OSCMessage
from lives_tpu_torch.osc.server import OSCServer
from lives_tpu_torch.player import CollectSink, Player
from lives_tpu_torch.tools import (batchproc, monitor, mt_edit_soak,
                                   rte_test, soaktest)
from test_torch_weed_binary import _Counter

ROOT = Path(__file__).resolve().parents[1]
FILTERS = sorted(list_filters())
#: the CPU sweep's frame size: under template_tracker's 32-row patch
SWEEP_W, SWEEP_H = 32, 18
REFERENCE = {**cs.RTE_REFERENCE_FAULTS, **cs.RTE_SMALL_FRAME_FAULTS}


def jax_tool(name: str):
    """The JAX package's `tools/<name>.py`, loaded as its tests load it."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class MemClip:
    """An in-memory clip of seeded RGB24 frames on the CPU."""

    def __init__(self, n=10, h=16, w=32, uid=1):
        self.frames, self.fps = n, 25.0
        self.width, self.height, self.unique_id = w, h, uid

    def get_frame(self, n):
        rng = np.random.default_rng(self.unique_id * 31 + n)
        return Layer(planes=(torch.from_numpy(rng.integers(
            0, 256, (3, self.height, self.width), np.uint8)),),
            palette=int(Palette.RGB24))


@pytest.fixture
def served():
    player = Player(sink=CollectSink(), device="cpu")
    player.state.fg_clip = MemClip()
    srv = OSCServer(player, port=0)
    srv.start()
    yield srv, player
    srv.stop()


# -- batchproc ----------------------------------------------------------------

def test_batchproc_tool(served):
    """`run_batch` runs a templated command once per open clip with $clip
    substituted, selecting each clip first, a ping barrier after each."""
    srv, player = served
    srv.clips[1] = player.state.fg_clip
    srv.clips[4] = MemClip(uid=4)          # sparse ids on purpose
    logs = []
    res = batchproc.run_batch("/clip/name/set,take$clip", port=srv.port,
                              log=logs.append)
    assert res == [(1, True), (4, True)]
    assert srv.clips[1].name == "take1"
    assert srv.clips[4].name == "take4"
    # after the loop the last clip is foreground (select side effect)
    assert player.state.fg_clip is srv.clips[4]
    # failing command per clip -> ok=False, engine keeps serving
    res = batchproc.run_batch("/clip/encode_as", port=srv.port,
                              log=logs.append)
    assert res and all(not ok for _, ok in res)
    assert any("FAILED" in line for line in logs)


def test_batchproc_main_exit_codes(served):
    srv, player = served
    assert batchproc.main(["/app/ping", "--port", str(srv.port)]) == 1
    srv.clips[1] = player.state.fg_clip
    assert batchproc.main(["/clip/name/set,a$clip", "--port",
                           str(srv.port)]) == 0
    assert batchproc.main(["/clip/encode_as", "--port",
                           str(srv.port)]) == 1


# -- rte_test -------------------------------------------------------------------

def test_rte_test_tool():
    """The JAX tool's two cases: four filters swept with no failure, and
    a match that names no filter."""
    logs = []
    names, failures = rte_test.run_rte_test(limit=4, frames=1, log=logs.append,
                                            device="cpu", width=64,
                                            height=32)
    assert len(names) == 4 and not failures, failures
    assert sum(1 for line in logs if line.startswith("ok")) == 4
    names, failures = rte_test.run_rte_test(match="zzz_no_such",
                                            log=logs.append, device="cpu")
    assert names == [] and not failures


@pytest.fixture(scope="module")
def port_host():
    p, srv, pump = rte_test.self_host("cpu", SWEEP_W, SWEEP_H)
    cli = OSCClient(port=srv.port, timeout=60.0)
    yield cli, pump, p
    cli.close()
    p.stop()
    srv.stop()


@pytest.fixture(scope="module")
def jax_host():
    """The JAX tool's self-hosted player (`tools/rte_test.py:104-116`) at
    the sweep's size, built as the port's `self_host` builds it."""
    from lives_tpu.io.genclip import GeneratorClip
    from lives_tpu.osc.client import OSCClient as JClient
    from lives_tpu.osc.server import OSCServer as JServer
    from lives_tpu.player import NullSink, Player as JPlayer
    p = JPlayer(sink=NullSink())
    p.async_compile = False
    p.state.fg_clip = GeneratorClip("plasma", SWEEP_W, SWEEP_H)
    p.state.bg_clip = GeneratorClip("colour_bars", SWEEP_W, SWEEP_H)
    srv = JServer(p, port=0)
    srv.start()
    p.state.playing = True

    def pump(k):
        for _ in range(k):
            p.state.frame = -1
            p.process_one()
    cli = JClient(port=srv.port, timeout=60.0)
    yield cli, pump, p
    cli.close()
    p.stop()
    srv.stop()


def failed_settings(errs):
    """The settings a sweep's errors name: 'filter' or 'filter.param=v'."""
    return [e.split(" (render)")[0] for e in errs]


@pytest.mark.parametrize("name", FILTERS, ids=FILTERS)
def test_rte_sweep(name, port_host, request):
    cli, pump, p = port_host
    shown, swept = rte_test.frames_rendered, rte_test.settings_swept
    errs = rte_test.test_filter(cli, name, 1, pump, 1)
    assert p.keymap.current_filter(0) == name
    assert rte_test.frames_rendered - shown == \
        2 + rte_test.settings_swept - swept - len(errs)
    if name not in REFERENCE:
        assert errs == []
        return
    # a reference-side fault: the JAX package fails at the same settings
    assert errs and all(" (render): " in e for e in errs), errs
    jcli, jpump, jp = request.getfixturevalue("jax_host")
    jerrs = rte_test.test_filter(jcli, name, 1, jpump, 1)
    assert jp.keymap.current_filter(0) == name
    assert failed_settings(jerrs) == failed_settings(errs)
    # the JAX tool meets it at its first render, and raises
    jt = jax_tool("rte_test")
    jcli.send("/effect_key/unmap", 1)
    assert jcli.barrier() == []
    with pytest.raises(TypeError):
        jt.test_filter(jcli, name, 1, jpump, 1)
    jcli.send("/effect_key/disable", 1)
    jcli.barrier()


def test_rte_sweep_covers_the_registry():
    """Every filter of the port's registry is a case of `test_rte_sweep`,
    and every listed fault names a filter of it."""
    assert len(FILTERS) == 147
    assert set(REFERENCE) <= set(FILTERS)


def test_jax_tool_sweeps_the_first_filter_only(jax_host, port_host):
    """The JAX tool maps each filter onto the key's next free mode
    (`tools/rte_test.py:61`, `lives_tpu/osc/server.py:237-251`): after
    `negate` (no parameters), `vignette` goes to mode 2 while the key
    serves mode 1, so none of vignette's settings is made. The port's
    tool unmaps the key first."""
    jt = jax_tool("rte_test")
    jcli, jpump, jp = jax_host
    jcli.send("/effect_key/unmap", 1)
    jcli.barrier()
    sent = []
    send = jcli.send
    jcli.send = lambda path, *a: (sent.append(path), send(path, *a))[1]
    try:
        for name in ("negate", "vignette"):
            assert jt.test_filter(jcli, name, 1, jpump, 1) == []
    finally:
        jcli.send = send
    assert jp.keymap.slots[0] == ["negate", "vignette"]
    assert jp.keymap.current_filter(0) == "negate"
    assert "/effect_key/parameter/value/set" not in sent
    cli, pump, p = port_host
    swept = rte_test.settings_swept
    for name in ("negate", "vignette"):
        assert rte_test.test_filter(cli, name, 1, pump, 1) == []
    assert p.keymap.slots[0] == ["vignette"]
    assert rte_test.settings_swept - swept == 6   # amount, radius x 3


def test_jax_tool_pump_renders_few_frames(monkeypatch):
    """The JAX tool's pump calls `process_one` back to back (`tools/
    rte_test.py:113-115`): a cycle whose clock frame is already shown
    renders nothing, so on a clock that does not move between cycles one
    of vignette's 8 pumped cycles renders. The port's pump renders each."""
    from lives_tpu.player import Player as JPlayer
    from lives_tpu.player import player as j_player_mod
    from lives_tpu_torch.player import player as t_player_mod
    monkeypatch.setattr(j_player_mod, "time", cs.ScriptedClock())
    monkeypatch.setattr(t_player_mod, "time", cs.ScriptedClock())
    jt = jax_tool("rte_test")
    shown = []
    process_one = JPlayer.process_one

    def counted(self):
        before = self.frames_shown
        out = process_one(self)
        shown.append(self.frames_shown - before)
        return out
    monkeypatch.setattr(JPlayer, "process_one", counted)
    names, failures = jt.run_rte_test(match="vignette", frames=1,
                                      log=lambda s: None)
    assert names == ["vignette"] and not failures
    assert len(shown) == 8 and sum(shown) == 1
    before = rte_test.frames_rendered
    names, failures = rte_test.run_rte_test(match="vignette", frames=1,
                                            log=lambda s: None,
                                            device="cpu", width=192,
                                            height=128)
    assert names == ["vignette"] and not failures
    assert rte_test.frames_rendered - before == 8


def test_rte_main(capsys):
    assert rte_test.main(["--device", "cpu", "--match", "negate",
                          "--frames", "1", "--width", "32",
                          "--height", "18"]) == 0
    assert "rte_test: 1 filters, 0 failing, 0 errors" in \
        capsys.readouterr().out
    assert rte_test.main(["--device", "cpu", "--match", "light_bloom",
                          "--frames", "1", "--width", "32",
                          "--height", "18"]) == 1


def test_rte_module_runs():
    r = subprocess.run(
        [sys.executable, "-m", "lives_tpu_torch.tools.rte_test", "--device",
         "cpu", "--limit", "2", "--frames", "1", "--width", "32",
         "--height", "18"], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rte_test: 2 filters, 0 failing, 0 errors" in r.stdout


# -- soaktest and monitor ---------------------------------------------------------

def test_soak_with_monitor():
    p, srv = soaktest.self_host("cpu", 64, 32)
    mon = monitor.Monitor(srv.port, out=lambda s: None)
    mon.subscribe()
    th = threading.Thread(target=mon.run, daemon=True)
    th.start()
    try:
        got = soaktest.soak(srv.port, 3.0, seed=0, rate=30.0, player=p)
        with OSCClient(port=srv.port, timeout=60.0) as cli:
            assert isinstance(cli.barrier(), list)
        alive = srv.dispatch(OSCMessage("/app/ping", []))
    finally:
        mon.stop()
        th.join(timeout=10)
        p.stop()
        srv.stop()
    assert not th.is_alive()
    assert alive and got["sent"] > 0 and p.frames_shown > 0
    assert len(got["cycle_s"]) == got["sent"]
    assert mon.events and all(isinstance(n, str) for n, _ in mon.events)
    assert "FRAME_SYNCH" in {n for n, _ in mon.events}


def test_soak_paths_and_seed_match_the_jax_tool():
    jt = jax_tool("soaktest")
    assert len(soaktest.PATHS) == len(jt.PATHS) == 62
    assert [p for p, _ in soaktest.PATHS] == [p for p, _ in jt.PATHS]
    assert soaktest.FILTERS == jt.FILTERS
    import random
    a, b = random.Random(0), random.Random(0)
    for _ in range(200):
        (pa, fa), (pb, fb) = a.choice(soaktest.PATHS), b.choice(jt.PATHS)
        assert pa == pb and fa(a) == fb(b)


def test_soak_main(capsys):
    assert soaktest.main(["--seconds", "1", "--device", "cpu", "--width",
                          "64", "--height", "32"]) == 0
    out = capsys.readouterr().out
    assert "engine alive" in out


def test_monitor_decodes_a_notify():
    assert monitor.decode(b"2|\n\x00") == ("PLAYBACK_STARTED", "")
    assert monitor.decode(b"512|3\n\x00") == ("CLIP_OPENED", "3")
    assert monitor.decode(b"x|y") == ("x", "y")


# -- mt_edit_soak -----------------------------------------------------------------

def read_timeline(base):
    import json
    import urllib.request
    with urllib.request.urlopen(base + "/api/timeline", timeout=10) as r:
        return json.loads(r.read())


def recording(mod, calls):
    api, get_timeline = mod.api, mod.get_timeline

    def rec_api(base, path, args):
        r = api(base, path, args)
        calls.append(("api", path, args, r))
        return r

    def rec_tl(base):
        r = get_timeline(base)
        calls.append(("timeline", r))
        return r
    return rec_api, rec_tl


def test_mt_edit_soak_both_packages(monkeypatch):
    from lives_tpu.multitrack.model import Multitrack as JMultitrack
    from lives_tpu_torch.multitrack.model import Multitrack as TMultitrack
    jt = jax_tool("mt_edit_soak")
    out = {}
    for pkg, mod, elmod, M in (("jax", jt, j_elmod, JMultitrack),
                               ("torch", mt_edit_soak, t_elmod,
                                TMultitrack)):
        calls, frames = [], []
        rec_api, rec_tl = recording(mod, calls)
        monkeypatch.setattr(mod, "api", rec_api)
        monkeypatch.setattr(mod, "get_timeline", rec_tl)
        monkeypatch.setattr(elmod, "uuid", _Counter())
        render = M.render

        def captured(self, *a, _render=render, _frames=frames, **kw):
            got = _render(self, *a, **kw)
            _frames.append(np.asarray(got[0]))
            return got
        monkeypatch.setattr(M, "render", captured)
        if pkg == "jax":
            # the JAX tool reads no timeline after its last op: read it as
            # its web UI stops
            import lives_tpu.webui as jw
            stop, final = jw.WebUI.stop, {}

            def stop_after_reading(self):
                final["timeline"] = read_timeline(
                    f"http://{self.host}:{self.port}")
                return stop(self)
            monkeypatch.setattr(jw.WebUI, "stop", stop_after_reading)
            monkeypatch.setattr(sys, "argv", ["mt_edit_soak.py", "--ops",
                                              "40", "--seed", "0"])
            assert mod.main() == 0
            res = final
        else:
            res = mod.session(40, 0, "cpu", log=lambda s: None)
            assert res["errors"] == 0
        out[pkg] = calls, frames, res
    (jc, jf, jres), (tc, tf, res) = out["jax"], out["torch"]
    # the port's session reads the final timeline once more
    assert tc[-1] == ("timeline", res["timeline"])
    assert len(jc) == len(tc) - 1 >= 40
    assert tc[:-1] == jc
    assert res["timeline"] == jres["timeline"]
    assert len(jf) == len(tf) == 1 and jf[0].shape == tf[0].shape
    assert res["rendered"] == res["n_frames"] == len(tf[0]) > 0
    assert int(np.abs(jf[0].astype(int) - tf[0].astype(int)).max()) <= 1
    np.testing.assert_array_equal(res["frames"], tf[0])


def test_mt_edit_soak_main():
    assert mt_edit_soak.main(["--ops", "10", "--device", "cpu"]) == 0


# -- the device rule ------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal "
                    "where CUDA is absent")
@pytest.mark.parametrize("prog", ["tools.rte_test", "tools.soaktest",
                                  "tools.mt_edit_soak",
                                  "examples.embed_demo",
                                  "examples.export_demo",
                                  "examples.multichip_render"])
def test_without_cuda_the_default_device_raises(prog):
    mod = importlib.import_module(f"lives_tpu_torch.{prog}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_tools_import_no_jax():
    code = ("import sys, importlib.abc\n"
            "class No(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'lives_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, No())\n"
            "import lives_tpu_torch.tools.batchproc, "
            "lives_tpu_torch.tools.monitor, lives_tpu_torch.tools.rte_test, "
            "lives_tpu_torch.tools.soaktest, "
            "lives_tpu_torch.tools.mt_edit_soak, "
            "lives_tpu_torch.examples.embed_demo, "
            "lives_tpu_torch.examples.export_demo, "
            "lives_tpu_torch.examples.multichip_render\n"
            "assert 'jax' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
