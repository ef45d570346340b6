"""The port's embeddable API (`lives_tpu_torch.api`: `LiVESApp`,
`LiVESClip`, `EffectKey`/`EffectKeyMap`, `LiVESPlayer`, `ClipSet`,
`LiVESBlock`, `LiVESMultitrack`), its clip sets and crash recovery
(`lives_tpu_torch.sets`) and `models.flagship` against lives_tpu's, on the
CPU.

Each scenario runs once a package, the port's app with `device="cpu"`, on
the same seeded YUV4MPEG clips (32x16 and 48x24), and notes what it
observes: frames within 1 LSB (torch's and XLA's float kernels differ by
an ulp), everything else equal. These are the counterparts of
`tests/test_control.py`'s API, set and recovery tests and of
`tests/test_api_multitrack.py`: set trees and the recovery journal equal
byte for byte (the journal with each session's directory written as
`<root>`), a take's event list equal as `to_json` text, and a crash, before
or after `record_stop`, recovering in a fresh app to frames equal to the
JAX package's.

Frames are shown with the serving loop stopped on a `chip_smoke.
ScriptedClock` (`tests/test_torch_osc.py`), event ids come from a counter
in both event_list modules, and `random` is seeded the same before each
package's run, so clip handles and unique ids agree.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import lives_tpu.api as j_api
import lives_tpu.events.event_list as j_elmod
import lives_tpu.io.clips as j_clips
import lives_tpu.io.genclip as j_genclip
import lives_tpu.models as j_models
import lives_tpu.multitrack as j_mt
import lives_tpu.sets as j_sets
import lives_tpu_torch.api as t_api
import lives_tpu_torch.events.event_list as t_elmod
import lives_tpu_torch.io.clips as t_clips
import lives_tpu_torch.io.genclip as t_genclip
import lives_tpu_torch.models as t_models
import lives_tpu_torch.multitrack as t_mt
import lives_tpu_torch.sets as t_sets
from lives_tpu.io.decoders import write_y4m
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch.osc import OSCClient
from lives_tpu_torch.osc.server import NOTIFY
from lives_tpu_torch.player import CollectSink as TCollectSink
from lives_tpu_torch.player import player as t_player_mod
from test_torch_clips import frame_px, tree
from test_torch_osc import assert_clips_within_1
from test_torch_weed_binary import _Counter

FPS = 25.0
PKG = {
    "jax": dict(api=j_api, sets=j_sets, mt=j_mt, el=j_elmod, clips=j_clips,
                gen=j_genclip, player=j_player_mod, sink=JCollectSink,
                kw={}),
    "torch": dict(api=t_api, sets=t_sets, mt=t_mt, el=t_elmod,
                  clips=t_clips, gen=t_genclip, player=t_player_mod,
                  sink=TCollectSink, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def media(root):
    """Two seeded YUV4MPEG clips: 20 frames of 32x16, 12 of 48x24."""
    root.mkdir(parents=True, exist_ok=True)
    out = []
    for k, (n, w, h) in enumerate(((20, 32, 16), (12, 48, 24))):
        rng = np.random.default_rng(70 + k)
        path = root / f"m{k}.y4m"
        if not path.exists():
            write_y4m(str(path), [
                (rng.integers(16, 236, (h, w), np.uint8),
                 rng.integers(16, 241, (h // 2, w // 2), np.uint8),
                 rng.integers(16, 241, (h // 2, w // 2), np.uint8))
                for _ in range(n)], FPS)
        out.append(str(path))
    return out


class P:
    """One package's side of a scenario: its modules, an app factory on
    the CPU, a scripted clock, and the observations."""

    def __init__(self, pkg, tmp, monkeypatch):
        m = PKG[pkg]
        self.pkg, self.tmp = pkg, Path(tmp) / pkg
        self.tmp.mkdir(parents=True)
        self.api, self.sets, self.mt, self.gen = (m["api"], m["sets"],
                                                  m["mt"], m["gen"])
        self.el = m["el"]
        self.Sink = m["sink"]
        self.clips = media(Path(tmp) / "media")
        self.clock = cs.ScriptedClock()
        monkeypatch.setattr(m["player"], "time", self.clock)
        monkeypatch.setattr(m["el"], "uuid", _Counter())
        monkeypatch.setattr(m["clips"], "_handle_counter", 0)
        random.seed(23)
        self.kw = m["kw"]
        self.obs = []

    def App(self, workdir="wd", **kw):
        app = self.api.LiVESApp(workdir=self.tmp / workdir, **kw,
                                **self.kw)
        app.player._player.async_compile = False
        app.player._player.prewarm_compile = False
        return app

    def show(self, app, frame):
        p = app.player._player
        p.state.frame = -1
        p._clock0 = self.clock.now
        p._frame0 = float(frame)
        p.process_one()
        self.clock.now += 1.0 / FPS

    def note(self, kind, value):
        def canon(v):
            if isinstance(v, str):
                return v.replace(str(self.tmp), "<root>")
            if isinstance(v, (list, tuple)):
                return type(v)(canon(x) for x in v)
            return v
        self.obs.append((kind, canon(value)))


def run_both(fn, tmp_path, monkeypatch):
    out = {}
    for pkg in PKG:
        side = P(pkg, tmp_path, monkeypatch)
        fn(side)
        out[pkg] = side.obs
    j, t = out["jax"], out["torch"]
    assert [k for k, _ in j] == [k for k, _ in t]
    for (kind, a), (_, b) in zip(j, t):
        if kind == "frames":
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                x, y = np.asarray(x).astype(int), np.asarray(y).astype(int)
                assert x.shape == y.shape and np.abs(x - y).max() <= 1, kind
        elif kind == "clip":
            assert_clips_within_1(a, b)
        elif kind == "tree":
            assert sorted(a) == sorted(b)
            for k in a:
                if not k.endswith(".png"):
                    assert a[k] == b[k], k
        else:
            assert a == b, kind
    return out


def clip_frames(c):
    return [frame_px(c, n) for n in range(c.frames)]


def sink_frames(sink):
    return [np.asarray(f) for f in sink.frames]


# -- the app, its keys and its player ----------------------------------------

def s_end_to_end(P):
    sink = P.Sink()
    app = P.App(sink=sink)
    events = []
    app.add_callback(P.api.NOTIFY.CLIP_OPENED, events.append)
    clip = app.open_file(P.clips[0])
    P.note("opened", (clip.frames, clip.width, clip.height, clip.fps,
                      clip.number, clip.name, events, app.set.num_clips))
    app.effect_key_map[0].map("negate")
    app.effect_key_map[0].set_enabled(True)
    P.note("enabled", app.effect_key_map[0].enabled)
    app.effect_key_map[1].map("gaussian_blur")
    app.effect_key_map[1].set_parameter("radius", 2)
    app.effect_key_map[1].set_enabled(True)
    app.player.set_fps(30.0)
    app.player.play()
    P.note("playing", (app.player.playing, app.player.fps))
    for i in range(3):
        P.show(app, i)
    app.player.tick(2)
    app.player.stop()
    P.note("shown", app.player._player.frames_shown)
    P.note("frames", sink_frames(sink))
    app.effect_key_map[1].next_mode()
    app.effect_key_map.clear()
    P.note("cleared", (app.effect_key_map[0].enabled,
                       app.effect_key_map[1].enabled))
    c = app.set[0]
    c.select_all()
    P.note("selection", (c.selection_start, c.selection_end))
    c.set_selection_start(4)
    c.set_selection_end(2)
    P.note("selection", (c.selection_start, c.selection_end))
    app.close_clip(c)
    P.note("closed", (app.set.num_clips, events))
    app.quit()


def s_sets_and_recovery(P):
    app = P.App()
    a = app.open_file(P.clips[0])
    app.open_file(P.clips[1])
    app.multitrack.insert_block(0, a.unique_id, 0, 4)
    app.set.save("myset")
    P.note("sets", P.sets.list_sets(app.workdir))
    P.note("tree", tree(app.workdir / "sets"))
    journal = app.workdir / P.sets.RECOVERY_FILE
    P.note("journal", journal.read_text())
    P.note("check", [str(d) for d in P.sets.check_recovery(app.workdir)])
    app2 = P.App()
    P.note("recovered", P.sets.recover_clips(app2))
    P.note("clips", [(c.number, c.unique_id, c.frames)
                     for c in app2._clips])
    P.sets.rewrite_recovery(app2.workdir, [app2._clips[1].raw().clip_dir])
    P.note("journal", journal.read_text())
    P.sets.clear_recovery(app2.workdir)
    P.note("check", P.sets.check_recovery(app2.workdir))
    app3 = P.App()
    P.note("loaded", P.sets.load_set(app3, "myset"))
    P.note("set", (app3.set.name, app3.set.num_clips,
                   len(app3.multitrack.blocks(0)),
                   app3.multitrack.el.to_json()))
    P.note("frames", clip_frames(app3.set[1].raw()))


def s_backup_and_restore(P):
    app = P.App()
    c = app.open_file(P.clips[1]).raw()
    arc = P.sets.backup_clip(c, P.tmp / "c.lvt")
    back = P.sets.restore_clip(arc, P.tmp / "restored")
    P.note("tree", tree(back.clip_dir))
    P.note("restored", (back.frames, back.unique_id, back.handle))
    P.note("frames", clip_frames(back))


# -- a take: render, preview, recovery ----------------------------------------

def record_take(P, app, n=6, switch_at=None, stop=True):
    app.effect_key_map[0].map("negate")
    app.player.play()
    app.player.record_start()
    for i in range(n):
        if i == 2:
            app.effect_key_map[0].set_enabled(True)
        if i == switch_at:
            app.set[1].select()
        P.show(app, i)
    el = app.player.record_stop() if stop else None
    app.player.stop()
    return el


def s_record_render_to_clip(P):
    app = P.App(sink=P.Sink())
    app.open_file(P.clips[0])
    app.open_file(P.clips[1])
    el = record_take(P, app, switch_at=4)
    P.note("recording", app.player.recording)
    P.note("take", el.to_json())
    P.note("autosave", app.check_recording_recovery())
    out = app.player.render_recording()
    P.note("rendered", (out.number, app.set.num_clips, out.frames,
                        out.width, out.height, out.name))
    P.note("clip", out.raw())
    P.note("autosave", app.check_recording_recovery())
    app.quit()


def s_preview_recording(P):
    sink = P.Sink()
    app = P.App(sink=sink)
    app.open_file(P.clips[0])
    record_take(P, app, n=5)
    live = len(sink.frames)
    shown = app.player.preview_recording()
    P.note("preview", (shown, len(sink.frames) - live, app.set.num_clips))
    P.note("frames", sink_frames(sink)[live:])
    app.quit()


def s_discard_recording(P):
    app = P.App()
    app.open_file(P.clips[0])
    record_take(P, app, n=3)
    P.note("autosave", app.check_recording_recovery())
    P.note("discard", app.player.discard_recording())
    P.note("autosave", app.check_recording_recovery())
    P.note("discard", app.player.discard_recording())


def s_crash_after_stop_recovers_in_fresh_app(P):
    """A crash between record_stop and render: a fresh app over the same
    workdir reopens the journaled clips and renders the final autosave
    (the console's `recover`)."""
    app = P.App()
    app.open_file(P.clips[0])
    app.open_file(P.clips[1])
    record_take(P, app, switch_at=3)
    app2 = P.App()
    P.note("autosave", app2.check_recording_recovery())
    P.note("unresolved", app2.recover_recording() is None)
    P.note("recovered", P.sets.recover_clips(app2))
    out = app2.recover_recording(render_audio=False)
    P.note("clip", out.raw())
    P.note("autosave", app2.check_recording_recovery())
    app.quit()
    app2.quit()


def s_crash_mid_take_recovers_from_sources(P):
    """A crash BEFORE record_stop: the JSONL autosave holds live-source
    references (a generator's uid is process-stable); a fresh app that
    re-creates the same generator recovers from it."""
    app = P.App(sink=P.Sink())
    gen = P.gen.GeneratorClip("plasma", 32, 16, fps=FPS, **P.kw)
    pl = app.player._player
    pl.state.fg_clip = gen
    pl.set_pb_fps(FPS)
    app.player.play()
    app.player.record_start(backup_every=0.0)   # autosave every frame
    for i in range(5):
        P.show(app, i)
    el = P.el.EventList.from_autosave(
        (app.workdir / "recording.autosave.json").read_text())
    scrap = {r.unique_id for r in pl._scrap_recs.values()}
    P.note("live_refs", all(e.clips[0] == gen.unique_id
                            and e.clips[0] not in scrap
                            for e in el if getattr(e, "clips", None)))
    P.note("autosave", el.to_json())
    pl.record = False      # the crash: no record_stop
    pl.state.playing = False
    app2 = P.App(sink=P.Sink())
    gen2 = P.gen.GeneratorClip("plasma", 32, 16, fps=FPS, **P.kw)
    app2.player._player.state.fg_clip = gen2
    out = app2.recover_recording()
    P.note("clip", out.raw())
    P.note("autosave", app2.check_recording_recovery())
    app.quit()
    app2.quit()


def s_unresolvable_autosave_is_kept(P):
    wd = P.tmp / "wd"
    wd.mkdir(parents=True)
    el = P.el.EventList(fps=FPS)
    for i in range(4):
        el.insert(P.el.frame_event(i * 4_000_000, [0x5EED], [i]))
    (wd / "recording.autosave.json").write_text(el.to_json())
    app = P.App()
    P.note("autosave", app.check_recording_recovery())
    P.note("recover", app.recover_recording())
    P.note("autosave", app.check_recording_recovery())
    (wd / "recording.autosave.json").write_text(
        P.el.EventList(fps=FPS).to_json())
    P.note("recover", app.recover_recording())
    P.note("autosave", app.check_recording_recovery())


# -- the multitrack API (tests/test_api_multitrack.py) ------------------------

def mt_app(P, **kw):
    app = P.App(**kw)
    app.multitrack = P.mt.Multitrack(width=32, height=16)
    return app, app.open_file(P.clips[0])


def s_insert_block_and_views(P):
    app, c = mt_app(P)
    mtk = app.get_multitrack()
    P.note("track", mtk.set_current_track(0))
    P.note("time", mtk.set_current_time(0.0))
    b = mtk.insert_block(c)
    P.note("block", (b.is_valid, b.start_time(), b.length(), b.track()))
    P.note("active", (mtk.is_active(), mtk.current_track(),
                      mtk.current_time()))
    P.note("bad track", mtk.set_current_track(9))


def s_selection_limits_insert(P):
    app, c = mt_app(P)
    c.set_selection_start(5)
    c.set_selection_end(10)
    mtk = app.get_multitrack()
    b = mtk.insert_block(c)
    P.note("len", b.length())
    P.note("none", mtk.insert_block(c, ignore_selection_limits=True))
    mtk.set_current_time(1.0)
    b3 = mtk.insert_block(c, ignore_selection_limits=True,
                          without_audio=True)
    P.note("len", (b3.start_time(), b3.length()))
    P.note("el", app.multitrack.el.to_json())


def s_block_move_remove_notify(P):
    app, c = mt_app(P)
    events = []
    for ev, tag in ((NOTIFY.BLOCK_INSERTED, "ins"),
                    (NOTIFY.BLOCK_MOVED, "mov"),
                    (NOTIFY.BLOCK_DELETED, "del"),
                    (NOTIFY.MT_TRACK_CHANGED, "trk"),
                    (NOTIFY.MT_TIME_CHANGED, "tim")):
        app.add_callback(ev, lambda d, tag=tag: events.append((tag, d)))
    mtk = app.get_multitrack()
    b = mtk.insert_block(c)
    P.note("moved", b.move_to(1, 0.4))
    P.note("block", (b.track(), b.start_time()))
    mtk.set_gravity(P.mt.Gravity.LEFT)
    mtk.set_current_track(1)
    mtk.set_current_time(2.0)
    b2 = mtk.insert_block(c)
    P.note("removed", b.remove())
    P.note("gone", (b.is_valid, b.start_time(), b.length(), b.track(),
                    b.remove(), b.move_to(0, 0.0)))
    P.note("left", (b2.is_valid, b2.start_time()))
    P.note("events", events)


def s_modes_and_tracks_surface(P):
    app, c = mt_app(P)
    mtk = app.get_multitrack()
    P.note("gravity", int(mtk.set_gravity(P.mt.Gravity.LEFT)))
    P.note("gravity", int(mtk.gravity()))
    P.note("mode", int(mtk.set_insert_mode(P.mt.InsertMode.OVERWRITE)))
    P.note("mode", int(mtk.insert_mode()))
    P.note("tracks", (mtk.num_video_tracks(), mtk.num_audio_tracks()))
    mtk.insert_block(c)
    P.note("added", mtk.add_video_track(in_front=True))
    P.note("tracks", (mtk.num_video_tracks(), mtk.fps()))
    P.note("el", app.multitrack.el.to_json())
    mtk.set_track_label(0, "cam A")
    P.note("labels", (mtk.track_label(0), mtk.track_label(1),
                      mtk.track_label(-1)))
    P.note("autotrans", (mtk.set_auto_transition("negate"),
                         mtk.set_auto_transition("crossfade"),
                         mtk.auto_transition()))
    mtk.disable_auto_transition()
    P.note("autotrans", mtk.auto_transition())


def s_audio_track_insert(P):
    app, c = mt_app(P)
    c.raw().write_audio(np.full((44100, 2), 0.5, np.float32), 44100)
    mtk = app.get_multitrack()
    P.note("track", mtk.set_current_track(-1))
    b = mtk.insert_block(c)
    P.note("ablock", (b is not None, len(app.multitrack.audio_blocks(-1))))
    P.note("el", app.multitrack.el.to_json())


def s_render_to_clip(P):
    app, c = mt_app(P)
    c.raw().write_audio(np.full((44100, 2), 0.25, np.float32), 44100)
    d = app.open_file(P.clips[1])
    mtk = app.get_multitrack()
    mtk.insert_block(c)
    mtk.set_current_track(1)
    mtk.set_current_time(0.2)
    mtk.insert_block(d)
    app.multitrack.add_effect("crossfade", [0, 1], 5, 8)
    events = []
    app.add_callback(NOTIFY.MT_RENDERED, events.append)
    out = mtk.render(render_audio=True)
    P.note("out", (out.frames, out.width, out.height, out.name, events))
    P.note("clip", out.raw())
    app.multitrack = P.mt.Multitrack(width=32, height=16)
    P.note("empty", mtk.render())


def s_wipe_and_layout_roundtrip(P):
    app, c = mt_app(P)
    mtk = app.get_multitrack()
    mtk.insert_block(c)
    path = str(P.tmp / "l.json")
    P.note("saved", Path(mtk.save_layout(path)).name)
    events = []
    app.add_callback(NOTIFY.LAYOUT_WIPED, events.append)
    P.note("wiped", mtk.wipe_layout(force=True))
    P.note("after", (app.multitrack.n_frames, events))
    P.note("reloaded", mtk.reload_layout(path))
    P.note("blocks", len(app.multitrack.blocks(0)))
    P.note("file", Path(path).read_text())


def s_flagship(P):
    models = j_models if P.pkg == "jax" else t_models
    el, src, sink = models.flagship(n_tracks=3, width=48, height=24,
                                    n_frames=6, **P.kw)
    P.note("el", el.to_json())
    P.note("sink", (sink.width, sink.height))
    P.note("frames", [np.asarray(src.get_batch([c] * 2, [0, 5]).planes[0])
                      for c in (1, 2, 3)])


SCENARIOS = {name[2:]: fn for name, fn in globals().items()
             if name.startswith("s_") and callable(fn)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_api_matches_jax(name, tmp_path, monkeypatch):
    run_both(SCENARIOS[name], tmp_path, monkeypatch)


# -- the port's own contracts -------------------------------------------------

def test_app_refuses_without_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.LiVESApp(workdir=tmp_path / "wd")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_models.flagship(n_tracks=2, width=16, height=8, n_frames=2)
    assert not (tmp_path / "wd").exists()


def test_app_device_reaches_player_and_renders(tmp_path):
    app = t_api.LiVESApp(workdir=tmp_path / "wd", device="cpu")
    assert app.device == torch.device("cpu")
    assert app.player._player.device == app.device


def test_grab_firewire_names_its_item(tmp_path, monkeypatch):
    """FireWire capture, a stub naming ROADMAP item 23 until it was
    ported: with no raw1394 libraries both apps find no camera and return
    [] (`lives_tpu/api.py:597-610`; the grab itself against mocks is
    `tests/test_torch_dvgrab.py`)."""
    import lives_tpu.io.dvgrab as j_dv
    import lives_tpu_torch.io.dvgrab as t_dv
    for mod in (j_dv, t_dv):
        monkeypatch.setattr(mod, "load_firewire_libs", lambda: None)
    app = t_api.LiVESApp(workdir=tmp_path / "wd", device="cpu")
    japp = j_api.LiVESApp(workdir=tmp_path / "jwd")
    assert app.grab_firewire(10) == japp.grab_firewire(10) == []
    assert not (tmp_path / "wd" / "capture").exists()


def test_app_serves_osc_over_its_workdir(tmp_path):
    paths = media(tmp_path / "media")
    app = t_api.LiVESApp(workdir=tmp_path / "wd", osc_port=0, device="cpu")
    try:
        c = app.open_file(paths[0])
        assert app.osc.workdir == str(app.workdir)
        with OSCClient(port=app.osc.port, timeout=5.0) as cl:
            assert cl.query1("/ping") == "pong"
            assert cl.query1("/clip/count") == 1
            assert cl.query1("/clip/frame/count") == c.frames
            assert cl.query1("/clipset/save", "over_osc") == "over_osc"
        assert t_sets.list_sets(app.workdir) == ["over_osc"]
    finally:
        app.quit()
    assert not app.osc._thread.is_alive()
