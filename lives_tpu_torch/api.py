"""Embeddable application API — the liblives successor.

Mirrors the class surface of the reference's `src/liblives.hpp:402-915`
(`livesApp`, `clip`, `set`, `effectKey`, `effectKeyMap`, `player`,
`multitrack`) as idiomatic Python over the engine. Callbacks are plain
callables registered per notify event (liblives marshals them onto the GTK
idle loop; here they run on the caller's thread or the OSC thread).

Counterpart of `lives_tpu/api.py:1-692` on the port's `Player`, clips and
multitrack model. `LiVESApp` takes its device (`device="cuda"` by
default; without CUDA it raises, as `Player` does) and passes it to its
player, to `MJPEGMultiClipSource` in `LiVESMultitrack.render` and so to
every render; a take (`render_recording`) and a timeline render reach the
new clip as host arrays, a chunk at a time for a take. FireWire capture
(`grab_firewire`, `io/dvgrab.py`) writes DV files under the work
directory and opens them as clips.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

from .graph.nodemodel import SinkSpec
from .io.clips import Clip as _Clip, create_clip, open_clip
from .multitrack import Multitrack
from .osc.server import NOTIFY, OSCServer
from .player import CollectSink, NullSink, Player
from .player.sinks import Sink


class LiVESClip:
    """liblives `clip` (liblives.hpp:~520): metadata + frame access."""

    def __init__(self, app: "LiVESApp", clip: _Clip, cnum: int):
        self._app = app
        self._clip = clip
        self.number = cnum

    @property
    def frames(self):
        return self._clip.frames

    @property
    def fps(self):
        return self._clip.fps

    @property
    def width(self):
        return self._clip.width

    @property
    def height(self):
        return self._clip.height

    @property
    def name(self):
        return self._clip.name

    @property
    def unique_id(self):
        return self._clip.unique_id

    def select(self):
        self._app.player._player.state.fg_clip = self._clip
        return True

    def select_background(self):
        self._app.player._player.state.bg_clip = self._clip
        return True

    # -- frame selection (liblives.hpp:~825 selectionStart/End/selectAll;
    #    1-based inclusive frames like the reference) --------------------
    @property
    def selection_start(self) -> int:
        return getattr(self, "_selection", (0, 0))[0]

    @property
    def selection_end(self) -> int:
        return getattr(self, "_selection", (0, 0))[1]

    def select_all(self) -> bool:
        self._selection = (1, max(self.frames, 1))
        return True

    def set_selection_start(self, start: int) -> bool:
        start = max(1, min(int(start), max(self.frames, 1)))
        end = max(self.selection_end, start)
        self._selection = (start, end)
        return True

    def set_selection_end(self, end: int) -> bool:
        end = max(1, min(int(end), max(self.frames, 1)))
        start = min(self.selection_start or 1, end)
        self._selection = (max(start, 1), end)
        return True

    def raw(self) -> _Clip:
        return self._clip


class EffectKey:
    """liblives `effectKey`: one of the 64 rte keys."""

    def __init__(self, app: "LiVESApp", key: int):
        self._app = app
        self.key = key

    def map(self, filter_name: str, mode: int = 0):
        self._app.player._player.keymap.set_key(self.key, mode, filter_name)

    @property
    def enabled(self) -> bool:
        return self._app.player._player.keymap.active[self.key]

    def set_enabled(self, on: bool):
        self._app.player._player.key_toggle(self.key, on)

    def next_mode(self):
        self._app.player._player.keymap.next_mode(self.key)

    def set_parameter(self, name: str, value):
        self._app.player._player.set_key_param(self.key, name, value)


class EffectKeyMap:
    """liblives `effectKeyMap`: indexable key collection."""

    def __init__(self, app: "LiVESApp"):
        self._app = app

    def __getitem__(self, key: int) -> EffectKey:
        return EffectKey(self._app, key)

    def clear(self):
        km = self._app.player._player.keymap
        for k in range(len(km.active)):
            if km.active[k]:
                self._app.player._player.key_toggle(k, False)


class LiVESPlayer:
    """liblives `player`."""

    AUTOSAVE_NAME = "recording.autosave.json"

    def __init__(self, app: "LiVESApp", sink: Sink | None = None, *,
                 device="cuda"):
        self._app = app
        self._player = Player(sink=sink or NullSink(), device=device)

    def play(self):
        self._player.start()
        self._app._notify(NOTIFY.PLAYBACK_STARTED, "")
        return True

    def stop(self):
        self._player.stop()
        self._app._notify(NOTIFY.PLAYBACK_STOPPED, "")
        return True

    @property
    def playing(self):
        return self._player.state.playing

    def set_fps(self, fps: float):
        self._player.set_pb_fps(fps)

    @property
    def fps(self):
        return self._player.state.pb_fps

    def tick(self, n: int = 1):
        """Advance n player cycles (headless pump)."""
        self._player.play_n_cycles(n)

    # -- recording (reference record + deal_with_render_choice flow) -------
    def record_start(self, scrap_generators: bool = True,
                     backup_every: float = 5.0):
        """Start recording the performance (events.c record path). Live
        generator output is scrapped to MJPEG clips by default so the
        render reproduces the take exactly. The take autosaves to
        <workdir>/recording.autosave.json (reference backup_recording)
        so a crash never loses a performance; recover_recording() on the
        app renders it after a restart."""
        clip = self._player.state.fg_clip
        self._player.scrap_dir = str(self._app.workdir)
        self._player.record_start(width=getattr(clip, "width", 0),
                                  height=getattr(clip, "height", 0),
                                  scrap_generators=scrap_generators,
                                  backup_path=str(self._app.workdir
                                                  / self.AUTOSAVE_NAME),
                                  backup_every=backup_every)
        self._app._notify(NOTIFY.RECORD_STARTED, "")

    def record_stop(self):
        """Stop recording; the take is kept for render_recording()."""
        el = self._player.record_stop()
        self._app._notify(NOTIFY.RECORD_STOPPED, "")
        return el

    @property
    def recording(self) -> bool:
        return bool(self._player.record)

    def discard_recording(self) -> bool:
        """Drop the last take and its autosave — the "discard" arm of
        the render choice."""
        return self._player.discard_recording()

    def _recording_uid_map(self) -> dict:
        return self._player.recording_uid_map(
            cl.raw() for cl in self._app._clips)

    def preview_recording(self, max_seconds: float | None = None) -> int:
        """Paced playback of the last take through the player's sink
        WITHOUT materialising a clip — the render-choice "preview"
        (deal_with_render_choice, events.c:5955). Refuses while playback
        runs. Returns frames shown."""
        return self._player.preview_last_recording(
            self._recording_uid_map(), max_seconds=max_seconds)

    def render_recording(self, render_audio: bool = True
                         ) -> Optional["LiVESClip"]:
        """Render the last recorded performance to a NEW clip in the app
        — the reference's post-record render choice
        (deal_with_render_choice, events.c:5101 render_to_clip). Scrap
        clips captured from live generators are consumed automatically."""
        import numpy as np

        uid_map = self._recording_uid_map()
        el = self._player.last_recording
        out = raw = None
        n = 0
        # streamed chunks, rendered on the player's device: bounded
        # memory on hour-long takes, and frames hit the clip as HOST
        # arrays
        for _tcs, chunk in self._player.render_last_recording_batches(
                uid_map):
            if raw is None:
                h, w = chunk.shape[-2], chunk.shape[-1]
                out = self._app.new_clip(w, h, el.fps or 25.0,
                                         name="recorded")
                raw = out.raw()
            raw.put_frames(range(n, n + len(chunk)), chunk)
            n += len(chunk)
        if raw is None:
            return None
        raw.frames = n
        raw.create_frame_index(all_virtual=False)
        if render_audio:
            from .audio.engine import render_audio_from_seeks
            audio = render_audio_from_seeks(el, uid_map)
            if len(audio) and np.abs(audio).max() > 1e-6:
                raw.write_audio(audio.astype(np.float32), 44100)
        raw.save_header()
        autosave = self._app.workdir / self.AUTOSAVE_NAME
        if autosave.exists():
            autosave.unlink()  # take rendered: recovery no longer needed
        self._app._notify(NOTIFY.CLIP_OPENED, str(out.number))
        return out


class ClipSet:
    """liblives `set`: the loaded clip collection, savable under a name
    (reference sethandler.c)."""

    def __init__(self, app: "LiVESApp"):
        self._app = app
        self.name = ""

    @property
    def num_clips(self):
        return len(self._app._clips)

    def __getitem__(self, i: int) -> LiVESClip:
        return self._app._clips[i]

    def save(self, name: str):
        from .sets import save_set
        save_set(self._app, name)
        self.name = name
        self._app._notify(NOTIFY.CLIPSET_SAVED, name)
        return True


class LiVESBlock:
    """liblives `block` (liblives.hpp:~278 + block class): a handle onto
    one timeline block, identified by (track, start time). Like the
    reference, the underlying block is only a *view* on the event list —
    the handle revalidates against the model on each call and becomes
    invalid when the block no longer exists."""

    def __init__(self, mtk: "LiVESMultitrack", track: int, start: int):
        self._mtk = mtk
        self._track = track
        self._start = start

    def _find(self):
        for b in self._mtk._mt.blocks(self._track):
            if b.start == self._start:
                return b
        return None

    @property
    def is_valid(self) -> bool:
        return self._find() is not None

    def start_time(self) -> float:
        """block::startTime() — seconds."""
        b = self._find()
        return b.start / self._mtk._mt.el.fps if b else -1.0

    def length(self) -> float:
        """block::length() — seconds."""
        b = self._find()
        return b.length / self._mtk._mt.el.fps if b else -1.0

    def track(self) -> int:
        return self._track if self._find() else -65536

    def remove(self) -> bool:
        """block::remove() — gravity may relocate other blocks."""
        b = self._find()
        if b is None:
            return False
        self._mtk._mt.delete_block(b)
        if self._mtk._mt.gravity == self._mtk._mt.gravity.__class__.LEFT:
            self._mtk._mt.remove_gaps([self._track], 0,
                                      self._mtk._mt.n_frames)
        self._mtk._app._notify(NOTIFY.BLOCK_DELETED, "")
        return True

    def move_to(self, track: int, time: float) -> bool:
        """block::moveTo(track, time)."""
        b = self._find()
        if b is None:
            return False
        mt = self._mtk._mt
        nb = mt.move_block(b, track, int(round(time * mt.el.fps)))
        if nb is None:
            return False
        self._track, self._start = nb.track, nb.start
        self._mtk._app._notify(NOTIFY.BLOCK_MOVED, "")
        return True


class LiVESMultitrack:
    """liblives `multitrack` (liblives.hpp:761-915 surface): current
    track/time insertion point, gravity/insert modes, block insertion and
    render-to-clip over the headless Multitrack model."""

    def __init__(self, app: "LiVESApp"):
        self._app = app
        self._current_track = 0
        self._current_time = 0.0
        self._labels: dict[int, str] = {}

    # the raw model lives on the app (`app.multitrack`), so layout loads
    # (sets.py) and OSC handlers see the same timeline this API edits
    @property
    def _mt(self) -> Multitrack:
        return self._app.multitrack

    @property
    def model(self) -> Multitrack:
        return self._mt

    def is_active(self) -> bool:
        return True  # headless build: always available

    # -- insertion point ---------------------------------------------------
    def set_current_track(self, track: int) -> bool:
        """multitrack::setCurrentTrack (liblives.hpp:1736)."""
        if not (-self._mt.n_audio_tracks <= track < self._mt.n_tracks):
            return False
        self._current_track = int(track)
        self._app._notify(NOTIFY.MT_TRACK_CHANGED, str(track))
        return True

    def current_track(self) -> int:
        return self._current_track

    def set_current_time(self, time: float) -> float:
        """multitrack::setCurrentTime (liblives.hpp:1758)."""
        if time >= 0.0:
            self._current_time = float(time)
            self._app._notify(NOTIFY.MT_TIME_CHANGED, str(time))
        return self._current_time

    def current_time(self) -> float:
        return self._current_time

    # -- modes -------------------------------------------------------------
    def gravity(self):
        return self._mt.gravity

    def set_gravity(self, mode):
        from .multitrack import Gravity
        self._mt.gravity = Gravity(mode)
        return self._mt.gravity

    def insert_mode(self):
        return self._mt.insert_mode

    def set_insert_mode(self, mode):
        from .multitrack import InsertMode
        self._mt.insert_mode = InsertMode(mode)
        return self._mt.insert_mode

    # -- tracks ------------------------------------------------------------
    def num_video_tracks(self) -> int:
        return self._mt.n_tracks

    def num_audio_tracks(self) -> int:
        return self._mt.n_audio_tracks

    def add_video_track(self, in_front: bool = False) -> bool:
        """multitrack::addVideoTrack. ``in_front`` renumbers existing
        content one track down (reference insert-before semantics)."""
        self._mt.add_track()
        if in_front:
            from .events.event_list import EventType
            for e in self._mt.el.events:
                if e.type == EventType.FRAME:
                    e.props["clips"].insert(0, -1)
                    e.props["clips"].pop()
                    e.props["frames"].insert(0, 0)
                    e.props["frames"].pop()
                elif e.type == EventType.FILTER_INIT \
                        and not e.props.get("audio"):
                    e.props["in_tracks"] = [t + 1 for t in
                                            e.props.get("in_tracks", [])]
                    e.props["out_tracks"] = [t + 1 for t in
                                             e.props.get("out_tracks", [])]
        return True

    def fps(self) -> float:
        return self._mt.el.fps

    # -- autotransition (liblives setAutoTransition/disableAutoTransition)
    def set_auto_transition(self, filter_name: str) -> bool:
        from .effects.host import get_filter
        f = get_filter(filter_name)
        if f.n_in < 2:
            return False
        self._mt.autotrans_filter = filter_name
        return True

    def disable_auto_transition(self):
        self._mt.autotrans_filter = None

    def auto_transition(self) -> str:
        return self._mt.autotrans_filter or ""

    def set_track_label(self, track: int, label: str = "") -> bool:
        self._labels[int(track)] = label
        return True

    def track_label(self, track: int) -> str:
        return self._labels.get(int(track), f"Video {track}"
                                if track >= 0 else f"Audio {-track}")

    # -- blocks ------------------------------------------------------------
    def insert_block(self, c: "LiVESClip",
                     ignore_selection_limits: bool = False,
                     without_audio: bool = False) -> Optional[LiVESBlock]:
        """multitrack::insertBlock: inserts `c` at (currentTrack,
        currentTime), honouring the clip's frame selection unless
        ignored, plus gravity/insert mode."""
        mt = self._mt
        start = int(round(self._current_time * mt.el.fps))
        offset, length = 0, max(int(c.frames), 1)
        sel = getattr(c, "_selection", None)
        if sel and not ignore_selection_limits:
            offset = max(sel[0] - 1, 0)
            length = max(sel[1] - sel[0] + 1, 1)
        if self._current_track < 0:
            ab = mt.insert_audio_block(self._current_track, c.unique_id,
                                       start, length,
                                       seek=offset / mt.el.fps)
            if ab is None:
                return None
            self._app._notify(NOTIFY.BLOCK_INSERTED, "")
            blk = LiVESBlock(self, ab.track, ab.start)
            return blk
        b = mt.insert_block(self._current_track, c.unique_id, start,
                            length, offset,
                            with_audio=not without_audio)
        if b is None:
            return None
        self._app._notify(NOTIFY.BLOCK_INSERTED, "")
        return LiVESBlock(self, b.track, b.start)

    def wipe_layout(self, force: bool = False) -> str:
        name = getattr(self, "_layout_name", "")
        self._app.multitrack = Multitrack(fps=self._mt.el.fps,
                                          width=self._mt.el.width,
                                          height=self._mt.el.height,
                                          n_tracks=self._mt.n_tracks)
        self._app._notify(NOTIFY.LAYOUT_WIPED, name)
        return name

    def save_layout(self, path: str) -> str:
        self._mt.save_layout(path)
        self._layout_name = path
        return path

    def reload_layout(self, path: str) -> bool:
        self._app.multitrack = Multitrack.load_layout(path)
        self._layout_name = path
        return True

    # -- render ------------------------------------------------------------
    def render(self, render_audio: bool = True,
               normalise_audio: bool = True) -> Optional["LiVESClip"]:
        """multitrack::render — renders the timeline to a NEW clip in the
        app (render_to_clip, events.c:4994)."""
        from .io.jpeg_ingest import MJPEGMultiClipSource
        mt = self._mt
        uid_map = {cl.unique_id: cl.raw() for cl in self._app._clips}
        if not uid_map or mt.n_frames == 0:
            return None
        w = mt.el.width or max(c.width for c in uid_map.values())
        h = mt.el.height or max(c.height for c in uid_map.values())
        # compressed-domain batches for MJPEG clips, host decode for the
        # rest — per-clip routing inside the source, on the app's device
        src = MJPEGMultiClipSource(uid_map, w, h, device=self._app.device)
        frames, _tcs = mt.render(
            src, sink=SinkSpec(width=w, height=h))
        out = self._app.new_clip(w, h, mt.el.fps, name="rendered")
        import numpy as np

        raw = out.raw()
        raw.frames = len(frames)
        raw.create_frame_index(all_virtual=False)
        # the render's HOST arrays straight to disk
        raw.put_frames(range(len(frames)), frames)
        if render_audio:
            audio = mt.render_audio(uid_map)
            if len(audio):
                if normalise_audio:
                    peak = float(np.abs(audio).max())
                    if peak > 1e-6:
                        audio = audio * min(1.0, 0.95 / peak)
                out.raw().write_audio(audio.astype(np.float32), 44100)
        out.raw().save_header()
        self._app._notify(NOTIFY.MT_RENDERED, str(out.number))
        return out


class LiVESApp:
    """liblives `livesApp`: the top-level embeddable application object,
    on `device` (default "cuda"; without CUDA it raises)."""

    def __init__(self, workdir: str | Path | None = None,
                 sink: Sink | None = None, osc_port: int | None = None, *,
                 device="cuda"):
        import tempfile
        self.player = LiVESPlayer(self, sink, device=device)
        self.device = self.player._player.device
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="lives_tpu_"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._clips: list[LiVESClip] = []
        self.effect_key_map = EffectKeyMap(self)
        self.set = ClipSet(self)
        self.multitrack = Multitrack()
        self.mt = LiVESMultitrack(self)
        self._callbacks: dict[int, list[Callable]] = {}
        self.osc: Optional[OSCServer] = None
        # user-authored rendered effects persist under <workdir>/rfx;
        # the reference scans its rfx dir at startup (rfx-builder
        # scripts land in ~/.lives-dir)
        try:
            from .rfx_builder import load_user_scripts
            load_user_scripts(self.workdir / "rfx")
        except Exception as e:
            from .messaging import d_print
            d_print(f"user rfx autoload failed: {e}", "warn")
        if osc_port is not None:
            self.osc = OSCServer(self.player._player, port=osc_port)
            # one workdir for the whole app: the OSC record/recover
            # surface must see the same autosaves and scrap clips the
            # api writes
            self.osc.workdir = str(self.workdir)
            self.osc.start()

    # -- clips -------------------------------------------------------------
    def open_file(self, uri: str) -> LiVESClip:
        from .sets import add_to_recovery
        clip = open_clip(uri, self.workdir)
        add_to_recovery(self.workdir, clip.clip_dir)
        c = LiVESClip(self, clip, len(self._clips) + 1)
        self._clips.append(c)
        if self.osc:
            self.osc.clips[c.number] = clip
        if self.player._player.state.fg_clip is None:
            c.select()
        self._notify(NOTIFY.CLIP_OPENED, str(c.number))
        return c

    def grab_firewire(self, max_frames: int, fmt: int = 0,
                      base: str = "dvgrab-", autosplit: bool = False,
                      libs=None) -> list[LiVESClip]:
        """Capture from a FireWire DV/HDV camera and open the captured
        file(s) as clips (`src/ldvgrab.c` on_open_fw_activate ->
        camready -> rec -> open; in-process instead of the dvgrab
        child; `lives_tpu/api.py:597-624`). Returns [] when no camera or
        raw1394 libs are present (gated). The captured DV opens through
        the libav lane (`io/av.py`), as any clip does."""
        from .io.dvgrab import DVGrabSession, FirewireCamera, grab
        cam = FirewireCamera.find(libs)
        if cam is None:
            from .messaging import d_print
            d_print("no FireWire AVC camera (or raw1394 libs) found",
                    "warn")
            return []
        capdir = self.workdir / "capture"
        capdir.mkdir(exist_ok=True)
        session = DVGrabSession(capdir, base=base, fmt=fmt,
                                autosplit=autosplit)
        cam.play()
        try:
            files = grab(cam, session, max_frames=max_frames)
        finally:
            cam.stop()
            cam.close()
        return [self.open_file(str(p)) for p in files]

    def new_clip(self, width: int, height: int, fps: float = 25.0,
                 name: str = "") -> LiVESClip:
        clip = create_clip(self.workdir, width, height, fps, name)
        c = LiVESClip(self, clip, len(self._clips) + 1)
        self._clips.append(c)
        if self.osc:
            self.osc.clips[c.number] = clip
        return c

    def close_clip(self, c: LiVESClip):
        self._clips.remove(c)
        self._notify(NOTIFY.CLIP_CLOSED, str(c.number))

    # -- callbacks (liblives appendListener) -------------------------------
    def add_callback(self, notify_event: int, fn: Callable[[str], None]):
        self._callbacks.setdefault(notify_event, []).append(fn)

    def _notify(self, event: int, data: str = ""):
        if self.osc:
            self.osc.notify(event, data)
        for fn in self._callbacks.get(event, []):
            fn(data)

    def get_multitrack(self) -> LiVESMultitrack:
        """liblives `livesApp::getMultitrack()`."""
        return self.mt

    # -- recording crash recovery ------------------------------------------
    def check_recording_recovery(self) -> bool:
        """True when an autosaved recording from a crashed session exists
        (deal_with_render_choice(is_recovery), events.c:5955)."""
        return (self.workdir / LiVESPlayer.AUTOSAVE_NAME).exists()

    def recover_recording(self, render_audio: bool = True
                          ) -> Optional[LiVESClip]:
        """Render an autosaved recording from a crashed session to a NEW
        clip. Scrap clips finalized by the crashed session resolve via
        the uids in their filenames (scan_scrap_clips); takes that
        crashed mid-recording were autosaved with live-source references
        and replay from the sources. Returns the clip, or None when
        there is nothing to recover."""
        from .events.event_list import EventList
        from .io.scrap import scan_scrap_clips
        path = self.workdir / LiVESPlayer.AUTOSAVE_NAME
        if not path.exists():
            return None
        try:
            el = EventList.from_autosave(path.read_text())
        except (ValueError, KeyError):
            return None  # unreadable autosave
        if not len(el.events):
            path.unlink()
            return None
        pl = self.player._player
        pl.last_recording = el
        pl.rec_scrap_clips.update(scan_scrap_clips(self.workdir))
        referenced = {c for e in el.events
                      for c in (getattr(e, "clips", None) or [])}
        if not referenced & set(self.player._recording_uid_map()):
            # nothing the take references resolves in this session (e.g.
            # a mid-take autosave whose sources are not reopened): keep
            # the autosave rather than rendering blank frames and
            # destroying the only copy of the performance
            return None
        return self.player.render_recording(render_audio=render_audio)

    def quit(self):
        self._notify(NOTIFY.APP_QUIT, "")
        if self.osc:
            self.osc.stop()
