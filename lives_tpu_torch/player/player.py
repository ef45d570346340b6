"""Realtime player: clock, frame targeting, trickplay, rte keys, recording.

Counterpart of `lives_tpu/player/player.py` (reference `src/player.c`:
`process_one` :2185, `calc_new_playback_position` :1831, `load_frame_image`
:918; the rte key system, `src/effects.c:1251`, `src/mainwindow.h:223-232`:
64 keys x 32 modes). A Player owns foreground/background clip sources, a
`KeyMap` of toggleable effect instances and a sink. Each cycle it converts
the clock to a target frame (fps may be negative or fractional:
trickplay), pulls the source layers, runs the `FrameGraph` of the current
key chain (`FrameGraph.run`: a decoded YUV420P track reaches the chain
through `convert_layer`, K2 on the card, and a YUV420P sink's output
leaves through K3) and hands the result to the sink. With recording on it
logs FRAME / FILTER_INIT / FILTER_DEINIT / FILTER_MAP / PARAM_CHANGE events
into an `EventList` that `render_last_recording` re-renders.

`KeyMap` (`:46-199`) and the clock, clamp, autotransition, key and
recording code (`:200-860`) are the JAX package's host Python, copied.

The device is explicit: `Player(..., device="cuda")` by default, raising
when CUDA is absent; the tests pass `device="cpu"`. Host frames (a clip's
`get_frame`) are uploaded by the player; a layer already on the player's
device passes through. On a CUDA device the precache worker reads each
frame into a ring of pinned host buffers (`UploadRing`) and copies it to
the card on a side stream; the serving loop's stream waits on the copy's
event before the graph reads the frame, and a pinned buffer is reused only
once the copy that read it has completed. A chain change is warmed on a
background thread on its own stream while the old graph serves.

Subtitles (`load_subtitles`, `text.SubtitleOverlay`) composite after the
chain and before the pipeline, indexed by clip time, on an RGB sink's
frames; a mask is uploaded once while its subtitle shows.

The compressed lane (JAX `:1015-1025,1047-1064,1228-1245`): a virtual
frame of a decoder with `get_frame_device` (an MJPEG AVI) is decoded
through `io/jpeg_ingest.py` onto the player's device while the pref
`mjpeg_device_decode` is on (the default): entropy decode on the host,
the rest on the card, so it skips the upload ring. The precache worker
decodes each clip's missing window with one `get_frames_device` call a
`precache_chunk` of frames, and a miss on such a clip drops the frame
(the worker will decode it) rather than decode inline. An exception of
the lane falls back to the host decode, as in the JAX package, and is
counted (`lane_errors`) and warned once a clip.

Data connections (`datacons`, an `effects.data.DataConnections`, JAX
`:306-309,482-510,912-962,1442-1444`): each cycle pushes the connected
out-values into the active chain's instances before the run
(`chain_data`, on the values' device), and the channel connections
between members of the chain become the graph's cconx (forward edges
only) and join the graph's cache key, so a cconx edit is a new graph.
While recording, the wiring is stamped on the destinations' FILTER_INIT
events as `cconx` props at each filter-map refresh and at `record_stop`,
so `render_recording` rebuilds it.

Scrap capture (JAX `:509-630,1493-1533`): while recording with
`scrap_generators` on, a live source that cannot replay (a stateful
generator, or a clip with `scrap_on_record` such as a YUV4MPEG fifo)
has each pulled device layer queued to an `io.scrap.MJPEGScrapRecorder`
of its own, whose worker encodes it on a side stream through the device
JPEG lane; the FRAME event references the scrap clip's frame, and
`record_stop` finalizes each capture into an MJPEG AVI clip under
`scrap_dir` (else the pref `workdir`, else a temporary directory) in
`rec_scrap_clips`, rewriting the references of frames a failed capture
lost back to the live source. Stateless generators ride as `GenSlot`s
and replay from the clip reference; decoded clips need no capture.

Left out, each raising `NotImplementedError` naming its ROADMAP Queue 1
item: audio, `time_source="audio"` and the audio of a recorded frame
(item 23); the JACK transport that mirrors start and stop
(`transport`, item 23) is absent. The JAX worker's fixed decode batch
sizes {4, `precache_chunk`} existed so that XLA compiled two templates;
the port decodes the window as it stands, in chunks of `precache_chunk`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..constants import Palette
from ..effects.host import (FILTER_STATEFUL, Instance, get_filter,
                            instantiate)
from ..events.event_list import (EventList, TICKS_PER_SECOND,
                                 filter_deinit_event, filter_init_event,
                                 filter_map_event, frame_event,
                                 param_change_event)
from ..graph.nodemodel import FrameGraph, GenSlot, SinkSpec
from ..layer import Layer, _plane_shapes
from .sinks import NullSink, Sink

N_KEYS = 64          # prefs::rte_keys_virtual ceiling (mainwindow.h:228)
MODES_PER_KEY = 32   # mainwindow.h:229

_ITEM23 = "ROADMAP Queue 1 item 23"


class _PrecacheMiss(Exception):
    """A frame the precache worker is decoding was not ready: the
    serving loop drops the frame instead of waiting (player.c getahead
    drop policy)."""


class KeyMap:
    """64 effect keys x up to 32 modes each; a key holds filter names, one
    mode active, toggling a key enables its active mode's instance."""

    def __init__(self):
        self.slots: list[list[str]] = [[] for _ in range(N_KEYS)]
        self.mode: list[int] = [0] * N_KEYS
        self.active: list[bool] = [False] * N_KEYS
        self.instances: list[Optional[Instance]] = [None] * N_KEYS
        # per-(key, mode) param defaults applied on instantiation —
        # the reference's resources/fxdefs.perkey
        self.defaults: dict[tuple[int, int], dict] = {}

    def set_key(self, key: int, mode: int, filter_name: str):
        get_filter(filter_name)  # validate
        slot = self.slots[key]
        while len(slot) <= mode:
            slot.append("")
        slot[mode] = filter_name

    def toggle(self, key: int, on: bool | None = None) -> bool:
        """rte_key_toggle (effects.c:1251). Returns new state."""
        state = (not self.active[key]) if on is None else on
        if state and not self.instances[key]:
            name = self.current_filter(key)
            if not name:
                return False
            dflt = self.defaults.get((key, self.mode[key]), {})
            self.instances[key] = instantiate(name, **dflt)
        self.active[key] = state
        return state

    def next_mode(self, key: int):
        slot = self.slots[key]
        if slot:
            self.mode[key] = (self.mode[key] + 1) % len(slot)
            self.instances[key] = None  # re-instantiate on next enable

    def prev_mode(self, key: int):
        slot = self.slots[key]
        if slot:
            self.mode[key] = (self.mode[key] - 1) % len(slot)
            self.instances[key] = None

    def current_filter(self, key: int) -> str:
        slot = self.slots[key]
        m = self.mode[key]
        return slot[m] if m < len(slot) else ""

    def active_chain(self) -> list[Instance]:
        out = []
        for k in range(N_KEYS):
            if self.active[k] and self.instances[k]:
                out.append(self.instances[k])
        return out

    def chain_key(self):
        # must agree with active_chain() (keys without a materialised
        # instance are NOT in the chain) and must distinguish instance
        # identity: re-instantiation (mode change / new defaults) makes a
        # new graph
        return tuple((k, self.current_filter(k), id(self.instances[k]))
                     for k in range(N_KEYS)
                     if self.active[k] and self.instances[k])

    #: substrings of reference Weed hashnames -> our filter names, used when
    #: importing a reference default.keymap
    REF_FILTER_MAP = {
        "rotozoom": "rotozoom", "lifetv": "life", "firetv": "fire",
        "blurzoom": "blurzoom", "mirror": "mirror", "kaleidoscope":
        "kaleidoscope", "rippletv": "ripple", "warptv": "warptv",
        "negat": "negate", "posterise": "posterize", "posterize":
        "posterize", "blur": "gaussian_blur", "vertigo": "vertigo",
        "edge": "edge", "rgbdelay": "rgb_delay", "noise":
        "noise", "plasma": "plasma", "bump2d": "bump2d", "bump": "lens",
        "onedtv": "onedtv",
        "nervous": "nervous", "textfun": "textfun", "colorkey":
        "chroma_key",
        # simple_blend.c modes
        "negative luma overlay": "luma_key", "luma overlay": "luma_key",
        "chroma blend": "crossfade", "simple_blend": "crossfade",
        # multi_blends.c modes (ours share the names)
        "blend_screen": "blend_screen", "blend_overlay": "blend_overlay",
        "blend_lighten": "blend_lighten", "blend_darken": "blend_darken",
        "blend_dodge": "blend_dodge", "blend_burn": "blend_burn",
        "blend_add": "blend_add", "blend_subtract": "blend_subtract",
        "blend_multiply": "blend_multiply",
        "blend_difference": "blend_difference",
        # other plugin families
        "slide_over": "slide_over", "tvpic": "tvpic",
        "puretext": "livetext", "scribbler": "scribbler",
        "videowall": "videowall", "compositor": "compositor",
        # weed-builder scripts (weed-plugins/scripts/)
        "ccorrect": "colour_balance", "alien_overlay": "alien_overlay",
        "targeted_zoom": "targeted_zoom", "revtv": "revtv",
        "pan_and_zoom": "targeted_zoom", "comic": "comic",
    }

    def load_reference_keymap(self, path) -> int:
        """Import a reference `default.keymap` (lines `key|WeedHashname`),
        mapping known plugin hashnames onto our filters. Returns mapped
        count. The first fragment of `REF_FILTER_MAP` that a line's
        hashname holds decides the line, as it does in the JAX package
        (whose registry holds every target); a line whose target the port
        does not register yet is skipped, never mapped by a later fragment
        (a reference blurzoom line would otherwise match "blur")."""
        from ..effects.host import list_filters
        have = set(list_filters())
        n = 0
        for line in open(path, errors="replace"):
            line = line.strip()
            if "|" not in line or not line[0].isdigit():
                continue
            key_s, hashname = line.split("|", 1)
            key = int(key_s) - 1
            if not 0 <= key < N_KEYS:
                continue
            h = hashname.lower()
            for frag, ours in self.REF_FILTER_MAP.items():
                if frag in h:
                    if ours in have:
                        self.set_key(key, len(self.slots[key]), ours)
                        n += 1
                    break
        return n

    # -- persistence (reference default.keymap / rte_window save) ----------
    def save(self, path):
        """The JAX package's file, byte for byte (indented JSON)."""
        import json
        data = [{"key": k, "modes": [m for m in self.slots[k] if m]}
                for k in range(N_KEYS) if any(self.slots[k])]
        dflts = [{"key": k, "mode": m, "values": v}
                 for (k, m), v in sorted(self.defaults.items()) if v]
        with open(path, "w") as fh:
            json.dump({"format": "lives_tpu_keymap", "version": 2,
                       "keys": data, "defaults": dflts}, fh, indent=1)

    def load(self, path):
        import json
        with open(path) as fh:
            d = json.load(fh)
        if d.get("format") != "lives_tpu_keymap":
            raise ValueError("not a keymap file")
        self.__init__()
        for entry in d["keys"]:
            for m, name in enumerate(entry["modes"]):
                self.set_key(entry["key"], m, name)
        for entry in d.get("defaults", []):
            self.defaults[(entry["key"], entry["mode"])] = entry["values"]

    def set_key_defaults(self, key: int, mode: int, **values):
        """Persistable per-key/mode param defaults (fxdefs.perkey)."""
        get_filter(self.slots[key][mode])  # validate the slot exists
        self.defaults[(key, mode)] = dict(values)
        if self.mode[key] == mode:
            self.instances[key] = None  # re-instantiate with new defaults


@dataclass
class PlayerState:
    playing: bool = False
    fg_clip: Any = None          # object with get_frame(n)/frames/fps
    bg_clip: Any = None
    pb_fps: float = 25.0         # may be negative (reverse) / scaled
    bg_pb_fps: float = 0.0       # bg clip rate; 0 = follow pb_fps
    frame: int = 0               # current frame (0-based)
    loop: bool = True
    ping_pong: bool = False
    blend_amount: float = 0.5    # fg/bg mix (blend factor, effects-weed.c:8815)
    sel_start: int = 0
    sel_end: int = -1            # -1 = clip end
    nervous: bool = False        # random-walk trickplay (player.c:1013)


class UploadRing:
    """Host frames to a CUDA device through a ring of pinned host buffers,
    copied on a side stream.

    `upload(specs, read)` takes the next slot, waits until the copy that
    last read its buffers has completed (the slot's event: a buffer whose
    copy is in flight is never handed out again), lets `read(buffers)` fill
    the slot's pinned tensors ((shape, dtype) each of `specs`), copies each
    to a new device tensor with `non_blocking=True` on the side stream and
    records an event there. Returns (device planes, event). The planes
    belong to the side stream's pool: the stream that reads them must wait
    on the event and mark them as used (`consume`), or the caching
    allocator could hand their memory out again too soon."""

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: list[list] = [[None, None] for _ in range(slots)]
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, specs, read):
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            bufs, ev = slot
            if ev is not None:
                ev.synchronize()
            if bufs is None or [(tuple(b.shape), b.dtype) for b in bufs] \
                    != [(tuple(s), d) for s, d in specs]:
                bufs = [torch.empty(s, dtype=d, pin_memory=True)
                        for s, d in specs]
            read(bufs)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                planes = tuple(b.to(self.device, non_blocking=True)
                               for b in bufs)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            slot[0], slot[1] = bufs, ev
            return planes, ev

    @staticmethod
    def consume(planes, ev) -> None:
        """Order the current stream of the planes' device after the copy
        event `ev`, and mark the planes as used on it."""
        stream = torch.cuda.current_stream(planes[0].device)
        stream.wait_event(ev)
        for p in planes:
            p.record_stream(stream)


class Player:
    def __init__(self, sink: Sink | None = None,
                 sink_spec: SinkSpec | None = None, fps: float = 25.0, *,
                 device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Player: device 'cuda' was asked for but CUDA is not "
                    "available; pass device='cpu' to play on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"Player: no path for device {dev}")
        self.device = dev
        self._ring = UploadRing(dev) if dev.type == "cuda" else None
        self._warm_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self.sink = sink or NullSink()
        self.sink_spec = sink_spec or SinkSpec()
        self.state = PlayerState(pb_fps=fps)
        self.keymap = KeyMap()
        self._graphs: dict[Any, FrameGraph] = {}
        self._clock0: float | None = None
        self._frame0: float = 0.0
        self.record = False
        self.event_list: EventList | None = None
        self._nervous_rng = np.random.default_rng()
        self._rec_inits: dict[int, Any] = {}
        self._scrap_generators = False
        self._scrap_recs: dict[int, Any] = {}
        self.rec_scrap_clips: dict[int, Any] = {}
        #: where record_stop writes scrap clips (its `scrap` folder)
        self.scrap_dir: str | None = None
        self.last_recording: EventList | None = None
        self._backup_lock = threading.Lock()
        # stats ladder (diagnostics.c:97 get_inst_fps)
        self.frames_shown = 0
        self.frames_dropped = 0
        self._frame_times: list[float] = []
        # pipelined sink: keep up to N frames in flight before the sink
        # consumes them (0 = synchronous)
        self.pipeline_depth = 0
        self._pending: list[tuple[Any, float]] = []
        # batched display fetch: pop the pipeline in groups of K frames,
        # stack them on the device and fetch the group in one copy into
        # pinned memory, then hand host-backed Layers to the sink
        # (reference analogue: the display plugin consuming frames from the
        # player's queue at its own cadence, videoplugin.h:145). 0 = fetch
        # per frame.
        self.fetch_batch = 0
        # async chain rebuild: a new key chain warms on a background thread
        # while the previous graph keeps serving frames (the reference
        # rebuilds the nodemodel at safe points, player.c:2655). Kept on
        # the card because a chain's first run there is slow: the first
        # launch of K2 or K3 in a process loads or builds its library
        # (native.load runs nvcc), and the plain route's first pass
        # allocates; warmed off-thread, a toggle never waits on either in
        # the serving loop
        self.async_compile = True
        # pre-warm graphs one toggle away at safe points (the reference
        # pre-builds nodemodels, player.c:2655)
        self.prewarm_compile = True
        self._prewarm_seen: set = set()
        self._last_layers: list = []
        self._served_key: Any = None
        # per-frame latency ladder (layers.h:78-85 status timestamps +
        # diagnostics.c:97): attach a diagnostics.FrameLadder to collect
        # queued->loaded->applied->displayed stage times per frame
        self.ladder = None
        # the latest warm-up's thread; the handle stays after the job ends,
        # so a caller that joins it never races with the job
        self._compile_thread = None
        # set when the latest warm-up has landed (its graph registered) or
        # failed; failures are counted in `warm_failures`, the last one
        # kept in `warm_error`
        self.warm_landed = threading.Event()
        self.warm_failures = 0
        self.warm_error: BaseException | None = None
        self._compile_key: Any = None      # chain key warming right now
        self._compile_adopt = False        # adopt-on-finish flag (upgradable)
        # predictive frame cache (pred_frame/precache, player.c:2185-2230)
        self.precache_depth = 0
        self._precache: dict[tuple, Any] = {}
        # copy events of cached frames the serving stream has not waited on
        self._copies: dict[tuple, Any] = {}
        self._pc_cv = threading.Condition()
        self._pc_stop = False
        self._pc_state = None
        self._pc_behind = False
        self._inflight: set = set()
        # realtime policy on a precache miss whose frame the worker is
        # already decoding: drop the frame (never block the serving loop
        # on a synchronous decode). First frame always renders.
        self.drop_on_miss = True
        # frames a batched decode of the compressed lane takes at once
        self.precache_chunk = 8
        # exceptions of the compressed lane that fell back to the host
        # decode, and the clips already warned about
        self.lane_errors = 0
        self._lane_warned: set = set()
        # adaptive quality under load (reference "effort", prefs->pbq_adaptive)
        self.adaptive_quality = False
        self.effort = 0
        self._lbox_wanted: bool | None = None  # user's letterbox intent
        self._precache_saved = 0
        # clock source: "system" (monotonic) or a callable returning
        # seconds (an external transport)
        self.time_source = "system"
        self._precache_thread = None
        # optional data connections (effects/data.py): out-param values
        # pushed into active instances each frame (pconx_chain_data before
        # each instance runs, effects-weed.c:3322), channel connections
        # wired into the graph (cconx)
        self.datacons = None
        # frame listeners: called (frame, tc) after each shown frame
        # (reference lives_notify, player.c:1295)
        self.frame_listeners: list = []
        # optional subtitle overlay (text.SubtitleOverlay) composited
        # after the chain, before the pipeline (reference subtitle path)
        self.subtitles = None
        self._autotrans_t0: float | None = None
        self.autotrans_key: int | None = None
        self.autotrans_duration = 1.0
        self._rec_automix = None
        self._rec_automix_amt: float | None = None
        self._rec_backup_path = None
        self._last_missed = None

    @property
    def time_source(self):
        return self._time_source

    @time_source.setter
    def time_source(self, src):
        if src == "audio":
            raise NotImplementedError(
                "time_source='audio' needs the realtime audio feeder "
                f"(audio/fx.py), which is not ported yet ({_ITEM23})")
        self._time_source = src

    def attach_audio(self, sink=None, rate: int = 44100):
        raise NotImplementedError(
            f"the realtime audio feeder (audio/fx.py) is not ported yet "
            f"({_ITEM23})")

    def load_subtitles(self, path, **style):
        """Attach .srt/.sub subtitles composited during playback
        (`lives_tpu/player/player.py:324-331`; reference reload_subs,
        clip_load_save.c:1752). The overlay blends onto the chain's
        output, so the sink's palette must be an RGB one."""
        from ..text import SubtitleOverlay, load_srt, load_sub
        subs = load_srt(path) if str(path).lower().endswith(".srt") \
            else load_sub(path, fps=abs(self.state.pb_fps) or 25.0)
        self.subtitles = SubtitleOverlay(subs, **style)
        return self.subtitles

    # -- clock / frame targeting ------------------------------------------
    def _now_ticks(self) -> int:
        return int(time.monotonic() * TICKS_PER_SECOND)

    def set_pb_fps(self, fps: float):
        """Trickplay: rebase the clock so scratching is continuous
        (player.c calc_new_playback_position semantics)."""
        self._rebase()
        self.state.pb_fps = fps

    def _rebase(self):
        if self._clock0 is not None:
            self._frame0 = self._target_frame_f()
            self._clock0 = time.monotonic()

    def _target_frame_f(self) -> float:
        if callable(self.time_source):
            # external transport clock (jack transport slave,
            # src/jack.c transport model): seconds -> clip frames at the
            # clip's base rate; trickplay rate is the transport's business
            base = getattr(self.state.fg_clip, "fps", 25.0) or 25.0
            return float(self.time_source()) * base
        if self._clock0 is None:
            return float(self.state.frame)
        dt = time.monotonic() - self._clock0
        return self._frame0 + dt * self.state.pb_fps

    def clamp_frame(self, f: float) -> int:
        """Loop/ping-pong/selection bounds (player.c:1678 clamp_frame)."""
        st = self.state
        clip = st.fg_clip
        n = clip.frames if clip is not None else 1
        lo = st.sel_start
        hi = st.sel_end if st.sel_end >= 0 else n - 1
        span = max(hi - lo + 1, 1)
        if st.ping_pong:
            m = math.floor(f - lo) % (2 * span)
            return lo + (m if m < span else 2 * span - 1 - m)
        if st.loop:
            return lo + math.floor(f - lo) % span
        return max(lo, min(math.floor(f), hi))

    # -- clip switching + autotransition (player.c:1001 set_trans_amt,
    #    prefs->autotrans_key/mode/amt) ------------------------------------
    def set_autotrans(self, key: int | None, duration: float = 1.0):
        """Configure automatic transitions on clip switch: `key` is an
        rte key holding a 2-input transition; switching the fg clip
        during playback puts the old clip on the bg track and ramps the
        blend from old to new over `duration` seconds."""
        self.autotrans_key = key
        self.autotrans_duration = max(float(duration), 1e-3)

    def switch_fg(self, clip):
        """Switch the foreground clip (the OSC /clip/select path). With
        autotransition configured and playback running, the switch rides
        a timed crossfade instead of a hard cut."""
        st = self.state
        old = st.fg_clip
        key = self.autotrans_key
        if key is None or not st.playing or old is None or old is clip:
            st.fg_clip = clip
            return
        st.bg_clip = old
        st.fg_clip = clip
        # crossfade amount weights the FG input: 0 = all old (bg track),
        # ramping to 1 = all new
        st.blend_amount = 0.0
        self._autotrans_t0 = time.monotonic()
        if not self.keymap.active[key]:
            self.key_toggle(key, True)

    def _autotrans_step(self):
        t0 = self._autotrans_t0
        if t0 is None:
            return
        amt = min((time.monotonic() - t0) / self.autotrans_duration, 1.0)
        self.state.blend_amount = amt
        if amt >= 1.0:
            # transition complete: release the bg track + key
            self._autotrans_t0 = None
            key = self.autotrans_key
            if key is not None and self.keymap.active[key]:
                self.key_toggle(key, False)
            self.state.bg_clip = None
            self.state.blend_amount = 0.5

    # -- rte keys ----------------------------------------------------------
    def key_toggle(self, key: int, on: bool | None = None):
        was = self.keymap.active[key]
        state = self.keymap.toggle(key, on)
        if state == was:
            return state  # idempotent enable/disable: nothing to record
        el = self.event_list   # snapshot vs record_stop on another thread
        if self.record and el is not None:
            tc = self._rec_tc()
            if state:
                inst = self.keymap.instances[key]
                init = filter_init_event(
                    tc, inst.filter.name,
                    in_tracks=list(inst.in_tracks),
                    out_tracks=list(inst.out_tracks),
                    values=dict(inst.values))
                el.insert(init)
                self._rec_inits[key] = init
                self._refresh_rec_map(tc, el)
            else:
                init = self._rec_inits.pop(key, None)
                if init is not None:
                    el.insert(filter_deinit_event(tc, init.event_id))
                    self._refresh_rec_map(tc, el)
        return state

    def set_key_param(self, key: int, name: str, value):
        inst = self.keymap.instances[key]
        if inst is None:
            return
        inst.set(**{name: value})
        el = self.event_list   # snapshot vs record_stop on another thread
        if self.record and el is not None and key in self._rec_inits:
            el.insert(param_change_event(
                self._rec_tc(), self._rec_inits[key].event_id, name, value))

    def _refresh_rec_map(self, tc: int, el=None):
        el = el if el is not None else self.event_list
        if el is None:
            return
        ids = [i.event_id for i in self._rec_inits.values()]
        if self._rec_automix is not None:
            ids.append(self._rec_automix.event_id)
        el.insert(filter_map_event(tc, ids))
        self._annotate_rec_cconx()

    def _annotate_rec_cconx(self):
        """Stamp channel-connection wiring onto recorded init events, so a
        re-render rebuilds the same cconx (`lives_tpu/player/player.py:
        482-510`): [[src_event_id, out_channel, slot], ...] on the
        destination's FILTER_INIT. The wiring is per-performance state, not
        timestamped, re-annotated at each map refresh."""
        if self.datacons is None or self.event_list is None:
            return
        by_inst = {}
        for k, init in self._rec_inits.items():
            inst = self.keymap.instances[k]
            if inst is not None:
                by_inst[id(inst)] = init
        for init in self._rec_inits.values():
            init.props.pop("cconx", None)
        for c in getattr(self.datacons, "chan_conns", ()):
            src_init = by_inst.get(id(c.src))
            dst_init = by_inst.get(id(c.dst))
            if src_init is None or dst_init is None:
                continue
            dst_init.props.setdefault("cconx", []).append(
                [src_init.event_id, c.out_channel, c.in_slot])

    # -- recording ---------------------------------------------------------
    def record_start(self, width: int = 0, height: int = 0,
                     backup_path=None, backup_every: float = 5.0,
                     scrap_generators: bool = True):
        """backup_path: autosave the recording there periodically so a crash
        never loses a performance (reference backup_recording,
        events.c:5547). scrap_generators: capture live-source output to
        MJPEG scrap clips so re-renders replay the performance exactly;
        recorded FRAME events then reference the scrap clip.
        rec_scrap_clips after record_stop maps their unique_ids to clips:
        merge it into the clips_by_uid given to render_recording
        (`recording_uid_map` does)."""
        if self.record:
            # restarting mid-take must not leak the old take's encode
            # workers or silently drop its events: finish it properly
            self.record_stop()
        for clip in self.rec_scrap_clips.values():
            if hasattr(clip, "close"):
                clip.close()
        self._scrap_generators = scrap_generators
        self._scrap_recs = {}
        self.rec_scrap_clips = {}
        self.event_list = EventList(fps=abs(self.state.pb_fps) or 25.0,
                                    width=width, height=height)
        self.record = True
        self._rec_t0 = self._now_ticks()
        self._rec_backup_path = backup_path
        self._rec_backup_every = backup_every
        self._rec_last_backup = time.monotonic()
        self._backup_count = 0
        if backup_path:
            # fresh JSONL autosave: header line now, events append
            # incrementally (O(new events) per interval)
            try:
                with self._backup_lock, open(backup_path, "w") as fh:
                    fh.write(self.event_list.header_json() + "\n")
            except OSError:
                self._rec_backup_path = None
        # effects already live at record start must appear in the
        # re-render: snapshot the active chain as tc=0 inits + filter map
        for k in range(N_KEYS):
            if self.keymap.active[k] and self.keymap.instances[k]:
                inst = self.keymap.instances[k]
                init = filter_init_event(
                    0, inst.filter.name,
                    in_tracks=list(inst.in_tracks),
                    out_tracks=list(inst.out_tracks),
                    values={kk: v for kk, v in inst.values.items()
                            if not hasattr(v, "shape")})
                self.event_list.insert(init)
                self._rec_inits[k] = init
        if self._rec_inits:
            self._refresh_rec_map(0)

    def record_stop(self) -> EventList:
        self._annotate_rec_cconx()  # final wiring snapshot
        self.record = False
        el, self.event_list = self.event_list, None
        self._rec_inits.clear()
        self._rec_automix = None
        self._rec_automix_amt = None
        self._finalize_scraps(el)
        if el is not None:
            # kept for the render-choice surface (deal_with_render_choice,
            # events.c:5101); a stray second stop (el None) must not
            # clobber the saved take
            self.last_recording = el
            if self._rec_backup_path:
                # final autosave: the take survives a crash between stop
                # and render; discard_recording() drops an unwanted take
                try:
                    with self._backup_lock:
                        self._atomic_write(self._rec_backup_path,
                                           el.to_json())
                except OSError:
                    pass
        return el

    def _finalize_scraps(self, el) -> None:
        """Finalize each scrap capture into an MJPEG clip keyed by the
        unique_id the recorded FRAME events reference (`player.py:
        574-605`); the frames of a failed capture go back to the live
        source's reference."""
        import tempfile
        from pathlib import Path
        from ..prefs import pref
        for rec in self._scrap_recs.values():
            base = self.scrap_dir or pref("workdir")
            if not base:
                base = tempfile.mkdtemp(prefix="lives_tpu_scrap_")
            try:
                clip = rec.finalize(
                    Path(base) / "scrap"
                    / (f"scrap_{rec.unique_id:016x}_"
                       f"{int(time.monotonic() * 1000) & 0xFFFFFF:06x}"
                       ".avi"))  # the full uid in the name (recovery keys
                # on it); a take suffix: never overwrite a file an earlier
                # take's open clip still reads
            except Exception:
                clip = None
            if clip is not None:
                self.rec_scrap_clips[rec.unique_id] = clip
            n_ok = clip.frames if clip is not None else 0
            if el is not None:
                self._rewrite_scrap_refs(el, rec, n_ok)
        self._scrap_recs = {}

    @staticmethod
    def _rewrite_scrap_refs(el: EventList, rec, n_ok: int) -> None:
        """Point FRAME events referencing scrap indices >= n_ok back at
        the live-source (clip, frame) captured at record time."""
        if n_ok >= len(rec.origs):
            return
        for e in el:
            cl = getattr(e, "clips", None)
            if not cl:
                continue
            for i, (c, f) in enumerate(zip(cl, e.frames)):
                if c == rec.unique_id and f >= n_ok:
                    e.clips[i], e.frames[i] = rec.origs[f]

    # -- render-choice helpers ---------------------------------------------
    def recording_uid_map(self, clips=()) -> dict:
        """clips_by_uid for re-rendering the last take: the given clips,
        the live fg/bg sources (the scrap-overflow fallback) and the take's
        scrap clips."""
        uid_map = {}
        for clip in clips:
            uid_map[getattr(clip, "unique_id", id(clip))] = clip
        for st_clip, dflt in ((self.state.fg_clip, 1),
                              (self.state.bg_clip, 2)):
            # fallback uids MUST match what the recording path wrote
            # (frame_event clips: fg getattr default 1, bg default 2)
            if st_clip is not None:
                uid_map.setdefault(getattr(st_clip, "unique_id", dflt),
                                   st_clip)
        uid_map.update(self.rec_scrap_clips)
        return uid_map

    def render_last_recording(self, uid_map: dict, batch_size: int = 8):
        """Render the last take against `uid_map` on the player's device.
        Returns (frames, tcs), frames a host (N,3,H,W) u8 array."""
        from ..events.renderer import render_recording
        el = self.last_recording
        if el is None or not len(el.events):
            return None, None
        return render_recording(el, uid_map, batch_size=batch_size,
                                device=self.device)

    def render_last_recording_batches(self, uid_map: dict,
                                      batch_size: int = 8):
        """Yield (tcs, host (B,3,H,W) u8) chunks of the last take:
        bounded memory. Callers write each chunk as it lands."""
        from ..events.renderer import ClipFrameSource, render_events
        el = self.last_recording
        if el is None or not len(el.events):
            return
        q = el.quantise(el.fps or 25.0)
        src = ClipFrameSource(uid_map, device=self.device)
        for tcs, lay in render_events(q, src, batch_size=batch_size):
            yield tcs, lay.planes[0].cpu().numpy()

    def preview_last_recording(self, uid_map: dict,
                               max_seconds: float | None = None,
                               batch_size: int = 8) -> int:
        """Paced playback of the last take through this player's sink
        (deal_with_render_choice, events.c:5955 / process_events
        events.c:3236). Refuses while playback runs: sinks are not
        thread-safe against the serving loop. Returns frames shown."""
        if self.state.playing:
            raise RuntimeError("stop playback before previewing a take")
        shown = 0
        t0 = time.monotonic()
        fps = (self.last_recording.fps if self.last_recording else 0) or 25.0
        inited = False
        try:
            for tcs, arr in self.render_last_recording_batches(
                    uid_map, batch_size):
                arr = torch.from_numpy(arr)
                if not inited:
                    self.sink.init_screen(arr.shape[-1], arr.shape[-2], fps)
                    inited = True
                for i, tc in enumerate(tcs):
                    delay = t0 + shown / fps - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    self.sink.play_frame(
                        Layer(planes=(arr[i],), palette=int(Palette.RGB24)),
                        float(tc) / TICKS_PER_SECOND)
                    shown += 1
                    if max_seconds is not None and \
                            time.monotonic() - t0 >= max_seconds:
                        return shown
            return shown
        finally:
            if inited:
                self.sink.exit_screen()

    def _record_automix(self, active: bool):
        """Record the fg/bg auto-blend as a crossfade init + amount
        pchain, so blend scratching and autotransitions re-render."""
        el = self.event_list
        amt = float(self.state.blend_amount)
        if active:
            init = self._rec_automix
            if init is None:
                init = filter_init_event(
                    self._rec_tc(), "crossfade", in_tracks=[0, 1],
                    out_tracks=[0], values={"amount": amt})
                el.insert(init)
                self._rec_automix = init
                self._rec_automix_amt = amt
                self._refresh_rec_map(init.tc)
            elif amt != self._rec_automix_amt:
                el.insert(param_change_event(self._rec_tc(),
                                             init.event_id, "amount", amt))
                self._rec_automix_amt = amt
        elif self._rec_automix is not None:
            el.insert(filter_deinit_event(self._rec_tc(),
                                          self._rec_automix.event_id))
            self._rec_automix = None
            self._refresh_rec_map(self._rec_tc())

    def _rec_tc(self) -> int:
        return self._now_ticks() - self._rec_t0

    def _append_backup(self, el: EventList) -> None:
        """Append events recorded since the last backup to the JSONL
        autosave. O(new events); runs on the serving thread."""
        path = self._rec_backup_path
        if path is None or el is None:
            return
        n = len(el.events)
        start = self._backup_count
        if start > n:
            start = 0   # list was rebuilt: fall back to a full rewrite
        recs = {rec.unique_id: rec for rec in self._scrap_recs.values()}
        lines = [EventList.event_json(self._live_refs(e, recs))
                 for e in el.events[start:n]]
        if not lines:
            self._backup_count = n
            return
        try:
            mode = "a" if start else "w"
            with self._backup_lock, open(path, mode) as fh:
                if mode == "w":
                    fh.write(el.header_json() + "\n")
                fh.write("\n".join(lines) + "\n")
                fh.flush()
            self._backup_count = n
        except OSError:
            pass

    @staticmethod
    def _live_refs(e, recs):
        """`e` with its scrap references that are not durable yet replaced
        by the live-source references (a crash mid-take replays from the
        sources), `player.py:781-799`."""
        cl = getattr(e, "clips", None)
        if not cl or not recs:
            return e
        sub, frs = list(cl), list(e.frames)
        changed = False
        for i, (c, f) in enumerate(zip(sub, frs)):
            rec = recs.get(c)
            if rec is not None and f < len(rec.origs):
                sub[i], frs[i] = rec.origs[f]
                changed = True
        if not changed:
            return e
        import copy
        e = copy.copy(e)
        e.props = dict(e.props)
        e.props["clips"] = sub
        e.props["frames"] = frs
        return e

    @staticmethod
    def _atomic_write(path, text: str) -> None:
        """tmp + os.replace: a crash mid-write must never destroy the
        previous good autosave (the exact window the file exists for)."""
        import os
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, str(path))

    def discard_recording(self) -> bool:
        """Drop the last take, its autosave and its scrap clips (the
        "discard" arm of the render choice, events.c:5955). Returns True
        when something was discarded."""
        import os
        had = self.last_recording is not None
        self.last_recording = None
        for clip in self.rec_scrap_clips.values():
            # a discarded take's scrap capture is dead weight: close the
            # decoder and remove the AVI
            src = getattr(clip, "source_uri", "") or getattr(
                getattr(clip, "cdata", None), "uri", "")
            if hasattr(clip, "close"):
                clip.close()
            if src:
                try:
                    os.unlink(src)
                except OSError:
                    pass
            had = True
        self.rec_scrap_clips = {}
        path = self._rec_backup_path
        if path:
            with self._backup_lock:
                try:
                    os.unlink(path)
                    had = True
                except OSError:
                    pass
        return had

    # -- playback ----------------------------------------------------------
    def start(self):
        self.state.playing = True
        self._clock0 = time.monotonic()
        self._frame0 = float(self.state.frame)
        clip = self.state.fg_clip
        if clip is not None:
            w = self.sink_spec.width or clip.width
            h = self.sink_spec.height or clip.height
            self.sink.init_screen(w, h, abs(self.state.pb_fps))

    def stop(self):
        """Stop playback: drain the pipeline into the sink, stop the
        precache worker, let a warm-up in flight land, close the sink."""
        self.state.playing = False
        for o, t in self._pending:
            self.sink.play_frame(o, t)
        self._pending.clear()
        self._pc_stop = True
        with self._pc_cv:
            self._pc_cv.notify_all()
        for th in (self._compile_thread, self._precache_thread):
            if th is not None and th.is_alive():
                th.join(timeout=60)
        self.sink.exit_screen()

    def _cconx_sig(self):
        """Channel-connection topology over keymap slots: part of the
        graph cache key, since a cconx edit is a new configuration
        (`lives_tpu/player/player.py:912-924`)."""
        dc = self.datacons
        if dc is None or not getattr(dc, "chan_conns", None):
            return ()
        pos = {id(inst): k for k, inst in enumerate(self.keymap.instances)
               if inst is not None}
        return tuple((pos.get(id(c.src)), c.out_channel,
                      pos.get(id(c.dst)), c.in_slot)
                     for c in dc.chan_conns)

    def _chain_cache_key(self):
        # bg presence changes the built chain (_build_graph appends the
        # crossfade), so it must be part of the cache key
        return (self.keymap.chain_key(), self.state.bg_clip is not None,
                self._cconx_sig())

    def _graph_for_chain(self) -> FrameGraph:
        key = self._chain_cache_key()
        g = self._graphs.get(key)
        if g is None:
            g = self._build_graph(key)
        return g

    def _build_graph(self, key, register: bool = True) -> FrameGraph:
        chain = list(self.keymap.active_chain())
        # fg/bg blend: if a bg clip is present and no transition in the
        # chain consumes track 1, append the blend (player fg/bg mix)
        uses_bg = any(len(i.in_tracks) > 1 for i in chain)
        auto_mix = None
        if self.state.bg_clip is not None and not uses_bg:
            auto_mix = instantiate("crossfade", amount=self.state.blend_amount)
            auto_mix.in_tracks = (0, 1)
            chain.append(auto_mix)
        # cconx: channel connections between chain members, as the graph's
        # wiring (forward edges only: the chain applies in key order)
        cconx = []
        if self.datacons is not None:
            idx = {id(inst): i for i, inst in enumerate(chain)}
            for c in getattr(self.datacons, "chan_conns", ()):
                si, di = idx.get(id(c.src)), idx.get(id(c.dst))
                if si is not None and di is not None and si < di:
                    cconx.append((si, c.out_channel, di, c.in_slot))
        g = FrameGraph(chain, self.sink_spec,
                       fps=abs(self.state.pb_fps) or 25.0, cconx=cconx)
        # blend_amount is a traced param: keep a handle so process_one can
        # refresh it per frame without a new graph
        g.auto_mix = auto_mix
        if register:
            # NOT registered for async/prewarm builds: _select_graph's
            # "already warm chain" fast path must only ever see graphs that
            # have run once
            self._graphs[key] = g
        return g

    def _bg_frame(self, target: int) -> int:
        """Background clip frame for fg frame `target`: follows the fg
        clock unless an independent bg rate is set (the reference's
        /clip/background/fps namespace)."""
        st = self.state
        ratio = st.bg_pb_fps / st.pb_fps if st.bg_pb_fps and st.pb_fps \
            else 1.0
        return int(target * ratio) % max(st.bg_clip.frames, 1)

    # -- precache (player.c pred_frame / srcgroup clone model) -------------
    def _pull(self, clip, n):
        """Frame n of `clip` for the chain, on the player's device, ready on
        the serving stream: a GenSlot for a stateless generator (generated
        inside the run), a live pull for a stateful one, else the LRU
        precache or a decode."""
        if FrameGraph._is_genclip(clip):
            return GenSlot(clip, n)
        if self._is_stateful_gen(clip):
            # frame n is NOT a pure function of n: pull live, on this
            # thread only (effects-weed.c:7572)
            return self._ready(*self._decode_frame(clip, n))
        # LRU cache, not a consume-once queue: disk-clip frames are
        # immutable, so a hit stays cached; re-insert on hit so the
        # insertion-order eviction approximates LRU
        key = self._ck(clip, n)
        lay = self._precache.pop(key, None)
        if lay is not None:
            self._precache[key] = lay
            return self._ready(lay, self._copies.pop(key, None))
        dec = getattr(getattr(clip, "cdata", None), "decoder", None)
        if self.drop_on_miss and self.frames_shown > 0 \
                and self.precache_depth > 0 \
                and (key in self._inflight
                     or hasattr(dec, "get_frames_device")):
            # the worker is (or will be) on it: skip this frame rather
            # than stall the loop with a synchronous decode
            raise _PrecacheMiss(key)
        lay, ev = self._decode_frame(clip, n)
        if self.precache_depth:
            self._precache[key] = lay
        return self._ready(lay, ev)

    @staticmethod
    def _ready(lay, ev):
        if ev is not None:
            UploadRing.consume(lay.planes, ev)
        return lay

    @staticmethod
    def _is_stateful_gen(clip) -> bool:
        inst = getattr(clip, "inst", None)
        return (inst is not None and inst.filter.is_generator
                and bool(inst.filter.flags & FILTER_STATEFUL))

    @staticmethod
    def _ck(clip, n):
        # cache key: clip identity + content generation (Clip.version bumps
        # on frame-index rewrites, so an edit never serves a stale frame) +
        # frame number
        return (id(clip), getattr(clip, "version", 0), n)

    def _lane(self, clip, frames):
        """(the decoder, its frames for `frames`) when the compressed lane
        takes them: an MJPG decoder with `get_frames_device` (a raw-DIB
        AVI has the method too, but nothing to decode), the pref on, and
        every frame a virtual one; else None."""
        from ..prefs import pref
        dec = getattr(getattr(clip, "cdata", None), "decoder", None)
        if not hasattr(dec, "get_frames_device") \
                or getattr(dec, "fourcc", "") != "MJPG" \
                or str(pref("mjpeg_device_decode", "1")) == "0":
            return None
        virt = getattr(clip, "is_virtual_frame", lambda _n: True)
        if not all(virt(f) for f in frames):
            return None
        fi = getattr(clip, "frame_index", None)
        return dec, [int(fi[f]) if fi is not None else f for f in frames]

    def _lane_failed(self, clip, e: Exception):
        self.lane_errors += 1
        if id(clip) not in self._lane_warned:
            self._lane_warned.add(id(clip))
            warnings.warn(f"Player: the compressed lane failed on "
                          f"{getattr(clip, 'name', clip)!r} ({e!r}); its "
                          "frames decode on the host")

    def _decode_frame(self, clip, n):
        """(frame n of `clip` on the player's device, the copy's event or
        None). The compressed lane decodes a frame of an MJPEG clip onto
        the device; a clip that knows its frame's planes (`frame_config`)
        is read straight into a pinned slot of the upload ring; other host
        frames are copied into one; a frame already on the device passes
        through. Shared by `_pull` and the precache worker."""
        lane = self._lane(clip, [n])
        if lane is not None:
            try:
                return lane[0].get_frame_device(lane[1][0],
                                                device=self.device), None
            except Exception as e:
                self._lane_failed(clip, e)
        cfg = getattr(clip, "frame_config", None)
        cfg = cfg(n) if cfg is not None else None
        if self._ring is not None and cfg is not None:
            pal, w, h = cfg[:3]
            got = {}

            def read(bufs):
                got["lay"] = clip.get_frame(
                    n, out=tuple(b.numpy() for b in bufs))
            planes, ev = self._ring.upload(
                [(s, torch.uint8) for s in _plane_shapes(pal, w, h)], read)
            return got["lay"].replace(planes=planes), ev
        lay = clip.get_frame(n)
        if lay.device == self.device:
            return lay, None
        if self._ring is None:
            return lay.replace(planes=tuple(p.to(self.device)
                                            for p in lay.planes)), None

        def copy_in(bufs):
            for b, p in zip(bufs, lay.planes):
                b.copy_(p)
        planes, ev = self._ring.upload(
            [(tuple(p.shape), p.dtype) for p in lay.planes], copy_in)
        return lay.replace(planes=planes), ev

    def _decode_frames_batched(self, clip, fs):
        """Frames `fs` of `clip` through the compressed lane in one
        `get_frames_device` call, on the player's device; None when the
        lane does not take them (the worker then decodes frame by
        frame)."""
        lane = self._lane(clip, fs)
        if lane is None:
            return None
        try:
            return lane[0].get_frames_device(lane[1], device=self.device)
        except Exception as e:
            self._lane_failed(clip, e)
            return None

    def _request_precache(self, target: int):
        st = self.state
        direction = 1 if st.pb_fps >= 0 else -1
        # fg None = generated in the run, nothing to decode; the bg clip
        # must still publish
        fgc = None if (FrameGraph._is_genclip(st.fg_clip)
                       or self._is_stateful_gen(st.fg_clip)) else st.fg_clip
        bg = None
        if st.bg_clip is not None and not FrameGraph._is_genclip(st.bg_clip) \
                and not self._is_stateful_gen(st.bg_clip):
            # the bg window follows the REAL bg mapping (independent
            # rate/direction via _bg_frame), not the fg stride
            bgs = tuple(dict.fromkeys(
                self._bg_frame(self.clamp_frame(target + direction * k))
                for k in range(0, self.precache_depth + 1)))
            bg = (st.bg_clip, bgs)
        if fgc is None and bg is None:
            return
        self._pc_state = (fgc, int(target), direction, bg)
        with self._pc_cv:
            self._pc_cv.notify()
        if self._precache_thread is None or \
                not self._precache_thread.is_alive():
            self._pc_stop = False
            self._precache_thread = threading.Thread(
                target=self._precache_worker, daemon=True)
            self._precache_thread.start()

    def _precache_worker(self):
        """Free-running look-ahead decoder (the reference's pred_frame /
        srcgroup clone model, player.c:2185-2230). The main loop only
        publishes (clip, playhead, direction, bg window); the worker keeps
        the whole window decoded and uploaded on its own clock, so it can
        decode faster than playback and catch up after a seek. Frames go
        one at a time through the upload ring."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._pc_stop:
            state = self._pc_state
            if state is None:
                with self._pc_cv:
                    self._pc_cv.wait(0.5)
                continue
            clip, target, direction, bg = state
            if clip is not None:
                missing = [f for f in dict.fromkeys(
                    self.clamp_frame(target + direction * k)
                    for k in range(0, self.precache_depth + 1))
                    if self._ck(clip, f) not in self._precache]
                nframes = getattr(clip, "frames", 0) or 1
            else:
                missing, nframes = [], 1
            bmiss = [f for f in bg[1]
                     if self._ck(bg[0], f) not in self._precache] \
                if bg is not None else []
            # lead compensation: when the playhead outruns the decode
            # latency (the target is STILL missing two cycles in a row),
            # decode farthest-first, so frames land ahead of the playhead
            target_missing = clip is not None and \
                self._ck(clip, target) not in self._precache
            if target_missing and self._pc_behind:
                missing.sort(
                    key=lambda f: -min(abs(f - target),
                                       nframes - abs(f - target)))
            self._pc_behind = target_missing
            self._inflight = {self._ck(clip, f) for f in missing} \
                | ({self._ck(bg[0], f) for f in bmiss} if bg else set())
            if not missing and not bmiss:
                with self._pc_cv:
                    if self._pc_state == state:
                        self._pc_cv.wait(0.05)
                continue
            for c, fs in ((bg[0] if bg else None, bmiss), (clip, missing)):
                step = max(1, int(self.precache_chunk))
                for k in range(0, len(fs), step):
                    if self._pc_stop:
                        break
                    self._store(c, fs[k:k + step])
            # bound the cache (racy vs _pull's pop-reinsert on the main
            # thread: a KeyError here would silently kill the worker)
            while len(self._precache) > 4 * self.precache_depth:
                try:
                    k = next(iter(self._precache))
                except (StopIteration, RuntimeError):
                    break
                self._precache.pop(k, None)
                self._copies.pop(k, None)

    def _store(self, clip, fs):
        """Decode frames fs of `clip` into the precache: through the
        compressed lane in one call where it takes them, else each decoded
        and uploaded (the copy event first, so the serving loop never sees
        a frame without it)."""
        todo = [f for f in fs if self._ck(clip, f) not in self._precache]
        lays = self._decode_frames_batched(clip, todo) if todo else None
        for j, f in enumerate(todo):
            k = self._ck(clip, f)
            if lays is not None:
                self._precache[k] = lays[j]
            else:
                try:
                    lay, ev = self._decode_frame(clip, f)
                    if ev is not None:
                        self._copies[k] = ev
                    self._precache[k] = lay
                except Exception:
                    pass  # a frame that fails is pulled inline later
        for f in fs:
            self._inflight.discard(self._ck(clip, f))

    def _fetch_host_layers(self, group):
        """A group of pipelined output Layers on the host in ONE copy: every
        plane of every frame concatenated as bytes on the device, copied
        into pinned memory (non-blocking, one event waited on), and cut
        into per-frame host Layers. A group whose frames differ in plane
        shapes or dtypes (a config change mid-group) passes through
        unfetched."""
        outs = [o for o, _ in group]
        sig = [(tuple(p.shape), p.dtype) for p in outs[0].planes]
        if any([(tuple(p.shape), p.dtype) for p in o.planes] != sig
               for o in outs[1:]):
            return group
        dev = outs[0].planes[0].device
        cuda = dev.type == "cuda"
        flat = torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                          for o in outs for p in o.planes])
        host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=cuda)
        host.copy_(flat, non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
        sizes = [math.prod(s) * torch.empty((), dtype=d).element_size()
                 for s, d in sig]
        res, o = [], 0
        for lay, t in group:
            planes = []
            for (shape, dtype), nb in zip(sig, sizes):
                planes.append(host[o:o + nb].view(dtype).reshape(shape))
                o += nb
            res.append((lay.replace(planes=tuple(planes)), t))
        return res

    # -- async chain rebuild ----------------------------------------------
    def _warm_graph_async(self, graph, key, layers, adopt: bool):
        """Run a graph once off-thread on a warm-up frame (on its own
        stream on a card, `mirror_state=False`); register it (and
        optionally adopt it as served) only once warm. One warm-up at a
        time."""
        self._compile_key = key
        self._compile_adopt = adopt
        landed = self.warm_landed = threading.Event()
        main = torch.cuda.current_stream(self.device) \
            if self._warm_stream is not None else None

        def compile_job(lys=list(layers)):
            try:
                self._warm_run(graph, lys, main)
                self._graphs[key] = graph
                # re-read the adopt flag AFTER the warm-up: a prewarm gets
                # upgraded by _select_graph when the user toggles to this
                # exact chain while it is in flight
                if self._compile_adopt:
                    self._served_key = key
            except Exception as e:
                self.warm_failures += 1
                self.warm_error = e
                if self._compile_adopt:
                    self._served_key = key  # fall through to sync path
            finally:
                self._compile_key = None
                landed.set()

        self._compile_thread = threading.Thread(target=compile_job,
                                                daemon=True)
        self._compile_thread.start()

    def _warm_run(self, graph, layers, main):
        """One run of `graph` on `layers` that leaves no trace: states
        untouched, the output dropped. On a card it runs on the warm-up
        stream, after what the serving stream had queued (the frames'
        uploads included), and waits for itself."""
        if main is None:
            graph.run(layers, tc=0.0, frame=0, mirror_state=False)
            return
        warm = self._warm_stream
        with torch.cuda.device(self.device), torch.cuda.stream(warm):
            warm.wait_stream(main)
            for lay in layers:
                if isinstance(lay, Layer):
                    for p in lay.planes:
                        p.record_stream(warm)
            graph.run(layers, tc=0.0, frame=0, mirror_state=False)
            warm.synchronize()

    def _select_graph(self, layers):
        self._last_layers = list(layers)
        desired = self._chain_cache_key()
        if not self.async_compile or self._served_key is None \
                or desired == self._served_key:
            g = self._graph_for_chain()
            self._served_key = desired
            return g
        cached = self._graphs.get(desired)
        if cached is not None:
            # toggling back to a warm chain: switch instantly
            self._served_key = desired
            return cached
        # chain changed: warm the new graph off-thread, keep serving the
        # old one meanwhile
        if self._compile_thread is None or not self._compile_thread.is_alive():
            new_graph = self._build_graph(desired, register=False)
            self._warm_graph_async(new_graph, desired, layers, adopt=True)
        elif self._compile_key == desired:
            # the desired chain is already warming as a prewarm: upgrade it
            # to adopt-on-finish instead of warming twice
            self._compile_adopt = True
        served = self._graphs.get(self._served_key)
        if served is None:  # effort transition cleared the cache
            served = self._build_graph(self._served_key) \
                if self._served_key else self._graph_for_chain()
        return served

    def _prewarm_step(self):
        """Safe-point pre-warm (reference: nodemodel pre-build at safe
        points, player.c:2655): while idle, warm the graph of ONE config
        reachable by a single key toggle in the background, so the toggle
        itself swaps to a warm graph. At most one warm-up at a time;
        attempted configs are remembered."""
        if not (self.async_compile and self.prewarm_compile):
            return
        if self._compile_thread is not None \
                and self._compile_thread.is_alive():
            return
        if not self._last_layers:
            return
        km = self.keymap
        for k in range(N_KEYS):
            if not km.current_filter(k):
                continue
            was = km.active[k]
            if not was and km.instances[k] is None:
                if not km.toggle(k, True):
                    continue
                km.active[k] = False
            km.active[k] = not was
            try:
                key = self._chain_cache_key()
                if key in self._graphs or key in self._prewarm_seen:
                    continue
                self._prewarm_seen.add(key)
                g = self._build_graph(key, register=False)
                self._warm_graph_async(g, key, self._last_layers,
                                       adopt=False)
                return  # one prewarm per safe point
            finally:
                km.active[k] = was

    def _scrap_capture(self, srcs, layers, clips, frames):
        """Queue the pulled layer of each live source that cannot replay (a
        stateful generator, a `scrap_on_record` clip) to its scrap
        recorder, and point the FRAME event's entry at the scrap frame
        (`player.py:1497-1533`). A stateless generator rides as a GenSlot,
        a pure function of (n, params): its clip reference replays
        exactly, nothing to scrap. On queue overflow the entry keeps the
        live source's reference."""
        for i, sclip in enumerate(srcs):
            if not (hasattr(sclip, "inst")
                    or getattr(sclip, "scrap_on_record", False)):
                continue
            if not isinstance(layers[i], Layer):
                continue
            rec = self._scrap_recs.get(id(sclip))
            if rec is None:
                from ..io.scrap import MJPEGScrapRecorder
                rec = MJPEGScrapRecorder(
                    sclip.width, sclip.height,
                    fps=abs(self.state.pb_fps) or 25.0, device=self.device)
                self._scrap_recs[id(sclip)] = rec
            idx = rec.put(layers[i])
            if idx is not None:
                # the live-source reference per index: if the encode
                # worker fails mid-take, record_stop rewrites the FRAME
                # events back to it
                rec.origs.append((clips[i], frames[i]))
                clips[i] = rec.unique_id
                frames[i] = idx

    def process_one(self) -> bool:
        """One player cycle (player.c:2185). Returns False when stopped."""
        st = self.state
        if not st.playing or st.fg_clip is None:
            return False
        t_start = time.monotonic()
        self._autotrans_step()
        target = self.clamp_frame(self._target_frame_f())
        if st.nervous:
            # nervous-mode trickplay (player.c:1013): random walk +/-10
            # around the playhead, only for clips that can seek backwards;
            # out-of-range jumps fall back to the clock frame. The jittered
            # frame IS the shown frame, so recordings capture it.
            can_rev = getattr(st.fg_clip, "can_reverse", True)
            n = getattr(st.fg_clip, "frames", 0) or 0
            if can_rev and n > 1:
                cand = target + int(self._nervous_rng.integers(-10, 11))
                if 0 <= cand < n:
                    target = cand
        if target == st.frame and self.frames_shown > 0:
            return True  # nothing new to show
        if self.frames_shown > 0:
            # frames the clock passed over without being shown (player.c
            # frame-drop accounting feeding the stats overlay)
            step = abs(target - st.frame)
            n = st.fg_clip.frames if st.fg_clip is not None else 1
            wrapped = min(step, abs(n - step))
            if wrapped > 1:
                self.frames_dropped += wrapped - 1
        prev_frame = st.frame
        st.frame = target
        if self.ladder is not None:
            self.ladder.begin()
        srcs = [st.fg_clip] + ([st.bg_clip] if st.bg_clip is not None
                               else [])
        try:
            layers = [self._pull(st.fg_clip, target)]
            if st.bg_clip is not None:
                layers.append(self._pull(st.bg_clip,
                                         self._bg_frame(target)))
        except _PrecacheMiss as miss:
            # frame not decoded yet: drop it (never block the serving
            # loop on a synchronous decode) and let the clock move on
            st.frame = prev_frame
            key = miss.args[0]
            if key != self._last_missed:
                self.frames_dropped += 1     # count each frame once
                self._last_missed = key
            if self.precache_depth:
                self._request_precache(target)
            if self.ladder is not None:
                self.ladder.end()
            # donate the GIL to the decode worker instead of spinning
            time.sleep(0.002)
            return True
        # this target pulled fine: a later re-miss of the same frame key
        # is a NEW drop episode and must count again
        self._last_missed = None
        if self.ladder is not None:
            self.ladder.mark("loaded")
        graph = self._select_graph(layers)
        if self.datacons is not None:
            for inst in self.keymap.active_chain():
                self.datacons.chain_data(inst)
        mix = getattr(graph, "auto_mix", None)
        if mix is not None:  # live blend factor (traced param)
            mix.values["amount"] = st.blend_amount
        if self.precache_depth:
            self._request_precache(target)
        tc = target / abs(st.pb_fps or 25.0)
        out = graph.run(layers, tc=tc, frame=target)
        if self.ladder is not None:
            self.ladder.mark("applied")
        if self.subtitles is not None:
            # subtitles index CLIP time (frame / clip fps), not the
            # playback-rate clock: scratching must not shift captions
            # (`lives_tpu/player/player.py:1454-1458`)
            clip_fps = getattr(st.fg_clip, "fps", 25.0) or 25.0
            out = self.subtitles.apply(out, target / clip_fps)
        if self.pipeline_depth > 0:
            self._pending.append((out, tc))
            ok = True
            k = self.fetch_batch
            if k > 1:
                # pop in groups of K: one host copy per group (adds up to
                # K-1 frames of display latency on top of pipeline_depth)
                while len(self._pending) >= self.pipeline_depth + k:
                    group = self._pending[:k]
                    del self._pending[:k]
                    for o, t in self._fetch_host_layers(group):
                        ok = self.sink.play_frame(o, t)
            else:
                while len(self._pending) > self.pipeline_depth:
                    o, t = self._pending.pop(0)
                    ok = self.sink.play_frame(o, t)
        else:
            ok = self.sink.play_frame(out, tc)
        if self.ladder is not None:
            self.ladder.mark("displayed")
            self.ladder.end()
        el = self.event_list   # snapshot: record_stop may null it from
        # another thread mid-section (the insert below must not race)
        if self.record and el is not None:
            # record against the PERFORMANCE state, not the served graph:
            # with async_compile the old graph (still carrying auto_mix)
            # keeps serving after bg_clip is dropped, which must not delay
            # the recorded deinit to the swap frame
            uses_bg = any(len(i.in_tracks) > 1
                          for i in self.keymap.active_chain())
            self._record_automix(st.bg_clip is not None and not uses_bg)
            clips = [getattr(st.fg_clip, "unique_id", 1)]
            frames = [target]
            if st.bg_clip is not None:
                clips.append(getattr(st.bg_clip, "unique_id", 2))
                frames.append(self._bg_frame(target))
            if self._scrap_generators:
                self._scrap_capture(srcs, layers, clips, frames)
            el.insert(frame_event(self._rec_tc(), clips, frames))
            if self._rec_backup_path and \
                    time.monotonic() - self._rec_last_backup \
                    > self._rec_backup_every:
                self._append_backup(el)
                self._rec_last_backup = time.monotonic()
        self.frames_shown += 1
        for cb in self.frame_listeners:
            try:
                cb(target, tc)
            except Exception:
                pass
        self._frame_times.append(time.monotonic() - t_start)
        if len(self._frame_times) > 256:
            self._frame_times = self._frame_times[-128:]
        if self.adaptive_quality:
            self._update_effort()
        self._prewarm_step()  # safe point: frame delivered
        # generator preset auto-cycle (projectM presetDuration role):
        # time-based switch at a safe point, after the frame was shown
        fg = self.state.fg_clip
        if fg is not None and getattr(fg, "autocycle_secs", 0.0):
            try:
                fg.maybe_autocycle(time.monotonic())
            except Exception:
                pass
        return ok

    def _update_effort(self):
        """Degrade/restore playback quality to hold fps (the reference's
        effort machinery, player.c effort updates / prefs->pbq_adaptive).

        Ladder (cumulative):
          0: full quality (smooth resize, letterbox honoured)
          1: bilinear resize
          2: nearest resize, letterboxing dropped
          3: + precache paused and free-run frame dropping
        """
        budget = 1.0 / max(abs(self.state.pb_fps), 1.0)
        recent = self._frame_times[-8:]
        if not recent:
            return
        avg = sum(recent) / len(recent)
        old = self.effort
        if avg > budget * 1.1 and self.effort < 3:
            self.effort += 1
        elif avg < budget * 0.5 and self.effort > 0:
            self.effort -= 1
        if old != self.effort:
            method = "smooth" if self.effort == 0 else \
                ("bilinear" if self.effort == 1 else "nearest")
            if self._lbox_wanted is None:  # first transition: remember
                self._lbox_wanted = self.sink_spec.letterbox
            self.sink_spec = dataclasses.replace(
                self.sink_spec, method=method,
                letterbox=self._lbox_wanted and self.effort < 2)
            if self.effort >= 3:
                self._precache_saved = self.precache_depth or \
                    self._precache_saved
                self.precache_depth = 0
            elif self._precache_saved:
                self.precache_depth = self._precache_saved
            self._graphs.clear()  # new graphs at the new quality
            self._prewarm_seen.clear()  # prewarmed configs gone with them

    def play_n_cycles(self, n: int, realtime: bool = False):
        """Drive n cycles (tests / headless playback)."""
        for _ in range(n):
            if not self.process_one():
                break
            if realtime:
                time.sleep(max(0.0, 1.0 / max(abs(self.state.pb_fps), 1)
                               - (self._frame_times[-1]
                                  if self._frame_times else 0)))

    # -- stats (diagnostics.c get_inst_fps / get_stats_msg) ---------------
    def stats(self) -> dict:
        ft = self._frame_times[-64:]
        mean = sum(ft) / len(ft) if ft else 0.0
        return {
            "frames_shown": self.frames_shown,
            "frames_dropped": self.frames_dropped,
            "inst_fps": (1.0 / mean) if mean > 0 else 0.0,
            "p99_ms": (float(np.percentile(ft, 99)) * 1e3) if ft else 0.0,
        }
