"""Event lists: recorded/edited timelines (reference `src/events.c`,
`libweed/weed-events.h:38-44`).

A verbatim copy of `lives_tpu/events/event_list.py:1-454` (pure Python;
importing it from `lives_tpu` would import jax). `to_json`/`from_json`
read and write the same text, so a timeline crosses between the two
packages byte for byte.

Numeric event-type values and tick resolution match the Weed event ABI so
serialized timelines are semantically interoperable. Events are plain
dataclasses in a list kept sorted by (tc, sort-rank); FRAME events carry
per-track (clip, frame) pairs; FILTER_INIT/DEINIT bracket an effect's
lifetime; FILTER_MAP orders active inits; PARAM_CHANGE events form per-init
"pchains" used for interpolation during rendering (reference
`interpolate_params`, effects-weed.c:10448).
"""

from __future__ import annotations

import bisect
import enum
import json
import uuid
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

TICKS_PER_SECOND = 100_000_000  # WEED_TICKS_PER_SECOND


class EventType(enum.IntEnum):
    UNDEFINED = 0
    FRAME = 1
    FILTER_INIT = 2
    FILTER_DEINIT = 3
    FILTER_MAP = 4
    PARAM_CHANGE = 5
    MARKER = 6


# events at equal tc apply in this order (inits/maps precede the frame)
_TYPE_RANK = {EventType.FILTER_INIT: 0, EventType.PARAM_CHANGE: 1,
              EventType.FILTER_MAP: 2, EventType.FRAME: 3,
              EventType.FILTER_DEINIT: 4, EventType.MARKER: 5,
              EventType.UNDEFINED: 6}


@dataclass
class Event:
    tc: int                       # ticks (1e-8 s)
    type: EventType
    props: dict[str, Any] = field(default_factory=dict)
    event_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])

    @property
    def _rank(self):
        return (self.tc, _TYPE_RANK[self.type])

    # convenience accessors for FRAME events
    @property
    def clips(self) -> list[int]:
        return self.props.get("clips", [])

    @property
    def frames(self) -> list[int]:
        return self.props.get("frames", [])


def frame_event(tc: int, clips: Sequence[int], frames: Sequence[int],
                **props) -> Event:
    return Event(tc, EventType.FRAME,
                 dict(clips=list(clips), frames=list(frames), **props))


def filter_init_event(tc: int, filter_name: str,
                      in_tracks: Sequence[int] = (0,),
                      out_tracks: Sequence[int] = (0,),
                      values: dict | None = None, **props) -> Event:
    return Event(tc, EventType.FILTER_INIT,
                 dict(filter=filter_name, in_tracks=list(in_tracks),
                      out_tracks=list(out_tracks),
                      values=dict(values or {}), **props))


def filter_deinit_event(tc: int, init_event_id: str) -> Event:
    return Event(tc, EventType.FILTER_DEINIT, dict(init_event=init_event_id))


def filter_map_event(tc: int, init_event_ids: Sequence[str]) -> Event:
    return Event(tc, EventType.FILTER_MAP,
                 dict(init_events=list(init_event_ids)))


def param_change_event(tc: int, init_event_id: str, param: str,
                       value: Any) -> Event:
    return Event(tc, EventType.PARAM_CHANGE,
                 dict(init_event=init_event_id, param=param, value=value))


def marker_event(tc: int, **props) -> Event:
    return Event(tc, EventType.MARKER, dict(props))


# -- sparse audio transitions on FRAME events ------------------------------
# Reference model (events.c:1251 insert_audio_event_at): flat pairs
# audio_clips=[track, clip, ...], audio_seeks=[seek_seconds, velocity, ...].
# An entry switches `track`'s audio; vel == 0 or clip < 0 means off.

def get_audio_entry(ev: Event, track: int):
    """(clip, seek, vel) for `track` at this FRAME event, or None."""
    ac = ev.props.get("audio_clips")
    if not ac:
        return None
    asx = ev.props.get("audio_seeks", [])
    for i in range(0, len(ac) - 1, 2):
        if ac[i] == track:
            seek = asx[i] if i < len(asx) else 0.0
            vel = asx[i + 1] if i + 1 < len(asx) else 1.0
            return (ac[i + 1], float(seek), float(vel))
    return None


def set_audio_entry(ev: Event, track: int, clip: int, seek: float,
                    vel: float):
    """Insert/replace `track`'s audio transition (insert_audio_event_at).
    Velocity rounds to 4 dp like the reference (events.c:1257)."""
    vel = round(float(vel) * 10000.0) / 10000.0
    ac = ev.props.setdefault("audio_clips", [])
    asx = ev.props.setdefault("audio_seeks", [])
    while len(asx) < len(ac):
        asx.append(0.0)
    for i in range(0, len(ac) - 1, 2):
        if ac[i] == track:
            ac[i + 1] = int(clip)
            asx[i], asx[i + 1] = float(seek), vel
            return
    ac.extend([int(track), int(clip)])
    asx.extend([float(seek), vel])


def is_audio_terminator(ev: Event) -> bool:
    """True for a FRAME event carrying no video and only audio OFF
    markers — a timeline-end audio bound, not a frame of content."""
    if ev.type != EventType.FRAME:
        return False
    if any(c >= 0 for c in ev.props.get("clips", [])):
        return False
    ac = ev.props.get("audio_clips") or []
    asx = ev.props.get("audio_seeks") or []
    if not ac:
        return False
    for i in range(0, len(ac) - 1, 2):
        vel = asx[i + 1] if i + 1 < len(asx) else 1.0
        if ac[i + 1] >= 0 and vel != 0.0:
            return False
    return True


def remove_audio_entry(ev: Event, track: int):
    """Drop `track`'s transition (remove_audio_for_track,
    events.c:1355); deletes the leaves when empty."""
    ac = ev.props.get("audio_clips")
    if not ac:
        return
    asx = ev.props.get("audio_seeks", [])
    for i in range(0, len(ac) - 1, 2):
        if ac[i] == track:
            del ac[i: i + 2]
            if i + 1 < len(asx):
                del asx[i: i + 2]
            break
    if not ac:
        ev.props.pop("audio_clips", None)
        ev.props.pop("audio_seeks", None)


class EventList:
    """An ordered timeline of events + global header (fps, geometry, audio).

    The single source of truth for recordings and multitrack layouts
    (reference multitrack.h:756-773: blocks are only *views* onto this).

    Indexed: alongside the sorted ``events`` list we keep a parallel rank
    list (O(log N) position lookups), an event-id map, and a sorted
    frame-tc index (O(log N) ``get_frame_event_at``) — the reference walks
    its linked list per lookup (events.c:792 get_frame_event_at), which
    made editor operations O(timeline x edit). All mutations must go
    through insert()/remove() (or call reindex() after bulk surgery).
    """

    def __init__(self, fps: float = 25.0, width: int = 0, height: int = 0,
                 audio_rate: int = 44100, audio_channels: int = 2):
        self.fps = fps
        self.width = width
        self.height = height
        self.audio_rate = audio_rate
        self.audio_channels = audio_channels
        #: container schema: 2 = audio transitions are explicit events
        #: (pre-2 lists get the legacy clip-placement audio fallback)
        self.schema = 2
        self.events: list[Event] = []
        self._ranks: list[tuple] = []          # parallel to events
        self._by_id: dict[str, Event] = {}
        self._frame_tcs: list[int] = []        # sorted tcs of FRAME events
        self._frame_at: dict[int, Event] = {}  # tc -> FRAME event

    def reindex(self):
        """Rebuild all indices after direct surgery on ``events``."""
        self.events.sort(key=lambda e: e._rank)
        self._ranks = [e._rank for e in self.events]
        self._by_id = {e.event_id: e for e in self.events}
        self._frame_at = {e.tc: e for e in self.events
                          if e.type == EventType.FRAME}
        self._frame_tcs = sorted(self._frame_at)

    # -- CRUD (reference events.c:246-1151) --------------------------------
    def insert(self, ev: Event) -> Event:
        rank = ev._rank
        # fast path: live recording appends in tc order
        if not self._ranks or rank >= self._ranks[-1]:
            self.events.append(ev)
            self._ranks.append(rank)
        else:
            idx = bisect.bisect_right(self._ranks, rank)
            self.events.insert(idx, ev)
            self._ranks.insert(idx, rank)
        self._by_id[ev.event_id] = ev
        if ev.type == EventType.FRAME:
            if ev.tc not in self._frame_at:
                bisect.insort(self._frame_tcs, ev.tc)
            self._frame_at[ev.tc] = ev
        return ev

    def extend(self, evs: Iterable[Event]):
        for e in evs:
            self.insert(e)

    def remove(self, ev: Event):
        idx = bisect.bisect_left(self._ranks, ev._rank)
        while idx < len(self.events) and self.events[idx] is not ev:
            if self._ranks[idx] != ev._rank:
                raise ValueError("event not in list")
            idx += 1
        if idx >= len(self.events):
            raise ValueError("event not in list")
        del self.events[idx]
        del self._ranks[idx]
        self._by_id.pop(ev.event_id, None)
        if ev.type == EventType.FRAME and self._frame_at.get(ev.tc) is ev:
            del self._frame_at[ev.tc]
            ti = bisect.bisect_left(self._frame_tcs, ev.tc)
            del self._frame_tcs[ti]
        return ev

    def get(self, event_id: str) -> Event | None:
        return self._by_id.get(event_id)

    def __len__(self):
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def duration_ticks(self) -> int:
        return self.events[-1].tc if self.events else 0

    # -- navigation --------------------------------------------------------
    def frame_events(self) -> list[Event]:
        return [self._frame_at[tc] for tc in self._frame_tcs]

    @property
    def n_frame_events(self) -> int:
        return len(self._frame_tcs)

    def get_frame_event_at(self, tc: int, exact: bool = False) -> Event | None:
        """Last FRAME event at or before tc (reference events.c:792),
        O(log F) via the frame-tc index."""
        e = self._frame_at.get(tc)
        if e is not None:
            return e
        if exact:
            return None
        idx = bisect.bisect_right(self._frame_tcs, tc)
        if idx == 0:
            return None
        return self._frame_at[self._frame_tcs[idx - 1]]

    def active_inits_at(self, tc: int) -> list[Event]:
        """FILTER_INIT events whose [init, deinit) interval covers tc,
        ordered by the most recent FILTER_MAP at or before tc."""
        inits: dict[str, Event] = {}
        order: list[str] | None = None
        for e in self.events:
            if e.tc > tc:
                break
            if e.type == EventType.FILTER_INIT:
                inits[e.event_id] = e
            elif e.type == EventType.FILTER_DEINIT:
                inits.pop(e.props["init_event"], None)
            elif e.type == EventType.FILTER_MAP:
                order = e.props["init_events"]
        if order is not None:
            out = [inits[i] for i in order if i in inits]
            out += [v for k, v in inits.items() if k not in order]
            return out
        return list(inits.values())

    def pchain(self, init_event_id: str, param: str) -> list[Event]:
        """Ordered PARAM_CHANGE events for one (init, param)."""
        return [e for e in self.events
                if e.type == EventType.PARAM_CHANGE
                and e.props["init_event"] == init_event_id
                and e.props["param"] == param]

    def interp_param(self, init: Event, param: str, tc: int):
        """Linear interpolation along the pchain at tc (reference
        interpolate_params). Falls back to the init's stored value."""
        chain = self.pchain(init.event_id, param)
        base = init.props["values"].get(param)
        if not chain:
            return base
        prev_tc, prev_v = init.tc, base
        for e in chain:
            v = e.props["value"]
            if e.tc <= tc:
                prev_tc, prev_v = e.tc, v
                continue
            if prev_v is None:
                return v
            if isinstance(v, (int, float)) and isinstance(prev_v, (int, float)) \
                    and e.tc > prev_tc:
                t = (tc - prev_tc) / (e.tc - prev_tc)
                return prev_v + (v - prev_v) * t
            if (isinstance(v, (list, tuple)) and isinstance(prev_v,
                                                            (list, tuple))
                    and len(v) == len(prev_v) and e.tc > prev_tc
                    and all(isinstance(x, (int, float)) for x in v)
                    and all(isinstance(x, (int, float)) for x in prev_v)):
                # element-wise interp for multi-valued params (the avol
                # per-track volume model, events.c:2636)
                t = (tc - prev_tc) / (e.tc - prev_tc)
                return [a + (b - a) * t for a, b in zip(prev_v, v)]
            return prev_v
        return prev_v

    # -- quantisation (reference resample.c:536 quantise_events) -----------
    def quantise(self, new_fps: float) -> "EventList":
        """Re-time FRAME events onto a new_fps grid. Source pick is
        floor/hold-last (the latest source frame at or before each grid
        tc — the reference quantise_events walks the same way); per-frame
        props (audio_clips/audio_seeks from recordings) are preserved."""
        out = EventList(fps=new_fps, width=self.width, height=self.height,
                        audio_rate=self.audio_rate,
                        audio_channels=self.audio_channels)
        tick_per_frame = TICKS_PER_SECOND / new_fps
        frames = self.frame_events()
        others = [e for e in self.events if e.type != EventType.FRAME]
        # rebase the timeline at the FIRST frame event (the reference
        # quantises relative to it too): without this, recordings whose
        # first frame lands late (compile warm-up) grew a dead pre-roll
        # of grid frames sitting BEFORE every recorded filter init — the
        # re-render's opening frames silently lost their effects
        t0 = frames[0].tc if frames else 0
        if frames:
            end_tc = frames[-1].tc - t0
            n_out = int(round(end_tc / tick_per_frame)) + 1
            fi = 0
            for i in range(n_out):
                tc = int(round(i * tick_per_frame))
                while fi + 1 < len(frames) and frames[fi + 1].tc - t0 <= tc:
                    fi += 1
                src = frames[fi]
                import copy as _copy
                extra = {k: _copy.deepcopy(v) for k, v in src.props.items()
                         if k not in ("clips", "frames")}
                out.insert(frame_event(tc, src.clips, src.frames, **extra))
        import copy as _copy
        for e in others:
            out.insert(Event(max(e.tc - t0, 0), e.type,
                             _copy.deepcopy(e.props), e.event_id))
        return out

    # -- serialisation (reference weed_plant_serialise :10969; we use a
    #    versioned JSON container with the same leaf names) ----------------
    def to_json(self) -> str:
        return json.dumps({
            "format": "lives_tpu_event_list",
            "version": self.schema,
            "weed_event_api_version": 122,
            "fps": self.fps, "width": self.width, "height": self.height,
            "audio_rate": self.audio_rate,
            "audio_channels": self.audio_channels,
            "events": [
                {"tc": e.tc, "type": int(e.type), "event_id": e.event_id,
                 "props": e.props}
                for e in self.events],
        })

    # -- crash-recovery autosave (incremental JSONL) -----------------------
    def header_json(self) -> str:
        """First line of the JSONL autosave: the container without events."""
        return json.dumps({
            "format": "lives_tpu_event_list_jsonl",
            "version": self.schema,
            "weed_event_api_version": 122,
            "fps": self.fps, "width": self.width, "height": self.height,
            "audio_rate": self.audio_rate,
            "audio_channels": self.audio_channels,
        })

    @staticmethod
    def event_json(e: "Event") -> str:
        return json.dumps({"tc": e.tc, "type": int(e.type),
                           "event_id": e.event_id, "props": e.props})

    @classmethod
    def from_autosave(cls, text: str) -> "EventList":
        """Load an autosave: either the one-document to_json() format or
        the incremental JSONL (header line + one event per line). A
        truncated trailing line — crash mid-append — is dropped rather
        than rejecting the whole take."""
        head = text.lstrip()[:512]
        if '"lives_tpu_event_list_jsonl"' not in head:
            return cls.from_json(text)
        lines = text.splitlines()
        d = json.loads(lines[0])
        el = cls(fps=d["fps"], width=d["width"], height=d["height"],
                 audio_rate=d.get("audio_rate", 0),
                 audio_channels=d.get("audio_channels", 0))
        el.schema = int(d.get("version", 1))
        for ln in lines[1:]:
            ln = ln.strip()
            if not ln:
                continue
            try:
                ed = json.loads(ln)
                el.events.append(Event(ed["tc"], EventType(ed["type"]),
                                       ed["props"], ed["event_id"]))
            except (ValueError, KeyError):
                break  # truncated tail from a crash mid-append
        el.reindex()
        return el

    @classmethod
    def from_json(cls, s: str) -> "EventList":
        d = json.loads(s)
        if d.get("format") != "lives_tpu_event_list":
            raise ValueError("not a lives_tpu event list")
        el = cls(fps=d["fps"], width=d["width"], height=d["height"],
                 audio_rate=d["audio_rate"],
                 audio_channels=d["audio_channels"])
        el.schema = int(d.get("version", 1))
        for ed in d["events"]:
            el.events.append(Event(ed["tc"], EventType(ed["type"]),
                                   ed["props"], ed["event_id"]))
        # canonical (tc, rank) order + indices: external/hand-edited files
        # may group events by type
        el.reindex()
        return el
