"""Binary Weed plant/event-list serialisation: the reference's durable
interchange format.

Counterpart of `lives_tpu/events/weed_binary.py:1-468`, copied (pure
Python; importing it from `lives_tpu` would import jax); both packages
write the same bytes for the same event list and read each other's files.
The filter registry it reads is the port's, which holds every filter of the
JAX package's. A name neither registry holds keeps the JAX package's path:
imported verbatim, skipped with a warning at render.

Byte format (reference `weed_plant_serialise`, src/effects-weed.c:10969 and
`weed_leaf_serialise` :10807, deserialise :11613):

  plant  := int32le nleaves, leaf("type"), leaf*          (type written first)
  leaf   := int32le keylen, key-utf8,
            int32le seed_type, int32le nelems,
            elem*                                          (one per element)
  elem   := int32le size, data
    - INT/BOOLEAN: 4-byte le            - DOUBLE: 8-byte le ieee754
    - INT64: 8-byte le                  - STRING: bytes, NO terminating NUL
    - FUNCPTR/VOIDPTR/PLANTPTR: written as VOIDPTR, 8-byte le value

Event lists on disk are the header plant (WEED_PLANT_EVENT_LIST, type 257)
followed by each event plant (type 256) in timecode order, with pointer
leaves converted exactly as the reference's writer does
(src/multitrack.c:224 `save_event_list_inner`): next/previous dropped,
FILTER_INIT gains an int64 `event_id`, FILTER_DEINIT/PARAM_CHANGE carry
int64 `init_event`, FILTER_MAP carries an int64 `init_events` array, and a
back-compat `hint` mirrors `event_type`.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO, Iterable

from .event_list import Event, EventList, EventType

# weed.h:386+ seed types
SEED_INT = 1
SEED_DOUBLE = 2
SEED_BOOLEAN = 3
SEED_STRING = 4
SEED_INT64 = 5
SEED_FUNCPTR = 64
SEED_VOIDPTR = 65
SEED_PLANTPTR = 66

PLANT_EVENT = 256        # weed-events.h:35
PLANT_EVENT_LIST = 257
WEED_EVENT_API_VERSION = 124

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _leaf_bytes(key: str, seed: int, values: Iterable[Any]) -> bytes:
    out = io.BytesIO()
    kb = key.encode()
    out.write(_I32.pack(len(kb)))
    out.write(kb)
    wire_seed = SEED_VOIDPTR if seed >= SEED_FUNCPTR else seed
    values = list(values)
    out.write(_I32.pack(wire_seed))
    out.write(_I32.pack(len(values)))
    for v in values:
        if seed in (SEED_INT, SEED_BOOLEAN):
            out.write(_I32.pack(4))
            out.write(_I32.pack(int(v)))
        elif seed == SEED_DOUBLE:
            out.write(_I32.pack(8))
            out.write(_F64.pack(float(v)))
        elif seed == SEED_INT64 or seed >= SEED_FUNCPTR:
            out.write(_I32.pack(8))
            out.write(_I64.pack(int(v)))
        elif seed == SEED_STRING:
            sb = str(v).encode()
            out.write(_I32.pack(len(sb)))
            out.write(sb)
        else:
            raise ValueError(f"unsupported seed type {seed}")
    return out.getvalue()


def serialise_plant(ptype: int, leaves: dict[str, tuple[int, list]]) -> bytes:
    """leaves: key -> (seed_type, [values]); 'type' is added automatically."""
    out = io.BytesIO()
    out.write(_I32.pack(len(leaves) + 1))
    out.write(_leaf_bytes("type", SEED_INT, [ptype]))
    for key, (seed, values) in leaves.items():
        out.write(_leaf_bytes(key, seed, values))
    return out.getvalue()


class _Reader:
    def __init__(self, fh: BinaryIO):
        self.fh = fh

    def _read(self, n: int) -> bytes:
        b = self.fh.read(n)
        if len(b) < n:
            raise EOFError
        return b

    def i32(self) -> int:
        return _I32.unpack(self._read(4))[0]

    def leaf(self) -> tuple[str, int, list]:
        klen = self.i32()
        if not 0 < klen < 65536:
            raise ValueError(f"implausible key length {klen}")
        key = self._read(klen).decode("utf-8", errors="replace")
        seed = self.i32()
        ne = self.i32()
        if not 0 <= ne < 1 << 24:
            raise ValueError(f"implausible element count {ne}")
        values = []
        for _ in range(ne):
            vlen = self.i32()
            data = self._read(vlen)
            if seed in (SEED_INT, SEED_BOOLEAN):
                values.append(_I32.unpack(data[:4])[0])
            elif seed == SEED_DOUBLE:
                values.append(_F64.unpack(data[:8])[0])
            elif seed == SEED_INT64 or seed >= SEED_FUNCPTR:
                values.append(_I64.unpack(data[:8])[0] if vlen >= 8
                              else 0)
            elif seed == SEED_STRING:
                values.append(data.decode("utf-8", errors="replace"))
            else:
                values.append(data)
        return key, seed, values

    def plant(self) -> tuple[int, dict[str, tuple[int, list]]]:
        nleaves = self.i32()
        if not 0 < nleaves < 1 << 16:
            raise ValueError(f"implausible leaf count {nleaves}")
        leaves: dict[str, tuple[int, list]] = {}
        ptype = 0
        for i in range(nleaves):
            key, seed, values = self.leaf()
            if i == 0:
                if key != "type":
                    raise ValueError("plant does not start with 'type'")
                ptype = int(values[0])
            else:
                leaves[key] = (seed, values)
        return ptype, leaves


def read_plants(fh: BinaryIO):
    """Yield (ptype, leaves) until EOF."""
    r = _Reader(fh)
    while True:
        try:
            yield r.plant()
        except EOFError:
            return


# ---------------------------------------------------------------------------
# EventList <-> weed binary
# ---------------------------------------------------------------------------

def _filter_params(name: str) -> list[str] | None:
    """In-parameter names of a filter of the JAX package's registry, or
    None for a name it does not hold."""
    from ..effects.host import get_filter
    try:
        return [p.name for p in get_filter(name).params]
    except KeyError:
        return None


def _param_index(filter_hashname: str, param_name: str) -> int:
    """Map our param name to the weed in-parameter index (or -1)."""
    names = _filter_params(filter_hashname.split("|")[0]) or []
    return names.index(param_name) if param_name in names else -1


def _param_name(filter_hashname: str, index: int) -> str:
    names = _filter_params(filter_hashname.split("|")[0]) or []
    if 0 <= index < len(names):
        return names[index]
    return f"param#{index}"


def _value_leaf(value) -> tuple[int, list]:
    if isinstance(value, bool):
        return SEED_BOOLEAN, [1 if value else 0]
    if isinstance(value, int):
        return SEED_INT, [value]
    if isinstance(value, float):
        return SEED_DOUBLE, [value]
    if isinstance(value, str):
        return SEED_STRING, [value]
    if isinstance(value, (list, tuple)) and value:
        if all(isinstance(v, (int, float)) for v in value):
            if any(isinstance(v, float) for v in value):
                return SEED_DOUBLE, [float(v) for v in value]
            return SEED_INT, [int(v) for v in value]
    return SEED_DOUBLE, [float(value)]


def save_event_list_binary(el: EventList, fh: BinaryIO) -> int:
    """Write el in the reference's binary layout/recording format.
    Returns bytes written."""
    ids: dict[str, int] = {}

    def int_id(event_id: str) -> int:
        # stable int64 ids standing in for the reference's pointer values
        if event_id not in ids:
            ids[event_id] = 0x10000 + 16 * len(ids)
        return ids[event_id]

    header = {
        "weed_event_api_version": (SEED_INT, [WEED_EVENT_API_VERSION]),
        "fps": (SEED_DOUBLE, [float(el.fps)]),
        "width": (SEED_INT, [int(el.width)]),
        "height": (SEED_INT, [int(el.height)]),
        "audio_channels": (SEED_INT, [int(el.audio_channels)]),
        "audio_rate": (SEED_INT, [int(el.audio_rate)]),
        "audio_sample_size": (SEED_INT, [16]),
        "audio_signed": (SEED_BOOLEAN, [1]),
        "audio_endian": (SEED_INT, [0]),
        # host marker: audio transitions are explicit events (schema 2);
        # reference-authored files lack it and get schema 1 semantics
        "host_schema": (SEED_INT, [int(getattr(el, "schema", 2))]),
    }
    total = fh.write(serialise_plant(PLANT_EVENT_LIST, header))
    for ev in el.events:
        leaves: dict[str, tuple[int, list]] = {
            "timecode": (SEED_INT64, [int(ev.tc)]),
            "event_type": (SEED_INT, [int(ev.type)]),
            "hint": (SEED_INT, [int(ev.type)]),  # back_compat service
        }
        p = ev.props
        if ev.type == EventType.FRAME:
            clips = [int(c) for c in p["clips"]]
            # reference clips are small clip numbers (SEED_INT); live
            # recordings carry 63-bit clip unique_ids -> promote to INT64
            cseed = SEED_INT if all(-(1 << 31) <= c < (1 << 31)
                                    for c in clips) else SEED_INT64
            leaves["clips"] = (cseed, clips)
            leaves["frames"] = (SEED_INT64,
                                [int(f) + 1 for f in p["frames"]])
            if "audio_clips" in p:
                leaves["audio_clips"] = (SEED_INT,
                                         [int(c) for c in p["audio_clips"]])
                leaves["audio_seeks"] = (SEED_DOUBLE,
                                         [float(s) for s in
                                          p.get("audio_seeks", [])])
        elif ev.type == EventType.FILTER_INIT:
            fname = p["filter"]
            hashname = fname if "|" in fname else _our_hashname(fname)
            leaves["filter"] = (SEED_STRING, [hashname])
            leaves["in_tracks"] = (SEED_INT,
                                   [int(t) for t in p.get("in_tracks", [0])])
            leaves["out_tracks"] = (SEED_INT,
                                    [int(t) for t in
                                     p.get("out_tracks", [0])])
            leaves["event_id"] = (SEED_INT64, [int_id(ev.event_id)])
            if p.get("audio"):
                # audio-filter marker (our avol init; the reference infers
                # this from the plugin's channel templates)
                leaves["host_audio"] = (SEED_BOOLEAN, [1])
            # initial param values: the reference records these as
            # PARAM_CHANGE events at the init's tc (pchain heads); we also
            # keep them verbatim in a host leaf so OUR round trip is exact
            # (unknown leaves are ignored by the reference's loader)
            if p.get("values"):
                import json as _json
                leaves["host_values"] = (SEED_STRING,
                                         [_json.dumps(p["values"])])
        elif ev.type == EventType.FILTER_DEINIT:
            leaves["init_event"] = (SEED_INT64, [int_id(p["init_event"])])
        elif ev.type == EventType.FILTER_MAP:
            leaves["init_events"] = (SEED_INT64,
                                     [int_id(i) for i in p["init_events"]])
        elif ev.type == EventType.PARAM_CHANGE:
            leaves["init_event"] = (SEED_INT64, [int_id(p["init_event"])])
            init = next((e for e in el.events
                         if e.event_id == p["init_event"]), None)
            fname = init.props["filter"] if init else ""
            leaves["index"] = (SEED_INT,
                               [_param_index(fname, p["param"])])
            leaves["value"] = _value_leaf(p["value"])
            # our param NAME travels too (harmless extra leaf; makes the
            # round trip exact even for filters absent from a registry)
            leaves["host_param_name"] = (SEED_STRING, [p["param"]])
        elif ev.type == EventType.MARKER:
            for k, v in p.items():
                if isinstance(v, (bool, int, float, str)) or (
                        isinstance(v, (list, tuple)) and v
                        and all(isinstance(x, (int, float)) for x in v)):
                    # incl. the reference's BLOCK_START "tracks" array
                    leaves[k] = _value_leaf(v)
        total += fh.write(serialise_plant(PLANT_EVENT, leaves))
        if ev.type == EventType.FILTER_INIT and p.get("values"):
            # real-LiVES interop: the reference reads initial param values
            # from pchain heads (PARAM_CHANGE at the init's tc), so emit
            # one per value. host_init_value marks them so OUR importer
            # folds them back into init.values instead of duplicating
            # pchain points.
            fname = p["filter"]
            for pn, pv in p["values"].items():
                pc = {
                    "timecode": (SEED_INT64, [int(ev.tc)]),
                    "event_type": (SEED_INT, [int(EventType.PARAM_CHANGE)]),
                    "hint": (SEED_INT, [int(EventType.PARAM_CHANGE)]),
                    "init_event": (SEED_INT64, [int_id(ev.event_id)]),
                    "index": (SEED_INT, [_param_index(fname, pn)]),
                    "value": _value_leaf(pv),
                    "host_param_name": (SEED_STRING, [pn]),
                    "host_init_value": (SEED_BOOLEAN, [1]),
                }
                total += fh.write(serialise_plant(PLANT_EVENT, pc))
    return total


def _our_hashname(name: str) -> str:
    from ..effects.host import get_filter
    try:
        return get_filter(name).hashname
    except KeyError:
        pass
    if _filter_params(name) is None:
        return name
    return f"{name}|lives_tpu|1"   # a deferred builtin's `Filter.hashname`


def load_event_list_binary(fh: BinaryIO) -> EventList:
    """Read a reference-format binary event list / layout."""
    plants = read_plants(fh)
    try:
        ptype, header = next(plants)
    except StopIteration:
        raise ValueError("empty event list file")
    if ptype != PLANT_EVENT_LIST:
        raise ValueError(f"first plant is type {ptype}, not an event list")

    def one(key, default=None):
        if key in header:
            vs = header[key][1]
            return vs[0] if vs else default
        return default

    el = EventList(fps=float(one("fps", 25.0)),
                   width=int(one("width", 0)), height=int(one("height", 0)),
                   audio_rate=int(one("audio_rate", 44100)),
                   audio_channels=int(one("audio_channels", 2)))
    # reference layouts DO carry explicit audio events (aclips pairs), so
    # they take schema 2 semantics; only our own pre-0.3 containers
    # (version 1 JSON) keep the legacy placement fallback
    el.schema = int(one("host_schema", 2))
    id_map: dict[int, str] = {}
    init_filters: dict[str, str] = {}
    init_events: dict[str, Event] = {}

    def ev_id(int_id: int) -> str:
        if int_id not in id_map:
            id_map[int_id] = f"ref{int_id:x}"
        return id_map[int_id]

    for ptype, leaves in plants:
        if ptype != PLANT_EVENT:
            continue

        def get(key, default=None):
            if key in leaves:
                vs = leaves[key][1]
                return vs[0] if vs else default
            return default

        def arr(key):
            return list(leaves[key][1]) if key in leaves else []

        etype = get("event_type", get("hint", 0))
        tc = int(get("timecode", 0))
        try:
            etype = EventType(int(etype))
        except ValueError:
            continue
        if etype == EventType.FRAME:
            ev = Event(tc, etype,
                       dict(clips=[int(c) for c in arr("clips")],
                            frames=[int(f) - 1 for f in arr("frames")]))
            if "audio_clips" in leaves:
                ev.props["audio_clips"] = arr("audio_clips")
                ev.props["audio_seeks"] = arr("audio_seeks")
        elif etype == EventType.FILTER_INIT:
            eid = ev_id(int(get("event_id", 0)))
            ours = _import_filter_name(str(get("filter", "")))
            values = {}
            if "host_values" in leaves:
                import json as _json
                try:
                    values = _json.loads(leaves["host_values"][1][0])
                except Exception:
                    values = {}
            ev = Event(tc, etype,
                       dict(filter=ours,
                            in_tracks=[int(t) for t in arr("in_tracks")]
                            or [0],
                            out_tracks=[int(t) for t in arr("out_tracks")]
                            or [0], values=values),
                       event_id=eid)
            raw_name = str(get("filter", ""))
            if get("host_audio") or "audio volume" in raw_name \
                    or "audio_volume" in raw_name:
                ev.props["filter"] = "avol"
                ev.props["audio"] = True
            init_filters[eid] = ours
            init_events[eid] = ev
        elif etype == EventType.FILTER_DEINIT:
            ev = Event(tc, etype,
                       dict(init_event=ev_id(int(get("init_event", 0)))))
        elif etype == EventType.FILTER_MAP:
            ev = Event(tc, etype,
                       dict(init_events=[ev_id(int(i))
                                         for i in arr("init_events")]))
        elif etype == EventType.PARAM_CHANGE:
            eid = ev_id(int(get("init_event", 0)))
            if get("host_init_value"):
                # synthetic initial-value pchain head (see save): fold into
                # the init's values rather than emitting a change event
                init = init_events.get(eid)
                pn = get("host_param_name")
                if init is not None and pn is not None:
                    vals = leaves["value"][1] if "value" in leaves else [0.0]
                    init.props.setdefault("values", {}).setdefault(
                        str(pn), vals[0] if len(vals) == 1 else list(vals))
                continue
            pname = get("host_param_name")
            if pname is None:
                pname = _param_name(init_filters.get(eid, ""),
                                    int(get("index", -1)))
            vals = leaves["value"][1] if "value" in leaves else [0.0]
            # reference colour params carry multi-element values (RGB)
            value = vals[0] if len(vals) == 1 else list(vals)
            ev = Event(tc, etype, dict(init_event=eid, param=str(pname),
                                       value=value))
        else:  # MARKER / unknown
            props = {k: (v[1][0] if len(v[1]) == 1 else list(v[1]))
                     for k, v in leaves.items()
                     if k not in ("timecode", "event_type", "hint")
                     and v[0] in (SEED_INT, SEED_DOUBLE, SEED_BOOLEAN,
                                  SEED_STRING, SEED_INT64)}
            ev = Event(tc, EventType.MARKER, props)
        el.events.append(ev)
    el.reindex()
    return el


def _import_filter_name(hashname: str) -> str:
    """Map a reference Weed hashname onto the JAX package's registry when
    possible (its registered names: the port's and the deferred ones)."""
    from ..effects.host import DEFERRED, list_filters
    name = hashname.split("|")[0].strip().lower()
    if _filter_params(name) is not None:
        return name
    # fuzzy: reference plugin hashnames embed the plugin's display name
    from ..player.player import KeyMap
    have = set(list_filters()) | set(DEFERRED)
    for frag, ours in KeyMap.REF_FILTER_MAP.items():
        if frag in name and ours in have:
            return ours
    return hashname  # keep verbatim; renderer will skip unknown filters
