"""The port's binary Weed serialisation (`lives_tpu_torch.events.
weed_binary`) against lives_tpu's, on the CPU: the same event lists give the
same bytes, each package reads the other's files into the same event list
(`to_json` text equal), a reference-writer-style file imports the same way,
random and truncated bytes fail or parse alike, and layouts render within
1 LSB of the JAX renderer. Event ids come from a counter in both packages
(`same_ids`), so lists built or read step for step are equal as text. A layout
naming puretext (once deferred) serialises with the JAX package's parameter
indices, imports the same way and renders within 1 LSB of the JAX renderer.
The milkdrop presets, registered in both packages, round-trip byte for byte
and render within 1 LSB of the JAX renderer. A name neither registry
holds renders with a warning, the unknown filter skipped, as in the JAX
package."""

import io
import random
import struct
import types
import warnings

import numpy as np
import pytest

import lives_tpu.events.event_list as j_elmod
import lives_tpu.events.weed_binary as jw
import lives_tpu_torch.events.event_list as t_elmod
import lives_tpu_torch.events.weed_binary as tw
from lives_tpu import scenes as j_scenes
from lives_tpu.events.renderer import render_to_arrays as j_render
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu_torch import scenes as t_scenes
from lives_tpu_torch.events import EventType
from lives_tpu_torch.events.renderer import render_to_arrays as t_render
from lives_tpu_torch.graph import SinkSpec as TSink

SCAN = {"LIVES_TPU_FUSED_SWEEP": "0", "LIVES_TPU_CHAIN_DTYPE": "f32"}


class _Counter:
    """Stands in for the `uuid` module of an event_list module: event ids
    (`uuid4().hex[:16]`) 0000...1, 0000...2, ... in creation order."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return types.SimpleNamespace(hex=f"{self.n:016x}" + "0" * 16)


@pytest.fixture(autouse=True)
def same_ids(monkeypatch):
    """Deterministic event ids, one counter a package (`load` restarts its
    package's, so every reading of a file names its events alike)."""
    for mod in (j_elmod, t_elmod):
        monkeypatch.setattr(mod, "uuid", _Counter())


@pytest.fixture
def scan_env(monkeypatch):
    """The JAX package's XLA path in float32, the oracle the port's plain
    route is held to."""
    for k, v in SCAN.items():
        monkeypatch.setenv(k, v)


PKGS = {"j": (j_elmod, jw), "t": (t_elmod, tw)}


def save(pkg, el) -> bytes:
    buf = io.BytesIO()
    n = PKGS[pkg][1].save_event_list_binary(el, buf)
    assert n == len(buf.getvalue())
    return buf.getvalue()


def load(pkg, data: bytes):
    PKGS[pkg][0].uuid.n = 0
    return PKGS[pkg][1].load_event_list_binary(io.BytesIO(data))


def assert_both_ways(j_el, t_el):
    """Equal bytes, and each package's reader makes the same list of
    either package's file."""
    bj, bt = save("j", j_el), save("t", t_el)
    assert bj == bt
    texts = {load(p, b).to_json() for p in PKGS for b in (bj, bt)}
    assert len(texts) == 1
    return bj


def frames_close(a, b, bound=1):
    a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= bound


# -- the plant format ----------------------------------------------------------

def test_plant_byte_format_exact():
    """The wire bytes of one plant: the JAX package's, in the C writer's
    layout (`type` first, int32 lengths, an int64 element of 8 bytes)."""
    leaves = {"timecode": (tw.SEED_INT64, [12345]),
              "event_type": (tw.SEED_INT, [1]),
              "name": (tw.SEED_STRING, ["naïve"]),
              "ptr": (tw.SEED_PLANTPTR, [0xDEAD]),
              "vals": (tw.SEED_DOUBLE, [0.5, -2.25])}
    data = tw.serialise_plant(tw.PLANT_EVENT, leaves)
    assert data == jw.serialise_plant(jw.PLANT_EVENT, leaves)
    b = io.BytesIO(data)
    assert struct.unpack("<7i", b.read(28)) == (6, 4, 0x65707974, 1, 1, 4,
                                                256)
    assert struct.unpack("<i", b.read(4))[0] == 8
    assert b.read(8) == b"timecode"
    assert struct.unpack("<iii", b.read(12)) == (tw.SEED_INT64, 1, 8)
    assert struct.unpack("<q", b.read(8))[0] == 12345
    ((ptype, got),) = list(tw.read_plants(io.BytesIO(data)))
    assert ptype == tw.PLANT_EVENT
    assert got["ptr"] == (tw.SEED_VOIDPTR, [0xDEAD])
    assert got["name"] == (tw.SEED_STRING, ["naïve"])
    assert got == list(jw.read_plants(io.BytesIO(data)))[0][1]


# -- event lists ---------------------------------------------------------------

@pytest.mark.parametrize("n_tracks,n_frames", [(4, 12), (10, 30)])
def test_event_list_roundtrip(n_tracks, n_frames):
    """`scenes.multitrack_timeline`: bytes equal both ways, and the read
    list has the events, clips, frames, filters and pchains written."""
    kw = dict(n_tracks=n_tracks, n_frames=n_frames, width=128, height=64,
              fps=25.0)
    j_el, t_el = (j_scenes.multitrack_timeline(**kw),
                  t_scenes.multitrack_timeline(**kw))
    assert j_el.to_json() == t_el.to_json()
    data = assert_both_ways(j_el, t_el)
    el2 = load("t", data)
    assert (el2.fps, el2.width, el2.height) == (25.0, 128, 64)
    assert len(el2.events) == len(t_el.events)
    for a, b in zip(t_el.events, el2.events):
        assert (a.tc, a.type) == (b.tc, b.type)
        if a.type == EventType.FRAME:
            assert (a.clips, a.frames) == (b.clips, b.frames)
        elif a.type == EventType.FILTER_INIT:
            assert b.props["filter"] == a.props["filter"]
            assert a.props["in_tracks"] == b.props["in_tracks"]
    inits = {e.event_id for e in el2.events
             if e.type == EventType.FILTER_INIT}
    assert all(e.props["init_event"] in inits for e in el2.events
               if e.type == EventType.PARAM_CHANGE)


def test_roundtripped_list_renders_identically(scan_env):
    """The list read back renders as the list written, and within 1 LSB of
    the JAX renderer on the same read list."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    el = t_scenes.multitrack_timeline(n_tracks=3, n_frames=6, width=128,
                                      height=48, fps=25.0)
    data = save("t", el)
    src = TSource(48, 128, device="cpu")
    a, _ = t_render(el, src, TSink(width=128, height=48), batch_size=3)
    b, _ = t_render(load("t", data), src, TSink(width=128, height=48),
                    batch_size=3)
    np.testing.assert_array_equal(a, b)
    ref, _ = j_render(load("j", data), JSource(48, 128),
                      JSink(width=128, height=48), batch_size=3)
    frames_close(b, ref)


def _leaf(key: bytes, seed: int, elems: list[bytes]) -> bytes:
    out = struct.pack("<i", len(key)) + key
    out += struct.pack("<ii", seed, len(elems))
    for e in elems:
        out += struct.pack("<i", len(e)) + e
    return out


def _reference_style_file(filter_name: bytes) -> bytes:
    """A file as the reference's own writer lays it out: `hint` instead of
    `event_type`, a pointer-valued init id, a concatenated Weed hashname, a
    param index with no host_param_name, 1-based frames, a stray VOIDPTR
    leaf (`tests/test_weed_binary.py:86-136`)."""
    i32 = lambda v: struct.pack("<i", v)  # noqa: E731
    i64 = lambda v: struct.pack("<q", v)  # noqa: E731
    ptr = 0x7F00AA00BB00
    raw = i32(4) + _leaf(b"type", tw.SEED_INT, [i32(tw.PLANT_EVENT_LIST)])
    raw += _leaf(b"fps", tw.SEED_DOUBLE, [struct.pack("<d", 25.0)])
    raw += _leaf(b"width", tw.SEED_INT, [i32(128)])
    raw += _leaf(b"height", tw.SEED_INT, [i32(64)])
    raw += i32(7) + _leaf(b"type", tw.SEED_INT, [i32(tw.PLANT_EVENT)])
    raw += _leaf(b"timecode", tw.SEED_INT64, [i64(0)])
    raw += _leaf(b"hint", tw.SEED_INT, [i32(2)])
    raw += _leaf(b"filter", tw.SEED_STRING, [filter_name])
    raw += _leaf(b"in_tracks", tw.SEED_INT, [i32(0), i32(1)])
    raw += _leaf(b"out_tracks", tw.SEED_INT, [i32(0)])
    raw += _leaf(b"event_id", tw.SEED_INT64, [i64(ptr)])
    raw += i32(6) + _leaf(b"type", tw.SEED_INT, [i32(tw.PLANT_EVENT)])
    raw += _leaf(b"timecode", tw.SEED_INT64, [i64(0)])
    raw += _leaf(b"hint", tw.SEED_INT, [i32(5)])
    raw += _leaf(b"init_event", tw.SEED_INT64, [i64(ptr)])
    raw += _leaf(b"index", tw.SEED_INT, [i32(0)])
    raw += _leaf(b"value", tw.SEED_DOUBLE, [struct.pack("<d", 0.25)])
    raw += i32(6) + _leaf(b"type", tw.SEED_INT, [i32(tw.PLANT_EVENT)])
    raw += _leaf(b"timecode", tw.SEED_INT64, [i64(4000000)])
    raw += _leaf(b"hint", tw.SEED_INT, [i32(1)])
    raw += _leaf(b"clips", tw.SEED_INT, [i32(1), i32(2)])
    raw += _leaf(b"frames", tw.SEED_INT64, [i64(5), i64(9)])
    raw += _leaf(b"next", tw.SEED_VOIDPTR, [i64(0xDEAD)])
    return raw


@pytest.mark.parametrize("hashname,ours,param", [
    (b"Weedsimple_blendblendsalsaman1", "crossfade", "amount"),
    (b"WeedpuretextPure Textsalsaman1", "livetext", "text"),
    (b"puretext|lives_tpu|1", "puretext", "text"),
    (b"milk_spin|lives_tpu|1", "milk_spin", "bass"),
    (b"WeedprojectMprojectM1", "WeedprojectMprojectM1", "param#0"),
])
def test_import_reference_writer_style_file(hashname, ours, param):
    """Both packages read the reference-style file into the same list: the
    hashname maps onto the JAX package's registry (a deferred filter's
    name too), index 0 names the filter's first parameter."""
    raw = _reference_style_file(hashname)
    el = load("t", raw)
    assert el.to_json() == load("j", raw).to_json()
    assert el.fps == 25.0 and el.width == 128
    init, pc, fr = el.events
    assert [e.type for e in el.events] == [EventType.FILTER_INIT,
                                           EventType.PARAM_CHANGE,
                                           EventType.FRAME]
    assert init.props["filter"] == ours
    assert pc.props["init_event"] == init.event_id
    assert pc.props["param"] == param
    assert abs(pc.props["value"] - 0.25) < 1e-9
    assert fr.props["frames"] == [4, 8]


def test_every_reference_fragment_imports_as_in_jax():
    """Each fragment of the reference keymap's table, inside a hashname,
    imports to the name the JAX package imports it to."""
    from lives_tpu_torch.player import KeyMap
    for frag in KeyMap.REF_FILTER_MAP:
        h = f"Weed{frag}plugin|salsaman|1"
        assert tw._import_filter_name(h) == jw._import_filter_name(h), frag


def _small_timeline(pkg, names, n=4):
    elmod = PKGS[pkg][0]
    el = elmod.EventList(fps=25.0, width=128, height=48)
    inits = []
    for name, vals in names:
        init = elmod.filter_init_event(0, name, in_tracks=[0, 1],
                                       out_tracks=[0], values=vals)
        el.insert(init)
        inits.append(init)
    el.insert(elmod.filter_map_event(0, [i.event_id for i in inits]))
    for i in range(n):
        el.insert(elmod.frame_event(i * 4_000_000, [1, 2], [i, i]))
    return el


def test_imported_reference_layout_renders(scan_env):
    """A binary layout read back renders through the batch renderer,
    within 1 LSB of the JAX renderer on the JAX package's reading."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    spec = [("crossfade", {"amount": 0.3})]
    data = assert_both_ways(_small_timeline("j", spec),
                            _small_timeline("t", spec))
    got, _ = t_render(load("t", data), TSource(48, 128, device="cpu"),
                      TSink(width=128, height=48), batch_size=2)
    ref, _ = j_render(load("j", data), JSource(48, 128),
                      JSink(width=128, height=48), batch_size=2)
    assert got.shape == (4, 3, 48, 128)
    frames_close(got, ref)


def test_unknown_filter_layout_renders_with_warning(scan_env):
    """A filter neither registry holds is skipped with a warning; the
    known one still applies, as in the JAX package."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    out = {}
    for pkg, render, src, sink in (
            ("t", t_render, TSource(48, 128, device="cpu"),
             TSink(width=128, height=48)),
            ("j", j_render, JSource(48, 128), JSink(width=128, height=48))):
        elmod = PKGS[pkg][0]
        el = elmod.EventList(fps=25.0, width=128, height=48)
        known = elmod.filter_init_event(0, "negate")
        unknown = elmod.filter_init_event(0, "WeedprojectMprojectM1")
        el.insert(known)
        el.insert(unknown)
        el.insert(elmod.filter_map_event(0, [known.event_id,
                                             unknown.event_id]))
        for i in range(4):
            el.insert(elmod.frame_event(i * 4_000_000, [1], [i]))
        el = load(pkg, save(pkg, el))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out[pkg], _ = render(el, src, sink, batch_size=4)
            assert any("unknown filter" in str(x.message) for x in w)
    ref = TSource(48, 128, device="cpu").get_batch([1] * 4, range(4))
    np.testing.assert_array_equal(out["t"], 255 - ref.planes[0].numpy())
    np.testing.assert_array_equal(out["t"], np.asarray(out["j"]))


@pytest.mark.parametrize("name,values", [
    ("puretext", {"text": "hi", "size": 12, "speed": 0.5}),
])
def test_deferred_filter_layout(name, values, scan_env):
    """A layout naming a filter the port once deferred (puretext): the
    bytes are the JAX package's (hashname, parameter indices, the init
    values' pchain heads), both read it to the same list, and the port
    renders it within 1 LSB of the JAX renderer."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    els = {}
    for pkg in PKGS:
        elmod = PKGS[pkg][0]
        el = elmod.EventList(fps=25.0, width=64, height=32)
        init = elmod.filter_init_event(0, name, values=values)
        el.insert(init)
        el.insert(elmod.filter_map_event(0, [init.event_id]))
        el.insert(elmod.param_change_event(4_000_000, init.event_id,
                                           list(values)[-1], 0.25))
        for i in range(3):
            el.insert(elmod.frame_event(i * 4_000_000, [1], [i]))
        els[pkg] = el
    data = assert_both_ways(els["j"], els["t"])
    plants = [leaves for ptype, leaves in tw.read_plants(io.BytesIO(data))
              if ptype == tw.PLANT_EVENT and "index" in leaves]
    from lives_tpu.effects.host import get_filter as j_get_filter
    names = [p.name for p in j_get_filter(name).params]
    assert {p["index"][1][0] for p in plants} == {names.index(k)
                                                  for k in values}
    got, _ = t_render(load("t", data), TSource(32, 64, device="cpu"),
                      TSink(width=64, height=32), batch_size=3)
    ref, _ = j_render(load("j", data), JSource(32, 64),
                      JSink(width=64, height=32), batch_size=3)
    assert got.shape == (3, 3, 32, 64)
    frames_close(got, ref)


@pytest.mark.parametrize("name", ["milk_geometry", "milk_pulse",
                                  "milk_spin", "milk_tunnel"])
def test_milk_preset_layout(name, scan_env):
    """A layout naming a milkdrop preset (a stateful generator the port
    once deferred): the same bytes from both packages, the parameter
    indices of the registered filter, both read it to the same list, and
    the port renders it within 1 LSB of the JAX renderer."""
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.effects.host import get_filter
    from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
    values = {"bass": 0.7, "vol": 0.1}
    els = {}
    for pkg in PKGS:
        elmod = PKGS[pkg][0]
        el = elmod.EventList(fps=25.0, width=48, height=32)
        init = elmod.filter_init_event(0, name, values=values)
        el.insert(init)
        el.insert(elmod.filter_map_event(0, [init.event_id]))
        el.insert(elmod.param_change_event(4_000_000, init.event_id,
                                           "vol", 0.25))
        for i in range(3):
            el.insert(elmod.frame_event(i * 4_000_000, [1], [i]))
        els[pkg] = el
    data = assert_both_ways(els["j"], els["t"])
    plants = [leaves for ptype, leaves in tw.read_plants(io.BytesIO(data))
              if ptype == tw.PLANT_EVENT and "index" in leaves]
    names = [p.name for p in get_filter(name).params]
    assert {p["index"][1][0] for p in plants} == {names.index(k)
                                                  for k in values}
    got, _ = t_render(load("t", data), TSource(32, 48, device="cpu"),
                      TSink(width=48, height=32), batch_size=2)
    ref, _ = j_render(load("j", data), JSource(32, 48),
                      JSink(width=48, height=32), batch_size=2)
    assert got.shape == (3, 3, 32, 48)
    frames_close(got, ref)


def test_loader_survives_fuzz():
    """Random bytes and truncations of a valid file: both packages raise
    the same error or read the same list."""
    rng = np.random.default_rng(0)
    el = t_scenes.multitrack_timeline(n_tracks=3, n_frames=4, width=64,
                                      height=32)
    data = save("t", el)
    blobs = [rng.integers(0, 256, rng.integers(4, 2048),
                          dtype=np.uint8).tobytes() for _ in range(50)]
    blobs += [data[:cut] for cut in
              range(1, len(data), max(len(data) // 40, 1))]

    def outcome(pkg, blob):
        try:
            return load(pkg, blob).to_json()
        except (ValueError, EOFError, MemoryError) as e:
            return type(e).__name__
    for blob in blobs:
        assert outcome("t", blob) == outcome("j", blob)


def _random_list(pkg, rng: random.Random):
    """tests/test_weed_binary.py:222-262's random event list, built with
    one package's constructors from the same rng draws."""
    m = PKGS[pkg][0]
    el = m.EventList(fps=rng.choice([24.0, 25.0, 30.0]),
                     width=rng.choice([64, 320]), height=48)
    inits = []
    tc = 0
    for k in range(rng.randint(5, 40)):
        tc += rng.randint(1, 5) * 4_000_000
        kind = rng.random()
        if kind < 0.6 or not inits:
            ev = m.frame_event(tc, [rng.randint(-1, 3) for _ in range(3)],
                               [rng.randint(0, 99) for _ in range(3)])
            if rng.random() < 0.4:
                m.set_audio_entry(ev, rng.choice([-1, 0, 1]),
                                  rng.randint(-1, 3), rng.uniform(0, 5),
                                  rng.choice([0.0, 1.0, -1.0, 0.5]))
            el.insert(ev)
        elif kind < 0.75:
            init = m.filter_init_event(tc, rng.choice(
                ["negate", "vignette", "crossfade", "puretext"]),
                in_tracks=[0, 1][: rng.randint(1, 2)],
                values={"amount": rng.random()})
            el.insert(init)
            inits.append(init)
            el.insert(m.filter_map_event(tc, [i.event_id for i in inits]))
        elif kind < 0.85:
            el.insert(m.param_change_event(tc, rng.choice(inits).event_id,
                                           "amount", rng.random()))
        elif kind < 0.93:
            el.insert(m.filter_deinit_event(tc, rng.choice(inits).event_id))
        else:
            el.insert(m.marker_event(tc, lives_type=1,
                                     tracks=[rng.randrange(3)]))
    return el


@pytest.mark.parametrize("seed", range(8))
def test_binary_roundtrip_fuzz(seed):
    """Random event lists: bytes equal both ways, and the read list keeps
    the frames, audio pairs and event counts of the written one."""
    j_el = _random_list("j", random.Random(seed))
    t_el = _random_list("t", random.Random(seed))
    assert j_el.to_json() == t_el.to_json()
    el2 = load("t", assert_both_ways(j_el, t_el))
    f1, f2 = t_el.frame_events(), el2.frame_events()
    assert len(f1) == len(f2)
    for a, b in zip(f1, f2):
        assert (a.tc, a.clips, a.frames) == (b.tc, b.clips, b.frames)
        assert a.props.get("audio_clips", []) == \
            list(b.props.get("audio_clips", []))
    for t in (EventType.FILTER_INIT, EventType.FILTER_DEINIT,
              EventType.PARAM_CHANGE, EventType.MARKER):
        assert sum(e.type == t for e in t_el.events) == \
            sum(e.type == t for e in el2.events)


def test_events_package_exports():
    """`lives_tpu_torch.events` exports the four names
    `lives_tpu/events/__init__.py:8-9` does."""
    import lives_tpu_torch.events as ev
    for name in ("load_event_list_binary", "save_event_list_binary",
                 "read_plants", "serialise_plant"):
        assert getattr(ev, name) is getattr(tw, name)
