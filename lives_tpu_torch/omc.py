"""OMC: external device event learning (reference `src/omc-learn.c`).

Raw MIDI / joystick / generic data events are parsed into `DeviceEvent`s,
then mapped — via a learn-mode workflow — to internal macros (play, stop,
clip select, fps change, effect-key toggles, parameter set) with linear
value transforms. Device maps serialize to JSON (the reference persists
them under resources/devicemaps/).

Events arrive programmatically (`feed_midi` bytes or `feed(DeviceEvent)`)
where no ALSA sequencer is read, which is also how tests and the OSC
bridge drive it; `JoystickReader` reads a Linux joystick device.

Counterpart of `lives_tpu/omc.py:1-244`, copied: pure Python over the
port's `Player`, its device maps the JAX package's JSON text.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

# event types (omc-learn.h equivalents)
MIDI_NOTE_ON = 1
MIDI_NOTE_OFF = 2
MIDI_CC = 3
MIDI_PITCH_BEND = 4
MIDI_PGM_CHANGE = 5
JS_AXIS = 16
JS_BUTTON = 17


@dataclass(frozen=True)
class EventKey:
    """Identity of a physical control (type, channel, controller)."""
    etype: int
    channel: int
    index: int


@dataclass
class DeviceEvent:
    key: EventKey
    value: float        # normalized 0..1 (or -1..1 for pitch/axes)


@dataclass
class Macro:
    """An internal action with an optional value parameter."""
    name: str
    action: Callable[[float], None]
    takes_value: bool = False


@dataclass
class Mapping:
    key: EventKey
    macro: str
    scale: float = 1.0
    offset: float = 0.0


def parse_midi(data: bytes) -> list[DeviceEvent]:
    """Parse raw MIDI bytes into normalized DeviceEvents."""
    out = []
    i = 0
    while i + 1 < len(data):
        status = data[i]
        if status < 0x80:
            i += 1
            continue
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90 and i + 2 < len(data):  # note on
            note, vel = data[i + 1], data[i + 2]
            t = MIDI_NOTE_ON if vel > 0 else MIDI_NOTE_OFF
            out.append(DeviceEvent(EventKey(t, ch, note), vel / 127.0))
            i += 3
        elif kind == 0x80 and i + 2 < len(data):
            out.append(DeviceEvent(EventKey(MIDI_NOTE_OFF, ch, data[i + 1]),
                                   data[i + 2] / 127.0))
            i += 3
        elif kind == 0xB0 and i + 2 < len(data):  # CC
            out.append(DeviceEvent(EventKey(MIDI_CC, ch, data[i + 1]),
                                   data[i + 2] / 127.0))
            i += 3
        elif kind == 0xE0 and i + 2 < len(data):  # pitch bend
            v = (data[i + 1] | (data[i + 2] << 7)) / 8192.0 - 1.0
            out.append(DeviceEvent(EventKey(MIDI_PITCH_BEND, ch, 0), v))
            i += 3
        elif kind == 0xC0 and i + 1 < len(data):  # program change
            out.append(DeviceEvent(EventKey(MIDI_PGM_CHANGE, ch, 0),
                                   data[i + 1] / 127.0))
            i += 2
        else:
            i += 1
    return out


class OMCLearner:
    def __init__(self, player=None):
        self.player = player
        self.macros: dict[str, Macro] = {}
        self.mappings: dict[EventKey, Mapping] = {}
        self._learning: Optional[str] = None
        if player is not None:
            self._register_player_macros(player)

    # -- macro registry ----------------------------------------------------
    def add_macro(self, name: str, action: Callable[[float], None],
                  takes_value: bool = False):
        self.macros[name] = Macro(name, action, takes_value)

    def _register_player_macros(self, p):
        self.add_macro("play", lambda v: p.start())
        self.add_macro("stop", lambda v: p.stop())
        self.add_macro("fps", lambda v: p.set_pb_fps(v * 50.0), True)
        self.add_macro("fps_reverse",
                       lambda v: p.set_pb_fps(-p.state.pb_fps))
        self.add_macro("blend", lambda v: setattr(
            p.state, "blend_amount", v), True)
        self.add_macro("nervous", lambda v: setattr(
            p.state, "nervous", not p.state.nervous))
        for k in range(9):  # the 9 physical vj keys
            self.add_macro(f"key{k + 1}_toggle",
                           lambda v, k=k: p.key_toggle(k))

    # -- learn workflow (omc-learn.c learn mode) ---------------------------
    def start_learn(self, macro_name: str):
        if macro_name not in self.macros:
            raise KeyError(macro_name)
        self._learning = macro_name

    @property
    def learning(self) -> Optional[str]:
        return self._learning

    def feed(self, ev: DeviceEvent) -> bool:
        """Process one event: bind if learning, else dispatch. Returns
        True if the event did something."""
        if self._learning is not None:
            self.mappings[ev.key] = Mapping(ev.key, self._learning)
            self._learning = None
            return True
        m = self.mappings.get(ev.key)
        if m is None:
            return False
        macro = self.macros.get(m.macro)
        if macro is None:
            return False
        macro.action(ev.value * m.scale + m.offset)
        return True

    def feed_midi(self, data: bytes) -> int:
        n = 0
        for ev in parse_midi(data):
            if self.feed(ev):
                n += 1
        return n

    # -- device map persistence -------------------------------------------
    def save_map(self, path: str | Path):
        Path(path).write_text(json.dumps([
            {"etype": m.key.etype, "channel": m.key.channel,
             "index": m.key.index, "macro": m.macro,
             "scale": m.scale, "offset": m.offset}
            for m in self.mappings.values()], indent=1))

    def load_map(self, path: str | Path):
        self.mappings.clear()
        for d in json.loads(Path(path).read_text()):
            key = EventKey(d["etype"], d["channel"], d["index"])
            self.mappings[key] = Mapping(key, d["macro"], d["scale"],
                                         d["offset"])


def parse_js(data: bytes) -> list[DeviceEvent]:
    """Parse Linux joystick events (linux/joystick.h struct js_event:
    u32 time, s16 value, u8 type, u8 number — the reference's js path,
    omc-learn.c js_msgs). Init events (type & 0x80) are skipped."""
    import struct
    out = []
    for ofs in range(0, len(data) - 7, 8):
        _, value, jtype, number = struct.unpack_from("<IhBB", data, ofs)
        if jtype & 0x80:       # JS_EVENT_INIT: initial state dump
            continue
        if jtype & 0x02:       # JS_EVENT_AXIS
            out.append(DeviceEvent(EventKey(JS_AXIS, 0, number),
                                   value / 32767.0))
        elif jtype & 0x01:     # JS_EVENT_BUTTON
            out.append(DeviceEvent(EventKey(JS_BUTTON, 0, number),
                                   float(value)))
    return out


class JoystickReader:
    """Background reader for /dev/input/jsN feeding an OMCLearner —
    the reference's joystick device path (omc-learn.c), cleanly gated on
    device presence."""

    def __init__(self, learner: OMCLearner, device: str = "/dev/input/js0"):
        import os
        if not os.path.exists(device):
            raise RuntimeError(f"{device} absent")
        self.learner = learner
        self.device = device
        self._fd = None
        self._thread = None
        self._running = False

    def start(self):
        import os
        import threading
        self._fd = os.open(self.device, os.O_RDONLY)
        self._running = True

        def loop():
            import os as _os
            while self._running:
                try:
                    data = _os.read(self._fd, 8 * 32)
                except OSError:
                    break
                for ev in parse_js(data):
                    self.learner.feed(ev)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        import os
        self._running = False
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        if self._thread:
            self._thread.join(timeout=1)


def feed_js(learner: OMCLearner, data: bytes) -> int:
    """Feed raw joystick bytes (tests / bridges). Returns events handled."""
    n = 0
    for ev in parse_js(data):
        if learner.feed(ev):
            n += 1
    return n
