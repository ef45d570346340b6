"""LADSPA bridge: host LADSPA 1.1 audio plugins as audio effects.

Counterpart of `lives_tpu/audio/ladspa.py:1-179` (reference
`lives-plugins/weed-plugins/ladspa.c`). A pure-ctypes host of the LADSPA
1.1 ABI, no SDK headers needed: plugins are searched in $LADSPA_PATH
(default /usr/lib/ladspa), and where none exist the scan is empty. The
JAX module imports no framework; the port keeps its own copy. Blocks are
host float32 arrays of shape (n, channels).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# port descriptor flags (ladspa.h)
PORT_INPUT = 0x1
PORT_OUTPUT = 0x2
PORT_CONTROL = 0x4
PORT_AUDIO = 0x8

LADSPA_Data = ctypes.c_float
LADSPA_Handle = ctypes.c_void_p


class PortRangeHint(ctypes.Structure):
    _fields_ = [("HintDescriptor", ctypes.c_int),
                ("LowerBound", LADSPA_Data),
                ("UpperBound", LADSPA_Data)]


class Descriptor(ctypes.Structure):
    pass


Descriptor._fields_ = [
    ("UniqueID", ctypes.c_ulong),
    ("Label", ctypes.c_char_p),
    ("Properties", ctypes.c_int),
    ("Name", ctypes.c_char_p),
    ("Maker", ctypes.c_char_p),
    ("Copyright", ctypes.c_char_p),
    ("PortCount", ctypes.c_ulong),
    ("PortDescriptors", ctypes.POINTER(ctypes.c_int)),
    ("PortNames", ctypes.POINTER(ctypes.c_char_p)),
    ("PortRangeHints", ctypes.POINTER(PortRangeHint)),
    ("ImplementationData", ctypes.c_void_p),
    ("instantiate", ctypes.CFUNCTYPE(LADSPA_Handle,
                                     ctypes.POINTER(Descriptor),
                                     ctypes.c_ulong)),
    ("connect_port", ctypes.CFUNCTYPE(None, LADSPA_Handle, ctypes.c_ulong,
                                      ctypes.POINTER(LADSPA_Data))),
    ("activate", ctypes.CFUNCTYPE(None, LADSPA_Handle)),
    ("run", ctypes.CFUNCTYPE(None, LADSPA_Handle, ctypes.c_ulong)),
    ("run_adding", ctypes.c_void_p),
    ("set_run_adding_gain", ctypes.c_void_p),
    ("deactivate", ctypes.CFUNCTYPE(None, LADSPA_Handle)),
    ("cleanup", ctypes.CFUNCTYPE(None, LADSPA_Handle)),
]

_descriptor_fn_t = ctypes.CFUNCTYPE(ctypes.POINTER(Descriptor),
                                    ctypes.c_ulong)


@dataclass
class LadspaPlugin:
    path: str
    index: int
    label: str
    name: str
    n_audio_in: int
    n_audio_out: int
    controls: list[tuple[int, str, float, float]]  # (port, name, lo, hi)


def search_paths() -> list[Path]:
    env = os.environ.get("LADSPA_PATH", "/usr/lib/ladspa")
    return [Path(p) for p in env.split(":") if Path(p).is_dir()]


def scan_plugins() -> list[LadspaPlugin]:
    """Enumerate available LADSPA plugins (ladspa.c plugin scan)."""
    out = []
    for d in search_paths():
        for so in sorted(d.glob("*.so")):
            try:
                lib = ctypes.CDLL(str(so))
                fn = _descriptor_fn_t(("ladspa_descriptor", lib))
            except (OSError, AttributeError):
                continue
            idx = 0
            while True:
                try:
                    desc_p = fn(idx)
                except Exception:
                    break
                if not desc_p:
                    break
                d0 = desc_p.contents
                na_in = na_out = 0
                controls = []
                for p in range(d0.PortCount):
                    pd = d0.PortDescriptors[p]
                    pname = d0.PortNames[p].decode("utf-8", "replace")
                    if pd & PORT_AUDIO:
                        if pd & PORT_INPUT:
                            na_in += 1
                        else:
                            na_out += 1
                    elif pd & PORT_CONTROL and pd & PORT_INPUT:
                        h = d0.PortRangeHints[p]
                        controls.append((p, pname, float(h.LowerBound),
                                         float(h.UpperBound)))
                out.append(LadspaPlugin(str(so), idx,
                                        d0.Label.decode(), d0.Name.decode(),
                                        na_in, na_out, controls))
                idx += 1
    return out


class LadspaInstance:
    """One running plugin instance processing float32 blocks."""

    def __init__(self, plugin: LadspaPlugin, rate: int = 44100):
        self.plugin = plugin
        lib = ctypes.CDLL(plugin.path)
        fn = _descriptor_fn_t(("ladspa_descriptor", lib))
        self.desc = fn(plugin.index).contents
        self.handle = self.desc.instantiate(ctypes.pointer(self.desc), rate)
        self.controls = {name: ctypes.c_float((lo + hi) / 2 if hi > lo
                                              else 1.0)
                         for _, name, lo, hi in plugin.controls}
        self._ctrl_ports = {name: port
                            for port, name, _, _ in plugin.controls}
        for name, buf in self.controls.items():
            self.desc.connect_port(self.handle, self._ctrl_ports[name],
                                   ctypes.byref(buf))
        if self.desc.activate:
            self.desc.activate(self.handle)

    def set_control(self, name: str, value: float):
        self.controls[name].value = value

    def run(self, block: np.ndarray) -> np.ndarray:
        """block: (n, channels) float32 -> processed (n, out_channels)."""
        d0 = self.desc
        n = len(block)
        ins, outs = [], []
        ai = 0
        out_arrs = []
        for p in range(d0.PortCount):
            pd = d0.PortDescriptors[p]
            if not pd & PORT_AUDIO:
                continue
            if pd & PORT_INPUT:
                ch = np.ascontiguousarray(
                    block[:, min(ai, block.shape[1] - 1)], np.float32)
                ins.append(ch)
                d0.connect_port(self.handle, p, ch.ctypes.data_as(
                    ctypes.POINTER(LADSPA_Data)))
                ai += 1
            else:
                o = np.zeros(n, np.float32)
                out_arrs.append(o)
                d0.connect_port(self.handle, p, o.ctypes.data_as(
                    ctypes.POINTER(LADSPA_Data)))
        d0.run(self.handle, n)
        if not out_arrs:
            return block
        return np.stack(out_arrs, 1)

    def close(self):
        if self.handle and self.desc.cleanup:
            if self.desc.deactivate:
                self.desc.deactivate(self.handle)
            self.desc.cleanup(self.handle)
            self.handle = None
