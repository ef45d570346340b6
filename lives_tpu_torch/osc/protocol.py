"""Minimal OSC 1.0 wire protocol (pure python, no deps).

Replaces the vendored libOSC (~4k LoC C) used by the reference's control
server (`src/osc.c`, `libOSC/`). Supports messages and bundles with
i/f/s/b/d/h/T/F/N argument types — everything the reference's ~392-method
namespace uses.

Counterpart of `lives_tpu/osc/protocol.py:1-115`, copied: the bytes
`build_message` writes are the JAX package's for every type tag, and
`parse_packet` reads the same messages and bundles.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any


@dataclass
class OSCMessage:
    address: str
    args: list[Any]


def _pad(b: bytes) -> bytes:
    return b + b"\0" * ((4 - len(b) % 4) % 4)


def _read_string(data: bytes, ofs: int) -> tuple[str, int]:
    end = data.index(b"\0", ofs)
    s = data[ofs:end].decode("utf-8", "replace")
    return s, (end + 4) & ~3


def _read_blob(data: bytes, ofs: int) -> tuple[bytes, int]:
    (n,) = struct.unpack(">i", data[ofs: ofs + 4])
    b = data[ofs + 4: ofs + 4 + n]
    return b, (ofs + 4 + n + 3) & ~3


def parse_message(data: bytes) -> OSCMessage:
    addr, ofs = _read_string(data, 0)
    args: list[Any] = []
    if ofs < len(data) and data[ofs: ofs + 1] == b",":
        tags, ofs = _read_string(data, ofs)
        for t in tags[1:]:
            if t == "i":
                (v,) = struct.unpack(">i", data[ofs: ofs + 4])
                ofs += 4
            elif t == "f":
                (v,) = struct.unpack(">f", data[ofs: ofs + 4])
                ofs += 4
            elif t == "d":
                (v,) = struct.unpack(">d", data[ofs: ofs + 8])
                ofs += 8
            elif t == "h":
                (v,) = struct.unpack(">q", data[ofs: ofs + 8])
                ofs += 8
            elif t == "s":
                v, ofs = _read_string(data, ofs)
            elif t == "b":
                v, ofs = _read_blob(data, ofs)
            elif t == "T":
                v = True
            elif t == "F":
                v = False
            elif t == "N":
                v = None
            else:
                raise ValueError(f"osc: unsupported type tag {t!r}")
            args.append(v)
    else:
        # typetag-less legacy messages: treat rest as raw
        args = []
    return OSCMessage(addr, args)


def parse_packet(data: bytes) -> list[OSCMessage]:
    """Parse a packet (message or #bundle) into messages."""
    if data[:8] == b"#bundle\0":
        out = []
        ofs = 16  # skip timetag
        while ofs + 4 <= len(data):
            (n,) = struct.unpack(">i", data[ofs: ofs + 4])
            out.extend(parse_packet(data[ofs + 4: ofs + 4 + n]))
            ofs += 4 + n
        return out
    return [parse_message(data)]


def build_message(address: str, *args: Any) -> bytes:
    tags = ","
    payload = b""
    for a in args:
        if isinstance(a, bool):
            tags += "T" if a else "F"
        elif isinstance(a, int):
            if -(1 << 31) <= a < (1 << 31):
                tags += "i"
                payload += struct.pack(">i", a)
            else:
                tags += "h"
                payload += struct.pack(">q", a)
        elif isinstance(a, float):
            tags += "f"
            payload += struct.pack(">f", a)
        elif isinstance(a, str):
            tags += "s"
            payload += _pad(a.encode() + b"\0")
        elif isinstance(a, (bytes, bytearray)):
            tags += "b"
            payload += struct.pack(">i", len(a)) + _pad(bytes(a))
        elif a is None:
            tags += "N"
        else:
            raise TypeError(f"osc: cannot encode {type(a)}")
    return _pad(address.encode() + b"\0") + _pad(tags.encode() + b"\0") \
        + payload
