"""FireWire DV / HDV camera grab.

Counterpart of `lives_tpu/io/dvgrab.py:1-288` (reference `src/ldvgrab.c`
and `src/ldvcallbacks.c`: AVC-VCR discovery over raw1394 ports, camready
`ldvgrab.c:132`; tape transport, camplay/camstop/camrew/camff/campause/
cameject `:209-256`; capture to file with autosplit naming,
find_free_camfile `:262` and rec `:298`). The JAX module imports no
framework; the port keeps its own copy, so the files it writes are the JAX
assembler's byte for byte.

The capture runs in-process: isochronous packets are CIP-unwrapped and DV
frames assembled at DIF-sequence boundaries; HDV passes its MPEG2-TS
payload through. Captured files open as clips through the libav lane
(`io/av.py`), where `load_avbridge()` builds; `api.LiVESApp.grab_firewire`
does both steps.

ctypes binding, gated: `load_firewire_libs()` returns None where
libraw1394, librom1394 or libavc1394 is absent, and every class takes
injected libs, so discovery, transport and assembly run against mocks
(tests/test_torch_dvgrab.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

CAM_FORMAT_DV = 0    # ldvgrab.h camera formats
CAM_FORMAT_HDV = 1

# librom1394 rom1394_node_types: UNKNOWN=0 DC=1 AVC=2 SBP2=3 CPU=4
ROM1394_NODE_TYPE_AVC = 2
# libavc1394 subunit type field (avc1394.h): tape recorder/player
AVC1394_SUBUNIT_TYPE_VCR = 4 << 19

#: exact DV frame sizes (libdv): 10/12 DIF sequences x 150 blocks x 80
DV_FRAME_NTSC = 120000
DV_FRAME_PAL = 144000
_DIF_BLOCK = 480          # DV iso payload per packet after the CIP header
_CIP_HEADER = 8           # IEC 61883-1 CIP header on every data packet


def load_firewire_libs():
    """dlopen the raw1394/rom1394/avc1394 triple; None when any is
    missing (gated feature — `ldvgrab.c` is compiled out the same way
    under HAVE_LDVGRAB)."""
    libs = []
    for stem in ("libraw1394.so.11", "libraw1394.so"), \
                ("librom1394.so.0", "librom1394.so"), \
                ("libavc1394.so.0", "libavc1394.so"):
        for name in stem:
            try:
                libs.append(ctypes.CDLL(name))
                break
            except OSError:
                continue
        else:
            return None
    return tuple(libs)


class _PortInfo(ctypes.Structure):
    """struct raw1394_portinfo (raw1394.h)."""
    _fields_ = [("nodes", ctypes.c_int), ("name", ctypes.c_char * 32)]


class FirewireCamera:
    """One AVC tape device on the 1394 bus (the reference `s_cam`).

    `find()` is camready (`ldvgrab.c:132`): walk every port, then every
    node on the port, keep the first whose config-ROM directory says
    AVC and whose subunit table includes a VCR.
    """

    def __init__(self, libs, handle, port: int, device: int):
        self._raw, self._rom, self._avc = libs
        self.handle = handle
        self.port = port
        self.device = device

    # -- discovery ------------------------------------------------------

    @classmethod
    def find(cls, libs=None) -> Optional["FirewireCamera"]:
        libs = libs or load_firewire_libs()
        if libs is None:
            return None
        raw, rom, avc = libs
        handle = raw.raw1394_new_handle()
        if not handle:
            return None
        pinf = (_PortInfo * 16)()
        n_ports = raw.raw1394_get_port_info(handle, pinf, 16)
        if n_ports < 0:
            raw.raw1394_destroy_handle(handle)
            return None
        for port in range(n_ports):
            if raw.raw1394_set_port(handle, port) < 0:
                continue
            for node in range(raw.raw1394_get_nodecount(handle)):
                # rom_dir is opaque to us; 1 KiB covers the struct on
                # every librom1394 release (it memsets what it uses)
                rom_dir = ctypes.create_string_buffer(1024)
                if rom.rom1394_get_directory(handle, node, rom_dir) < 0:
                    continue
                if (rom.rom1394_get_node_type(rom_dir)
                        == ROM1394_NODE_TYPE_AVC
                        and avc.avc1394_check_subunit_type(
                            handle, node, AVC1394_SUBUNIT_TYPE_VCR)):
                    return cls(libs, handle, port, node)
        raw.raw1394_destroy_handle(handle)
        return None

    # -- transport (avc1394_vcr_*, `ldvgrab.c:209`) ----------------------

    def play(self):
        self._avc.avc1394_vcr_play(self.handle, self.device)

    def stop(self):
        self._avc.avc1394_vcr_stop(self.handle, self.device)

    def pause(self):
        self._avc.avc1394_vcr_pause(self.handle, self.device)

    def rewind(self):
        self._avc.avc1394_vcr_rewind(self.handle, self.device)

    def forward(self):
        self._avc.avc1394_vcr_forward(self.handle, self.device)

    def eject(self):
        self._avc.avc1394_vcr_eject(self.handle, self.device)

    def close(self):
        if self.handle:
            self._raw.raw1394_destroy_handle(self.handle)
            self.handle = None


class DVFrameAssembler:
    """Reassemble complete DV frames from CIP-wrapped iso packets.

    A DV frame starts at the DIF block whose 3-byte id has section
    type HEADER (SCT=0) in DIF sequence 0 (Dseq=0) — the libdv frame
    boundary rule the dvgrab capture loop uses. Packets shorter than
    CIP+480 are empty CIP keepalives and are dropped
    (`ldvgrab.c:27` raw_iso_handler keeps only data packets).
    """

    def __init__(self):
        self._buf = bytearray()
        self.frames_dropped = 0

    @staticmethod
    def _is_frame_start(block: bytes) -> bool:
        return (block[0] >> 5) == 0 and (block[1] >> 4) == 0

    def feed(self, packet: bytes) -> list[bytes]:
        """One iso packet in; zero or more COMPLETE frames out."""
        if len(packet) < _CIP_HEADER + _DIF_BLOCK:
            return []
        payload = packet[_CIP_HEADER:]
        out = []
        for ofs in range(0, len(payload) - _DIF_BLOCK + 1, _DIF_BLOCK):
            chunk = payload[ofs:ofs + _DIF_BLOCK]
            if self._is_frame_start(chunk):
                if len(self._buf) in (DV_FRAME_NTSC, DV_FRAME_PAL):
                    out.append(bytes(self._buf))
                elif self._buf:
                    self.frames_dropped += 1   # incomplete: bus reset etc
                self._buf = bytearray()
            self._buf.extend(chunk)
        return out


def find_free_camfile(dirname: Path, base: str, fmt: int) -> Path:
    """First unused capture filename — reference naming exactly
    (`ldvgrab.c:262`): `<base>%03d.dv` for DV, `<base>%04d.mpg` for
    HDV."""
    if fmt == CAM_FORMAT_HDV:
        names = (f"{base}{i:04d}.mpg" for i in range(1, 10000))
    else:
        names = (f"{base}{i:03d}.dv" for i in range(1, 1000))
    for name in names:
        p = Path(dirname) / name
        if not p.exists():
            return p
    raise FileExistsError(f"no free camfile under {dirname}")


@dataclass
class DVGrabSession:
    """Capture-to-file with autosplit (the in-process `rec`,
    `ldvgrab.c:298`). DV: assembled frames append to the current
    `.dv` file; autosplit opens a new file whenever frames were
    dropped in between (recording gap — the dvgrab -autosplit role).
    HDV: the MPEG2-TS payload streams through unparsed."""

    dirname: Path
    base: str = "dvgrab-"
    fmt: int = CAM_FORMAT_DV
    autosplit: bool = False
    files: list[Path] = field(default_factory=list)
    frames_written: int = 0
    _asm: DVFrameAssembler = field(default_factory=DVFrameAssembler)
    _fh: object = None
    _dropped_seen: int = 0

    def _open_next(self):
        self._close_fh()
        path = find_free_camfile(Path(self.dirname), self.base, self.fmt)
        self._fh = open(path, "wb")
        self.files.append(path)

    def _close_fh(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def feed_packet(self, packet: bytes):
        if self.fmt == CAM_FORMAT_HDV:
            if len(packet) <= _CIP_HEADER:
                return
            if self._fh is None:
                self._open_next()
            self._fh.write(packet[_CIP_HEADER:])
            return
        for frame in self._asm.feed(packet):
            if self._fh is None or (
                    self.autosplit
                    and self._asm.frames_dropped > self._dropped_seen):
                self._dropped_seen = self._asm.frames_dropped
                self._open_next()
            self._fh.write(frame)
            self.frames_written += 1

    def split(self):
        """Manual split point: next frame starts a new file."""
        self._close_fh()

    def close(self) -> list[Path]:
        self._close_fh()
        # drop zero-byte leftovers (grab stopped before the first frame)
        keep = []
        for p in self.files:
            if p.stat().st_size:
                keep.append(p)
            else:
                p.unlink()
        self.files = keep
        return keep


def grab(cam: FirewireCamera, session: DVGrabSession,
         max_frames: int = 0, max_iterations: int = 1_000_000,
         channel: int = 63) -> list[Path]:
    """Run the iso receive loop until `max_frames` DV frames landed
    (the `ldvgrab.c` RX_CHANNEL=63 receive path + the blocking capture
    the dvgrab child performed). Transport must already be rolling
    (`cam.play()`); stops the receive, not the tape."""
    raw = cam._raw
    done = {"n": 0}

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_size_t, ctypes.c_void_p)
    def handler(_handle, chan, length, data):
        if chan == channel and length and data:
            session.feed_packet(ctypes.string_at(data, length))
            done["n"] = session.frames_written
        return 0

    if hasattr(raw, "raw1394_set_iso_handler"):
        raw.raw1394_set_iso_handler(cam.handle, channel, handler)
    if hasattr(raw, "raw1394_start_iso_rcv"):
        raw.raw1394_start_iso_rcv(cam.handle, channel)
    try:
        for _ in range(max_iterations):
            if raw.raw1394_loop_iterate(cam.handle) < 0:
                break
            if max_frames and done["n"] >= max_frames:
                break
    finally:
        if hasattr(raw, "raw1394_stop_iso_rcv"):
            raw.raw1394_stop_iso_rcv(cam.handle, channel)
    return session.close()
