"""Frame streaming over UDP — the LiVES-to-LiVES link.

Counterpart of `lives_tpu/stream.py:58-477` (`StreamSender`,
`StreamReceiver`, `l2l_frame_size`, `l2l_frame_header`,
`l2l_frame_datagrams`, `L2LSender`, `L2LParser`, `L2LReceiver`): host
Python, copied, with the same wire bytes. The port's parts are the two
ends of the wire. A sender fetches the device layer it is given once a
frame (`player.sinks.host_planes`, one copy) and serialises it with
`layer_to_bytes`; its `palette_list` (RGB24, YUV420P) lets a player with
a YUV420P `SinkSpec` convert on the card in the sink step (K3, one
launch a frame). A receiver is a live clip source that yields host
frames (`device="cpu"` layers, as the scrap reader does), which the
player uploads; a YUV420P stream is converted to RGB on the card by the
receiving player (K2, one launch a frame). Both ends count their
datagrams (`datagrams`) and the receivers the frames they completed
(`received`; the LTPU receiver also the partial frames it dropped,
`dropped`), so a loss shows.

Successor of `src/stream.c` (L2L packet protocol, receive) and
`lives-plugins/plugins/playback/video/lives2lives_stream.c` (send).

Two wire formats live here:

1. The reference **L2L packet protocol** (interoperable with a real LiVES
   peer) — `L2LSender` / `L2LParser` / `L2LReceiver`.  Spec, from
   `lives2lives_stream.c:295-336` (render_frame_stream) and
   `src/stream.c:188-412` (l2l_get_packet_sync / _get_packet_header /
   _parse_packet_header):

     "PACKET "                                    (7 bytes, sync token)
     ASCII header, space-separated:
       ptype id flags dsize [tc hsize vsize fps palette \
        sampling clamping subspace compression]
       (the bracketed fields are omitted when flags bit 0 —
        IS_CONTINUATION — is set; the sender emits
        "1 0 0 %d %ld %d %d %.8f %d 1 %d 0 0 ")
     "DATA"                                       (4 bytes)
     dsize payload bytes (RGB24 packed, or YUV420P planes Y,U,V)

   "STREND" replaces "PACKET " at end of stream.  The transport is UDP;
   each lives_stream_out() call is its own datagram (MTU-halved on
   EMSGSIZE), and the receiver treats the datagram sequence as a byte
   stream, resyncing on "PACKET " after loss (stream.c:188).

2. The native **LTPU datagram format** (fast-path extension, not
   interoperable): self-describing per-datagram headers so any single
   lost chunk drops only its own frame.  Kept as the default between
   two instances of this package; L2L is for talking to a real LiVES
   instance.

LTPU wire format per datagram (little-endian):
  magic u32 'LTPU' | frame_id u32 | palette u16 | w u16 | h u16 |
  chunk u16 | nchunks u16 | payload
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

import torch

from .constants import Palette
from .layer import Layer, layer_blank, layer_from_bytes, layer_to_bytes
from .player.sinks import Sink, host_planes

MAGIC = 0x4C545055  # 'LTPU'
HDR = struct.Struct("<IIHHHHH")
CHUNK_PAYLOAD = 60000


def frame_bytes(layer: Layer) -> bytes:
    """One frame's reference-format bytes: a device layer crosses to the
    host in one copy, then `layer_to_bytes`."""
    return layer_to_bytes(layer.replace(planes=tuple(
        torch.from_numpy(p) for p in host_planes(layer))))


class StreamSender(Sink):
    """Sends played frames to a remote receiver (playback-plugin role)."""

    palette_list = (Palette.RGB24, Palette.YUV420P)

    def __init__(self, host: str = "127.0.0.1", port: int = 48888):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.frame_id = 0
        self.datagrams = 0   # sent

    def play_frame(self, layer: Layer, tc: float) -> bool:
        payload = frame_bytes(layer)
        n = (len(payload) + CHUNK_PAYLOAD - 1) // CHUNK_PAYLOAD
        for c in range(n):
            part = payload[c * CHUNK_PAYLOAD: (c + 1) * CHUNK_PAYLOAD]
            hdr = HDR.pack(MAGIC, self.frame_id, int(layer.palette),
                           layer.width, layer.height, c, n)
            self.sock.sendto(hdr + part, self.addr)
            self.datagrams += 1
        self.frame_id += 1
        return True

    def exit_screen(self):
        self.sock.close()


class StreamReceiver:
    """Clip-like source fed by a StreamSender (CLIP_TYPE_LIVES2LIVES).

    `get_frame(n)` returns the newest complete frame (n is ignored — it is
    a live source), or black until the first frame lands."""

    def __init__(self, port: int = 48888, width: int = 0, height: int = 0,
                 fps: float = 25.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:  # large frames burst many chunks; grow the kernel buffer
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 << 20)
        except OSError:
            pass
        self.sock.bind(("0.0.0.0", port))
        self.port = self.sock.getsockname()[1]
        self.fps = fps
        self.frames = 1 << 30
        self.width, self.height = width, height
        self.unique_id = 0x121212
        self.scrap_on_record = True  # live feed: recordings scrap frames
        self._latest: Optional[Layer] = None
        # counts: datagrams taken, frames completed, partial frames
        # dropped (a datagram of theirs lost)
        self.datagrams = self.received = self.dropped = 0
        self._partial: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        self.sock.settimeout(0.5)
        while self._running:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            self.datagrams += 1
            if len(data) < HDR.size:
                continue
            magic, fid, pal, w, h, c, n = HDR.unpack_from(data)
            if magic != MAGIC:
                continue
            entry = self._partial.setdefault(
                fid, {"chunks": {}, "n": n, "pal": pal, "w": w, "h": h,
                      "t": time.monotonic()})
            entry["chunks"][c] = data[HDR.size:]
            if len(entry["chunks"]) == entry["n"]:
                payload = b"".join(entry["chunks"][i]
                                   for i in range(entry["n"]))
                try:
                    lay = layer_from_bytes(payload, entry["w"], entry["h"],
                                           entry["pal"], device="cpu")
                    with self._lock:
                        self._latest = lay
                        self.width, self.height = entry["w"], entry["h"]
                    self.received += 1
                except Exception:
                    pass
                del self._partial[fid]
            # GC stale partial frames (drop-late policy)
            now = time.monotonic()
            for k in [k for k, v in self._partial.items()
                      if now - v["t"] > 1.0]:
                del self._partial[k]
                self.dropped += 1

    def get_frame(self, n: int) -> Layer:
        with self._lock:
            if self._latest is not None:
                return self._latest
        w = self.width or 64
        h = self.height or 64
        return layer_blank(w, h, Palette.RGB24, device="cpu")

    def close(self):
        self._running = False
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Reference L2L packet protocol (interop with a real LiVES peer)
# ---------------------------------------------------------------------------

L2L_PACKET_LEN = 1024            # stream.c:15
L2L_STREAM_TYPE_VIDEO = 1        # lives2lives_stream.c header comment
L2L_FLAG_IS_CONTINUATION = 1     # LIVES_VSTREAM_FLAGS_IS_CONTINUATION
L2L_TICKS_PER_SECOND = 100_000_000   # src/timing.h:6 — global timebase

_L2L_MAX_DSIZE = 1 << 28         # sanity cap: 4K RGBA is ~33 MB; a
# hostile header claiming more is garbage, not a frame (untrusted input)
_L2L_SYNC = b"PACKET "
_L2L_STREND = b"STREND"
_L2L_DATA = b"DATA"


def l2l_frame_size(palette: int, width: int, height: int) -> int:
    """Full-frame byte count for the palettes the reference streams
    (lives2lives_stream.c:318-319)."""
    pal = Palette(palette)
    if pal == Palette.RGB24:
        return width * height * 3
    if pal == Palette.YUV420P:
        return width * height * 3 // 2
    raise ValueError(f"L2L streams RGB24 or YUV420P, not {pal!r}")


def l2l_frame_header(dsize: int, tc_ticks: int, width: int, height: int,
                     fps: float, palette: int, clamping: int) -> bytes:
    """ASCII packet header, byte-exact with the reference sender's
    snprintf format (lives2lives_stream.c:321-322):
    ``"1 0 0 %d %ld %d %d %.8f %d 1 %d 0 0 "``
    (ptype=video, stream id 0, flags 0, then dsize tc hsize vsize fps
    palette sampling=1 clamping subspace=0 compression=0)."""
    return ("1 0 0 %d %d %d %d %.8f %d 1 %d 0 0 "
            % (dsize, tc_ticks, width, height, fps,
               int(palette), int(clamping))).encode("ascii")


def l2l_frame_datagrams(layer: Layer, tc: float, fps: float,
                        mtu: int = 60000) -> list[bytes]:
    """Encode one frame as the reference datagram sequence:
    sync token, header, "DATA", then payload split plane-wise and
    MTU-chunked (each ``lives_stream_out`` call in the reference is its
    own datagram; sendudp halves oversize chunks, lives2lives_stream.c:126)."""
    payload = frame_bytes(layer)
    dsize = l2l_frame_size(layer.palette, layer.width, layer.height)
    if len(payload) != dsize:  # defensive: Layer must be compact
        raise ValueError("frame payload size mismatch")
    tc_ticks = int(round(tc * L2L_TICKS_PER_SECOND))
    out = [_L2L_SYNC,
           l2l_frame_header(dsize, tc_ticks, layer.width, layer.height,
                            fps, layer.palette, layer.clamping),
           _L2L_DATA]
    for off in range(0, dsize, mtu):
        out.append(payload[off: off + mtu])
    return out


class L2LSender(Sink):
    """Streams played frames in the reference LiVES-to-LiVES wire format
    (playback-plugin role, lives2lives_stream.c:310-337). A real LiVES
    instance receiving on (host, port) via 'Receive LiVES stream from...'
    can display this stream."""

    palette_list = (Palette.RGB24, Palette.YUV420P)

    def __init__(self, host: str = "127.0.0.1", port: int = 8888,
                 mtu: int = 60000):
        self.addr = (host, port)
        self.mtu = mtu
        self.fps = 25.0
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                 4 << 20)
        except OSError:
            pass
        self.datagrams = 0   # sent

    def init_screen(self, width: int, height: int, fps: float):
        self.fps = float(fps)

    def play_frame(self, layer: Layer, tc: float) -> bool:
        try:
            for dgram in l2l_frame_datagrams(layer, tc, self.fps, self.mtu):
                self.sock.sendto(dgram, self.addr)
                self.datagrams += 1
        except OSError:
            return False
        return True

    def exit_screen(self):
        try:  # "on stream end send STREND" (lives2lives_stream.c:352)
            self.sock.sendto(_L2L_STREND, self.addr)
            self.datagrams += 1
        except OSError:
            pass
        self.sock.close()


class L2LParser:
    """Incremental byte-stream parser for the reference packet protocol.

    Mirrors the receive path of `src/stream.c`:
      - resync by scanning for "PACKET " (l2l_get_packet_sync:188)
      - header chars accumulate until "DATA" (l2l_get_packet_header:248,
        >1000 header bytes = garbage, resync)
      - parse space-split fields; wrong type/id packets are skipped whole
        (lives2lives_read_stream:525 "dropping it")
      - continuation packets (flags bit 0) append payload to the current
        frame; a fresh non-continuation header while a frame is short
        delivers what arrived, zero-padded ("just return what we have",
        stream.c:708)
    Feed raw received bytes; completed frames come back as Layers.
    """

    def __init__(self, stream_id: int = 0):
        self.stream_id = stream_id
        self.ended = False
        self.fps = 0.0
        self.last_tc_ticks = 0
        self._buf = bytearray()
        self._need = 0          # payload bytes still owed to current packet
        self._skip = False      # current packet is foreign: discard payload
        self._meta: Optional[dict] = None   # current frame metadata
        self._acc = bytearray()             # current frame payload

    # -- internals ----------------------------------------------------

    def _start_frame(self, fields: list[bytes]) -> None:
        (tc, hsize, vsize, fps, pal, sampling, clamping, subspace,
         compression) = fields[4:13]
        meta = {
            "tc_ticks": int(tc), "width": int(hsize), "height": int(vsize),
            "fps": float(fps), "palette": int(pal),
            "sampling": int(sampling), "clamping": int(clamping),
            "subspace": int(subspace), "compression": int(compression),
        }
        # untrusted input: an unknown palette raises here (caught by the
        # caller -> packet skipped), and hostile geometry whose frame
        # would dwarf any real stream is rejected instead of letting
        # _emit allocate petabytes of padding
        if not (0 < l2l_frame_size(meta["palette"], meta["width"],
                                   meta["height"]) <= _L2L_MAX_DSIZE):
            raise ValueError("hostile L2L frame geometry")
        self._meta = meta
        self.fps = self._meta["fps"]
        self._acc = bytearray()

    def _emit(self, frames: list[Layer]) -> None:
        m = self._meta
        self._meta = None
        if m is None:
            return
        try:
            expect = l2l_frame_size(m["palette"], m["width"], m["height"])
        except ValueError:
            return
        buf = self._acc
        if len(buf) < expect:
            buf = buf + bytes(expect - len(buf))
        try:
            frames.append(layer_from_bytes(
                bytes(buf[:expect]), m["width"], m["height"], m["palette"],
                device="cpu", clamping=m["clamping"],
                sampling=m["sampling"], subspace=m["subspace"]))
            self.last_tc_ticks = m["tc_ticks"]
        except Exception:
            pass

    # -- public -------------------------------------------------------

    def feed(self, data: bytes) -> list[Layer]:
        self._buf.extend(data)
        frames: list[Layer] = []
        buf = self._buf
        while True:
            if self._need:
                take = min(self._need, len(buf))
                if not take:
                    break
                # accumulate only while a frame is open: once _emit
                # consumed the metadata, excess payload (hostile dsize
                # larger than the declared frame) is discarded instead
                # of growing _acc unboundedly
                if not self._skip and self._meta is not None:
                    self._acc.extend(buf[:take])
                del buf[:take]
                self._need -= take
                if self._need:
                    break
                if (not self._skip and self._meta is not None
                        and len(self._acc) >= l2l_frame_size(
                            self._meta["palette"], self._meta["width"],
                            self._meta["height"])):
                    self._emit(frames)
                self._skip = False
                continue
            # hunt for a sync token
            i = buf.find(_L2L_SYNC)
            j = buf.find(_L2L_STREND)
            if j != -1 and (i == -1 or j < i):
                self.ended = True
                if self._meta is not None and self._acc:
                    self._emit(frames)  # flush the in-flight frame
                del buf[:j + len(_L2L_STREND)]
                continue
            if i == -1:
                # keep a tail that might be a split token
                if len(buf) > len(_L2L_SYNC):
                    del buf[:len(buf) - len(_L2L_SYNC)]
                break
            d = buf.find(_L2L_DATA, i + len(_L2L_SYNC))
            if d == -1:
                if len(buf) - i - len(_L2L_SYNC) > 1000:
                    del buf[:i + len(_L2L_SYNC)]  # garbage header: resync
                    continue
                break
            hdr = bytes(buf[i + len(_L2L_SYNC): d])
            del buf[:d + len(_L2L_DATA)]
            fields = hdr.split()
            try:
                ptype, pid, flags, dsize = (int(fields[0]), int(fields[1]),
                                            int(fields[2]), int(fields[3]))
            except (IndexError, ValueError):
                continue  # malformed header: resync on next token
            if dsize < 0 or dsize > _L2L_MAX_DSIZE:
                continue  # hostile size field: resync on next token
            self._need = dsize
            if ptype != L2L_STREAM_TYPE_VIDEO or pid != self.stream_id:
                self._skip = True       # foreign packet: drop payload whole
                continue
            if flags & L2L_FLAG_IS_CONTINUATION:
                self._skip = self._meta is None  # continuation w/o a frame
                continue
            try:
                if self._meta is not None and self._acc:
                    self._emit(frames)  # truncated predecessor: deliver
                self._start_frame(fields)
                self._skip = False
            except (IndexError, ValueError):
                self._meta = None
                self._skip = True
        return frames


class L2LReceiver:
    """Clip-like source fed by a reference-format L2L stream
    (CLIP_TYPE_LIVES2LIVES role, `src/stream.c:415`
    lives2lives_read_stream). Presents the same surface as
    StreamReceiver: newest complete frame wins."""

    def __init__(self, port: int = 8888, width: int = 0, height: int = 0,
                 fps: float = 25.0, stream_id: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 << 20)
        except OSError:
            pass
        self.sock.bind(("0.0.0.0", port))
        self.port = self.sock.getsockname()[1]
        self.fps = fps
        self.frames = 1 << 30
        self.width, self.height = width, height
        self.unique_id = 0x121213
        self.scrap_on_record = True  # live feed: recordings scrap frames
        self.ended = False
        self._parser = L2LParser(stream_id)
        self._latest: Optional[Layer] = None
        # counts: datagrams taken, frames the parser delivered
        self.datagrams = self.received = 0
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        self.sock.settimeout(0.5)
        while self._running:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            self.datagrams += 1
            try:
                frames = self._parser.feed(data)
            except Exception:
                # defense in depth: a parser bug on hostile bytes must
                # not kill the receive thread — drop state and resync
                self._parser = L2LParser(self._parser.stream_id)
                continue
            self.received += len(frames)
            if frames:
                with self._lock:
                    self._latest = frames[-1]
                    self.width = frames[-1].width
                    self.height = frames[-1].height
                if self._parser.fps > 0:
                    self.fps = self._parser.fps
            if self._parser.ended:
                self.ended = True

    def get_frame(self, n: int) -> Layer:
        with self._lock:
            if self._latest is not None:
                return self._latest
        w = self.width or 64
        h = self.height or 64
        return layer_blank(w, h, Palette.RGB24, device="cpu")

    def close(self):
        self._running = False
        try:
            self.sock.close()
        except OSError:
            pass
