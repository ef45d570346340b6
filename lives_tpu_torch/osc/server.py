"""OSC control server + notify sockets.

Successor of `src/osc.c` (UDP server, ~392 methods, osc.c:6694 table) and
the notify protocol (`src/osc_notify.h`: messages `msg_number|msg_string\\n`
pushed to subscribed UDP clients on state changes).

The method namespace mirrors the reference's (/video/play, /clip/select,
/effect_key/enable, /clip/foreground/fps/set, ...), bound to a Player.
Unknown paths reply via /error on the status socket if one is open.

Counterpart of `lives_tpu/osc/server.py:1-422` over the port's `Player`:
the same `NOTIFY` numbers (`:21`), sockets (`:151`), structured `/error`
replies (`:110-125`) and built-in table (`:177`); `register_extended`
(`osc/namespace.py`) binds the rest. Packets are dispatched on the
server's own thread while the player serves on another: on a CUDA player
each handler runs with the player's device current (`torch.cuda.device`),
and every handler that renders (`/clip/encode_as` here, the namespace's
`/record/render`, `/mt/render`, `/clip/save_as`, ...) names the player's
device explicitly. `/app/version/get` answers the port's own version.
"""

from __future__ import annotations

import socket
import threading
from typing import Any, Callable, Optional

from .protocol import OSCMessage, build_message, parse_packet


def _version() -> str:
    from .. import __version__
    return __version__


class NOTIFY:
    """osc_notify.h event numbers (subset used so far)."""
    FRAME_SYNCH = 1
    PLAYBACK_STARTED = 2
    PLAYBACK_STOPPED = 3
    PLAYBACK_STOPPED_RD = 4
    RECORD_STARTED = 32
    RECORD_STOPPED = 33
    APP_QUIT = 64
    CLIP_OPENED = 512
    CLIP_CLOSED = 513
    CLIPSET_OPENED = 1024
    CLIPSET_SAVED = 1025
    SUCCESS = 8192
    FAILED = 8193
    CANCELLED = 8194
    MODE_CHANGED = 4096
    # extension range (no reference analogue; > USER1 base): multitrack
    # editing notifications for the liblives-style multitrack/block API
    BLOCK_INSERTED = 16384
    BLOCK_DELETED = 16385
    BLOCK_MOVED = 16386
    MT_TRACK_CHANGED = 16387
    MT_TIME_CHANGED = 16388
    LAYOUT_WIPED = 16389
    MT_RENDERED = 16390


#: number -> name for console mirroring (FRAME_SYNCH excluded: per-frame)
_NOTIFY_NAMES = {v: k.lower().replace("_", " ")
                 for k, v in vars(NOTIFY).items()
                 if isinstance(v, int) and k != "FRAME_SYNCH"}


class OSCServer:
    def __init__(self, player=None, host: str = "127.0.0.1", port: int = 0):
        self.player = player
        self.host = host
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self.methods: dict[str, Callable[..., Any]] = {}
        # per-instance clip registry for /clip/select (id -> clip object);
        # must not be shared across servers in one process
        self.clips: dict[int, Any] = {}
        self._notify_clients: list[tuple[str, int]] = []
        self._status_client: Optional[tuple[str, int]] = None
        self._reply_client: Optional[tuple[str, int]] = None
        self._msg_no = 0
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._register_builtin()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        try:
            # unblock recvfrom
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM).sendto(
                b"", (self.host, self.port))
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2)
        self.sock.close()

    def _loop(self):
        self.sock.settimeout(0.5)
        while self._running:
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                continue
            try:
                for msg in parse_packet(data):
                    self.dispatch(msg, addr)
            except Exception as e:  # malformed packet: report, keep serving
                self._status(f"error parsing packet: {e}")

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, msg: OSCMessage, addr=None):
        fn = self.methods.get(msg.address)
        if fn is None:
            self._reply(addr, "/error", msg.address, "unknown method")
            self._status(f"unknown method {msg.address}")
            return False
        try:
            with self._device_ctx():
                ret = fn(*msg.args)
        except Exception as e:
            # structured failure: /error <path> <message> back to the
            # requester (+ free text on the status socket)
            self._reply(addr, "/error", msg.address, str(e))
            self._status(f"error in {msg.address}: {e}")
            from ..messaging import console
            console.d_print(f"{msg.address}: {e}", "error")
            return False
        if ret is not None:
            # structured reply: query results echo back on the request
            # path to /reply_to (or the sender's source address)
            if isinstance(ret, (list, tuple)):
                self._reply(addr, msg.address, *ret)
            else:
                self._reply(addr, msg.address, ret)
            self._status(str(ret))
        return True

    def _device_ctx(self):
        """The player's CUDA device made current on the dispatching
        thread (its current device starts at 0); a no-op on the CPU."""
        import contextlib
        dev = getattr(self.player, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _reply(self, addr, path: str, *args):
        target = self._reply_client or addr
        if target is None:
            return
        try:
            args = tuple(a if isinstance(a, (int, float, str, bool, bytes))
                         else str(a) for a in args)
            self.sock.sendto(build_message(path, *args), target)
        except OSError:
            pass

    def add_method(self, path: str, fn: Callable[..., Any]):
        self.methods[path] = fn

    # -- notify / status sockets (osc_notify.h protocol) -------------------
    def notify(self, msg_number: int, msg_string: str = ""):
        # Mirror every notification into the message console: the
        # reference d_prints around the same events its notify socket
        # announces (clip opened/closed, playback, record start/stop —
        # src/messaging.c d_print; osc_notify.h numbers).
        name = _NOTIFY_NAMES.get(int(msg_number))
        if name is not None:          # FRAME_SYNCH et al stay off-console
            from ..messaging import console
            console.d_print(
                f"{name}{': ' + msg_string if msg_string else ''}",
                "info")
        payload = f"{msg_number}|{msg_string}\n\0".encode()
        for client in list(self._notify_clients):
            try:
                self.sock.sendto(payload, client)
            except OSError:
                self._notify_clients.remove(client)

    def _status(self, s: str):
        if self._status_client:
            try:
                self.sock.sendto((s + "\n\0").encode(), self._status_client)
            except OSError:
                pass

    # -- builtin namespace (subset of osc.c:6694 table, same paths) --------
    def _register_builtin(self):
        p = lambda: self.player
        m = self.add_method

        m("/lives/open_notify_socket",
          lambda port, host="127.0.0.1": self._notify_clients.append(
              (host, int(port))))
        m("/lives/close_notify_socket",
          lambda port=None: self._notify_clients.clear())
        m("/app/open_status_socket",
          lambda port, host="127.0.0.1": setattr(
              self, "_status_client", (host, int(port))))
        m("/app/ping", lambda: "pong")
        m("/app/name", lambda: "lives_tpu")
        m("/app/version/get", _version)
        m("/app/quit", lambda: self.notify(NOTIFY.APP_QUIT))

        # video transport
        def play():
            p().start()
            self.notify(NOTIFY.PLAYBACK_STARTED)

        def stop():
            p().stop()
            self.notify(NOTIFY.PLAYBACK_STOPPED)

        m("/video/play", play)
        m("/video/stop", stop)
        m("/video/pause/toggle",
          lambda: setattr(p().state, "playing", not p().state.playing))
        m("/video/fps/set", lambda fps: p().set_pb_fps(float(fps)))
        m("/video/fps/get", lambda: p().state.pb_fps)
        m("/video/play/forwards", lambda: p().set_pb_fps(
            abs(p().state.pb_fps)))
        m("/video/play/backwards", lambda: p().set_pb_fps(
            -abs(p().state.pb_fps)))
        m("/video/play/reverse", lambda: p().set_pb_fps(-p().state.pb_fps))
        m("/video/loop/set", lambda on: setattr(p().state, "loop", bool(on)))
        m("/video/pingpong/set",
          lambda on: setattr(p().state, "ping_pong", bool(on)))

        # clips
        m("/clip/foreground/frame/set",
          lambda f: setattr(p().state, "frame", int(f)))
        m("/clip/foreground/frame/get", lambda: p().state.frame)
        m("/clip/foreground/fps/set", lambda fps: p().set_pb_fps(float(fps)))
        m("/clip/foreground/fps/get", lambda: p().state.pb_fps)
        m("/clip/foreground/select",
          lambda c: self._select_clip(c, bg=False))
        m("/clip/background/select",
          lambda c: self._select_clip(c, bg=True))
        m("/clip/foreground/background/swap", self._swap_fg_bg)

        # effect keys (effects.c rte namespace)
        m("/effect_key/enable", lambda k: p().key_toggle(int(k) - 1, True))
        m("/effect_key/disable", lambda k: p().key_toggle(int(k) - 1, False))
        m("/effect_key/toggle", lambda k: p().key_toggle(int(k) - 1))
        m("/effect_key/mode/next",
          lambda k: p().keymap.next_mode(int(k) - 1))
        def _fx_map(k, name, mode=None):
            """Reference semantics (osc.c lives_osc_cb_fx_map →
            weed_add_effectkey): no mode → bind to the key's first FREE
            mode; explicit mode (1-based, rte_window drag-assign) →
            overwrite that slot."""
            km = p().keymap
            key = int(k) - 1
            if mode is None:
                slot = km.slots[key]
                mode = next((i for i, s in enumerate(slot) if not s),
                            len(slot))
            else:
                mode = int(mode) - 1
            km.set_key(key, mode, str(name))
            return mode + 1

        m("/effect_key/map", _fx_map)
        m("/effect_key/mode/map",
          lambda k, mode, name: _fx_map(k, name, mode))
        m("/keymap/save", lambda path: p().keymap.save(str(path)))
        m("/keymap/load", lambda path: p().keymap.load(str(path)))
        m("/effect_key/nparameter/set",
          lambda k, pname, v: p().set_key_param(int(k) - 1, str(pname),
                                                float(v)))
        m("/effect_key/maxmode/get",
          lambda k: len(p().keymap.slots[int(k) - 1]))

        # record
        def rec_start():
            import os as _os
            pl = p()
            clip = pl.state.fg_clip
            backup = None
            if getattr(self, "workdir", None):
                pl.scrap_dir = str(self.workdir)  # durable scrap clips
                backup = _os.path.join(str(self.workdir),
                                       "recording.autosave.json")
            pl.record_start(width=getattr(clip, "width", 0),
                            height=getattr(clip, "height", 0),
                            backup_path=backup)
            self.notify(NOTIFY.RECORD_STARTED)

        def rec_stop():
            p().record_stop()
            self.notify(NOTIFY.RECORD_STOPPED)

        m("/record/enable", rec_start)
        m("/record/disable", rec_stop)
        m("/record/toggle",
          lambda: rec_stop() if p().record else rec_start())

        # transport / selection (osc.c /video + /clip namespaces)
        m("/video/stop/get", lambda: int(not p().state.playing))
        m("/video/play/get", lambda: int(p().state.playing))
        m("/clip/count", lambda: len(self.clips))
        m("/clip/foreground/get",
          lambda: next((k for k, v in self.clips.items()
                        if v is p().state.fg_clip), 0))
        m("/clip/background/get",
          lambda: next((k for k, v in self.clips.items()
                        if v is p().state.bg_clip), 0))
        m("/clip/select", lambda c: self._select_clip(c, bg=False))

        def clip_close(c):
            clip = self.clips.pop(int(c), None)
            if clip is not None:
                if p().state.fg_clip is clip:
                    p().state.fg_clip = None
                if p().state.bg_clip is clip:
                    p().state.bg_clip = None
                if hasattr(clip, "close"):
                    clip.close()  # release native decoder resources
                self.notify(NOTIFY.CLIP_CLOSED, str(c))

        m("/clip/close", clip_close)
        m("/clip/foreground/fps/faster",
          lambda: p().set_pb_fps(p().state.pb_fps * 1.1))
        m("/clip/foreground/fps/slower",
          lambda: p().set_pb_fps(p().state.pb_fps * 0.9))
        m("/clip/foreground/fps/reset",
          lambda: p().set_pb_fps(
              getattr(p().state.fg_clip, "fps", 25.0) or 25.0))
        m("/clip/foreground/fps/reverse",
          lambda: p().set_pb_fps(-p().state.pb_fps))
        m("/clip/background/next", self._bg_next)
        m("/clip/select/next", self._fg_next)
        m("/clip/end/set",
          lambda f: setattr(p().state, "sel_end", int(f)))
        m("/clip/start/set",
          lambda f: setattr(p().state, "sel_start", int(f)))
        m("/clip/end/get", lambda: p().state.sel_end)
        m("/clip/start/get", lambda: p().state.sel_start)

        # effect key state queries
        m("/effect_key/state/get",
          lambda k: int(p().keymap.active[int(k) - 1]))
        m("/effect_key/mode/get",
          lambda k: p().keymap.mode[int(k) - 1] + 1)
        m("/effect_key/name/get",
          lambda k: p().keymap.current_filter(int(k) - 1))
        m("/effect_key/count", lambda: len(p().keymap.active))

        # encode / transcode (reference /clip/encode_as)
        def encode_as(path, encoder="yuv4mpeg"):
            clip = p().state.fg_clip
            if clip is None:
                raise RuntimeError("no foreground clip")
            from ..transcode import transcode
            ok = transcode(clip, str(path), str(encoder),
                           device=p().device)
            self.notify(NOTIFY.SUCCESS if ok else NOTIFY.FAILED, str(path))
            return int(ok)

        m("/clip/encode_as", encode_as)

        # audio namespace (audio feeder attached as player.audio)
        def _audio():
            return getattr(p(), "audio", None)

        m("/audio/mute/set",
          lambda on: setattr(_audio(), "muted", bool(on))
          if _audio() else None)
        m("/audio/mute/get",
          lambda: int(_audio().muted) if _audio() else 0)
        m("/audio/volume/set",
          lambda v: setattr(_audio(), "volume", float(v))
          if _audio() else None)
        m("/audio/volume/get",
          lambda: _audio().volume if _audio() else 1.0)

        # FRAME_SYNCH notifications per shown frame (osc_notify.h:10,
        # lives_notify player.c:1295) — only when a client subscribed and
        # the events mask admits it
        def _frame_synch(frame, tc):
            if self._notify_clients and \
                    getattr(self, "_events_mask", -1) & NOTIFY.FRAME_SYNCH:
                self.notify(NOTIFY.FRAME_SYNCH, str(frame + 1))

        if self.player is not None and \
                hasattr(self.player, "frame_listeners"):
            self.player.frame_listeners.append(_frame_synch)

        # introspection: method-count self-report
        m("/lives/methods/count", lambda: len(self.methods))
        m("/lives/methods/list",
          lambda: " ".join(sorted(self.methods)))

        # the rest of the reference's osc.c:6694 table
        from .namespace import register_extended
        register_extended(self)

    def _select_clip(self, c, bg: bool):
        clip = self.clips.get(int(c))
        if clip is None:
            raise KeyError(f"no clip {c}")
        if bg:
            self.player.state.bg_clip = clip
        else:
            self.player.switch_fg(clip)

    def _swap_fg_bg(self):
        st = self.player.state
        st.fg_clip, st.bg_clip = st.bg_clip, st.fg_clip

    def _cycle(self, cur):
        keys = sorted(self.clips)
        # an active clip group filters the switcher to its members
        # (sethandler.c filter_clips; groups hold durable unique_ids)
        grp = getattr(self, "clip_groups", {}).get(
            getattr(self, "active_group", "") or "", None)
        if grp is not None:
            keys = [k for k in keys
                    if getattr(self.clips[k], "unique_id", None)
                    in grp] or keys
        if not keys:
            return None
        if cur is None:
            return self.clips[keys[0]]
        ids = [k for k, v in self.clips.items() if v is cur]
        i = keys.index(ids[0]) if ids else -1
        return self.clips[keys[(i + 1) % len(keys)]]

    def _fg_next(self):
        st = self.player.state
        st.fg_clip = self._cycle(st.fg_clip) or st.fg_clip

    def _bg_next(self):
        st = self.player.state
        st.bg_clip = self._cycle(st.bg_clip) or st.bg_clip
