"""The full OSC method namespace (reference src/osc.c:6694 table).

`register_extended(server)` binds the remainder of the reference's ~208
method paths onto an OSCServer: clip open/edit/clipboard, clip sets,
effect-key parameter enumeration + typed get/set, out-parameter/channel
data connections (pconx/cconx), multitrack (/mt, /block), output flags,
playback-plugin parameters, notify configuration and app queries.

Conventions follow the reference: keys are 1-based on the wire
(`/effect_key/...`), modes are 1-based, parameters are 0-indexed
(osc.c lives_osc_cb_rte_getparamname), frames are 1-based on the wire
and 0-based internally. Queries RETURN their value: the server replies
both on the status socket and as an OSC message to the requester.

Counterpart of `lives_tpu/osc/namespace.py:1-1461`: the same method paths
(`register_extended`, `:44`), each lazy import (`:200-1412`) mapped to the
port's module. The pixel work runs on the player's device (`dev()`):
generator clips, the clipboard's reads, merges, rendered effects, RFX
scripts, `/clip/save_as`, `/mt/render` (its clips through
`MJPEGMultiClipSource`) and `/record/render` (the take streamed to the new
clip a chunk at a time as host arrays, as the JAX package writes them).
Out-parameter values leave the device as numpy values, so their wire
text is the JAX package's. `/lives/version/get` answers the port's own
version. The live sources, `/clip/open/unicap` (`io/videodev.py`,
`:216-217,1447`), `/clip/open/kinect` (`io/kinect.py`, `:219-230`) and
`/clip/open/vjack` (`io/videojack.py`, `:234-245`), serve their frames on
the player's device; where the hardware or its library is absent the
dispatch turns the source's error into the `/error` reply on the same
path, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from .server import _version

#: /lives/constant/value/get table (reference exposes build constants)
CONSTANTS = {
    "LIVES_OSC_NOTIFY_FRAME_SYNCH": 1,
    "LIVES_OSC_NOTIFY_PLAYBACK_STARTED": 2,
    "LIVES_OSC_NOTIFY_PLAYBACK_STOPPED": 3,
    "LIVES_OSC_NOTIFY_RECORD_STARTED": 32,
    "LIVES_OSC_NOTIFY_RECORD_STOPPED": 33,
    "LIVES_OSC_NOTIFY_APP_QUIT": 64,
    "LIVES_OSC_NOTIFY_CLIP_OPENED": 512,
    "LIVES_OSC_NOTIFY_CLIP_CLOSED": 513,
    "LIVES_OSC_NOTIFY_SUCCESS": 8192,
    "LIVES_OSC_NOTIFY_FAILED": 8193,
    "LIVES_STATUS_NOTREADY": 0,
    "LIVES_STATUS_READY": 1,
    "LIVES_STATUS_PLAYING": 2,
    "LIVES_STATUS_PROCESSING": 4,
}

_PARAM_TYPE = {"num": "float", "int": "int", "bool": "bool",
               "string": "string", "string_list": "string_list",
               "color": "color"}


def register_extended(srv) -> None:
    m = srv.add_method
    p = lambda: srv.player
    st = lambda: srv.player.state

    # ---- state the extended namespace needs on the server -----------------
    srv.workdir = getattr(srv, "workdir", None)
    srv.multitrack = getattr(srv, "multitrack", None)
    srv.clipboard = None
    srv.output_flags = {"fullscreen": False, "nodrop": False, "fps": 0.0}
    srv.mode = 0  # 0 = clip editor, 1 = multitrack (reference /lives/mode)
    srv._confirms = False
    srv._events_mask = -1
    srv._t0 = time.monotonic()

    def workdir():
        if srv.workdir is None:
            import tempfile
            srv.workdir = tempfile.mkdtemp(prefix="lives_tpu_osc_")
        return srv.workdir

    def cur(bg=False):
        c = st().bg_clip if bg else st().fg_clip
        if c is None:
            raise RuntimeError("no clip")
        return c

    def clip_by_id(c):
        clip = srv.clips.get(int(c))
        if clip is None:
            raise KeyError(f"no clip {c}")
        return clip

    def clip_id_of(clip):
        return next((k for k, v in srv.clips.items() if v is clip), 0)

    def new_id():
        return max(srv.clips, default=0) + 1

    def dev():
        """The device of every render a handler starts: the player's."""
        return p().device

    # ---- app / lives ------------------------------------------------------
    m("/ping", lambda: "pong")
    m("/lives/ping", lambda: "pong")
    m("/app/name/get", lambda: "lives_tpu")
    m("/lives/version/get", _version)
    m("/lives/status/get",
      lambda: 2 if st().playing else 1)
    m("/lives/mode/get", lambda: srv.mode)
    m("/lives/mode/set", lambda v: setattr(srv, "mode", int(v)))
    m("/lives/open_status_socket",
      lambda port, host="127.0.0.1": setattr(
          srv, "_status_client", (host, int(port))))
    m("/lives/open_notify_socket",
      lambda port, host="127.0.0.1": srv._notify_clients.append(
          (host, int(port))))
    m("/lives/constant/value/get",
      lambda name: CONSTANTS.get(str(name), 0))
    m("/quit", srv.methods.get("/app/quit", lambda: None))
    m("/lives/quit", srv.methods.get("/app/quit", lambda: None))
    m("/test", lambda *a: "test " + " ".join(map(str, a)))
    m("/notify/confirmations/set",
      lambda on: setattr(srv, "_confirms", bool(int(on))))
    m("/notify/events/set",
      lambda mask: setattr(srv, "_events_mask", int(mask)))
    m("/notify_to",
      lambda port, host="127.0.0.1": srv._notify_clients.append(
          (host, int(port))))
    m("/reply_to",
      lambda port, host="127.0.0.1": setattr(
          srv, "_reply_client", (host, int(port))))

    # ---- video transport extras -------------------------------------------
    m("/video/play/faster",
      lambda: p().set_pb_fps(st().pb_fps * 1.1))
    m("/video/play/slower",
      lambda: p().set_pb_fps(st().pb_fps * 0.9))
    m("/video/play/reset",
      lambda: p().set_pb_fps(getattr(st().fg_clip, "fps", 25.0) or 25.0))
    m("/video/play/reverse/soft",
      lambda: p().set_pb_fps(-st().pb_fps))
    m("/video/loop/get", lambda: int(st().loop))
    m("/video/pingpong/get", lambda: int(st().ping_pong))
    m("/video/play/time/get",
      lambda: (st().frame / abs(st().pb_fps)) if st().pb_fps else 0.0)
    m("/video/freeze/toggle",
      lambda: p().set_pb_fps(0.0 if st().pb_fps else
                             (getattr(st().fg_clip, "fps", 25.0) or 25.0)))
    # nervous-mode trickplay (player.c:1013; reference binds ctrl-\ via
    # nervous_callback, callbacks.c:10817)
    m("/video/nervous/enable", lambda: setattr(st(), "nervous", True))
    m("/video/nervous/disable", lambda: setattr(st(), "nervous", False))
    m("/video/nervous/get", lambda: int(st().nervous))
    # autotransition on clip switch (prefs->autotrans_key/amt,
    # player.c:1001 set_trans_amt; keys 1-based on the wire)
    m("/video/autotrans/set",
      lambda key, duration=1.0: p().set_autotrans(int(key) - 1,
                                                  float(duration)))
    m("/video/autotrans/disable", lambda: p().set_autotrans(None))

    def fps_ratio_get():
        base = getattr(st().fg_clip, "fps", 25.0) or 25.0
        return st().pb_fps / base

    def fps_ratio_set(r):
        base = getattr(st().fg_clip, "fps", 25.0) or 25.0
        p().set_pb_fps(float(r) * base)

    m("/video/fps/ratio/get", fps_ratio_get)
    m("/video/fps/ratio/set", fps_ratio_set)
    m("/clip/foreground/fps/ratio/get", fps_ratio_get)
    m("/clip/foreground/fps/ratio/set", fps_ratio_set)

    def play_selection():
        s = st()
        s.frame = s.sel_start
        p().start()

    m("/video/selection/play", play_selection)

    # ---- background clip clock (player bg_pb_fps) --------------------------
    def bg_fps():
        return st().bg_pb_fps or st().pb_fps

    m("/clip/background/fps/set",
      lambda fps: setattr(st(), "bg_pb_fps", float(fps)))
    m("/clip/background/fps/get", bg_fps)
    m("/clip/background/fps/faster",
      lambda: setattr(st(), "bg_pb_fps", bg_fps() * 1.1))
    m("/clip/background/fps/slower",
      lambda: setattr(st(), "bg_pb_fps", bg_fps() * 0.9))
    m("/clip/background/fps/reverse",
      lambda: setattr(st(), "bg_pb_fps", -bg_fps()))
    m("/clip/background/fps/reset",
      lambda: setattr(st(), "bg_pb_fps", 0.0))
    m("/clip/background/fps/ratio/get",
      lambda: bg_fps() / (getattr(st().bg_clip, "fps", 25.0) or 25.0))
    m("/clip/background/fps/ratio/set",
      lambda r: setattr(st(), "bg_pb_fps",
                        float(r) * (getattr(st().bg_clip, "fps", 25.0)
                                    or 25.0)))
    m("/clip/background/frame/set",
      lambda f: None)  # bg follows its clock; parity no-op like pre-play set
    m("/clip/background/frame/get",
      lambda: p()._bg_frame(st().frame) + 1 if st().bg_clip else 0)
    m("/clip/background/set", lambda c: srv._select_clip(c, bg=True))
    m("/clip/background/next", srv._bg_next)
    m("/clip/background/previous", srv._bg_next)
    m("/clip/background/retrigger",
      lambda: setattr(st(), "bg_pb_fps", 0.0))

    # ---- clip open / query / edit -----------------------------------------
    def clip_open_file(path, start=0., frames=0):
        """Open a file; with start/frames it is 'Open Part of File'
        (reference lives_osc_cb_open_file: filename, starttime secs,
        numframes; 0 frames = to the end)."""
        from ..clipedit import trim_clip
        from ..io.clips import open_clip
        clip = open_clip(str(path), workdir())
        if float(start) > 0 or int(frames) > 0:
            f0 = min(int(round(float(start) * clip.fps)),
                     max(clip.frames - 1, 0))
            n = int(frames) if int(frames) > 0 else clip.frames - f0
            trim_clip(clip, f0, min(f0 + n, clip.frames))
            # (the trim snapshot remains: undo restores the full file)
        cid = new_id()
        srv.clips[cid] = clip
        if st().fg_clip is None:
            st().fg_clip = clip
        srv.notify(512, str(path))  # CLIP_OPENED
        return cid

    m("/clip/open/file", clip_open_file)
    m("/clip/open/unicap", lambda dev="/dev/video0": _open_videodev(
        srv, str(dev)))

    def clip_open_kinect(index=0, minthresh=0, maxthresh=65536):
        """Depth-keyed Kinect live source (freenect.c generator role);
        errors cleanly when libfreenect isn't present (gated hardware)."""
        from ..io.kinect import KinectCamera, KinectClip
        src = KinectClip(camera=KinectCamera(index=int(index)),
                         minthresh=int(minthresh), maxthresh=int(maxthresh),
                         device=dev())
        cid = new_id()
        srv.clips[cid] = src
        if st().fg_clip is None:
            st().fg_clip = src
        srv.notify(512, f"kinect:{int(index)}")  # CLIP_OPENED
        return cid

    m("/clip/open/kinect", clip_open_kinect)

    def clip_open_vjack(w=640, h=480, name="lives_tpu-vjack-rcv"):
        """Video-JACK receive port as a live source (vjack_rcv.c role);
        errors cleanly without the videojack libjack fork."""
        from ..io.videojack import VJackSource
        src = VJackSource(width=int(w), height=int(h),
                          client_name=str(name), device=dev())
        cid = new_id()
        srv.clips[cid] = src
        if st().fg_clip is None:
            st().fg_clip = src
        srv.notify(512, f"vjack:{name}")  # CLIP_OPENED
        return cid

    m("/clip/open/vjack", clip_open_vjack)

    # extensions: generator clips by filter name, and MilkDrop preset
    # files loaded live (projectM.cpp role via effects/milkdrop.py);
    # the reference starts generators via keyed fx (effects-weed.c:7739),
    # which also works here — these add the clip-source route
    def clip_open_generator(name, w=640, h=360, fps=30.0):
        from ..io.genclip import GeneratorClip
        clip = GeneratorClip(str(name), int(w), int(h), float(fps),
                             device=dev())
        cid = new_id()
        srv.clips[cid] = clip
        if st().fg_clip is None:
            st().fg_clip = clip
        srv.notify(512, str(name))  # CLIP_OPENED
        return cid

    m("/clip/open/generator", clip_open_generator)

    def clip_open_milk(path, w=640, h=360, fps=30.0):
        from ..effects.milkdrop import load_milk_preset
        f = load_milk_preset(str(path))
        return clip_open_generator(f.name, w, h, fps)

    m("/clip/open/milk", clip_open_milk)

    # preset playlist: a whole directory of .milk files on one generator
    # clip, cycled in place (projectM.cpp preset directory + nextPreset
    # switching — the reference plugin auto-scans its preset dir)
    # NOTE: no background compile-prewarm of the next preset — measured
    # on this host, a prewarm thread starves the single host core and
    # the serving loop shows ~0 fps while it compiles. First-time
    # switches drop frames once (reference generator-start behavior);
    # repeat switches hit the persistent compile cache and are instant.
    def clip_open_milkdir(path, w=640, h=360, fps=30.0):
        from pathlib import Path as _P

        from ..effects.milkdrop import load_milk_preset
        files = sorted(_P(str(path)).glob("*.milk"))
        if not files:
            raise FileNotFoundError(f"no .milk presets under {path}")
        names = []
        for f in files:
            try:
                names.append(load_milk_preset(f).name)
            except ValueError:
                pass  # out-of-subset preset (projectM skips these too)
        if not names:
            raise ValueError(f"no loadable .milk presets under {path}")
        cid = clip_open_generator(names[0], w, h, fps)
        clip = srv.clips[cid]
        clip.playlist = names
        clip.playlist_pos = 0
        return cid

    def gen_switch(c, name):
        clip = clip_by_id(c)
        clip.switch(str(name))
        srv.notify(512, str(name))
        return 1

    def gen_next(c=None, step=1):
        clip = clip_by_id(c) if c is not None else st().fg_clip
        pos = clip.cycle(int(step))
        srv.notify(512, clip.playlist[pos])
        return pos

    def gen_autocycle(secs, c=None):
        # projectM presetDuration: 0 disables; the player switches at
        # safe points once the interval elapses
        clip = clip_by_id(c) if c is not None else st().fg_clip
        if not getattr(clip, "playlist", None):
            raise RuntimeError("clip has no preset playlist")
        clip.autocycle_secs = max(0.0, float(secs))
        clip._last_cycle = None
        return 1

    m("/clip/open/milkdir", clip_open_milkdir)
    m("/clip/generator/switch", gen_switch)
    m("/clip/generator/next", gen_next)
    m("/clip/generator/autocycle", gen_autocycle)

    def audio_new(path):
        cd_open = clip_open_file(path)
        return cd_open

    m("/clip/audio/new", audio_new)

    # ---- clip audio editing (the Audio menu; audioedit.py — reference
    # callbacks.c on_fade_audio/on_normalise_audio/on_trim_audio/
    # on_del_audio/on_ins_silence/on_append_audio + sync adjust) ----------
    def _sel_secs(clip):
        s = st()
        fps = float(getattr(clip, "fps", 25.0)) or 25.0
        end = s.sel_end + 1 if s.sel_end >= 0 else \
            int(getattr(clip, "frames", 0))
        return s.sel_start / fps, end / fps

    def _aud(op, *args, selection=False):
        from .. import audioedit
        clip = cur()
        if clip is None:
            raise RuntimeError("no foreground clip")
        if selection:
            args = _sel_secs(clip) + args
        return getattr(audioedit, op)(clip, *args)

    m("/clip/audio/fadein", lambda t=1.0: _aud("fade_in", float(t)))
    m("/clip/audio/fadeout", lambda t=1.0: _aud("fade_out", float(t)))
    m("/clip/audio/fade/selection",
      lambda out=0: _aud("fade_span", *((1.0, 0.0) if int(out)
                                        else (0.0, 1.0)),
                         selection=True))
    m("/clip/audio/normalize",
      lambda target=0.95: float(_aud("normalize", float(target))))
    m("/clip/audio/volume/adjust",
      lambda gain: _aud("voladj", float(gain)))
    m("/clip/audio/trim", lambda: _aud("trim_pad", selection=True))
    m("/clip/audio/delete", lambda: _aud("delete_span", selection=True))
    m("/clip/audio/delete_all", lambda: _aud("delete_span"))
    m("/clip/audio/insert_silence",
      lambda: _aud("insert_silence", selection=True))
    m("/clip/audio/sync/adjust",
      lambda offset: _aud("adjust_sync", float(offset)))
    m("/clip/audio/undo", lambda: int(_aud("undo_audio")))

    def audio_append(path):
        """Append audio decoded from a media file (on_append_audio):
        rip s16 interleaved pcm through the decoder bridge, resample
        and channel-match to the clip."""
        import tempfile

        import numpy as np

        from ..io.clips import try_decoders
        cd = try_decoders(str(path))
        if cd is None or not cd.achans or cd.decoder is None:
            raise RuntimeError(f"no audio decodable in {path}")
        fd, tmp = tempfile.mkstemp(suffix=".pcm")
        os.close(fd)
        try:
            if not cd.decoder.rip_audio(tmp):
                raise RuntimeError(f"audio rip failed for {path}")
            raw = np.fromfile(tmp, "<i2").astype(np.float32) / 32768.0
        finally:
            os.unlink(tmp)
            if hasattr(cd.decoder, "close"):
                cd.decoder.close()
        n = len(raw) // cd.achans
        _aud("append_audio", raw[: n * cd.achans].reshape(n, cd.achans),
             cd.arate)
        return int(cd.arate)

    m("/clip/audio/append", audio_append)
    m("/clip/fps/get", lambda: getattr(cur(), "fps", 25.0))

    def clip_fps_set(fps):
        """Tools menu 'Change Playback/Save Speed' (create_new_pb_speed):
        rewrites the clip's header fps — same frames, new duration.
        Distinct from /video/fps/set, the live playback rate."""
        clip = cur()
        if clip is None:
            raise RuntimeError("no foreground clip")
        f = float(fps)
        if not 0.001 <= abs(f) <= 2000.0:
            raise ValueError(f"fps {f} out of range")
        clip.fps = f
        if hasattr(clip, "save_header"):
            clip.save_header()
        return f

    m("/clip/fps/set", clip_fps_set)
    m("/clip/frame/count", lambda: getattr(cur(), "frames", 0))
    m("/clip/size/get", lambda: [int(getattr(cur(), "width", 0)),
                                 int(getattr(cur(), "height", 0))])
    m("/clip/name/get",
      lambda c=None: getattr(clip_by_id(c) if c is not None else cur(),
                             "name", ""))
    m("/clip/name/set",
      lambda name: setattr(cur(), "name", str(name)))
    m("/clip/is_valid/get",
      lambda c=None: int((clip_by_id(c) if c is not None else
                          st().fg_clip) is not None))
    # ids can be sparse after closes: enumerate them for batch clients
    # (tools/batchproc.py — reference tools/batchproc.pl iterates 1..n)
    m("/clip/list",
      lambda: " ".join(str(k) for k in sorted(srv.clips)))
    m("/clip/goto", lambda f: setattr(st(), "frame", int(f) - 1))
    m("/clip/foreground/set", lambda c: srv._select_clip(c, bg=False))
    m("/clip/foreground/next", srv._fg_next)
    m("/clip/foreground/previous", srv._fg_next)
    m("/clip/foreground/retrigger",
      lambda: setattr(st(), "frame", 0))
    m("/clip/retrigger", lambda: setattr(st(), "frame", 0))
    m("/clip/select/previous", srv._fg_next)
    m("/clip/select_all",
      lambda: (setattr(st(), "sel_start", 0),
               setattr(st(), "sel_end", -1)) and None)

    # ---- clip bookmarks (the F1-F12 store/switch slots) --------------------
    # Reference: storeclip_callback (src/callbacks.c, bound to F1..F12 in
    # gui.c:2727): pressing Fn with an empty slot stores the current clip;
    # with a filled slot it switches to that clip (re-storing if the clip
    # has since been closed). Shift+Fn force-stores.
    srv.clip_bookmarks = getattr(srv, "clip_bookmarks", {})

    def bookmark_set(n, c=None):
        clip = clip_by_id(c) if c is not None else cur()
        srv.clip_bookmarks[int(n)] = clip
        return clip_id_of(clip)

    def bookmark_select(n):
        clip = srv.clip_bookmarks.get(int(n))
        if clip is None or clip_id_of(clip) == 0:   # empty or closed slot
            return bookmark_set(n)
        p().switch_fg(clip)
        return clip_id_of(clip)

    m("/clip/bookmark/set", bookmark_set)
    m("/clip/bookmark/select", bookmark_select)
    m("/clip/bookmark/get",
      lambda n: clip_id_of(srv.clip_bookmarks.get(int(n))))

    def save_frame_image(path, frame=None):
        import numpy as np
        clip = cur()
        n = int(frame) - 1 if frame is not None else st().frame
        lay = clip.get_frame(n)
        from ..ops.colorspace import convert_layer
        from ..constants import Palette
        lay = lay.replace(planes=tuple(q.to(dev()) for q in lay.planes))
        rgb = convert_layer(lay, Palette.RGB24).planes[0].cpu().numpy()
        from PIL import Image
        Image.fromarray(np.moveaxis(rgb, 0, -1)).save(str(path))
        return str(path)

    m("/clip/frame/save_as_image", save_frame_image)

    # clipboard / selection editing (clipedit.py; [start, end) exclusive)
    def _sel(clip):
        s = st()
        end = s.sel_end + 1 if s.sel_end >= 0 else clip.frames
        return s.sel_start, end

    def clip_copy():
        from ..clipedit import copy_frames
        clip = cur()
        srv.clipboard = copy_frames(clip, *_sel(clip), device=dev())
        return clip.frames

    def sel_cut():
        from ..clipedit import cut_frames
        clip = cur()
        srv.clipboard = cut_frames(clip, *_sel(clip), device=dev())
        return clip.frames

    def sel_delete():
        from ..clipedit import delete_frames
        clip = cur()
        delete_frames(clip, *_sel(clip))
        return clip.frames

    def paste(at=None, before=True):
        from ..clipedit import paste_insert
        if srv.clipboard is None:
            raise RuntimeError("clipboard empty")
        clip = cur()
        pos = st().frame if at is None else int(at) - 1
        paste_insert(clip, pos if before else pos + 1, srv.clipboard)
        return clip.frames

    m("/clip/copy", clip_copy)
    m("/clip/selection/copy", clip_copy)
    m("/clip/selection/cut", sel_cut)
    m("/clip/selection/delete", sel_delete)
    def clipboard_reverse():
        """Tools menu 'Reverse Clipboard' (callbacks.c
        on_rev_clipboard_activate): frames and audio both flip."""
        cb = srv.clipboard
        if cb is None:
            raise RuntimeError("clipboard empty")
        cb.frames.reverse()
        if cb.audio is not None and len(cb.audio):
            cb.audio = cb.audio[::-1].copy()
        return len(cb)

    m("/clipboard/reverse", clipboard_reverse)
    m("/clipboard/paste", paste)
    m("/clipboard/insert_before", lambda at=None: paste(at, True))
    m("/clipboard/insert_after", lambda at=None: paste(at, False))

    def paste_as_new():
        """Edit menu 'Paste as New' (gui.c new-clip-from-clipboard role):
        the clipboard becomes a fresh clip, selected as foreground."""
        from ..io.clips import create_clip
        cb = srv.clipboard
        if cb is None or not len(cb):
            raise RuntimeError("clipboard empty")
        h, w = cb.frames[0].shape[1:]
        clip = create_clip(workdir(), w, h, cb.fps, name="pasted")
        clip.frames = len(cb.frames)
        # the clipboard's HOST arrays straight to disk
        clip.put_frames(range(len(cb.frames)), cb.frames)
        if cb.audio is not None and len(cb.audio):
            clip.write_audio(cb.audio, cb.arate)
        # header last so the audio metadata write_audio sets persists
        clip.save_header()
        cid = new_id()
        srv.clips[cid] = clip
        st().fg_clip = clip
        srv.notify(512, "pasted")  # CLIP_OPENED
        return cid

    m("/clipboard/paste_as_new", paste_as_new)

    def clip_undo():
        """Undo the last destructive op: a frame-layout edit if one is
        pending, else the last rendered effect (reference single undo
        slot per clip; both our buffers swap, so /clip/redo re-applies)."""
        from ..clipedit import undo_edit
        from ..rfx import undo_rendered_effect
        clip = cur()
        if undo_edit(clip):
            return 1
        return int(undo_rendered_effect(clip))

    m("/clip/undo", clip_undo)
    m("/clip/redo", clip_undo)  # undo buffer is a swap (reference redo)

    def clip_resample(fps):
        from ..resample import resample_clip_fps
        resample_clip_fps(cur(), float(fps))
        return float(fps)

    m("/clip/resample", clip_resample)

    def clip_save_as(out_path, encoder="", start=0, end=0):
        """Encode the fg clip (or a frame range) to a file — the
        reference Save-As flow (src/clip_load_save.c save_file through
        an encoder plugin). Synchronous; the web UI wraps it in a
        background job with progress instead."""
        from ..io.encoders import list_encoders
        from ..transcode import transcode
        clip = cur()
        encs = list_encoders()
        enc = str(encoder) or ("av" if "av" in encs else "yuv4mpeg")
        s, e = int(start), int(end) or clip.frames
        return int(transcode(clip, str(out_path), encoder=enc,
                             start=s, end=e, device=dev()))

    m("/clip/save_as", clip_save_as)

    def subs_load(path):
        """Attach .srt/.sub subtitles to playback (the reference
        Subtitles > Load menu, clip_load_save.c reload_subs)."""
        p().load_subtitles(str(path))
        return 1

    m("/clip/subtitles/load", subs_load)
    m("/clip/subtitles/erase",
      lambda: (setattr(p(), "subtitles", None), 1)[-1])

    def rte_apply():
        """Apply the active key chain to the fg clip's selection
        (reference /clip/selection/rte_apply)."""
        from ..rfx import apply_rendered_effect
        clip = cur()
        s, e = _sel(clip)
        n = 0
        for inst in p().keymap.active_chain():
            apply_rendered_effect(clip, inst.filter.name, start=s,
                                  end=e, values=dict(inst.values),
                                  device=dev())
            n += 1
        return n

    m("/clip/selection/rte_apply", rte_apply)

    def sel_merge(transition="crossfade", ramp_start=0.0, ramp_end=1.0):
        """Merge the clipboard into the selection through a transition
        (the reference Merge dialog, src/merge.c)."""
        from ..clipedit import merge_clipboard
        if srv.clipboard is None:
            raise RuntimeError("clipboard empty")
        clip = cur()
        s, e = _sel(clip)
        return int(merge_clipboard(clip, srv.clipboard, str(transition),
                                   start=s, end=e,
                                   ramp=(float(ramp_start),
                                         float(ramp_end)), device=dev()))

    m("/clip/selection/merge", sel_merge)

    # ---- RFX rendered-effect scripts (the reference applies these via
    # menus; the control-plane analogue exposes the script library) --------
    def rfx_list():
        from ..rfx_scripts import list_scripts
        return " ".join(list_scripts())

    def rfx_params(name):
        from ..rfx_scripts import get_script
        spec = get_script(str(name)).params_spec()
        return " ".join(f"{q['name']}:{q.get('kind', 'num')}" for q in spec)

    def rfx_apply(name, *kvs):
        """Apply script `name` to the fg clip's selection. Extra args are
        alternating key value pairs; values parse as float when they can.
        Two-source scripts read the clipboard as `other`."""
        from ..rfx_scripts import apply_script, get_script
        clip = cur()
        s, e = _sel(clip)
        from ..rfx_scripts import parse_param_value
        params = {}
        for i in range(0, len(kvs) - 1, 2):
            params[str(kvs[i])] = parse_param_value(kvs[i + 1])
        if get_script(str(name)).filter == "(two-source)":
            if srv.clipboard is None:
                raise RuntimeError("two-source script needs a clipboard")
            params["other"] = srv.clipboard
        return int(apply_script(clip, str(name), start=s, end=e,
                                device=dev(), **params))

    m("/rfx/list", rfx_list)
    m("/rfx/params/get", rfx_params)
    m("/rfx/apply", rfx_apply)

    def rfx_load_dir(dirpath):
        """Load user-authored RFX .script files (rfx_builder dialect)
        from a directory — the reference scans the user's rfx dir at
        startup (rfx-builder.c scripts land in ~/.lives-dir). Returns
        the registered names."""
        from ..rfx_builder import load_user_scripts
        names = load_user_scripts(str(dirpath))
        return ";".join(names)

    m("/rfx/load_dir", rfx_load_dir)

    def rfx_define(name, filter_name, params_json="[]",
                   mapping_json="{}", save=0):
        """Author a rendered effect over the wire (the rfx-builder "New
        Test RFX" dialog role, rfx-builder.c): params_json is a list of
        [name, kind, default, min, max] rows, mapping_json maps filter
        params to whitelisted arithmetic expressions. save=1 also writes
        <workdir>/rfx/<name>.script in the reference DSL."""
        import json

        from ..rfx_builder import RFXBuilder
        b = RFXBuilder(str(name))
        for row in json.loads(str(params_json)):
            pname, kind = row[0], (row[1] if len(row) > 1 else "num2")
            dflt = row[2] if len(row) > 2 else 0.0
            lo = float(row[3]) if len(row) > 3 else 0.0
            hi = float(row[4]) if len(row) > 4 else 1.0
            b.add_param(str(pname), str(kind), dflt, lo, hi)
        mapping = {str(k): str(v)
                   for k, v in json.loads(str(mapping_json)).items()}
        b.set_filter(str(filter_name), **mapping)
        b.register()
        if int(save):
            b.save(os.path.join(str(workdir()), "rfx",
                                f"{name}.script"))
        return str(name)

    m("/rfx/define", rfx_define)

    # ---- OMC learn (omc-learn.c MIDI/joystick learner window role) --------
    def omc():
        if getattr(srv, "omc", None) is None:
            from ..omc import OMCLearner
            srv.omc = OMCLearner(p())
        return srv.omc

    m("/omc/macro/list", lambda: " ".join(sorted(omc().macros)))
    m("/omc/learn/start", lambda name: omc().start_learn(str(name)))
    m("/omc/learn/status", lambda: omc().learning or "")
    m("/omc/feed_midi",
      lambda hexbytes: omc().feed_midi(bytes.fromhex(str(hexbytes))))
    m("/omc/mappings/list",
      lambda: ";".join(
          f"{k.etype},{k.channel},{k.index}:{mp.macro}"
          for k, mp in omc().mappings.items()))
    m("/omc/map/save", lambda path: (omc().save_map(str(path)), 1)[1])
    m("/omc/map/load", lambda path: (omc().load_map(str(path)), 1)[1])
    m("/omc/mapping/clear",
      lambda: (omc().mappings.clear(), 1)[1])

    # ---- clip sets ---------------------------------------------------------
    class _ClipW:  # sets.py expects app._clips of .raw()-wrappers
        def __init__(self, c):
            self._c = c

        def raw(self):
            return self._c

    def _set_app():
        import pathlib
        from ..multitrack.model import Multitrack as _Mt

        class _App:
            pass

        import types
        app = _App()
        app.workdir = pathlib.Path(workdir())
        app._clips = [_ClipW(c) for c in srv.clips.values()]
        app.multitrack = srv.multitrack or _Mt()
        app.set = types.SimpleNamespace(name="")
        return app

    def clipset_save(name):
        from .. import sets
        sets.save_set(_set_app(), str(name))
        srv._set_name = str(name)
        srv.notify(1025, str(name))
        return str(name)

    def clipset_load(name):
        from .. import sets
        app = _set_app()
        app._clips = []
        app.open_clip_dir = None
        n = sets.load_set(app, str(name))
        for w in app._clips:
            srv.clips[new_id()] = w.raw() if hasattr(w, "raw") else w
        srv._set_name = str(name)
        srv.notify(1024, str(name))
        return n

    def clipset_list():
        import pathlib

        from .. import sets
        return " ".join(sets.list_sets(pathlib.Path(workdir())))

    m("/clipset/save", clipset_save)
    m("/clipset/load", clipset_load)
    m("/clipset/list", clipset_list)
    m("/clipset/name/get", lambda: getattr(srv, "_set_name", ""))

    # ---- effect keys: modes / map -----------------------------------------
    km = lambda: p().keymap
    m("/effect_key/mode/set",
      lambda k, mode: (km().mode.__setitem__(int(k) - 1, int(mode) - 1),
                       km().instances.__setitem__(int(k) - 1, None),
                       None)[-1])
    m("/effect_key/mode/previous",
      lambda k: km().prev_mode(int(k) - 1))
    m("/effect_key/unmap",
      lambda k: (km().slots[int(k) - 1].clear(),
                 km().instances.__setitem__(int(k) - 1, None), None)[-1])
    m("/effect_key/map/clear",
      lambda: [(s.clear(), None) for s in km().slots] and None)
    m("/effect_key/reset",
      lambda: [p().key_toggle(i, False) for i in range(len(km().active))
               if km().active[i]] and None)
    m("/effects/realtime/name/get", _fx_name_by_idx)

    # ---- effect key parameter enumeration / typed access -------------------
    def filt_of(k):
        from ..effects.host import get_filter
        name = km().current_filter(int(k) - 1)
        if not name:
            raise KeyError(f"key {k} unmapped")
        return get_filter(name)

    def param_of(k, i):
        filt = filt_of(k)
        params = filt.params
        i = int(i)
        if not 0 <= i < len(params):
            raise IndexError(f"param {i} of {filt.name}")
        return params[i]

    def inst_of(k):
        inst = km().instances[int(k) - 1]
        if inst is None:
            raise RuntimeError(f"key {k} has no instance (enable it)")
        return inst

    def pval_get(k, i):
        par = param_of(k, i)
        inst = km().instances[int(k) - 1]
        v = inst.values.get(par.name, par.default) if inst else par.default
        return float(v) if par.kind == "num" else v

    def pval_set(k, i, *vals):
        par = param_of(k, i)
        v = vals[0] if len(vals) == 1 else list(vals)
        if par.kind == "num":
            v = float(v)
        elif par.kind in ("int", "string_list"):
            v = int(v)
        elif par.kind == "bool":
            v = bool(int(v))
        p().set_key_param(int(k) - 1, par.name, v)

    for pfx in ("/effect_key/parameter", "/effect_key/nparameter"):
        m(f"{pfx}/count", lambda k, _f=filt_of: len(_f(k).params))
        m(f"{pfx}/name/get", lambda k, i: param_of(k, i).name)
        m(f"{pfx}/type/get",
          lambda k, i: _PARAM_TYPE.get(param_of(k, i).kind, "float"))
        m(f"{pfx}/min/get", lambda k, i: float(param_of(k, i).min))
        m(f"{pfx}/max/get", lambda k, i: float(param_of(k, i).max))
        m(f"{pfx}/default/get", lambda k, i: param_of(k, i).default)
        m(f"{pfx}/value/get", pval_get)
        m(f"{pfx}/value/set", pval_set)
        m(f"{pfx}/is_transition",
          lambda k, i: int(filt_of(k).is_transition))
    def pdefault_set(k, i, v):
        """Persists into the keymap's per-(key,mode) defaults
        (fxdefs.perkey) AND applies to the live instance."""
        par = param_of(k, i)
        key0 = int(k) - 1
        mode = km().mode[key0]
        d = km().defaults.setdefault((key0, mode), {})
        d[par.name] = float(v) if par.kind == "num" else v
        pval_set(k, i, v)

    m("/effect_key/parameter/default/set", pdefault_set)
    m("/effect_key/nparameter/default/set", pdefault_set)
    m("/effect_key/parameter/has_default", lambda k, i: 1)
    m("/effect_key/parameter/flags/get", lambda k, i: 0)
    m("/effect_key/parameter/group/get",
      lambda k, i: int(param_of(k, i).group))
    m("/effect_key/parameter/colorspace/get",
      lambda k, i: "rgb" if param_of(k, i).kind == "color" else "")
    m("/effect_key/parameter/gui/choices/count",
      lambda k, i: len(param_of(k, i).choices))
    m("/effect_key/parameter/gui/choices/get",
      lambda k, i, c: param_of(k, i).choices[int(c)])

    # out parameters (analysers; feed data connections)
    def oparam_of(k, i):
        filt = filt_of(k)
        i = int(i)
        if not 0 <= i < len(filt.out_params):
            raise IndexError(f"out param {i} of {filt.name}")
        return filt.out_params[i]

    m("/effect_key/outparameter/count",
      lambda k: len(filt_of(k).out_params))
    m("/effect_key/outparameter/name/get",
      lambda k, i: oparam_of(k, i).name)
    m("/effect_key/outparameter/type/get",
      lambda k, i: _PARAM_TYPE.get(oparam_of(k, i).kind, "float"))
    m("/effect_key/outparameter/min/get",
      lambda k, i: float(oparam_of(k, i).min))
    m("/effect_key/outparameter/max/get",
      lambda k, i: float(oparam_of(k, i).max))
    m("/effect_key/outparameter/default/get",
      lambda k, i: oparam_of(k, i).default)
    m("/effect_key/outparameter/value/get",
      lambda k, i: _host(inst_of(k).out_values.get(
          oparam_of(k, i).name, oparam_of(k, i).default)))
    m("/effect_key/outparameter/has_min", lambda k, i: 1)
    m("/effect_key/outparameter/has_max", lambda k, i: 1)
    m("/effect_key/outparameter/has_default", lambda k, i: 1)
    m("/effect_key/outparameter/colorspace/get", lambda k, i: "")

    # data connections (effects-data.c pconx/cconx). The map is SHARED
    # with the player (player.datacons) so live playback applies it —
    # pconx host-side each frame, cconx in-template via _build_graph.
    def conns():
        if not hasattr(srv, "datacons"):
            from ..effects.data import DataConnections
            pl = getattr(srv, "player", None)
            existing = getattr(pl, "datacons", None) if pl else None
            srv.datacons = existing or DataConnections()
            if pl is not None:
                pl.datacons = srv.datacons
        return srv.datacons

    def conn_add(k, i, dk, di, autoscale=1):
        par = oparam_of(k, i)
        dpar = param_of(dk, di)
        conns().add(inst_of(k), par.name, inst_of(dk), dpar.name,
                    autoscale=bool(int(autoscale)))
        return 1

    def conn_del(k, i):
        par = oparam_of(k, i)
        for c in list(conns().conns):
            if c.src is inst_of(k) and c.out_param == par.name:
                conns().remove(c)

    def conn_list(k=None):
        out = [f"{c.out_param}->{c.in_param}" for c in conns().conns]
        return " ".join(out) or ""

    m("/effect_key/outparameter/connection/add", conn_add)
    m("/effect_key/outparameter/connection/list", conn_list)
    m("/effect_key/outparameter/connection/delete", conn_del)

    # cconx: alpha out-channel i of key k -> alpha in-slot di of key dk
    # (cconx_add_connection, effects-data.c:2106)
    def cconn_add(k, i, dk, di=0):
        src = inst_of(k)
        tmpl = src.filter.alpha_outs[int(i)]
        conns().add_channel(src, tmpl.name, inst_of(dk), int(di))
        return 1

    def cconn_del(k, i):
        src = inst_of(k)
        tmpl = src.filter.alpha_outs[int(i)]
        for c in list(conns().chan_conns):
            if c.src is src and c.out_channel == tmpl.name:
                conns().remove(c)

    def cconn_list(k=None):
        return " ".join(f"{c.out_channel}->{c.in_slot}"
                        for c in conns().chan_conns) or ""

    m("/effect_key/outchannel/connection/add", cconn_add)
    m("/effect_key/outchannel/connection/list", cconn_list)
    m("/effect_key/outchannel/connection/delete", cconn_del)

    # channels (alpha channels counted after the colour ones, like the
    # reference's enabled-channel iteration in cconx_chain_data)
    m("/effect_key/inchannel/active/count",
      lambda k: len(filt_of(k).in_channels) + len(filt_of(k).alpha_ins))
    m("/effect_key/outchannel/active/count",
      lambda k: len(filt_of(k).out_channels) + len(filt_of(k).alpha_outs))

    def _chan_pal(tmpls, base, i):
        i = int(i)
        if i < len(base):
            return "RGB24"
        t = tmpls[i - len(base)]
        from ..constants import Palette as _Pal
        return _Pal(t.palettes[0]).name if t.palettes else "A8"

    m("/effect_key/inchannel/palette/get",
      lambda k, i=0: _chan_pal(filt_of(k).alpha_ins,
                               filt_of(k).in_channels, i))
    m("/effect_key/outchannel/palette/get",
      lambda k, i=0: _chan_pal(filt_of(k).alpha_outs,
                               filt_of(k).out_channels, i))

    # ---- playback-plugin ("/video/play/parameter") namespace ---------------
    # our sinks expose no tweakable params yet: count 0, typed errors beyond
    m("/video/play/parameter/count", lambda: 0)
    for leaf in ("value/set", "value/get", "flags/get", "min/get",
                 "max/get", "type/get", "name/get", "colorspace/get",
                 "default/get"):
        m(f"/video/play/parameter/{leaf}",
          lambda *a: (_ for _ in ()).throw(
              IndexError("no playback plugin parameters")))

    # ---- output / sink flags ----------------------------------------------
    m("/output/fullscreen/enable",
      lambda: srv.output_flags.__setitem__("fullscreen", True))
    m("/output/fullscreen/disable",
      lambda: srv.output_flags.__setitem__("fullscreen", False))
    m("/output/nodrop/enable",
      lambda: srv.output_flags.__setitem__("nodrop", True))
    m("/output/nodrop/disable",
      lambda: srv.output_flags.__setitem__("nodrop", False))
    m("/output/fps/set",
      lambda fps: srv.output_flags.__setitem__("fps", float(fps)))

    # ---- preferences (preferences.h PREF_* namespace over OSC; the
    # live/deferred split mirrors prefs/future_prefs) ------------------------
    def _prefs():
        from ..prefs import store
        return store()

    def pref_set(key, value, deferred=0):
        if isinstance(value, str):
            for conv in (int, float):
                try:
                    value = conv(value)
                    break
                except ValueError:
                    continue
        _prefs().set(str(key), value, deferred=bool(int(deferred)))
        return 1

    m("/pref/set", pref_set)
    m("/pref/get",
      lambda key, default="": _prefs().get(str(key), default))
    m("/pref/apply_future", lambda: (_prefs().apply_future(), 1)[1])
    m("/pref/save", lambda: (_prefs().save(), 1)[1])

    # ---- audio source ------------------------------------------------------
    m("/audio/source/get",
      lambda: getattr(srv, "_audio_source", 0))
    m("/audio/source/set",
      lambda v: setattr(srv, "_audio_source", int(v)))

    # live audio fx chain on the realtime feeder (the reference applies
    # audio filters in the jack/pulse callback, weed_apply_audio_
    # effects_rt, effects-weed.c:3438)
    def _achain():
        ap = getattr(p(), "audio", None)
        if ap is None:
            raise RuntimeError("no audio player attached")
        return ap.chain

    def afx_add(name, *kv):
        from ..audio.fx import audio_instantiate
        values = {}
        for pair in kv:
            k, _, v = str(pair).partition("=")
            try:
                values[k] = float(v)
            except ValueError:
                values[k] = v
        inst = audio_instantiate(str(name), **values)
        _achain().append(inst)
        return len(_achain())

    m("/audio/fx/add", afx_add)
    def _afx_names():
        from ..audio.fx import list_audio_filters
        return " ".join(sorted(list_audio_filters()))

    m("/audio/fx/names", _afx_names)
    m("/audio/fx/count", lambda: len(_achain()))
    m("/audio/fx/list",
      lambda: " ".join(i.filter.name for i in _achain()))

    def afx_remove(idx=-1):
        ch = _achain()
        ch.pop(int(idx))
        return len(ch)

    m("/audio/fx/remove", afx_remove)
    m("/audio/fx/clear", lambda: (_achain().clear(), 0)[1])

    def afx_param(idx, pname, value):
        _achain()[int(idx)].values[str(pname)] = float(value)
        return 1

    m("/audio/fx/parameter/set", afx_param)

    # ---- multitrack (/mt, /block) ------------------------------------------
    def mt():
        if srv.multitrack is None:
            from ..multitrack.model import Multitrack
            srv.multitrack = Multitrack()
        return srv.multitrack

    m("/mt/time/get", lambda: getattr(mt(), "ctime", 0.0))
    m("/mt/time/set",
      lambda t: setattr(mt(), "ctime", float(t)))
    m("/mt/ctrack/get", lambda: getattr(mt(), "ctrack", 0))
    m("/mt/ctrack/set",
      lambda t: setattr(mt(), "ctrack", int(t)))

    def block_insert(clip_id, track=None, at=None):
        clip = clip_by_id(clip_id)
        t = int(track) if track is not None else getattr(mt(), "ctrack", 0)
        tm = float(at) if at is not None else getattr(mt(), "ctime", 0.0)
        start = int(tm * mt().el.fps)
        mt().insert_block(t, getattr(clip, "unique_id", int(clip_id)),
                          start, max(getattr(clip, "frames", 1), 1))
        return len(mt().blocks(t))

    m("/block/insert", block_insert)
    m("/block/count",
      lambda track=None: len(mt().blocks(int(track)
                                         if track is not None
                                         else getattr(mt(), "ctrack", 0))))

    def block_time(track, idx, end=False):
        b = mt().blocks(int(track))[int(idx)]
        return (b.end if end else b.start) / mt().el.fps

    m("/block/start/time/get", lambda track, i: block_time(track, i, False))
    m("/block/end/time/get", lambda track, i: block_time(track, i, True))

    def block_delete(track, idx):
        blks = mt().blocks(int(track))
        mt().delete_block(blks[int(idx)])
        return len(mt().blocks(int(track)))

    m("/block/delete", block_delete)  # extension (GUI delete handler role)

    # extended editing surface (multitrack.c editing handlers over OSC;
    # the web UI timeline drives these)
    def _all_filters():
        from ..effects.host import list_filters
        return " ".join(sorted(list_filters()))

    m("/effects/list", _all_filters)  # full registry (region-fx picker)

    def _generators():
        # 0-in filters become clip sources (effects-weed.c:7739 role);
        # the web UI's generator-open picker lists these
        from ..effects.host import get_filter, list_filters
        return " ".join(sorted(
            n for n in list_filters()
            if not get_filter(n).in_channels))

    m("/effects/generators/list", _generators)  # extension

    def _transitions():
        # 2-in filters usable by the Merge dialog / auto-transitions
        from ..effects.host import get_filter, list_filters
        return " ".join(sorted(n for n in list_filters()
                               if get_filter(n).is_transition))

    m("/effects/transitions/list", _transitions)  # extension
    m("/mt/gravity/get", lambda: int(mt().gravity))
    def _gravity_set(g):
        from ..multitrack import Gravity
        mt().gravity = Gravity(int(g))

    def _insert_mode_set(i):
        from ..multitrack import InsertMode
        mt().insert_mode = InsertMode(int(i))

    m("/mt/gravity/set", _gravity_set)
    m("/mt/insert_mode/get", lambda: int(mt().insert_mode))
    m("/mt/insert_mode/set", _insert_mode_set)
    m("/mt/ntracks/get", lambda: mt().n_tracks)
    m("/mt/natracks/get", lambda: mt().n_audio_tracks)
    m("/mt/track/add", lambda: mt().add_track())
    m("/mt/atrack/add", lambda: mt().add_audio_track())
    m("/mt/nframes/get", lambda: mt().n_frames)
    m("/mt/undo", lambda: 1 if mt().undo() else 0)
    m("/mt/redo", lambda: 1 if mt().redo() else 0)

    def region_select(t0, t1, *tracks):
        mt().select_region([int(t) for t in tracks] or
                           list(range(mt().n_tracks)),
                           int(t0), int(t1))
        return 1

    m("/mt/region/select", region_select)
    m("/mt/region/clear", lambda: (mt().clear_selection(), 1)[1])

    def block_move(track, idx, new_track, at_time):
        b = mt().blocks(int(track))[int(idx)]
        nb = mt().move_block(b, int(new_track),
                             int(round(float(at_time) * mt().el.fps)))
        return nb.start if nb else -1

    m("/block/move", block_move)

    def block_split(track, idx, at_time):
        b = mt().blocks(int(track))[int(idx)]
        at = int(round(float(at_time) * mt().el.fps))
        mt().split_block(b, at)
        return at

    m("/block/split", block_split)

    def block_trim(track, idx, new_len_time, from_start=0):
        b = mt().blocks(int(track))[int(idx)]
        nb = mt().trim_block(b, int(round(float(new_len_time)
                                          * mt().el.fps)),
                             from_start=bool(int(from_start)))
        return nb.length if nb else -1

    m("/block/trim", block_trim)

    def ablock_insert(clip_id, track=-1, at=0.0, length=None, seek=0.0,
                      vel=1.0):
        clip = clip_by_id(clip_id)
        n = int(round(float(length) * mt().el.fps)) if length is not None \
            else max(getattr(clip, "frames", 25), 25)
        ab = mt().insert_audio_block(
            int(track), getattr(clip, "unique_id", int(clip_id)),
            int(round(float(at) * mt().el.fps)), n, float(seek),
            float(vel))
        return len(mt().audio_blocks(int(track))) if ab else 0

    m("/mt/ablock/insert", ablock_insert)
    m("/mt/ablock/count",
      lambda track=-1: len(mt().audio_blocks(int(track))))

    def ablock_delete(track, idx):
        abs_ = mt().audio_blocks(int(track))
        mt().delete_audio_block(abs_[int(idx)])
        return len(mt().audio_blocks(int(track)))

    m("/mt/ablock/delete", ablock_delete)

    def gap_insert(at_time, length_time, *tracks):
        mt().insert_gap([int(t) for t in tracks] or
                        list(range(mt().n_tracks)),
                        int(round(float(at_time) * mt().el.fps)),
                        int(round(float(length_time) * mt().el.fps)))
        return 1

    m("/mt/gap/insert", gap_insert)

    def gap_remove(first_only=0):
        mt().remove_gaps(first_only=bool(int(first_only)))
        return 1

    m("/mt/gap/remove", gap_remove)

    m("/mt/track/volume/get",
      lambda track, frame=None: mt().track_volume(
          int(track), int(frame) if frame is not None else None))

    def track_volume_set(track, vol, frame=None):
        mt().set_track_volume(int(track), float(vol),
                              int(frame) if frame is not None else None)
        return 1

    m("/mt/track/volume/set", track_volume_set)

    def fx_region(fname, t0, t1, *tracks):
        trk = [int(t) for t in tracks] or [0]
        return mt().add_effect(str(fname), trk, int(t0),
                               int(t1) - int(t0))

    m("/mt/fx/region", fx_region)  # frames, not seconds (grid-exact)
    m("/mt/fx/list",
      lambda: ";".join(f"{d['id']},{d['filter']},{d['start']},{d['end']},"
                       f"{'|'.join(map(str, d['tracks']))}"
                       for d in mt().effects()))
    m("/mt/fx/remove", lambda fid: (mt().remove_effect(str(fid)), 1)[1])

    def afx_region(fname, t0, t1, *tracks):
        return mt().add_audio_effect(str(fname),
                                     [int(t) for t in tracks],
                                     int(t0), int(t1) - int(t0))

    m("/mt/afx/region", afx_region)  # audio-filter region (frames)

    def kf_set(fid, frame, pname, value):
        mt().set_keyframe(str(fid), int(frame), str(pname), float(value))
        return 1

    m("/mt/keyframe/set", kf_set)
    m("/mt/keyframe/remove",
      lambda fid, frame, pname: 1 if mt().remove_keyframe(
          str(fid), int(frame), str(pname)) else 0)
    m("/mt/keyframe/list",
      lambda fid, pname: ";".join(
          f"{fr},{v}" for fr, v in mt().keyframes(str(fid), str(pname))))

    def mt_render(with_audio=1):
        """Render the timeline to a NEW clip registered with the server
        (render_to_clip, events.c:4994). Returns the new clip id."""
        import numpy as np

        from ..io.clips import create_clip
        from ..io.jpeg_ingest import MJPEGMultiClipSource
        model = mt()
        if model.n_frames == 0:
            raise ValueError("empty timeline")
        uid_map = {}
        for cid, clip in srv.clips.items():
            uid_map[getattr(clip, "unique_id", cid)] = clip
        w = model.el.width or 64
        h = model.el.height or 64
        from ..graph.nodemodel import SinkSpec
        frames, _tcs = model.render(
            MJPEGMultiClipSource(uid_map, w, h, device=dev()),
            sink=SinkSpec(width=w, height=h),
            # the web UI's render job publishes per-batch progress here
            progress_cb=getattr(srv, "render_progress", None))
        out = create_clip(workdir(), w, h, model.el.fps,
                          name="mt_render")
        out.frames = len(frames)
        out.create_frame_index(all_virtual=False)
        # the render's HOST arrays straight to disk
        out.put_frames(range(len(frames)), frames)
        if int(with_audio):
            audio = model.render_audio(uid_map)
            if len(audio):
                out.write_audio(audio.astype(np.float32), 44100)
        out.save_header()
        cid = new_id()
        srv.clips[cid] = out
        return cid

    m("/mt/render", mt_render)
    m("/layout/clear", lambda: setattr(srv, "multitrack", None))

    def record_render(with_audio=1):
        """Render the last recorded performance to a NEW clip registered
        with the server — the reference's post-record render choice
        (deal_with_render_choice, events.c:5101). Generator takes render
        from their MJPEG scrap clips (frameloader.c:1212 role). Returns
        the new clip id."""
        import numpy as np

        from ..audio.engine import render_audio_from_seeks
        from ..io.clips import create_clip
        pl = p()
        uid_map = pl.recording_uid_map(srv.clips.values())
        el = pl.last_recording
        out = None
        n = 0
        # streamed chunks (bounded memory), rendered on the player's
        # device; frames land as HOST arrays
        for _tcs, chunk in pl.render_last_recording_batches(uid_map):
            if out is None:
                h, w = chunk.shape[-2], chunk.shape[-1]
                out = create_clip(workdir(), w, h, el.fps or 25.0,
                                  name="recorded")
            out.put_frames(range(n, n + len(chunk)), chunk)
            n += len(chunk)
        if out is None:
            raise RuntimeError("nothing recorded")
        out.frames = n
        out.create_frame_index(all_virtual=False)
        if int(with_audio):
            audio = render_audio_from_seeks(el, uid_map)
            if len(audio) and np.abs(audio).max() > 1e-6:
                out.write_audio(audio.astype(np.float32), 44100)
        out.save_header()
        autosave = os.path.join(str(workdir()),
                                "recording.autosave.json")
        bp = getattr(pl, "_rec_backup_path", None)
        for f in {autosave, str(bp) if bp else autosave}:
            if os.path.exists(f):
                os.unlink(f)   # take rendered: recovery no longer needed
        cid = new_id()
        srv.clips[cid] = out
        return cid

    m("/record/render", record_render)
    m("/record/discard", lambda: int(p().discard_recording()))

    def record_preview(max_seconds=30.0):
        """Preview the last take through the player's sink, paced to its
        fps (the preview arm of deal_with_render_choice, events.c:5955).
        Refuses while playback runs (sinks are not thread-safe against
        the serving loop). Runs on a worker thread; returns the frame
        count queued (the take's quantised length)."""
        import threading
        pl = p()
        if st().playing:
            raise RuntimeError("stop playback before previewing a take")
        el = getattr(pl, "last_recording", None)
        if el is None or not len(el.events):
            raise RuntimeError("nothing recorded")
        uid_map = pl.recording_uid_map(srv.clips.values())
        n = sum(1 for e in el.quantise(el.fps or 25.0)
                if getattr(e, "clips", None))

        def run(limit=float(max_seconds)):
            try:
                pl.preview_last_recording(uid_map, max_seconds=limit)
            except RuntimeError:
                pass  # playback (re)started meanwhile: preview refused

        threading.Thread(target=run, daemon=True,
                         name="record-preview").start()
        return n

    m("/record/preview", record_preview)

    def record_recover():
        """Load an autosaved recording from a crashed session (written
        under the server workdir by the api record path) and render it —
        deal_with_render_choice(is_recovery), events.c:5955. Returns the
        new clip id."""
        from ..events.event_list import EventList
        from ..io.scrap import scan_scrap_clips
        base = workdir()
        path = os.path.join(str(base), "recording.autosave.json")
        if not os.path.exists(path):
            raise RuntimeError("no autosaved recording")
        pl = p()
        with open(path) as fh:
            pl.last_recording = EventList.from_autosave(fh.read())
        pl.rec_scrap_clips.update(scan_scrap_clips(base))
        cid = record_render()
        if os.path.exists(path):   # record_render usually removed it
            os.unlink(path)
        return cid

    m("/record/recover", record_recover)

    # ---- message console (src/messaging.c d_print ring; the main-window
    # message area and LIVES_INFO/WARN/ERROR levels; crash-log dump
    # save_log_file, clip_load_save.c:151) --------------------------------
    def _console():
        from ..messaging import console
        return console

    m("/messages/recent",
      lambda n=50: "\n".join(_console().tail(int(n))))
    m("/messages/clear", lambda: _console().ring.clear())
    m("/messages/level/set",
      lambda lvl: setattr(_console(), "level", str(lvl)))
    m("/messages/level/get", lambda: _console().level)
    m("/messages/save", lambda path: _console().save_log(str(path)))
    # external controllers can annotate the console (cue notes mid-set)
    m("/messages/log",
      lambda msg, lvl="info": _console().d_print(str(msg), str(lvl)))


def _host(v):
    """An out-parameter value as the reply carries it: a tensor leaves
    the device as a numpy value (its text is the JAX array's)."""
    import torch
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
        return v[()] if v.ndim == 0 else v
    return v


def _open_videodev(srv, dev: str):
    from ..io.videodev import V4L2Source
    src = V4L2Source(dev, torch_device=srv.player.device)
    cid = max(srv.clips, default=0) + 1
    srv.clips[cid] = src
    return cid


def _fx_name_by_idx(idx):
    from ..effects.host import list_filters
    names = sorted(list_filters())
    i = int(idx)
    if not 0 <= i < len(names):
        raise IndexError(f"effect {i}")
    return names[i]
