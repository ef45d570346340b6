"""The port's OSC control surface (`lives_tpu_torch.osc`: protocol, client,
server, namespace) against lives_tpu's, on the CPU.

- Protocol: `build_message` writes the JAX package's bytes for random
  messages of every type tag (i, h, f, s, b, T, F, N), and `parse_packet`
  reads the same messages from those bytes, from hand-built float64 ('d')
  messages and from bundles.
- Method table: after `register_extended` the port's server holds exactly
  the JAX server's method paths.
- One OSC script, dispatched through both servers (a `Player` each, the
  port's with `device="cpu"`), gives equal reply lists (address and
  arguments, with each session's own directory written as `<root>`) and
  equal notify messages. It covers clip open, select, edit and the
  clipboard, effect keys and their typed parameters, pconx and cconx,
  `/mt` and `/block` with `/mt/render`, record, render, preview and
  discard, clip sets, `/omc`, the message console and the live sources
  whose hardware is absent here (`/clip/open/unicap`, `/vjack`,
  `/kinect`), whose replies are `/error` on the same path with the same
  message in both, and whose console lines agree. Rendered clips agree within
  1 LSB (torch's and XLA's float kernels differ by an ulp), the takes'
  event lists as `to_json` text, and the set trees, clip headers, frame
  indexes and device maps byte for byte.
- One round trip over a real UDP socket on port 0 through the port's
  `OSCClient`, with a time limit.

Determinism: each package's player module reads a `chip_smoke.ScriptedClock`
for its `time`, frames are shown with the serving loop stopped (the clock
based at the frame to show, as `tests/test_torch_player.py` does), chains
rebuild synchronously, event ids come from a counter in both event_list
modules (`tests/test_torch_weed_binary.py:_Counter`), and `random` (clip
handles and unique ids) is seeded the same before each session.
"""

import random
import socket
import struct
import threading
import time
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (the JAX side runs on the CPU)
import numpy as np
import pytest

import chip_smoke as cs
import lives_tpu.events.event_list as j_elmod
import lives_tpu.io.clips as j_clips
import lives_tpu.messaging as j_msg
import lives_tpu.osc.protocol as j_proto
import lives_tpu_torch.events.event_list as t_elmod
import lives_tpu_torch.io.clips as t_clips
import lives_tpu_torch.messaging as t_msg
import lives_tpu_torch.osc.protocol as t_proto
from lives_tpu.io.decoders import write_y4m
from lives_tpu.osc.server import OSCServer as JServer
from lives_tpu.player import CollectSink as JCollectSink
from lives_tpu.player import Player as JPlayer
from lives_tpu.player import player as j_player_mod
from lives_tpu_torch.osc import OSCClient
from lives_tpu_torch.osc.server import NOTIFY
from lives_tpu_torch.osc.server import OSCServer as TServer
from lives_tpu_torch.player import CollectSink as TCollectSink
from lives_tpu_torch.player import Player as TPlayer
from lives_tpu_torch.player import player as t_player_mod
from test_torch_clips import tree
from test_torch_weed_binary import _Counter

PKGS = ("jax", "torch")
MODS = {
    "jax": dict(player=j_player_mod, el=j_elmod, clips=j_clips,
                proto=j_proto, msg=j_msg),
    "torch": dict(player=t_player_mod, el=t_elmod, clips=t_clips,
                  proto=t_proto, msg=t_msg),
}
FPS = 25.0
#: the requester's address and the notify client's, as the server sees
#: them (its socket is a recorder here)
ADDR = ("127.0.0.1", 5001)
NOTIFY_PORT = 5002
#: replies whose value is each package's own version
VERSION_PATHS = {"/app/version/get", "/lives/version/get"}


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


# -- the protocol -------------------------------------------------------------

def _random_args(rng):
    """One argument of each kind the encoder knows, in random order and
    values: int32, int64, float32, str (padding 0-3), bytes (0-9), True,
    False, None."""
    args = [int(rng.integers(-2**31, 2**31)),
            int(rng.integers(2**31, 2**62)) * int(rng.choice([-1, 1])),
            float(np.float32(rng.normal() * 10.0 ** rng.integers(-3, 4))),
            "".join(chr(int(c)) for c in rng.integers(97, 123,
                                                      rng.integers(0, 9))),
            bytes(rng.integers(0, 256, rng.integers(0, 10), np.uint8)),
            True, False, None]
    return [args[i] for i in rng.permutation(len(args))]


@pytest.mark.parametrize("seed", range(8))
def test_build_message_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        path = "/" + "/".join("abcdefg"[:int(k)]
                              for k in rng.integers(1, 8, rng.integers(1, 4)))
        args = _random_args(rng)[:int(rng.integers(0, 9))]
        got = t_proto.build_message(path, *args)
        assert got == j_proto.build_message(path, *args)
        (tm,), (jm,) = t_proto.parse_packet(got), j_proto.parse_packet(got)
        assert tm.address == jm.address == path
        assert tm.args == jm.args == args


def test_int_boundaries_and_refusals_equal_jax():
    for v in (-2**31, 2**31 - 1, 2**31, -2**31 - 1, 2**63 - 1, -2**63):
        assert t_proto.build_message("/i", v) == j_proto.build_message(
            "/i", v)
    for pkg in (t_proto, j_proto):
        with pytest.raises(TypeError, match="cannot encode"):
            pkg.build_message("/x", object())
        with pytest.raises(ValueError, match="unsupported type tag"):
            pkg.parse_packet(b"/x\0\0,q\0\0")


def test_float64_and_tagless_messages_parse_equal():
    pkt = (b"/d\0\0" + b",dh\0" + struct.pack(">d", np.pi)
           + struct.pack(">q", -(1 << 40)))
    for pkt in (pkt, b"/bare\0\0\0", b"/bare\0\0\0xyz\0"):
        (t,), (j,) = t_proto.parse_packet(pkt), j_proto.parse_packet(pkt)
        assert (t.address, t.args) == (j.address, j.args)


@pytest.mark.parametrize("seed", range(3))
def test_bundles_parse_equal(seed):
    rng = np.random.default_rng(100 + seed)

    def bundle(depth):
        parts = []
        for k in range(int(rng.integers(1, 4))):
            if depth and rng.random() < 0.4:
                inner = bundle(depth - 1)
            else:
                inner = j_proto.build_message(f"/m{depth}/{k}",
                                              *_random_args(rng)[:3])
            parts.append(struct.pack(">i", len(inner)) + inner)
        return b"#bundle\0" + bytes(8) + b"".join(parts)
    pkt = bundle(2)
    t, j = t_proto.parse_packet(pkt), j_proto.parse_packet(pkt)
    assert [(m.address, m.args) for m in t] == \
        [(m.address, m.args) for m in j]
    assert len(t) >= 1


# -- the method table ---------------------------------------------------------

def test_method_table_equals_jax():
    js = JServer(JPlayer(sink=JCollectSink()))
    ts = TServer(TPlayer(sink=TCollectSink(), device="cpu"))
    try:
        assert set(ts.methods) == set(js.methods)
        assert len(ts.methods) >= 300
        assert ts.methods["/lives/methods/count"]() == len(js.methods)
        assert ts.methods["/lives/methods/list"]() == \
            js.methods["/lives/methods/list"]()
    finally:
        js.sock.close()
        ts.sock.close()


def test_server_refuses_without_cuda_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        TServer(TPlayer(sink=TCollectSink()))


# -- one script through both servers -----------------------------------------

class Recorder:
    """Stands in for the server's UDP socket: keeps what it sends."""

    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((bytes(data), addr))

    def close(self):
        pass


def write_clips(root):
    """Two seeded YUV4MPEG clips: 10 frames of 48x24 and 8 of 32x16."""
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for k, (n, w, h) in enumerate(((10, 48, 24), (8, 32, 16))):
        rng = np.random.default_rng(40 + k)
        path = root / f"clip{k + 1}.y4m"
        write_y4m(str(path), [(rng.integers(16, 236, (h, w), np.uint8),
                               rng.integers(16, 241, (h // 2, w // 2),
                                            np.uint8),
                               rng.integers(16, 241, (h // 2, w // 2),
                                            np.uint8))
                              for _ in range(n)], FPS)
        paths.append(str(path))
    return paths


class Session:
    """One package's server over a CPU player: a scripted clock, a
    recorder for its socket, its own work directory under `root`."""

    def __init__(self, pkg, root, monkeypatch, seed=18):
        self.pkg, self.root = pkg, Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        mods = MODS[pkg]
        self.proto = mods["proto"]
        self.clock = cs.ScriptedClock()
        monkeypatch.setattr(mods["player"], "time", self.clock)
        monkeypatch.setattr(mods["el"], "uuid", _Counter())
        monkeypatch.setattr(mods["clips"], "_handle_counter", 0)
        random.seed(seed)
        if pkg == "jax":
            self.player = JPlayer(sink=JCollectSink(), fps=FPS)
            self.srv = JServer(self.player)
        else:
            self.player = TPlayer(sink=TCollectSink(), fps=FPS,
                                  device="cpu")
            self.srv = TServer(self.player)
        self.player.async_compile = False
        self.player.prewarm_compile = False
        self.srv.sock.close()
        self.srv.sock = self.rec = Recorder()
        self.srv.workdir = str(self.root / "wd")
        (self.root / "wd").mkdir(exist_ok=True)
        self.console = mods["msg"].console
        self.console.ring.clear()
        self.console.level = "info"

    def send(self, path, *args):
        """Dispatch `path` as it arrives off the wire; the packets the
        server sent for it, parsed, with this session's root as
        `<root>`."""
        n = len(self.rec.sent)
        for msg in self.proto.parse_packet(
                self.proto.build_message(path, *args)):
            self.srv.dispatch(msg, ADDR)
        return [self.canon(d, a) for d, a in self.rec.sent[n:]]

    def canon(self, data, addr):
        root = str(self.root)
        if data.startswith(b"/"):
            (m,) = self.proto.parse_packet(data)
            args = [a.replace(root, "<root>") if isinstance(a, str) else a
                    for a in m.args]
            return addr, m.address, args
        return addr, data.decode().replace(root, "<root>")

    def show(self, frame):
        """Show source frame `frame` with the loop stopped, then step the
        clock one frame period."""
        p = self.player
        p.state.frame = -1
        p._clock0 = self.clock.now
        p._frame0 = float(frame)
        p.process_one()
        self.clock.now += 1.0 / FPS

    def close(self):
        self.srv._running = False


def frames_of(clip):
    """A clip's frames as host (3, H, W) int arrays."""
    from test_torch_clips import frame_px
    return [frame_px(clip, n) for n in range(clip.frames)]


def assert_clips_within_1(jc, tc):
    assert jc.frames == tc.frames > 0
    assert (jc.clip_dir / "header.lives").read_bytes() == \
        (tc.clip_dir / "header.lives").read_bytes()
    for name in ("frame_index", "audio"):
        jp, tp = jc.clip_dir / name, tc.clip_dir / name
        assert jp.exists() == tp.exists(), name
        if jp.exists():
            assert jp.read_bytes() == tp.read_bytes(), name
    for a, b in zip(frames_of(jc), frames_of(tc)):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


#: the script's steps: (path, args...) sent as they are, or ("@show", n),
#: ("@preview_wait",), ("@check", name) markers the runner acts on
def osc_script(paths, root):
    a, b = paths
    s = [
        ("/lives/open_notify_socket", NOTIFY_PORT),
        ("/messages/clear",), ("/app/ping",), ("/ping",), ("/app/name",),
        ("/app/name/get",), ("/lives/status/get",), ("/lives/mode/get",),
        ("/lives/constant/value/get", "LIVES_OSC_NOTIFY_CLIP_OPENED"),
        ("/test", 1, "two", 3.5),
        # clip open / select / queries
        ("/clip/open/file", a), ("/clip/open/file", b),
        ("/clip/count",), ("/clip/list",), ("/clip/foreground/get",),
        ("/clip/background/select", 2), ("/clip/background/get",),
        ("/clip/select", 1), ("/clip/name/get",), ("/clip/name/get", 2),
        ("/clip/frame/count",), ("/clip/size/get",), ("/clip/fps/get",),
        ("/clip/is_valid/get", 2), ("/clip/is_valid/get", 7),
        ("/clip/foreground/background/swap",), ("/clip/foreground/get",),
        ("/clip/select/next",), ("/clip/foreground/get",),
        ("/clip/foreground/set", 1), ("/clip/bookmark/select", 3),
        ("/clip/bookmark/get", 3),
        ("/video/fps/set", 30.0), ("/video/fps/get",),
        ("/video/fps/ratio/get",), ("/video/play/faster",),
        ("/video/fps/get",), ("/video/play/reset",), ("/video/fps/get",),
        ("/video/loop/set", 1), ("/video/loop/get",),
        ("/clip/background/fps/set", 12.5), ("/clip/background/fps/get",),
        ("/clip/background/fps/reset",), ("/video/play/get",),
        # the clip's own fps and an image of a frame
        ("/clip/fps/set", 20.0), ("/clip/fps/get",), ("/clip/fps/set", 25.0),
        ("/clip/frame/save_as_image", f"{root}/frame3.png", 3),
        # the clipboard: copy, paste, reverse, delete, undo, paste as new
        ("/clip/start/set", 1), ("/clip/end/set", 3),
        ("/clip/start/get",), ("/clip/end/get",),
        ("/clip/selection/copy",), ("/clipboard/reverse",),
        ("/clipboard/insert_after", 2), ("/clip/frame/count",),
        ("/clip/start/set", 0), ("/clip/end/set", 1),
        ("/clip/selection/delete",), ("/clip/undo",), ("/clip/frame/count",),
        ("/clip/selection/cut",), ("/clipboard/paste_as_new",),
        ("/clip/count",), ("/clip/frame/count",), ("/clip/select", 1),
        ("/clip/selection/merge", "crossfade", 0.0, 1.0),
        ("/clip/resample", 30.0), ("/clip/frame/count",),
        ("/clip/undo",), ("/clip/frame/count",),
        ("@check", "clip1"),
        ("/clip/save_as", f"{root}/saved.y4m", "yuv4mpeg", 1, 5),
        ("/clip/encode_as", f"{root}/encoded.y4m"),
        ("/clip/open/generator", "plasma", 32, 16, 25.0),
        ("/clip/size/get",), ("/clip/foreground/get",),
        ("/clip/close", 4), ("/clip/select", 1),
        ("/clip/select_all",), ("/rfx/params/get", "sepia"),
        ("/rfx/apply", "sepia"), ("/clip/undo",),
        # effect keys and their typed parameters
        ("/effect_key/map", 1, "brightness_contrast"),
        ("/effect_key/map", 1, "gaussian_blur"),
        ("/effect_key/maxmode/get", 1), ("/effect_key/mode/get", 1),
        ("/effect_key/mode/next", 1), ("/effect_key/name/get", 1),
        ("/effect_key/mode/set", 1, 1), ("/effect_key/enable", 1),
        ("/effect_key/state/get", 1), ("/effect_key/count",),
        ("/effect_key/parameter/count", 1),
        ("/effect_key/parameter/name/get", 1, 1),
        ("/effect_key/parameter/type/get", 1, 0),
        ("/effect_key/parameter/min/get", 1, 0),
        ("/effect_key/parameter/max/get", 1, 1),
        ("/effect_key/parameter/default/get", 1, 1),
        ("/effect_key/parameter/value/set", 1, 1, 2.5),
        ("/effect_key/parameter/value/get", 1, 1),
        ("/effect_key/nparameter/default/set", 1, 0, 0.25),
        ("/effect_key/parameter/value/get", 1, 0),
        ("/effect_key/parameter/is_transition", 1, 0),
        ("/effect_key/parameter/value/get", 1, 9),
        ("/effect_key/disable", 1),
        ("/effect_key/map", 2, "vignette"), ("/effect_key/toggle", 2),
        ("/effect_key/state/get", 2),
        # pconx / cconx over two analysers' outputs
        ("/effect_key/map", 4, "motion_mask"),
        ("/effect_key/map", 5, "mask_overlay"),
        ("/effect_key/map", 6, "saturation"),
        ("/effect_key/enable", 4), ("/effect_key/enable", 5),
        ("/effect_key/enable", 6),
        ("/effect_key/outparameter/count", 4),
        ("/effect_key/outparameter/name/get", 4, 0),
        ("/effect_key/outparameter/type/get", 4, 0),
        ("/effect_key/outparameter/value/get", 4, 0),
        ("/effect_key/outchannel/active/count", 4),
        ("/effect_key/inchannel/active/count", 5),
        ("/effect_key/outchannel/palette/get", 4, 1),
        ("/effect_key/inchannel/palette/get", 5, 1),
        ("/effect_key/outparameter/connection/add", 4, 0, 6, 0),
        ("/effect_key/outparameter/connection/list",),
        ("/effect_key/outchannel/connection/add", 4, 0, 5, 0),
        ("/effect_key/outchannel/connection/list",),
        ("/effect_key/outparameter/connection/delete", 4, 0),
        ("/effect_key/outchannel/connection/delete", 4, 0),
        ("/effect_key/outparameter/connection/list",),
        ("/effect_key/disable", 4), ("/effect_key/disable", 5),
        ("/effect_key/disable", 6), ("/effect_key/unmap", 6),
        # the multitrack: blocks, an effect region with a keyframe, render
        ("/mt/ctrack/set", 0), ("/block/insert", 1),
        ("/block/insert", 2, 1, 0.12), ("/block/count", 1),
        ("/block/start/time/get", 1, 0), ("/block/end/time/get", 0, 0),
        ("/mt/fx/region", "crossfade", 2, 6, 0, 1), ("/mt/fx/list",),
        ("/mt/keyframe/set", "@fid", 3, "amount", 0.75),
        ("/mt/keyframe/list", "@fid", "amount"),
        ("/mt/nframes/get",), ("/mt/ntracks/get",), ("@check", "mt_el"),
        ("/mt/render", 0), ("@check", "mt"),
        ("/mt/undo",), ("/mt/fx/list",), ("/mt/redo",),
        ("/block/move", 1, 0, 1, 0.2), ("/block/split", 1, 0, 0.36),
        ("/block/count", 1), ("/mt/gravity/set", 1), ("/mt/gravity/get",),
        # a take: recorded with the loop stopped, rendered, previewed
        ("/effect_key/enable", 1), ("/video/play",), ("/record/enable",),
        ("@show", 0), ("@show", 1), ("/effect_key/enable", 2),
        ("@show", 2), ("@show", 3), ("/clip/select", 2), ("@show", 4),
        ("@show", 5), ("/record/disable",), ("/video/stop",),
        ("@check", "take"), ("/record/render", 0), ("@check", "render"),
        ("/record/preview", 5.0), ("@preview_wait",),
        ("/video/play",), ("/record/enable",), ("@show", 0), ("@show", 1),
        ("/record/disable",), ("/video/stop",), ("/record/discard",),
        ("/record/discard",), ("/video/play/get",),
        ("/effect_key/reset",),
        # clip sets
        ("/clipset/save", "set_a"), ("/clipset/list",),
        ("/clipset/name/get",), ("@check", "set"),
        ("/clipset/load", "set_a"), ("/clip/count",),
        # OMC learning
        ("/omc/macro/list",), ("/omc/learn/start", "blend"),
        ("/omc/learn/status",), ("/omc/feed_midi", "b0077f"),
        ("/omc/learn/status",), ("/omc/feed_midi", "b00740"),
        ("/omc/mappings/list",), ("/omc/map/save", f"{root}/map.json"),
        ("/omc/mapping/clear",), ("/omc/mappings/list",),
        ("/omc/map/load", f"{root}/map.json"), ("/omc/mappings/list",),
        # prefs-free queries and failures that both packages refuse alike
        ("/no/such/method", 1), ("/clip/select", 99),
        ("/clipboard/paste_as_new", 1, 2, 3),
        ("/effect_key/parameter/name/get", 7, 0),
        ("/video/play/parameter/value/get", 0),
        # the live sources, their hardware absent: the same /error
        ("@error", "/clip/open/unicap", "/dev/video_absent"),
        ("@error", "/clip/open/vjack"),
        ("@error", "/clip/open/kinect", 0),
        # the message console
        ("/messages/log", "cue: breakdown", "warn"),
        ("/messages/level/set", "error"), ("/messages/level/get",),
        ("/messages/level/set", "info"),
        ("/messages/recent", 200), ("/clip/close", 2), ("/clip/count",),
    ]
    return s


def run_script(pkg, root, paths, monkeypatch):
    """Run `osc_script` on a fresh session; returns (the session, its
    replies in order, {check name: what it observed})."""
    s = Session(pkg, root, monkeypatch)
    out, checks, fid = [], {}, None
    for step in osc_script(paths, root):
        head = step[0]
        if head == "@show":
            s.show(step[1])
            continue
        if head == "@preview_wait":
            for t in threading.enumerate():
                if t.name == "record-preview":
                    t.join(timeout=60)
                    assert not t.is_alive(), "preview did not finish"
            out.append(("preview_frames", len(s.player.sink.frames)))
            continue
        if head == "@error":
            got = s.send(*step[1:])
            assert [(r[1], r[2][0]) for r in got if r[1] == "/error"] == \
                [("/error", step[1])], got
            out.append(("error", step[1],
                        [r[2] for r in got if r[1] == "/error"]))
            continue
        if head == "@check":
            checks[step[1]] = observe(s, step[1])
            continue
        step = tuple(fid if a == "@fid" else a for a in step)
        got = s.send(*step)
        if head == "/mt/fx/region":
            fid = got[0][2][0]
        out.extend(got)
    s.close()
    return s, out, checks


def observe(s, what):
    srv = s.srv
    if what == "clip1":
        return srv.clips[1]
    if what == "mt":
        return srv.clips[max(srv.clips)]
    if what == "take":
        return s.player.last_recording.to_json()
    if what == "mt_el":
        return srv.multitrack.el.to_json()
    if what == "render":
        return srv.clips[max(srv.clips)]
    if what == "set":
        return tree(Path(srv.workdir) / "sets")
    raise KeyError(what)


def test_osc_script_matches_jax(tmp_path, monkeypatch):
    paths = write_clips(tmp_path / "media")
    runs = {pkg: run_script(pkg, tmp_path / pkg, paths, monkeypatch)
            for pkg in PKGS}
    (js, jout, jchk), (ts, tout, tchk) = runs["jax"], runs["torch"]
    assert len(tout) == len(jout)
    for j, t in zip(jout, tout):
        if len(j) == 3 and j[1] in VERSION_PATHS:
            continue
        assert t == j
    # the notify socket saw the same messages
    assert any(r[0] == ("127.0.0.1", NOTIFY_PORT) for r in tout)
    assert jchk["take"] == tchk["take"]
    assert jchk["mt_el"] == tchk["mt_el"]
    for name in ("clip1", "mt", "render"):
        assert_clips_within_1(jchk[name], tchk[name])
    jset, tset = jchk["set"], tchk["set"]
    assert sorted(jset) == sorted(tset)
    for k in jset:
        if k.endswith(".png"):
            continue   # the pixels are held within 1 LSB above
        assert jset[k] == tset[k], k
    assert (tmp_path / "jax" / "map.json").read_text() == \
        (tmp_path / "torch" / "map.json").read_text()
    from PIL import Image
    ja, ta = (np.asarray(Image.open(tmp_path / p / "frame3.png"), int)
              for p in PKGS)
    assert np.abs(ja - ta).max() <= 1
    for name in ("saved.y4m", "encoded.y4m"):
        ja, ta = ((tmp_path / p / name).read_bytes() for p in PKGS)
        assert len(ja) == len(ta) > 0
        d = np.abs(np.frombuffer(ja, np.uint8).astype(int)
                   - np.frombuffer(ta, np.uint8).astype(int))
        assert d.max() <= 1, name


class MemClip:
    """An in-memory clip of seeded frames, as either package's Layers,
    with a fixed unique id (a clip a fresh session reopens)."""

    def __init__(self, pkg, n=12, h=24, w=48, uid=7):
        self.pkg, self.frames, self.fps = pkg, n, FPS
        self.width, self.height, self.unique_id = w, h, uid
        self.name = f"mem{uid}"

    def get_frame(self, n):
        a = np.random.default_rng(self.unique_id * 131 + n).integers(
            0, 256, (3, self.height, self.width), np.uint8)
        if self.pkg == "jax":
            from lives_tpu.layer import Layer
            return Layer(planes=(jnp.asarray(a),), palette=1)
        import torch
        from lives_tpu_torch.layer import Layer
        return Layer(planes=(torch.from_numpy(a),), palette=1)


def test_osc_record_recover_and_discard_match_jax(tmp_path, monkeypatch):
    """The pure-OSC crash flow (`tests/test_osc_namespace.py:
    test_osc_record_recover_and_discard`), frames driven with the loop
    stopped: a take autosaves under the server's workdir, a FRESH server
    over that workdir renders it by `/record/recover`, and
    `/record/discard` drops the next take and its autosave."""
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        obs = []

        def take(s, n=4):
            s.srv.clips[1] = MemClip(pkg)
            s.player.state.fg_clip = s.srv.clips[1]
            obs.extend(s.send("/effect_key/map", 1, "negate"))
            for path in ("/video/play", "/record/enable"):
                obs.extend(s.send(path))
            for i in range(n):
                if i == 2:
                    obs.extend(s.send("/effect_key/enable", 1))
                s.show(i)
            for path in ("/record/disable", "/video/stop"):
                obs.extend(s.send(path))

        s1 = Session(pkg, root, monkeypatch)
        obs.extend(s1.send("/record/recover"))
        take(s1)
        autosave = Path(s1.srv.workdir) / "recording.autosave.json"
        obs.append(("autosave", autosave.exists()))
        s1.close()
        s2 = Session(pkg, root, monkeypatch)
        s2.srv.workdir = s1.srv.workdir
        s2.srv.clips[1] = MemClip(pkg)
        obs.extend(s2.send("/record/recover"))
        cid = max(s2.srv.clips)
        obs.append(("autosave", autosave.exists()))
        clip = s2.srv.clips[cid]
        take(s2, 3)
        obs.append(("autosave", autosave.exists()))
        obs.extend(s2.send("/record/discard"))
        obs.append(("autosave", autosave.exists()))
        s2.close()
        out[pkg] = (obs, clip)
    assert out["torch"][0] == out["jax"][0]
    assert ("autosave", True) in out["torch"][0]
    assert_clips_within_1(out["jax"][1], out["torch"][1])
    assert out["torch"][1].frames == 4


# -- a real UDP round trip ----------------------------------------------------

def test_udp_round_trip_through_the_client(tmp_path):
    p = TPlayer(sink=TCollectSink(), device="cpu")
    srv = TServer(p, port=0)
    srv.workdir = str(tmp_path)
    srv.start()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    try:
        with OSCClient(port=srv.port, timeout=5.0) as c:
            assert c.query1("/ping") == "pong"
            c.send("/lives/open_notify_socket", rx.getsockname()[1])
            assert c.barrier() == []
            c.send("/video/fps/set", 12.5)
            c.send("/no/such/path")
            assert c.barrier() == ["/no/such/path unknown method"]
            assert c.query1("/video/fps/get") == 12.5
            with pytest.raises(RuntimeError, match="/clip/select"):
                c.query("/clip/select", 3)
            c.send("/video/play")
            assert rx.recv(512).decode().startswith(
                f"{NOTIFY.PLAYBACK_STARTED}|")
            c.send("/video/stop")
            assert c.barrier() == []
            assert not p.state.playing
    finally:
        rx.close()
        srv.stop()
    assert not srv._thread.is_alive()


def test_control_surfaces_import_without_jax():
    """The port's control modules import with jax and lives_tpu made
    unimportable, and leave jax out of `sys.modules`."""
    import subprocess
    import sys
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'lives_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lives_tpu_torch.api, lives_tpu_torch.osc.namespace\n"
        "import lives_tpu_torch.sets, lives_tpu_torch.omc\n"
        "import lives_tpu_torch.messaging, lives_tpu_torch.models\n"
        "import lives_tpu_torch.osc.client, lives_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'lives_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=str(Path(__file__).resolve().parents[1]))
    assert r.returncode == 0 and r.stdout.strip() == "clean", r.stderr
