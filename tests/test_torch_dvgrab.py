"""FireWire DV grab of lives_tpu_torch (`io/dvgrab.py`,
`api.LiVESApp.grab_firewire`) against lives_tpu's, over the same mock
raw1394, rom1394 and avc1394 libraries.

The mocks and the DV synthesis are `tests/test_dvgrab.py`'s, copied. Each
scenario feeds the same packets to both packages: the frames, the files
(byte for byte), the transport calls and the clips opened from a grab
must be equal. The DV round trip into a clip needs the libav lane, in
either package: where `load_avbridge()` is None those tests say so.
"""

import ctypes

import numpy as np
import pytest

import lives_tpu.io.dvgrab as jdv
import lives_tpu_torch.io.dvgrab as tdv
from test_torch_bridges import jax_bridge

DV = {"jax": jdv, "torch": tdv}


class MockRaw:
    """The raw1394 calls FirewireCamera/grab use, with an iso loop that
    replays a canned packet list through the registered handler."""

    def __init__(self, packets=(), n_ports=1, n_nodes=2):
        self.packets = list(packets)
        self.n_ports, self.n_nodes = n_ports, n_nodes
        self.handler = None
        self.iso_started = self.iso_stopped = False
        self.destroyed = 0

    def raw1394_new_handle(self):
        return 0xBEEF

    def raw1394_get_port_info(self, handle, pinf, n):
        return self.n_ports

    def raw1394_set_port(self, handle, port):
        return 0

    def raw1394_get_nodecount(self, handle):
        return self.n_nodes

    def raw1394_destroy_handle(self, handle):
        self.destroyed += 1

    def raw1394_set_iso_handler(self, handle, channel, cb):
        self.handler = cb

    def raw1394_start_iso_rcv(self, handle, channel):
        self.iso_started = True

    def raw1394_stop_iso_rcv(self, handle, channel):
        self.iso_stopped = True

    def raw1394_loop_iterate(self, handle):
        if not self.packets:
            return -1
        pkt = self.packets.pop(0)
        buf = ctypes.create_string_buffer(pkt, len(pkt))
        self.handler(None, 63, len(pkt),
                     ctypes.cast(buf, ctypes.c_void_p).value)
        return 0


class MockRom:
    def __init__(self, avc_node=1):
        self.avc_node = avc_node
        self._last = None

    def rom1394_get_directory(self, handle, node, rom_dir):
        self._last = node
        return 0

    def rom1394_get_node_type(self, rom_dir):
        return (jdv.ROM1394_NODE_TYPE_AVC if self._last == self.avc_node
                else 0)


class MockAvc:
    def __init__(self, vcr_node=1):
        self.vcr_node = vcr_node
        self.calls = []

    def avc1394_check_subunit_type(self, handle, node, subtype):
        assert subtype == jdv.AVC1394_SUBUNIT_TYPE_VCR
        return 1 if node == self.vcr_node else 0

    def __getattr__(self, name):
        if name.startswith("avc1394_vcr_"):
            def call(handle, device, _n=name):
                self.calls.append((_n.removeprefix("avc1394_vcr_"),
                                   device))
            return call
        raise AttributeError(name)


def synth_dv_frame(seed: int) -> bytes:
    """A PAL-sized DV frame with correct DIF ids: 12 sequences x 150
    blocks x 80 bytes, each sequence led by an SCT=0 header block."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for seq in range(12):
        for blk in range(150):
            body = rng.integers(0, 256, 77, np.uint8).tobytes()
            if blk == 0:
                out += bytes([0x00, seq << 4, 0x00]) + body
            else:
                out += bytes([0x40 | (blk & 0x1F), seq << 4, 0x00]) + body
    assert len(out) == jdv.DV_FRAME_PAL
    return bytes(out)


def to_packets(frames):
    """CIP-wrap a DV stream as 8+480-byte iso packets, with empty CIP
    keepalives sprinkled in."""
    stream = b"".join(frames)
    pkts = []
    for ofs in range(0, len(stream), 480):
        pkts.append(b"\x00" * 8 + stream[ofs:ofs + 480])
        if ofs % 4800 == 0:
            pkts.append(b"\x00" * 8)
    return pkts


def libs(packets=(), avc_node=1, vcr_node=1):
    return (MockRaw(packets), MockRom(avc_node), MockAvc(vcr_node))


def test_constants_match_jax():
    for name in ("CAM_FORMAT_DV", "CAM_FORMAT_HDV", "ROM1394_NODE_TYPE_AVC",
                 "AVC1394_SUBUNIT_TYPE_VCR", "DV_FRAME_NTSC", "DV_FRAME_PAL",
                 "_DIF_BLOCK", "_CIP_HEADER"):
        assert getattr(tdv, name) == getattr(jdv, name), name
    assert ctypes.sizeof(tdv._PortInfo) == ctypes.sizeof(jdv._PortInfo)


@pytest.mark.parametrize("cut", [None, 48000, 96000, 143520])
def test_assembler_matches_jax(cut):
    """Whole frames, or a frame cut short mid-stream (a bus reset): the
    same frames out, the same drops, in both packages."""
    f = [synth_dv_frame(i) for i in range(4)]
    if cut is not None:
        f[1] = f[1][:cut]
    pkts = to_packets(f) + [b"\x00" * 8 + synth_dv_frame(9)[:480]]
    res = {}
    for pkg, mod in DV.items():
        asm = mod.DVFrameAssembler()
        got = []
        for p in pkts:
            got += asm.feed(p)
        res[pkg] = (got, asm.frames_dropped)
    assert res["torch"] == res["jax"]
    assert res["torch"][1] == (0 if cut is None else 1)


def test_find_free_camfile_matches_jax(tmp_path):
    for fmt, base in ((tdv.CAM_FORMAT_DV, "dvgrab-"),
                      (tdv.CAM_FORMAT_HDV, "cap")):
        names = []
        for _ in range(3):
            t = tdv.find_free_camfile(tmp_path, base, fmt)
            assert t == jdv.find_free_camfile(tmp_path, base, fmt)
            t.write_bytes(b"x")
            names.append(t.name)
        assert names[0] in ("dvgrab-001.dv", "cap0001.mpg")


@pytest.mark.parametrize("avc_node,vcr_node", [(1, 1), (0, 0), (1, 99)])
def test_discovery_and_transport_match_jax(avc_node, vcr_node):
    res = {}
    for pkg, mod in DV.items():
        ls = libs(avc_node=avc_node, vcr_node=vcr_node)
        cam = mod.FirewireCamera.find(ls)
        if cam is not None:
            for step in ("play", "pause", "rewind", "forward", "stop",
                         "eject"):
                getattr(cam, step)()
            cam.close()
            cam.close()
            res[pkg] = (cam.port, cam.device, ls[2].calls, ls[0].destroyed)
        else:
            res[pkg] = (None, ls[0].destroyed)
    assert res["torch"] == res["jax"]
    assert (res["torch"][0] is None) == (avc_node != vcr_node)


def test_discovery_is_gated_like_jax(monkeypatch):
    assert (tdv.load_firewire_libs() is None) == \
        (jdv.load_firewire_libs() is None)
    for mod in DV.values():
        monkeypatch.setattr(mod, "load_firewire_libs", lambda: None)
        assert mod.FirewireCamera.find() is None


@pytest.mark.parametrize("autosplit", [False, True])
def test_grab_writes_the_files_jax_writes(tmp_path, autosplit):
    """A gap after frame 0 (frame 1 cut): the same files, byte for byte,
    split where autosplit asks."""
    f = [synth_dv_frame(i) for i in range(4)]
    pkts = to_packets([f[0], f[1][:96000], f[2], f[3],
                       synth_dv_frame(9)[:480]])
    res = {}
    for pkg, mod in DV.items():
        ls = libs(pkts)
        cam = mod.FirewireCamera.find(ls)
        d = tmp_path / pkg
        d.mkdir()
        session = mod.DVGrabSession(d, base="take", autosplit=autosplit)
        files = mod.grab(cam, session)
        res[pkg] = ([(p.name, p.read_bytes()) for p in files],
                    session.frames_written, ls[0].iso_started,
                    ls[0].iso_stopped)
    assert res["torch"] == res["jax"]
    names = [n for n, _ in res["torch"][0]]
    assert names == (["take001.dv", "take002.dv"] if autosplit
                     else ["take001.dv"])


def test_grab_stops_at_max_frames_and_splits_like_jax(tmp_path):
    f = [synth_dv_frame(i) for i in range(5)]
    res = {}
    for pkg, mod in DV.items():
        ls = libs(to_packets(f))
        cam = mod.FirewireCamera.find(ls)
        d = tmp_path / pkg
        d.mkdir()
        session = mod.DVGrabSession(d)
        files = mod.grab(cam, session, max_frames=2)
        session.split()
        res[pkg] = ([p.read_bytes() for p in files], len(ls[0].packets))
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == [f[0] + f[1]]


def test_grab_hdv_streams_the_payload_like_jax(tmp_path):
    payload = bytes(range(256)) * 10
    pkts = [b"\x00" * 8 + payload[i:i + 480]
            for i in range(0, len(payload), 480)] + [b"\x00" * 8]
    res = {}
    for pkg, mod in DV.items():
        cam = mod.FirewireCamera.find(libs(pkts))
        d = tmp_path / pkg
        d.mkdir()
        files = mod.grab(cam, mod.DVGrabSession(d, base="hdv",
                                                fmt=mod.CAM_FORMAT_HDV))
        res[pkg] = [(p.name, p.read_bytes()) for p in files]
    assert res["torch"] == res["jax"] == [("hdv0001.mpg", payload)]


def test_grab_that_captured_nothing_leaves_no_file(tmp_path):
    res = {}
    for pkg, mod in DV.items():
        d = tmp_path / pkg
        d.mkdir()
        cam = mod.FirewireCamera.find(libs([b"\x00" * 8] * 5))
        session = mod.DVGrabSession(d)
        session._open_next()            # a file opened, nothing written
        res[pkg] = (mod.grab(cam, session), sorted(p.name
                                                   for p in d.iterdir()))
    assert res["torch"] == res["jax"] == ([], [])


def real_dv(tmp_path, n, av):
    """n PAL frames of real DV (the libav bridge's dvvideo encoder)."""
    src = tmp_path / "src.dv"
    enc = av.AVEncodeSession(str(src), 720, 576, 25.0, vcodec="dvvideo",
                             container="dv")
    for i in range(n):
        enc.write_frame(np.full((576, 720, 3), 30 + i * 60, np.uint8))
    enc.close()
    raw = src.read_bytes()
    assert len(raw) == n * jdv.DV_FRAME_PAL
    return raw


@pytest.fixture
def libav():
    from lives_tpu_torch.io import av
    if av.load_avbridge() is None:
        pytest.skip(f"the libav lane is absent: {av.absent_reason()}")
    jax_bridge("avbridge")
    return av


def test_real_dv_grab_opens_as_the_jax_clip(tmp_path, libav):
    """Real DV over the mock bus: the captured file is the source's bytes
    in both packages, and it opens as a clip whose frames are the JAX
    clip's (the libav lane's planes, exact)."""
    from lives_tpu.io.clips import open_clip as j_open_clip
    from lives_tpu_torch.io.clips import open_clip
    raw = real_dv(tmp_path, 3, libav)
    frames = [raw[i:i + jdv.DV_FRAME_PAL]
              for i in range(0, len(raw), jdv.DV_FRAME_PAL)]
    pkts = to_packets(frames) + [b"\x00" * 8 + synth_dv_frame(7)[:480]]
    files = {}
    for pkg, mod in DV.items():
        cam = mod.FirewireCamera.find(libs(list(pkts)))
        d = tmp_path / pkg
        d.mkdir()
        files[pkg] = mod.grab(cam, mod.DVGrabSession(d, base="cam"),
                              max_frames=3)
        assert files[pkg][0].read_bytes() == raw
    t = open_clip(str(files["torch"][0]), tmp_path / "tw")
    j = j_open_clip(str(files["jax"][0]), tmp_path / "jw")
    assert (t.frames, t.width, t.height) == (j.frames, j.width, j.height) \
        == (3, 720, 576)
    for i in range(3):
        for a, b in zip(t.get_frame(i).planes, j.get_frame(i).planes):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_api_grab_firewire_matches_jax(tmp_path, libav):
    """`LiVESApp.grab_firewire` (`lives_tpu/api.py:597-624`): the camera
    found, the tape rolled and stopped around the grab, the capture under
    the work directory opened as clips; [] where no camera answers."""
    from lives_tpu.api import LiVESApp as JApp
    from lives_tpu_torch.api import LiVESApp
    raw = real_dv(tmp_path, 2, libav)
    pkts = to_packets([raw[:jdv.DV_FRAME_PAL], raw[jdv.DV_FRAME_PAL:]]) \
        + [b"\x00" * 8 + synth_dv_frame(7)[:480]]
    res = {}
    for pkg in DV:
        ls = libs(list(pkts))
        app = JApp(workdir=tmp_path / pkg) if pkg == "jax" else \
            LiVESApp(workdir=tmp_path / pkg, device="cpu")
        clips = app.grab_firewire(max_frames=2, libs=ls)
        cap = sorted(p.name for p in (tmp_path / pkg / "capture").iterdir())
        res[pkg] = (len(clips), [c._clip.frames for c in clips],
                    ls[2].calls, cap,
                    app.grab_firewire(max_frames=1,
                                      libs=libs(avc_node=5, vcr_node=5)[:2]
                                      + (MockAvc(vcr_node=7),)))
    assert res["torch"] == res["jax"]
    assert res["torch"][:3] == (1, [2], [("play", 1), ("stop", 1)])


def test_api_grab_firewire_without_libs_is_empty(tmp_path, monkeypatch):
    """Gated: no raw1394 libs, no camera: [] and a console warning, as
    the JAX app (no `NotImplementedError` any more)."""
    from lives_tpu_torch import api as t_api
    from lives_tpu_torch.messaging import console
    monkeypatch.setattr(tdv, "load_firewire_libs", lambda: None)
    app = t_api.LiVESApp(workdir=tmp_path / "wd", device="cpu")
    assert app.grab_firewire(10) == []
    assert "no FireWire AVC camera" in console.tail(1)[0]
