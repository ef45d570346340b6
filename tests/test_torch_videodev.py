"""The V4L2 capture of lives_tpu_torch (`io/videodev.py`) against
lives_tpu's, on the same bytes.

There is no camera here or on the card: the kernel's side of the ioctl
interface is played by a stand-in for `fcntl.ioctl` and `select.select`
that dequeues canned buffers, so `V4L2Source.get_frame` runs in both
packages on the same YUYV and MJPEG bytes. Frames: u8 within 1 LSB (YUYV
crosses as its bytes; MJPEG decodes through PIL in both, exact).
"""

import fcntl
import io
import select
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import lives_tpu.io.videodev as jv
import lives_tpu_torch.io.videodev as tv
from lives_tpu_torch.constants import Palette

V4L = {"jax": jv, "torch": tv}


def yuyv_bytes(w, h, seed):
    return np.random.default_rng(seed).integers(16, 236, w * h * 2,
                                                np.uint8).tobytes()


def mjpeg_bytes(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 90 * np.sin(xx / 5.0 + seed) * np.cos(yy / 4.0)
            + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.stack([base, 255 - base, np.roll(base, 3, 1)], -1)
                    ).save(buf, "JPEG", quality=85)
    return buf.getvalue()


class FakeV4L2:
    """DQBUF hands out the canned buffers in turn (index and bytesused
    written into the v4l2_buffer as the kernel would); the other ioctls
    are recorded."""

    def __init__(self, payloads):
        self.payloads = list(payloads)
        self.k = 0
        self.calls = []

    def ioctl(self, fd, req, arg, *rest):
        self.calls.append(req)
        if req == jv.VIDIOC_DQBUF:
            struct.pack_into("<I", arg, 0, self.k % len(self.payloads))
            struct.pack_into("<I", arg, 44,
                             len(self.payloads[self.k % len(self.payloads)]))
            self.k += 1
        return 0


def fake_source(pkg, v4l2, w, h, pixfmt):
    """A V4L2Source as its constructor leaves it, on the fake's
    buffers (the constructor's own ioctls need a device node)."""
    src = V4L[pkg].V4L2Source.__new__(V4L[pkg].V4L2Source)
    src.fd, src.width, src.height, src.pixfmt = -1, w, h, pixfmt
    src._buffers = list(v4l2.payloads)
    if pkg == "torch":
        src.torch_device = torch.device("cpu")
    return src


def host(lay):
    return [p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in lay.planes]


@pytest.fixture
def v4l2(monkeypatch):
    def install(payloads):
        d = FakeV4L2(payloads)
        monkeypatch.setattr(fcntl, "ioctl", d.ioctl)
        monkeypatch.setattr(select, "select", lambda r, w, x, t: (r, w, x))
        return d
    return install


def test_constants_match_jax():
    for name in dir(jv):
        if name.startswith(("VIDIOC_", "V4L2_")):
            assert getattr(tv, name) == getattr(jv, name), name


@pytest.mark.parametrize("geom", [(32, 16), (64, 48), (10, 6)])
def test_yuyv_frames_match_jax(v4l2, geom):
    """YUYV bytes, clamped range: the same planes in both packages (the
    port's on its device), three buffers in turn."""
    w, h = geom
    d = v4l2([yuyv_bytes(w, h, s) for s in range(3)])
    res = {}
    for pkg in V4L:
        d.k = 0
        src = fake_source(pkg, d, w, h, jv.V4L2_PIX_FMT_YUYV)
        lays = [src.get_frame(n) for n in range(3)]
        res[pkg] = [(host(l), l.palette, l.clamping) for l in lays]
    for (tp, tpal, tcl), (jp, jpal, jcl) in zip(res["torch"], res["jax"]):
        assert (tpal, tcl) == (jpal, jcl) and tpal == int(Palette.YUYV)
        for a, b in zip(tp, jp):
            assert a.shape == b.shape
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() \
                <= 1


@pytest.mark.parametrize("geom", [(32, 16), (40, 24)])
def test_mjpeg_frames_match_jax(v4l2, geom):
    w, h = geom
    d = v4l2([mjpeg_bytes(w, h, s) for s in range(2)])
    res = {}
    for pkg in V4L:
        d.k = 0
        src = fake_source(pkg, d, w, h, jv.V4L2_PIX_FMT_MJPEG)
        res[pkg] = [(host(src.get_frame(n)), src.get_frame(n).palette)
                    for n in range(2)]
    for (tp, tpal), (jp, jpal) in zip(res["torch"], res["jax"]):
        assert tpal == jpal == int(Palette.RGB24)
        np.testing.assert_array_equal(tp[0], jp[0])


def test_frame_layer_is_on_the_asked_device_and_refuses_unknown_formats():
    lay = tv.frame_layer(yuyv_bytes(8, 4, 1), tv.V4L2_PIX_FMT_YUYV, 8, 4,
                         "cpu")
    assert lay.planes[0].device.type == "cpu"
    assert (lay.width, lay.height) == (8, 4)
    for call in (lambda: tv.frame_layer(b"", 0x1234, 8, 4, "cpu"),):
        with pytest.raises(RuntimeError, match="unsupported pixfmt"):
            call()


def test_dequeue_requeues_each_buffer_like_jax(v4l2):
    d = v4l2([yuyv_bytes(8, 4, s) for s in range(2)])
    calls = {}
    for pkg in V4L:
        d.k, d.calls = 0, []
        src = fake_source(pkg, d, 8, 4, jv.V4L2_PIX_FMT_YUYV)
        src.get_frame(0)
        src.get_frame(0)
        calls[pkg] = list(d.calls)
    assert calls["torch"] == calls["jax"] == [jv.VIDIOC_DQBUF,
                                              jv.VIDIOC_QBUF] * 2


def test_list_devices_matches_jax():
    assert tv.list_devices() == jv.list_devices()


def test_osc_open_unicap_route_like_jax(tmp_path, monkeypatch):
    """`/clip/open/unicap`'s handler (`lives_tpu/osc/namespace.py:
    1447-1453`): a node that does not exist raises the same error in both
    packages (the dispatch's `/error`, `tests/test_torch_osc.py`); a
    source that opens takes the next clip id, and the port's takes the
    player's device."""
    from lives_tpu.osc import namespace as jns
    from lives_tpu.osc.server import OSCServer as JServer
    from lives_tpu.player import CollectSink as JCollect
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.osc import namespace as tns
    from lives_tpu_torch.osc.server import OSCServer
    from lives_tpu_torch.player import CollectSink, Player
    node = str(tmp_path / "video99")
    jsrv = JServer(player=JPlayer(sink=JCollect()))
    tsrv = OSCServer(player=Player(sink=CollectSink(), device="cpu"))
    errs = []
    for ns, srv in ((jns, jsrv), (tns, tsrv)):
        with pytest.raises(OSError) as e:
            ns._open_videodev(srv, node)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    made = {}

    def opened(mod, key):
        class Src:
            def __init__(self, dev, **kw):
                made[key] = (dev, kw)
        monkeypatch.setattr(mod, "V4L2Source", Src)
    opened(jv, "jax")
    opened(tv, "torch")
    ids = [jns._open_videodev(jsrv, node), tns._open_videodev(tsrv, node)]
    assert ids[0] == ids[1] == max(tsrv.clips)
    assert made["jax"] == (node, {})
    assert made["torch"] == (node, {"torch_device": torch.device("cpu")})
