"""The Kinect camera and clip of lives_tpu_torch (`io/kinect.py`) against
lives_tpu's, over the same fake libfreenect_sync.

The fake is `tests/test_kinect.py`'s, copied, with seeded RGB and depth.
Each scenario pulls the same frames through both packages: the keyed
RGBA32 frames (u8, within 1 LSB; 0 expected, the keying compares and
selects) and the AFLOAT depth planes (exact) must agree.
"""

import ctypes

import numpy as np
import pytest
import torch

import lives_tpu.io.kinect as jk
import lives_tpu_torch.io.kinect as tk
from lives_tpu_torch.constants import Palette

KIN = {"jax": jk, "torch": tk}
H, W = jk.KINECT_H, jk.KINECT_W


class FakeFreenect:
    """In-process libfreenect_sync: serves RGB and registered depth
    through the real ctypes calling convention (byref out-pointers,
    string_at reads); `seed` None is the JAX test's ramp, else seeded
    noise."""

    def __init__(self, seed=None):
        if seed is None:
            rgb = np.zeros((H, W, 3), np.uint8)
            rgb[..., 0] = np.arange(W, dtype=np.uint32) % 256
            rgb[..., 1] = 128
            rgb[..., 2] = (np.arange(H, dtype=np.uint32) % 256)[:, None]
            depth = np.broadcast_to((np.arange(W, dtype=np.uint16) * 2),
                                    (H, W)).copy()
        else:
            rng = np.random.default_rng(seed)
            rgb = rng.integers(0, 256, (H, W, 3), np.uint8)
            depth = rng.integers(0, 65535, (H, W)).astype(np.uint16)
        self.rgb, self.depth = rgb, depth
        self._rgb_buf = ctypes.create_string_buffer(self.rgb.tobytes())
        self._depth_buf = ctypes.create_string_buffer(self.depth.tobytes())
        self.video_calls = 0
        self.stopped = False

    def freenect_sync_get_video(self, data_ref, ts_ref, index, fmt):
        assert fmt == 0  # FREENECT_VIDEO_RGB
        self.video_calls += 1
        data_ref._obj.value = ctypes.addressof(self._rgb_buf)
        ts_ref._obj.value = self.video_calls
        return 0

    def freenect_sync_get_depth(self, data_ref, ts_ref, index, fmt):
        assert fmt == 4  # FREENECT_DEPTH_REGISTERED
        data_ref._obj.value = ctypes.addressof(self._depth_buf)
        ts_ref._obj.value = self.video_calls
        return 0

    def freenect_sync_stop(self):
        self.stopped = True


def host(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def clip(pkg, fake, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return KIN[pkg].KinectClip(camera=KIN[pkg].KinectCamera(lib=fake), **kw)


def test_constants_and_camera_match_jax():
    for name in ("FREENECT_VIDEO_RGB", "FREENECT_DEPTH_REGISTERED",
                 "KINECT_W", "KINECT_H", "_DEPTH_MAX"):
        assert getattr(tk, name) == getattr(jk, name), name
    res = {}
    for pkg, mod in KIN.items():
        fake = FakeFreenect(seed=1)
        cam = mod.KinectCamera(lib=fake)
        res[pkg] = (cam.get_rgb(), cam.get_depth())
        cam.close()
        assert fake.stopped
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,window,ccol", [
    (None, (100, 800), (255, 0, 0)),
    (3, (0, 65536), (0, 0, 0)),
    (4, (1000, 40000), (12, 200, 99)),
    (5, (30000, 30001), (255, 255, 255)),
])
def test_clip_keys_like_jax(seed, window, ccol):
    """`KinectClip.get_frame` (`lives_tpu/io/kinect.py:101-162`): RGBA32
    with outside-the-window pixels `ccol` at alpha 0, and the depth as
    AFLOAT [0, 1]."""
    res = {}
    for pkg in KIN:
        fake = FakeFreenect(seed)
        c = clip(pkg, fake, minthresh=window[0], maxthresh=window[1],
                 ccol=ccol)
        lay = c.get_frame(0)
        res[pkg] = (host(lay.planes[0]), host(c.last_depth.planes[0]),
                    lay.palette, c.last_depth.palette)
    t, j = res["torch"], res["jax"]
    d = np.abs(t[0].astype(np.int16) - j[0].astype(np.int16))
    assert t[0].shape == (4, H, W) and d.max() <= 1, d.max()
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2:] == j[2:] == (int(Palette.RGBA32), int(Palette.AFLOAT))


def test_clip_contract_fields_match_jax():
    fake = FakeFreenect()
    t, j = clip("torch", fake), clip("jax", fake)
    for k in ("width", "height", "fps", "frames", "unique_id",
              "scrap_on_record", "minthresh", "maxthresh", "ccol"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.device == torch.device("cpu")
    t.close()
    assert fake.stopped


def test_camera_errors_and_gate_match_jax(monkeypatch):
    assert (tk.load_freenect() is None) == (jk.load_freenect() is None)

    class Failing(FakeFreenect):
        def freenect_sync_get_video(self, data_ref, ts_ref, index, fmt):
            return -1
    for mod in KIN.values():
        with pytest.raises(RuntimeError, match="rc=-1"):
            mod.KinectCamera(lib=Failing()).get_rgb()
        monkeypatch.setattr(mod, "load_freenect", lambda: None)
        with pytest.raises(RuntimeError, match="not available"):
            mod.KinectCamera()


def test_key_frame_matches_the_jax_key_fn():
    """`key_frame`, the JAX `_key_fn` in plain torch, on seeded inputs
    at another geometry."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (3, 7, 11), np.uint8)
    depth = rng.integers(0, 65535, (7, 11)).astype(np.uint16)
    key = jk._key_fn()
    j_rgba, j_d = key(jnp.asarray(rgb), jnp.asarray(depth),
                      jnp.asarray(np.array([500, 20000, 9, 8, 7, 0],
                                           np.float32)))
    t_rgba, t_d = tk.key_frame(torch.from_numpy(rgb),
                               torch.from_numpy(depth.astype(np.int32)),
                               500.0, 20000.0, (9, 8, 7))
    np.testing.assert_array_equal(t_rgba.numpy(), np.asarray(j_rgba))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


def test_depth_key_filter_on_the_clips_depth_matches_jax():
    """The clip's depth through the `depth_key` filter on its own frame
    (the cconx route): the port's and the JAX package's agree."""
    import jax.numpy as jnp

    from lives_tpu.effects.host import FrameContext as JCtx
    from lives_tpu.effects.host import apply_instance as j_apply
    from lives_tpu.effects.host import instantiate as j_inst
    from lives_tpu.layer import Layer as JLayer
    from lives_tpu_torch.effects.host import FrameContext, apply_instance
    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.layer import Layer
    fake = FakeFreenect(seed=12)
    t, j = clip("torch", fake), clip("jax", fake)
    tl, jl = t.get_frame(0), j.get_frame(0)
    vals = dict(minthresh=2000.0, maxthresh=50000.0, ccol_g=1.0)
    tout = apply_instance(
        instantiate("depth_key", **vals),
        [Layer(planes=(tl.planes[0][None],), palette=tl.palette)],
        FrameContext(width=W, height=H),
        alpha_ins={0: Layer(planes=(t.last_depth.planes[0][None],),
                            palette=int(Palette.AFLOAT))})[0]
    jout = j_apply(j_inst("depth_key", **vals),
                   [JLayer(planes=(jl.planes[0],), palette=jl.palette)],
                   JCtx(width=W, height=H),
                   alpha_ins={0: JLayer(planes=(jnp.asarray(
                       j.last_depth.planes[0])[None],),
                       palette=int(Palette.AFLOAT))})[0]
    d = np.abs(host(tout.planes[0][0]).astype(np.int16)
               - host(jout.planes[0]).astype(np.int16))
    assert d.max() <= 1, d.max()


def test_osc_open_kinect_route_like_jax(monkeypatch):
    """`/clip/open/kinect` opens a `KinectClip` on the player's device
    with the wire's thresholds, and it becomes the fg clip, as in the
    JAX namespace (`lives_tpu/osc/namespace.py:219-233`)."""
    from lives_tpu.osc.protocol import OSCMessage as JMsg
    from lives_tpu.osc.server import OSCServer as JServer
    from lives_tpu.player import CollectSink as JCollect
    from lives_tpu.player import Player as JPlayer
    from lives_tpu_torch.osc.protocol import OSCMessage
    from lives_tpu_torch.osc.server import OSCServer
    from lives_tpu_torch.player import CollectSink, Player
    for mod in KIN.values():
        monkeypatch.setattr(mod, "load_freenect", lambda: FakeFreenect(2))
    jsrv = JServer(player=JPlayer(sink=JCollect()))
    tsrv = OSCServer(player=Player(sink=CollectSink(), device="cpu"))
    jsrv.dispatch(JMsg("/clip/open/kinect", [0, 100, 800]))
    tsrv.dispatch(OSCMessage("/clip/open/kinect", [0, 100, 800]))
    (j,) = [c for c in jsrv.clips.values() if isinstance(c, jk.KinectClip)]
    (t,) = [c for c in tsrv.clips.values() if isinstance(c, tk.KinectClip)]
    assert (t.minthresh, t.maxthresh) == (j.minthresh, j.maxthresh) \
        == (100, 800)
    assert t.device == torch.device("cpu")
    assert tsrv.player.state.fg_clip is t
    np.testing.assert_array_equal(host(t.get_frame(0).planes[0]),
                                  host(j.get_frame(0).planes[0]))
