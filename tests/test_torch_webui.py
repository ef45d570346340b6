"""The port's web UI (`lives_tpu_torch.webui`) against lives_tpu's, on the
CPU.

- The page is the JAX package's byte for byte, and `/` serves it.
- One scripted session runs through both packages' `WebUI` over an
  `OSCServer` on a CPU player (`tests/test_torch_osc.Session`: a scripted
  clock, event ids from a counter, the same seed): clips opened, effect
  keys mapped and driven through `POST /api/cmd`, `/api/blend`, a pconx, a
  multitrack with an effect region, a keyframe and an audio block, frames
  shown with `process_one`. Every JSON route then equals the JAX UI's:
  state (less `inst_fps` and `p99_ms`, host timings), timeline, keymap,
  params, datacons, prefs, encoders, clipinfo, rfx_spec, messages (less
  their timestamps), audio_wave and jobs, with each session's directory
  read as `<root>`.
- The Save-As encode job and the multitrack render job run to completion
  (their threads joined with a limit): the encoded Y4M and the rendered
  clip within 1 LSB of the JAX UI's.
- Thumbnails, strips and the multitrack preview decode within 1 LSB of
  the JAX UI's JPEGs (PIL codes both from frames that agree); the preview
  tap codes a CPU frame with PIL (`host_encodes`), never on a device.

Every HTTP request goes to port 0's server with a time limit; no step
waits on the wall clock."""

import io
import json
import wave
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
import lives_tpu.prefs as j_prefs
import lives_tpu.webui as jw
import lives_tpu_torch.prefs as t_prefs
import lives_tpu_torch.webui as tw
from test_torch_osc import Session, assert_clips_within_1, write_clips

PKGS = ("jax", "torch")
TIMEOUT = 60
#: state fields read off the host's clock
HOST_TIMINGS = ("inst_fps", "p99_ms")


class TickingClock(cs.ScriptedClock):
    """The scripted clock, a tenth of a millisecond on at each reading, so
    the player's frame times are not zero."""

    def monotonic(self):
        self.now += 1e-4
        return self.now


def http(ui, path, body=None):
    return cs.http_call(ui, path, body, timeout=TIMEOUT)


def write_wav(path, seconds=1.0, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    pcm = (np.stack([np.sin(2 * np.pi * 220 * t),
                     0.5 * np.sin(2 * np.pi * 330 * t)], 1) * 20000
           ).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


def canon(obj, root):
    return json.loads(json.dumps(obj).replace(str(root), "<root>"))


def run_session(pkg, root, media, monkeypatch):
    """The scripted session through one package's web UI; returns what the
    tests compare."""
    s = Session(pkg, root, monkeypatch)
    s.clock.__class__ = TickingClock
    store_mod = j_prefs if pkg == "jax" else t_prefs
    monkeypatch.setattr(store_mod, "_store",
                        store_mod.PrefsStore(str(root / "prefsrc")))
    ui = (jw if pkg == "jax" else tw).WebUI(s.srv).start()
    ui.tap.min_interval = 0.0
    out = {"ui": ui, "session": s}
    try:
        def cmd(path, *args):
            code, _, body = http(ui, "/api/cmd",
                                 {"path": path, "args": list(args)})
            return json.loads(body)

        a, b, wav = media
        rets = [cmd("/clip/open/file", a), cmd("/clip/open/file", b),
                cmd("/clip/open/file", wav),
                cmd("/effect_key/map", 1, "gaussian_blur"),
                cmd("/effect_key/map", 2, "colour_balance"),
                cmd("/effect_key/map", 3, "compositor"),
                cmd("/effect_key/map", 4, "motion_mask"),
                cmd("/effect_key/map", 6, "saturation"),
                cmd("/effect_key/enable", 1),
                cmd("/effect_key/parameter/value/set", 1, 0, 3),
                cmd("/effect_key/enable", 4), cmd("/effect_key/enable", 6),
                cmd("/effect_key/outparameter/connection/add", 4, 0, 6, 0),
                cmd("/clip/select", 1), cmd("/no/such/method")]
        out["cmds"] = rets
        http(ui, "/api/blend", b"0.25")
        s.player.state.playing = True
        for f in range(4):
            s.show(f)
        out["preview_jpeg"] = ui.tap.wait_jpeg(-1, timeout=TIMEOUT)[0]
        for step in (("/mt/ctrack/set", 0), ("/block/insert", 1),
                     ("/block/insert", 2, 1, 0.12)):
            rets.append(cmd(*step))
        fid = cmd("/mt/fx/region", "crossfade", 2, 6, 0, 1)["ret"]
        rets.append(cmd("/mt/keyframe/set", fid, 3, "amount", 0.75))
        # a backing audio block naming the WAV clip by its id, as the
        # UI's waveform strip reads it
        s.srv.multitrack.insert_audio_block(-1, 3, 0, 10, 0.1, 1.0)
        routes = ["/api/state", "/api/timeline", "/api/keymap",
                  "/api/params/1", "/api/params/2", "/api/params/3",
                  "/api/params/5", "/api/datacons", "/api/prefs",
                  "/api/encoders", "/api/clipinfo/1", "/api/clipinfo/3",
                  "/api/jobs", "/api/audio_wave/-1?w=64",
                  "/api/rfx_spec/sepia", "/api/rfx_spec/resize",
                  "/api/messages?n=40"]
        got = {}
        for r in routes:
            code, ctype, body = http(ui, r)
            assert code == 200 and ctype == "application/json", r
            got[r] = json.loads(body)
        for m in got["/api/messages?n=40"]:
            m.pop("t")
        for k in HOST_TIMINGS:
            got["/api/state"].pop(k)
        out["routes"] = canon(got, root)
        # the Save-As encode and the multitrack render, as jobs
        enc = json.loads(http(ui, "/api/encode", {
            "cid": 1, "path": str(root / "saved.y4m"),
            "encoder": "yuv4mpeg"})[2])
        cs.join_named("encode-job", TIMEOUT)
        mt = json.loads(http(ui, "/api/mt_render", {"audio": True})[2])
        cs.join_named("mt-render-job", TIMEOUT)
        out["jobs"] = canon(json.loads(http(ui, "/api/jobs")[2]), root)
        out["job_rets"] = (enc, mt)
        out["mt_clip"] = s.srv.clips[max(s.srv.clips)]
        out["jpegs"] = {r: http(ui, r)[2] for r in (
            "/api/thumb/1?frame=2&w=40", "/api/thumb/2?w=24",
            "/api/strip/1", "/api/strip/2")}
        # the multitrack preview: the rendered frame PIL codes, and its
        # JPEG
        coded = []
        real = Image.fromarray
        monkeypatch.setattr(Image, "fromarray",
                            lambda a, *k: coded.append(a) or real(a, *k))
        out["mt_preview"] = http(ui, "/api/mt_preview/3")
        monkeypatch.setattr(Image, "fromarray", real)
        out["mt_preview_frame"] = coded
        out["page"] = http(ui, "/")[2]
        out["missing"] = [http(ui, r)[0] for r in (
            "/api/clipinfo/99", "/api/thumb/99", "/nowhere",
            "/api/rfx_spec/no_such_script")]
    finally:
        ui.stop()
        s.close()
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("webui")
    a, b = write_clips(root / "media")
    media = (a, b, write_wav(root / "media" / "tone.wav"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIVES_TPU_FUSED_SWEEP", "0")
        mp.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
        for pkg in PKGS:
            out[pkg] = run_session(pkg, root / pkg, media, mp)
    return out


def test_page_is_byte_identical(sessions):
    assert tw._PAGE == jw._PAGE
    assert sessions["torch"]["page"] == jw._PAGE.encode()
    assert sessions["jax"]["page"] == sessions["torch"]["page"]


def test_commands_answer_as_jax(sessions):
    assert sessions["torch"]["cmds"] == sessions["jax"]["cmds"]
    assert sessions["torch"]["cmds"][14]["ok"] is False


@pytest.mark.parametrize("route", [
    "/api/state", "/api/timeline", "/api/keymap", "/api/params/1",
    "/api/params/2", "/api/params/3", "/api/params/5", "/api/datacons",
    "/api/prefs", "/api/encoders", "/api/clipinfo/1", "/api/clipinfo/3",
    "/api/jobs", "/api/audio_wave/-1?w=64", "/api/rfx_spec/sepia",
    "/api/rfx_spec/resize", "/api/messages?n=40"])
def test_json_route_equals_jax(sessions, route):
    got, ref = (dict(sessions[pkg]["routes"][route]) if isinstance(
        sessions[pkg]["routes"][route], dict)
        else sessions[pkg]["routes"][route] for pkg in ("torch", "jax"))
    if route.startswith("/api/params/") and got:
        # a filter's description may drop the JAX package's TPU wording
        # ("MXU separable"); the port's is its own registry's
        from lives_tpu_torch.effects.host import get_filter
        assert got.pop("description") == get_filter(got["filter"]) \
            .description
        ref.pop("description")
    assert got == ref


def test_route_contents_are_exercised(sessions):
    r = sessions["torch"]["routes"]
    assert r["/api/state"]["shown"] == 4 and r["/api/state"]["blend"] == 0.25
    assert r["/api/datacons"]["pconx"], r["/api/datacons"]
    assert r["/api/timeline"]["effects"][0]["keyframes"]
    assert any(v != 0 for v in r["/api/audio_wave/-1?w=64"]["maxs"])
    assert r["/api/params/2"]["widgets"][0]["widget"] == "color"
    assert r["/api/params/3"]["special"]["type"] == "multipoint"


def test_missing_things_are_404_as_jax(sessions):
    assert sessions["torch"]["missing"] == sessions["jax"]["missing"] \
        == [404] * 4


def test_jobs_finish_as_jax(sessions):
    t, j = sessions["torch"], sessions["jax"]
    assert t["job_rets"] == j["job_rets"]
    assert t["jobs"] == j["jobs"]
    assert [v["state"] for v in t["jobs"].values()] == ["done", "done"]


def test_encode_job_clip_within_1_lsb(sessions):
    from lives_tpu_torch.io.decoders import try_decoders
    cds = {pkg: try_decoders(str(sessions[pkg]["session"].root
                                 / "saved.y4m")) for pkg in PKGS}
    assert cds["torch"].nframes == cds["jax"].nframes == 10
    for n in range(10):
        for tp, jp in zip(cds["torch"].decoder.get_frame(n).planes,
                          cds["jax"].decoder.get_frame(n).planes):
            d = np.abs(tp.numpy().astype(int) - jp.numpy().astype(int))
            assert d.max() <= 1


def test_mt_render_job_clip_within_1_lsb(sessions):
    assert_clips_within_1(sessions["jax"]["mt_clip"],
                          sessions["torch"]["mt_clip"])


@pytest.mark.parametrize("route", [
    "/api/thumb/1?frame=2&w=40", "/api/thumb/2?w=24", "/api/strip/1",
    "/api/strip/2"])
def test_jpeg_route_within_1_lsb(sessions, route):
    def px(data):
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                          np.int16)
    t, j = (px(sessions[pkg]["jpegs"][route]) for pkg in ("torch", "jax"))
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= 1


def test_preview_tap_codes_cpu_frames_on_the_host(sessions):
    tap = sessions["torch"]["ui"].tap
    assert tap.host_encodes >= 1 and tap.device_encodes == 0
    assert tap.error is None
    img = Image.open(io.BytesIO(sessions["torch"]["preview_jpeg"]))
    assert img.size == (48, 24)


def test_preview_tap_ends_on_a_failing_device_lane():
    """A CUDA frame the device lane cannot convert ends the preview: its
    exception is kept in `error` and raised by `wait_jpeg`, and no frame
    goes to PIL."""
    tap = tw.PreviewTap()
    bad = SimpleNamespace(planes=(SimpleNamespace(
        device=torch.device("cuda")),))
    assert tap.play_frame(bad, 0.0)
    assert tap.error is not None and tap.host_encodes == 0
    with pytest.raises(RuntimeError, match="preview encode failed"):
        tap.wait_jpeg(0, timeout=1.0)
    assert tap.play_frame(bad, 0.04) and tap._worker is None


def test_mt_preview_frame_within_1_lsb(sessions):
    """The preview pane's frame, as rendered and handed to PIL, within 1
    LSB of the JAX UI's (a JPEG of it moves further than the frame, so
    the frame is compared), and its JPEG decodes at the timeline's size."""
    t, j = (sessions[pkg]["mt_preview_frame"] for pkg in ("torch", "jax"))
    assert len(t) == len(j) == 1
    assert t[0].shape == j[0].shape
    assert np.abs(t[0].astype(int) - j[0].astype(int)).max() <= 1
    code, ctype, body = sessions["torch"]["mt_preview"]
    assert code == 200 and ctype == "image/jpeg"
    assert Image.open(io.BytesIO(body)).size == t[0].shape[1::-1]
