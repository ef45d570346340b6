"""The ffmpeg encoder and decoder of lives_tpu_torch (`io/encoders.py`
`FFmpegEncoder`, `io/decoders.py` `FFmpegDecoder`) against lives_tpu's,
over a fake `ffmpeg` and `ffprobe` on PATH.

The fakes are small Python scripts written per test: the encoder's
`ffmpeg` writes its arguments and every byte piped to it into the output
file; the decoder's answers `-ss T` with a frame seeded by T, and
`ffprobe` with a fixed geometry. The JAX encoder registers at import,
where `ffmpeg` is on PATH, so its side runs in a subprocess with the fake
on PATH (`test_torch_bridges.jax_registry_in_subprocess` for the
registry). Files and frames: bytes exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lives_tpu.io.decoders as jdec
import lives_tpu_torch.io.decoders as tdec
import lives_tpu_torch.io.encoders as tenc
from test_torch_bridges import ROOT, jax_registry_in_subprocess

FFMPEG = r'''#!{py}
import hashlib, json, sys
import numpy as np
a = sys.argv[1:]
if "-ss" in a:                      # decode one frame to stdout
    t = float(a[a.index("-ss") + 1])
    n = {w} * {h} * 3
    seed = int(hashlib.md5(f"{{t:.6f}}".encode()).hexdigest()[:8], 16)
    sys.stdout.buffer.write(np.random.default_rng(seed).integers(
        0, 256, n, np.uint8).tobytes()[: n if t < {tail} else 7])
else:                               # encode: arguments, then the pipe
    with open(a[-1], "wb") as f:
        f.write(json.dumps(a[:-1]).encode() + b"\n" + sys.stdin.buffer.read())
'''
FFPROBE = '''#!{py}
print("{w},{h},25/1,{n}")
'''


@pytest.fixture
def fakes(tmp_path, monkeypatch):
    """A directory holding the fake `ffmpeg` and `ffprobe` (32x16, 10
    frames; `-ss` past 0.3 s decodes short), first on PATH."""
    d = tmp_path / "bin"
    d.mkdir()
    for name, text in (("ffmpeg", FFMPEG), ("ffprobe", FFPROBE)):
        p = d / name
        p.write_text(text.format(py=sys.executable, w=32, h=16, n=10,
                                 tail=0.3))
        p.chmod(0o755)
    monkeypatch.setenv("PATH", f"{d}{os.pathsep}{os.environ['PATH']}")
    return d


def frames(n=3, h=16, w=24, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, h, w), np.uint8) for _ in range(n)]


def jax_encode(tmp_path, fs, out, fps):
    """The JAX package's "ffmpeg" encoder in a fresh process (it registers
    at import, where the fake is on PATH): (its return, the file)."""
    np.save(tmp_path / "frames.npy",
            np.stack(fs) if fs else np.zeros((0, 3, 2, 2), np.uint8))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "from lives_tpu.io.encoders import get_encoder\n"
        f"fs = list(np.load({str(tmp_path / 'frames.npy')!r}))\n"
        f"print(json.dumps(get_encoder('ffmpeg').encode({str(out)!r}, fs, "
        f"{fps!r})))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), \
        Path(out).read_bytes() if Path(out).exists() else None


def test_registry_holds_ffmpeg_where_the_binary_is(fakes, monkeypatch):
    """With `ffmpeg` on PATH both registries hold it, with the same
    formats and capabilities; without it, neither does."""
    from lives_tpu_torch import native
    bridges = ["jpegcoef"] + (["avbridge"] if native.load_avbridge()
                              is not None else [])
    jreg = jax_registry_in_subprocess(bridges)
    assert tenc.list_encoders() == sorted(jreg)
    assert "ffmpeg" in jreg
    assert [f.__dict__ for f in tenc.get_encoder("ffmpeg").get_formats()] \
        == jreg["ffmpeg"]
    assert tenc.FFmpegEncoder.get_capabilities() == \
        tenc.CAP_VIDEO | tenc.CAP_AUDIO
    monkeypatch.setenv("PATH", os.environ["PATH"].split(os.pathsep, 1)[1])
    if not __import__("shutil").which("ffmpeg"):
        assert "ffmpeg" not in tenc.list_encoders()
        with pytest.raises(KeyError):
            tenc.get_encoder("ffmpeg")


#: fps -> the JAX encoder's (return, file) on `frames()`, once a process
JAX_PIPED: dict = {}


@pytest.mark.parametrize("layout", ["chw", "hwc", "tensor", "rgba"])
@pytest.mark.parametrize("fps", [25.0, 29.97])
def test_encoder_pipes_what_jax_pipes(fakes, tmp_path, layout, fps):
    """The same command line and the same RGB24 bytes reach `ffmpeg`, from
    numpy frames (CHW, HWC, RGBA) or tensors, as from the JAX encoder."""
    fs = frames()
    given = {"chw": fs, "hwc": [np.moveaxis(f, 0, -1) for f in fs],
             "tensor": [torch.from_numpy(f) for f in fs],
             "rgba": [np.concatenate([f, np.full_like(f[:1], 9)])
                      for f in fs]}[layout]
    out_t = tmp_path / "t.mp4"
    assert tenc.get_encoder("ffmpeg").encode(str(out_t), given, fps)
    if fps not in JAX_PIPED:     # the JAX side sees CHW frames whatever
        JAX_PIPED[fps] = jax_encode(tmp_path, fs, tmp_path / "j.mp4", fps)
    ok, ref = JAX_PIPED[fps]
    got = out_t.read_bytes()
    head_t, body_t = got.split(b"\n", 1)
    head_j, body_j = ref.split(b"\n", 1)
    assert ok is True
    assert json.loads(head_t)[1:] == json.loads(head_j)[1:]
    assert body_t == body_j == b"".join(np.moveaxis(f, 0, -1).tobytes()
                                        for f in fs)


def test_encoder_refuses_no_frames_like_jax(fakes, tmp_path):
    assert tenc.get_encoder("ffmpeg").encode(str(tmp_path / "t.mp4"), [],
                                             25.0) is False
    ok, ref = jax_encode(tmp_path, [], tmp_path / "j.mp4", 25.0)
    assert ok is False and ref is None and not (tmp_path / "t.mp4").exists()


@pytest.fixture
def fake_decoder(fakes, monkeypatch):
    for mod in (jdec, tdec):
        monkeypatch.setattr(mod, "FFMPEG", str(fakes / "ffmpeg"))
        monkeypatch.setattr(mod, "FFPROBE", str(fakes / "ffprobe"))


def test_decoder_probe_and_frames_match_jax(fake_decoder, tmp_path):
    """`FFmpegDecoder` on a file the fakes describe: the same clip data and
    the same frames; a frame past the tail retries a frame earlier, then
    serves black, as the JAX decoder does."""
    path = tmp_path / "clip.bin"
    path.write_bytes(b"media")
    t = tdec.FFmpegDecoder.get_clip_data(str(path))
    j = jdec.FFmpegDecoder.get_clip_data(str(path))
    for k in ("nframes", "fps", "width", "height", "palette"):
        assert getattr(t, k) == getattr(j, k), k
    assert (t.nframes, t.width, t.height, t.fps) == (10, 32, 16, 25.0)
    for n in (0, 3, 7, 9):
        a = t.decoder.get_frame(n).planes[0]
        b = np.asarray(j.decoder.get_frame(n).planes[0])
        assert a.dtype == torch.uint8 and a.shape == (3, 16, 32)
        np.testing.assert_array_equal(a.numpy(), b)
    out = (np.empty((3, 16, 32), np.uint8),)
    lay = t.decoder.get_frame(3, out=out)
    np.testing.assert_array_equal(out[0], lay.planes[0].numpy())


def test_decoder_comes_last_and_is_gated_like_jax(fake_decoder, tmp_path,
                                                   monkeypatch):
    """`try_decoders` reaches `FFmpegDecoder` after every other decoder,
    in the JAX registry's order; without the binaries it claims nothing."""
    assert [c.name for c in tdec._DECODERS] == \
        [c.name for c in jdec._DECODERS]
    assert tdec._DECODERS[-1] is tdec.FFmpegDecoder
    path = tmp_path / "clip.xyz"
    path.write_bytes(b"not a container libav knows")
    t, j = tdec.try_decoders(str(path)), jdec.try_decoders(str(path))
    assert type(t.decoder).__name__ == type(j.decoder).__name__ \
        == "FFmpegDecoder"
    for mod in (jdec, tdec):
        monkeypatch.setattr(mod, "FFMPEG", None)
    assert tdec.FFmpegDecoder.get_clip_data(str(path)) is None
    assert jdec.FFmpegDecoder.get_clip_data(str(path)) is None
