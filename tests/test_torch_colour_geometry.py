"""The launch geometry of the colour kernels K2 and K3, and the YUV4MPEG
encoder's chunked input, on the CPU.

`colour_geometry` (ops/yuv_kernels.py) is the launch csrc/yuv420.cu takes:
runs of 8 or 16 pixels of a row pair a thread, the access width of the
full-resolution planes (`wide`) and of U and V (`narrow`) from the
alignment of every pointer and stride, and the grid. `k2_geometry` and
`k3_geometry` describe the planes the wrappers pass. Here: every pixel of
every row pair lies in exactly one run, every run that takes wide accesses
starts on a multiple of its width in every plane it reads or writes (planes
that are views at byte offsets 0-15 of one buffer, widths 2-130), and what
the kernel cannot take is refused. The kernels run only on a GPU
(tests/test_torch_cuda.py).

`Y4MEncoder` given (B, C, H, W) chunks, as `render_to_encoder` hands them,
writes the file the same frames one at a time write (plain versions on the
CPU)."""

import numpy as np
import pytest
import torch

from lives_tpu_torch import transcode
from lives_tpu_torch.io.decoders import try_decoders
from lives_tpu_torch.io.encoders import Y4MEncoder
from lives_tpu_torch.ops import yuv_kernels as yk


def _covered(g):
    """{(frame, row pair): sorted [x0, x0 + n) spans} of the launch."""
    spans = {}
    for b, qy, x0, n in g.runs():
        spans.setdefault((b, qy), []).append((x0, x0 + n))
    return {k: sorted(v) for k, v in spans.items()}


@pytest.mark.parametrize("run", yk.RUNS)
@pytest.mark.parametrize("B,H", [(1, 2), (2, 6), (3, 17), (1, 1)])
def test_every_pixel_in_one_run(run, B, H):
    """Every pixel of every row pair of every frame in exactly one run,
    widths 1-130 (K2 takes the even ones, K3 all)."""
    for W in range(1, 131):
        g = yk.colour_geometry(B, H, W, run=run)
        spans = _covered(g)
        assert set(spans) == {(b, q) for b in range(B)
                              for q in range((H + 1) // 2)}, (W, H)
        for row in spans.values():
            assert row[0][0] == 0 and row[-1][1] == W, (W, row)
            assert all(a[1] == b[0] for a, b in zip(row, row[1:])), (W, row)
            assert all(x1 - x0 == run for x0, x1 in row[:-1])


def _starts(g, planes):
    """The first byte address of each run with all its pixels, in each
    plane (pointer, frame stride, row pitch, bytes a pixel pair)."""
    for b, qy, x0, n in g.runs():
        if n != g.run:
            continue  # a run cut by the row's end moves single bytes
        for ptr, fs, pitch, chroma in planes:
            for dy in ((0,) if chroma else (0, 1)):
                row = qy if chroma else 2 * qy + dy
                yield chroma, ptr + b * fs + row * pitch + (
                    x0 // 2 if chroma else x0)


@pytest.mark.parametrize("run", yk.RUNS)
@pytest.mark.parametrize("off", range(16))
def test_k2_widths_fit_every_access(run, off):
    """K2 over planes that are views at byte offset `off` of one buffer (a
    packed YUV420P upload, as a decoder could hand it), widths 2-130: the
    chosen widths divide every wide access's address; at offset 0 and a
    width that is a multiple of 32 they are the run's bytes (16 and 8 at
    runs of 16)."""
    B, h = 2, 4
    for w in range(2, 131, 2):
        fs = h * w * 3 // 2
        buf = torch.zeros(B * fs + 16, dtype=torch.uint8)
        flat = buf[off:off + B * fs].view(B, fs)
        y = flat[:, :h * w].view(B, h, w)
        u = flat[:, h * w:h * w + fs // 6].view(B, h // 2, w // 2)
        v = flat[:, h * w + fs // 6:].view(B, h // 2, w // 2)
        out = torch.empty((B, 3, h, w), dtype=torch.uint8)
        g = yk.k2_geometry(y, fs, u, fs, v, fs, out, run)
        assert g.run == run and g.wide <= run and g.narrow <= run // 2
        planes = [(y.data_ptr(), fs, w, False)]
        planes += [(out.data_ptr() + c * h * w, 3 * h * w, w, False)
                   for c in range(3)]
        planes += [(p.data_ptr(), fs, w // 2, True) for p in (u, v)]
        for chroma, at in _starts(g, planes):
            assert at % (g.narrow if chroma else g.wide) == 0, (w, off)
        if off == 0 and w % 32 == 0:
            assert (g.wide, g.narrow) == (run, run // 2), w


@pytest.mark.parametrize("run", yk.RUNS)
@pytest.mark.parametrize("off", range(16))
def test_k3_widths_fit_every_access(run, off):
    """K3 over an RGBA chunk that is a view at byte offset `off`, odd and
    even widths 2-130 and an odd height: the chosen widths divide every
    wide access's address (an odd row takes single bytes)."""
    B, C, h = 2, 4, 5
    for w in range(2, 131):
        buf = torch.zeros(B * C * h * w + 16, dtype=torch.uint8)
        rgb = buf[off:off + B * C * h * w].view(B, C, h, w)
        y = torch.empty((B, h, w), dtype=torch.uint8)
        u = torch.empty((B, h // 2, w // 2), dtype=torch.uint8)
        v = torch.empty_like(u)
        g = yk.k3_geometry(rgb, y, u, v, run)
        planes = [(rgb.data_ptr() + c * h * w, C * h * w, w, False)
                  for c in range(3)]
        planes += [(y.data_ptr(), h * w, w, False)]
        planes += [(p.data_ptr(), (h // 2) * (w // 2), w // 2, True)
                   for p in (u, v)]
        for chroma, at in _starts(g, planes):
            assert at % (g.narrow if chroma else g.wide) == 0, (w, off)
        if w % 2:
            assert g.wide == 1


def test_geometry_of_a_1080p_chunk():
    """The main path's launch: a 96-frame 1080p chunk, its planes
    allocated whole: full-width accesses, a block of 128 threads for each
    of a frame's 540 row pairs (120 runs of 16 pixels; 240 runs of 8 in
    256); at 2160p the frames x row pairs stay on grid.x, and a row pair
    wider than 1024 runs takes more blocks."""
    y = torch.empty((96, 1080, 1920), dtype=torch.uint8)
    u = torch.empty((96, 540, 960), dtype=torch.uint8)
    out = torch.empty((96, 3, 1080, 1920), dtype=torch.uint8)
    n = 1080 * 1920
    g = yk.k2_geometry(y, n, u, n // 4, u, n // 4, out)
    assert (g.run, g.wide, g.narrow, g.threads, g.grid) == \
        (16, 16, 8, 128, (96 * 540, 1))
    g = yk.k3_geometry(out, y, u, u, 8)
    assert (g.run, g.wide, g.narrow, g.threads, g.grid) == \
        (8, 8, 4, 256, (96 * 540, 1))
    g = yk.colour_geometry(96, 2160, 3840)
    assert (g.threads, g.grid) == (256, (96 * 1080, 1))
    g = yk.colour_geometry(1, 2, 1025 * 16 + 1)
    assert (g.threads, g.grid) == (1024, (1, 2))


def test_geometry_refuses_what_the_kernel_cannot_take():
    for bad in (dict(run=12), dict(run=4), dict(B=0), dict(H=0), dict(W=0),
                dict(W=65535 * 1024 * 16 + 1), dict(B=2**31 // 64 + 1,
                                                    H=128)):
        kw = dict(B=1, H=4, W=8) | bad
        with pytest.raises(ValueError, match="colour_geometry"):
            yk.colour_geometry(**kw)
    # the widest grid it takes
    g = yk.colour_geometry(1, 2, 65535 * 1024 * 16)
    assert g.grid == (1, 65535)


# -- Y4MEncoder over chunks ---------------------------------------------------

def _encode(tmp_path, name, items):
    path = tmp_path / name
    assert Y4MEncoder().encode(str(path), items, 30.0)
    return path.read_bytes()


@pytest.mark.parametrize("h,w", [(36, 50), (37, 51), (2, 2)])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_y4m_encoder_chunks_write_the_frames_file(tmp_path, h, w, C,
                                                  layout):
    """(B, C, H, W) chunks (and (B, H, W, C)) write the bytes of the same
    frames given one at a time, as tensors or numpy arrays; one copy of a
    chunk, its alpha ignored."""
    rng = np.random.default_rng(h * w + C)
    frames = rng.integers(0, 256, (7, C, h, w), dtype=np.uint8)
    if layout == "hwc":
        frames = frames.transpose(0, 2, 3, 1)
    t = torch.from_numpy(np.ascontiguousarray(frames))
    one = _encode(tmp_path, "one.y4m", list(frames))
    assert _encode(tmp_path, "tensors.y4m", list(t)) == one
    assert _encode(tmp_path, "chunks.y4m", [t[:4], t[4:]]) == one
    assert _encode(tmp_path, "mixed.y4m", [t[:1], frames[1], t[2:]]) == one
    if h % 2 == 0 and w % 2 == 0:  # the decoder takes even geometry
        cd = try_decoders(str(tmp_path / "chunks.y4m"))
        assert (cd.nframes, cd.width, cd.height) == (7, w, h)
        cd.decoder.close()
    assert yk.LAUNCHES == {"yuv420_to_rgb": 0, "rgb_to_yuv420": 0}


class _Spy:
    """An encoder that records the items it is handed."""

    def __init__(self, device_frames):
        self.accepts_device_frames = device_frames
        self.items = []

    def encode(self, out_path, frames, fps, audio=None, arate=44100):
        self.items = [(type(f), tuple(f.shape)) for f in frames]
        return True


@pytest.mark.parametrize("device_frames", [True, False])
def test_render_to_encoder_hands_chunks_to_a_device_encoder(monkeypatch,
                                                            device_frames):
    """An encoder that takes device frames gets each rendered chunk whole;
    any other gets host frames one at a time, as the JAX package hands
    them."""
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)
    spy = _Spy(device_frames)
    monkeypatch.setattr(transcode, "get_encoder", lambda name: spy)
    el = multitrack_timeline(n_tracks=2, n_frames=7, width=16, height=8,
                             fps=30.0)
    assert transcode.render_to_encoder(
        el, DeviceSyntheticSource(8, 16, device="cpu"), "unused.y4m",
        encoder="spy", batch_size=4)
    if device_frames:
        assert spy.items == [(torch.Tensor, (4, 3, 8, 16)),
                             (torch.Tensor, (3, 3, 8, 16))]
    else:
        assert spy.items == [(np.ndarray, (3, 8, 16))] * 7
