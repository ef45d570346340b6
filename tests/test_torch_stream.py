"""The port's frame streaming (`lives_tpu_torch.stream`) against
lives_tpu's, on the CPU.

- Wire bytes: the LTPU datagrams (`StreamSender`) and the reference L2L
  datagrams (`L2LSender`, `l2l_frame_datagrams`, STREND at the end) equal
  the JAX package's for RGB24 and YUV420P frames made from a seed, the
  LTPU frames large enough to take several chunks.
- Parsing: `L2LParser` decodes the reference captures
  `tests/fixtures/l2l_ref_{rgb24,yuv420}.bin` into the JAX parser's
  layers (planes, palette, clamping, fps, last timecode, end of stream),
  and the fuzz and hostile-header cases of `tests/test_l2l.py` give the
  same frames, the same refusals and the same bounded buffers through
  both parsers.
- One loopback round trip of each format over UDP on port 0, each step
  with a time limit: the receiver yields host frames (`device="cpu"`
  layers) equal to the frames sent, and counts the datagrams.
"""

import pathlib
import random
import threading

import numpy as np
import pytest
import torch

import lives_tpu.stream as js
import lives_tpu_torch.stream as ts
from lives_tpu.constants import Palette as JPalette
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.layer import Layer as TLayer

FIXDIR = pathlib.Path(__file__).parent / "fixtures"
TIMEOUT = 20.0


class Recorder:
    """Stands in for a sender's UDP socket."""

    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((bytes(data), addr))

    def setsockopt(self, *a):
        pass

    def close(self):
        pass


def frames_of(palette, w, h, n, seed):
    """n seeded frames as host plane tuples."""
    rng = np.random.default_rng(seed)
    if palette == Palette.RGB24:
        return [(rng.integers(0, 256, (3, h, w), np.uint8),)
                for _ in range(n)]
    return [(rng.integers(16, 236, (h, w), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8))
            for _ in range(n)]


def layers(planes, palette):
    return (JLayer(planes=planes, palette=int(palette)),
            TLayer(planes=tuple(torch.from_numpy(p) for p in planes),
                   palette=int(palette)))


PALS = [Palette.RGB24, Palette.YUV420P]


@pytest.mark.parametrize("palette", PALS, ids=["rgb24", "yuv420p"])
def test_ltpu_datagrams_equal_jax(palette):
    sent = {}
    for pkg, mod in (("jax", js), ("torch", ts)):
        snd = mod.StreamSender("127.0.0.1", 9)
        snd.sock.close()
        snd.sock = rec = Recorder()
        for f, planes in enumerate(frames_of(palette, 320, 240, 3, 5)):
            lay = layers(planes, palette)[pkg == "torch"]
            assert snd.play_frame(lay, f / 25.0)
        snd.exit_screen()
        sent[pkg] = rec.sent
    assert sent["torch"] == sent["jax"]
    assert len(sent["torch"]) >= 6          # several chunks a frame
    assert snd.datagrams == len(sent["torch"])


@pytest.mark.parametrize("palette", PALS, ids=["rgb24", "yuv420p"])
def test_l2l_datagrams_equal_jax(palette):
    sent = {}
    for pkg, mod in (("jax", js), ("torch", ts)):
        snd = mod.L2LSender("127.0.0.1", 9, mtu=20000)
        snd.sock.close()
        snd.sock = rec = Recorder()
        snd.init_screen(64, 48, 29.97)
        for f, planes in enumerate(frames_of(palette, 64, 48, 3, 6)):
            lay = layers(planes, palette)[pkg == "torch"]
            assert snd.play_frame(lay, f / 29.97)
        snd.exit_screen()
        sent[pkg] = rec.sent
    assert sent["torch"] == sent["jax"]
    assert sent["torch"][-1][0] == b"STREND"
    # one frame's datagrams, by the module function, too
    planes = frames_of(palette, 64, 48, 1, 7)[0]
    jl, tl = layers(planes, palette)
    assert ts.l2l_frame_datagrams(tl, 1.5, 25.0, 1000) == \
        js.l2l_frame_datagrams(jl, 1.5, 25.0, 1000)


def test_l2l_header_and_sizes_equal_jax():
    for args in ((4608, 4_000_000, 64, 48, 25.0, 1, 0),
                 (3456, 123456789012, 48, 48, 29.97, 2, 1)):
        assert ts.l2l_frame_header(*args) == js.l2l_frame_header(*args)
    for pal in (JPalette.RGB24, JPalette.YUV420P):
        assert ts.l2l_frame_size(pal, 64, 48) == \
            js.l2l_frame_size(pal, 64, 48)
    for mod in (ts, js):
        with pytest.raises(ValueError, match="L2L streams"):
            mod.l2l_frame_size(int(JPalette.RGBA32), 4, 4)


def assert_layers_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.palette, g.width, g.height, g.clamping, g.sampling,
                g.subspace) == (r.palette, r.width, r.height, r.clamping,
                                r.sampling, r.subspace)
        assert len(g.planes) == len(r.planes)
        for gp, rp in zip(g.planes, r.planes):
            assert gp.device.type == "cpu"
            np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))


@pytest.mark.parametrize("name", ["l2l_ref_rgb24.bin", "l2l_ref_yuv420.bin"])
def test_parser_decodes_reference_captures_as_jax(name):
    wire = (FIXDIR / name).read_bytes()
    tp, jp = ts.L2LParser(), js.L2LParser()
    got, ref = tp.feed(wire), jp.feed(wire)
    assert len(got) == 3
    assert_layers_equal(got, ref)
    assert (tp.fps, tp.last_tc_ticks, tp.ended) == \
        (jp.fps, jp.last_tc_ticks, jp.ended)
    # fed in odd-sized pieces: the same frames
    tp2, jp2 = ts.L2LParser(), js.L2LParser()
    got2, ref2 = [], []
    for off in range(0, len(wire), 333):
        got2 += tp2.feed(wire[off:off + 333])
        ref2 += jp2.feed(wire[off:off + 333])
    assert_layers_equal(got2, ref2)
    assert_layers_equal(got2, got)


def _ref_sender_bytes(img, tc_ticks, fps=25.0, palette=1, clamping=0):
    """The reference sender's bytes for one RGB24 frame (`tests/
    test_l2l.py:_ref_sender_bytes`)."""
    h, w = img.shape[:2]
    payload = img.tobytes()
    hdr = ("1 0 0 %d %d %d %d %.8f %d 1 %d 0 0 "
           % (len(payload), tc_ticks, w, h, fps, palette, clamping))
    return b"PACKET " + hdr.encode() + b"DATA" + payload


def _rgb_frame(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def fuzz_inputs():
    """The fuzz cases of `tests/test_l2l.py:275-315`, as byte strings."""
    rng = random.Random(1234)
    nprng = np.random.default_rng(1234)
    valid = b"".join(_ref_sender_bytes(_rgb_frame(16, 12, i), i * 4000)
                     for i in range(4))
    out = []
    for trial in range(120):
        kind = trial % 4
        if kind == 0:
            data = bytes(nprng.integers(0, 256, rng.randrange(1, 4096),
                                        dtype=np.uint8))
        elif kind == 1:
            buf = bytearray(valid)
            for _ in range(rng.randrange(1, 40)):
                buf[rng.randrange(len(buf))] = rng.randrange(256)
            data = bytes(buf)
        elif kind == 2:
            cuts = sorted(rng.randrange(len(valid)) for _ in range(6))
            chunks = [valid[a:b] for a, b in
                      zip([0] + cuts, cuts + [len(valid)])]
            rng.shuffle(chunks)
            data = b"".join(chunks)
        else:
            fields = [rng.choice([b"0", b"-1", b"999999999999", b"nan",
                                  b"inf", b"1e309", b"x", b"4294967295"])
                      for _ in range(13)]
            data = b"PACKET " + b" ".join(fields) + b" DATA" + bytes(64)
        out.append(data)
    return out


def run_parser(mod, data, step=997):
    """Feed `data` in pieces; (frames, the exception type that stopped
    the feed or None, the parser's buffer sizes)."""
    p = mod.L2LParser()
    frames, err = [], None
    try:
        for off in range(0, len(data), step):
            frames += p.feed(data[off:off + step])
    except (ValueError, OverflowError) as e:
        err = type(e)
    return frames, err, (len(p._buf), len(p._acc), p.ended)


@pytest.mark.parametrize("chunk", range(4))
def test_parser_fuzz_same_outcomes_as_jax(chunk):
    cases = fuzz_inputs()[chunk * 30:(chunk + 1) * 30]
    for data in cases:
        got, gerr, gsize = run_parser(ts, data)
        ref, rerr, rsize = run_parser(js, data)
        assert (gerr, gsize) == (rerr, rsize)
        assert_layers_equal(got, ref)
        assert gsize[0] < len(data) + 1100 and gsize[1] < (1 << 26)


def test_parser_hostile_headers_same_outcomes_as_jax():
    img = _rgb_frame(16, 12, 7)
    good = _ref_sender_bytes(img, 0)
    hostile = good.replace(b" %d " % (16 * 12 * 3), b" 1099511627776 ", 1)
    streams = [
        [hostile] + [bytes(16384)] * 64 + [_ref_sender_bytes(img, 4000)],
        [b"PACKET 1 0 0 576 0 16 12 25.0 7 1 0 0 0 DATA" + bytes(576),
         b"PACKET 1 0 0 1000 0 100000000 100000000 25.0 1 1 0 0 0 DATA"
         + bytes(1000)] + [b"PACKET 1 0 1 1000 DATA" + bytes(1000)] * 8
        + [_ref_sender_bytes(_rgb_frame(16, 12, 3), 0)],
    ]
    for parts in streams:
        tp, jp = ts.L2LParser(), js.L2LParser()
        for part in parts:
            assert_layers_equal(tp.feed(part), jp.feed(part))
            assert (len(tp._buf), len(tp._acc)) == \
                (len(jp._buf), len(jp._acc))
        assert len(tp._acc) <= 16 * 12 * 3


def _wait_for(cond):
    ev = threading.Event()
    for _ in range(int(TIMEOUT / 0.01)):
        if cond():
            return True
        ev.wait(0.01)
    return cond()


@pytest.mark.parametrize("fmt", ["ltpu", "l2l"])
@pytest.mark.parametrize("palette", PALS, ids=["rgb24", "yuv420p"])
def test_loopback_round_trip(fmt, palette):
    rx = (ts.StreamReceiver if fmt == "ltpu" else ts.L2LReceiver)(port=0)
    try:
        tx = (ts.StreamSender if fmt == "ltpu" else ts.L2LSender)(
            "127.0.0.1", rx.port)
        blank = rx.get_frame(0)
        assert blank.planes[0].device.type == "cpu"
        tx.init_screen(96, 64, 25.0)
        sent = frames_of(palette, 96, 64, 1, 11)[0]
        lay = layers(sent, palette)[1]
        assert tx.play_frame(lay, 0.5)
        assert _wait_for(lambda: rx.received >= 1), "no frame arrived"
        got = rx.get_frame(123)
        assert got.palette == int(palette)
        assert got.planes[0].device.type == "cpu"
        for g, s in zip(got.planes, sent):
            np.testing.assert_array_equal(g.numpy(), s)
        assert rx.datagrams == tx.datagrams
        tx.exit_screen()
        if fmt == "l2l":
            assert _wait_for(lambda: rx.ended), "STREND did not arrive"
    finally:
        rx.close()
