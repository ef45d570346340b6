"""Text and titles of lives_tpu_torch against lives_tpu: `text.py` (the
glyph mask, the overlay, .srt/.sub files, the subtitle overlay),
`Player.load_subtitles`, and the float32 twins the text filters' hard
selects need (`utils.sinf.cosf`, `utils.xla_exp.expf` and `fma32`).

Tolerances: masks and subtitle files byte-identical (both packages call
the same PIL on this machine); overlays exact (the same eager float32
operations in the same order), held at +/-1 LSB as frames are; the twins
bit for bit against `jnp.cos`, `jax.jit(jnp.exp)` and a jitted `a * b +
c`; the players' shown frames +/-1 LSB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu import text as jtext
from lives_tpu.constants import Palette as JPalette
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch import text as ttext
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.utils.sinf import cosf
from lives_tpu_torch.utils.xla_exp import expf, fma32
from test_torch_player import make_player, run_both, same_frames, show

MASKS = [("HELLO", 96, 54, {}),
         ("two\nlines of text", 96, 54, {"size": 14, "valign": "top"}),
         ("right", 67, 41, {"size": 10, "halign": "right",
                            "valign": "middle", "margin": 3}),
         ("left + colour", 67, 41, {"size": 12, "halign": "left",
                                    "colour": (255, 200, 10)}),
         ("by name", 96, 54, {"size": 16, "font": "DejaVuSans"}),
         ("fallback", 96, 54, {"size": 16, "font": "no-such-font"}),
         ("", 40, 30, {"size": 9})]


@pytest.mark.parametrize("text,w,h,style", MASKS,
                         ids=[m[0].split("\n")[0] or "empty" for m in MASKS])
def test_render_text_mask_is_byte_identical(text, w, h, style):
    ref = jtext.render_text_mask(text, w, h, **style)
    got = ttext.render_text_mask(text, w, h, **style)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (4, h, w)
    assert got.tobytes() == ref.tobytes()
    if text:
        assert got[3].any()


def _frames(c, b=None, h=41, w=67, seed=5):
    rng = np.random.default_rng(seed + c)
    shape = (c, h, w) if b is None else (b, c, h, w)
    return rng.integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("c", [3, 4])
def test_overlay_text_matches_jax(c):
    """RGB24 and RGBA32 (alpha kept); the port also takes a batch."""
    pal = Palette.RGBA32 if c == 4 else Palette.RGB24
    a = _frames(c)
    style = {"size": 12, "valign": "middle"}
    ref = np.asarray(jtext.overlay_text(JLayer(
        planes=(jnp.asarray(a),), palette=int(pal)), "Title", **style)
        .planes[0])
    got = ttext.overlay_text(TLayer(planes=(torch.from_numpy(a),),
                                    palette=int(pal)), "Title", **style)
    assert np.abs(got.planes[0].numpy().astype(int) - ref).max() <= 1
    batch = np.stack([a, _frames(c, seed=9)])
    got = ttext.overlay_text(TLayer(planes=(torch.from_numpy(batch),),
                                    palette=int(pal)), "Title", **style)
    assert np.abs(got.planes[0][0].numpy().astype(int) - ref).max() <= 1
    if c == 4:
        np.testing.assert_array_equal(got.planes[0][:, 3].numpy(),
                                      batch[:, 3])


def test_overlay_refuses_a_yuv_layer():
    lay = TLayer(planes=(torch.zeros(8, 8, dtype=torch.uint8),) * 3,
                 palette=int(Palette.YUV420P))
    with pytest.raises(ValueError, match="RGB"):
        ttext.overlay_text(lay, "x")


SUBS = [(0.0, 0.2, "HELLO"), (1.5, 2.25, "two\nlines"),
        (3723.456, 3725.0, "an hour in")]


def test_srt_files_byte_identical_and_parsed_alike(tmp_path):
    jp, tp = tmp_path / "j.srt", tmp_path / "t.srt"
    jtext.save_srt(jp, [jtext.Subtitle(*s) for s in SUBS])
    ttext.save_srt(tp, [ttext.Subtitle(*s) for s in SUBS])
    assert tp.read_bytes() == jp.read_bytes()
    ref, got = jtext.load_srt(jp), ttext.load_srt(tp)
    assert [(s.start, s.end, s.text) for s in got] == \
        [(s.start, s.end, s.text) for s in ref]
    for t in (0.1, 0.2, 1.6, 3724.0, 9.0):
        assert ttext.sub_at(got, t) == jtext.sub_at(ref, t)


def test_sub_files_parsed_alike(tmp_path):
    path = tmp_path / "m.sub"
    path.write_text("{0}{25}first|line\nnoise\n{50}{75}second\n")
    for fps in (25.0, 29.97):
        ref, got = jtext.load_sub(path, fps), ttext.load_sub(path, fps)
        assert [(s.start, s.end, s.text) for s in got] == \
            [(s.start, s.end, s.text) for s in ref]


def test_subtitle_overlay_matches_jax_and_uploads_once():
    subs = [(0.0, 1.0, "first"), (2.0, 3.0, "second\ntitle")]
    jo = jtext.SubtitleOverlay([jtext.Subtitle(*s) for s in subs], size=11)
    to = ttext.SubtitleOverlay([ttext.Subtitle(*s) for s in subs], size=11)
    for t in (0.0, 0.5, 1.5, 2.0, 2.9):
        a = _frames(3, seed=int(t * 10))
        ref = np.asarray(jo.apply(JLayer(planes=(jnp.asarray(a),),
                                         palette=int(JPalette.RGB24)), t)
                         .planes[0])
        got = to.apply(TLayer(planes=(torch.from_numpy(a),),
                              palette=int(Palette.RGB24)), t).planes[0]
        assert np.abs(got.numpy().astype(int) - ref).max() <= 1
        if t == 1.5:
            np.testing.assert_array_equal(got.numpy(), a)
    assert to.uploads == 2   # one mask a subtitle, not one a frame


def test_player_subtitles_match_jax(monkeypatch, tmp_path):
    """`load_subtitles` on both players: the frames shown with and between
    subtitles, the subtitle indexed by clip time."""
    srt = tmp_path / "subs.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:00,200\nHELLO\n\n"
                   "2\n00:00:00,400 --> 00:00:00,600\nWORLD\n")

    def script(p, sink, clock, pkg):
        p.load_subtitles(srt, size=12)
        p.start()
        for f in (2, 7, 10, 14, 19):
            show(p, f, clock)
    res = run_both(monkeypatch, script)
    same_frames(res["jax"][1].frames, res["torch"][1].frames)
    shown = res["torch"][1].frames
    clip = res["torch"][0].state.fg_clip
    assert not np.array_equal(shown[0], clip.frame_array(2))
    np.testing.assert_array_equal(shown[1], clip.frame_array(7))
    assert not np.array_equal(shown[2], clip.frame_array(10))
    assert res["torch"][0].subtitles.uploads == 2


def test_player_subtitles_sub_file(tmp_path):
    """A .sub file's frames count at the playback fps."""
    path = tmp_path / "m.sub"
    path.write_text("{0}{5}hi\n")
    p, _ = make_player("torch", fps=10.0)
    subs = p.load_subtitles(path).subs
    assert [(s.start, s.end, s.text) for s in subs] == [(0.0, 0.5, "hi")]


# -- the float32 twins --------------------------------------------------------

def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("lo,hi", [(0, 0x3F400000), (0x3F400000, 0x42F00000),
                                   (0x42F00000, 0x48000000)])
def test_cosf_is_jax_cos_on_a_stride(lo, hi):
    """Every 14,983rd float32 of each path of the C library's `cosf`: the
    polynomial alone, one multiply-subtract, Payne-Hanek (to 2^17), and
    the negatives."""
    x = np.arange(lo, hi, 14983, dtype=np.uint32).view(np.float32)
    for v in (x, -x):
        np.testing.assert_array_equal(_bits(cosf(torch.from_numpy(v))),
                                      _bits(jnp.cos(v)))


def test_cosf_edges():
    edges = [0x00000000, 0x39800000, 0x3F400000, 0x3F490FDB, 0x42F00000,
             0x48000000, 0x4B000000, 0x7F7FFFFF]
    bits = np.unique(np.concatenate([np.arange(e - 40, e + 40) for e in
                                     edges]).clip(0, 0x7F7FFFFF))
    x = bits.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, -x, np.float32([np.inf, -np.inf, np.nan])])
    got = cosf(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.cos(x))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(ref[ok]))


@pytest.mark.parametrize("lo,hi", [(-90.0, -80.0), (-80.0, 0.0),
                                   (0.0, 89.0)])
def test_expf_is_jitted_jax_exp(lo, hi):
    """300,007 values a range, XLA's subnormal flush included, and
    clamped arguments beyond it."""
    x = np.linspace(lo, hi, 300_007, dtype=np.float32)
    ref = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(_bits(expf(torch.from_numpy(x))),
                                  _bits(ref))
    with pytest.raises(TypeError, match="float32"):
        expf(torch.zeros(2, dtype=torch.float64))


def test_fma32_is_a_contracted_jit():
    """A jitted `a * b + c` is one FMA on this host; fma32 rounds alike,
    where the float64 sum alone would round twice."""
    rng = np.random.default_rng(7)
    a, b, c = (rng.standard_normal(500_000).astype(np.float32) * s
               for s in (1.0, 1e3, 1e-2))
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # exact 1 + 2^-23 + 2^-24 - 2^-60: float64 rounds it to a float32
    # midpoint, whose tie goes to 1 + 2^-22; once rounded it is 1 + 2^-23
    a = np.float32([2.0 ** -12 * (1 + 2.0 ** -18)])
    b = np.float32([2.0 ** -12 * (1 - 2.0 ** -18)])
    c = np.float32([1 + 2.0 ** -23])
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[0] == np.float32(1 + 2.0 ** -22)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got.item() == 1 + 2.0 ** -23
    assert _bits(got.numpy()) == _bits(jax.jit(lambda a, b, c: a * b + c)(
        a, b, c))
