"""Clip edits of lives_tpu_torch against lives_tpu's on the CPU: the
clipboard (copy, cut, delete, paste_insert, trim_clip), merge_clipboard
through two-input transitions with its ramp and audio crossfade (on the
plain route and under LIVES_TPU_PALLAS_COMPOSITE=1, each against the same
route of the JAX package), the frame-edit undo and its redo, resample.py
(fps retime, reverse, speed change) and every audioedit op with its
one-slot undo.

Inputs are seeded numpy frames and audio: the same YUV4MPEG2 clip opened
by both packages, or clips of image frames, 48x32; the port runs with
`device="cpu"`. Tolerances: whole clip directory trees (names and bytes:
images, headers, frame indexes, audio, the undo snapshot) equal after
every edit, undo and redo; merged pixels within 1 LSB (a blend's
multiply-add that XLA fuses; wipe is exact), PNGs byte for byte where the
pixels are equal; audio sample-exact.
"""

import numpy as np
import pytest

from lives_tpu import audioedit as jae
from lives_tpu import clipedit as jce
from lives_tpu import resample as jrs
from lives_tpu.io import clips as jclips
from lives_tpu_torch import audioedit as tae
from lives_tpu_torch import clipedit as tce
from lives_tpu_torch import resample as trs
from lives_tpu_torch.graph import nodemodel as tnm
from lives_tpu_torch.io import clips as tclips
from test_torch_clips import assert_clips_match, image_pair, tree, y4m_pair

CPU = "cpu"
RATE = 8000


@pytest.fixture(autouse=True)
def jax_f32_chain(monkeypatch):
    monkeypatch.setenv("LIVES_TPU_FUSED_SWEEP", "0")
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")


def _audio(n_frames, fps=25.0, ch=2, seed=0):
    t = np.arange(int(n_frames / fps * RATE), dtype=np.float32) / RATE
    rng = np.random.default_rng(seed)
    wave = 0.5 * np.sin(2 * np.pi * (220 + 40 * seed) * t)
    return np.stack([wave, wave * 0.5][:ch], 1).astype(np.float32) \
        + rng.normal(0, 0.01, (len(t), ch)).astype(np.float32)


def assert_trees_match(jc, tc):
    """The two clip directories, every file's name and bytes (the undo
    snapshot included)."""
    assert tree(jc.clip_dir) == tree(tc.clip_dir)


def _pair_with_audio(tmp, kind="y4m", n=8, seed=3):
    if kind == "y4m":
        return y4m_pair(tmp, n=n, seed=seed, audio=_audio(n, seed=seed),
                        arate=RATE)
    jc, tc = image_pair(tmp, n=n, seed=seed)
    for c in (jc, tc):
        c.write_audio(_audio(n, seed=seed), RATE)
        c.save_header()
    return jc, tc


# -- the clipboard ------------------------------------------------------------

def test_copy_frames_matches_jax(tmp_path):
    jc, tc = _pair_with_audio(tmp_path)
    jcb = jce.copy_frames(jc, 2, 7)
    tcb = tce.copy_frames(tc, 2, 7, device=CPU)
    assert len(tcb) == len(jcb) == 5 and tcb.fps == jcb.fps
    for a, b in zip(tcb.frames, jcb.frames):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tcb.audio, jcb.audio)
    assert tcb.arate == jcb.arate == RATE
    assert tce.copy_frames(tc, 0, 2, with_audio=False,
                           device=CPU).audio is None


@pytest.mark.parametrize("kind", ["y4m", "images"])
def test_paste_insert_then_undo_redo_trees(tmp_path, kind):
    """copy 3 frames of a second clip, paste them into the first: the
    trees equal the JAX package's after the paste, after undo (the tree
    before the paste, the snapshot now holding the paste) and after the
    second undo, a redo."""
    jc, tc = _pair_with_audio(tmp_path / "a", kind)
    jo, to = _pair_with_audio(tmp_path / "b", kind, seed=5)
    jcb, tcb = jce.copy_frames(jo, 1, 4), tce.copy_frames(to, 1, 4,
                                                           device=CPU)
    before = tree(tc.clip_dir)
    jce.paste_insert(jc, 3, jcb)
    tce.paste_insert(tc, 3, tcb)
    assert tc.frames == 11 and not tc.is_virtual_frame(3)
    assert_trees_match(jc, tc)
    assert_clips_match(jc, tc)
    pasted = tree(tc.clip_dir)

    def layout(t):
        # an image clip had no frame_index before the paste: the undo
        # leaves the paste's file behind, in both packages (the JAX
        # package's undo_edit writes the index only when there is one)
        return {k: v for k, v in t.items()
                if not k.startswith(tce.EDIT_UNDO_DIR)
                and not (kind == "images" and k == "frame_index")}
    assert tce.undo_edit(tc) and jce.undo_edit(jc)
    assert_trees_match(jc, tc)
    assert layout(tree(tc.clip_dir)) == layout(before)
    assert tc.frames == 8
    assert tce.undo_edit(tc) and jce.undo_edit(jc)   # redo
    assert_trees_match(jc, tc)
    assert layout(tree(tc.clip_dir)) == layout(pasted)


def test_paste_resamples_clipboard_audio_like_jax(tmp_path):
    jc, tc = _pair_with_audio(tmp_path, "images")
    audio = _audio(3, seed=2)
    jcb = jce.Clipboard(frames=[np.full((3, 32, 48), 9, np.uint8)] * 2,
                        audio=audio, arate=RATE // 2)
    tcb = tce.Clipboard(frames=list(jcb.frames), audio=audio,
                        arate=RATE // 2)
    jce.paste_insert(jc, 8, jcb)
    tce.paste_insert(tc, 8, tcb)
    assert_trees_match(jc, tc)


@pytest.mark.parametrize("kind", ["y4m", "images"])
def test_cut_delete_and_trim_trees(tmp_path, kind):
    jc, tc = _pair_with_audio(tmp_path, kind)
    jcb = jce.cut_frames(jc, 1, 3)
    tcb = tce.cut_frames(tc, 1, 3, device=CPU)
    for a, b in zip(tcb.frames, jcb.frames):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert_trees_match(jc, tc)
    jce.delete_frames(jc, 4, 5)
    tce.delete_frames(tc, 4, 5)
    assert_trees_match(jc, tc)
    jce.trim_clip(jc, 1, 4)
    tce.trim_clip(tc, 1, 4)
    assert tc.frames == 3
    assert_trees_match(jc, tc)
    assert tce.undo_edit(tc) and jce.undo_edit(jc)
    assert tc.frames == 5
    assert_trees_match(jc, tc)


def test_undo_without_snapshot_is_refused(tmp_path):
    jc, tc = image_pair(tmp_path, n=2)
    assert not tce.undo_edit(tc) and not jce.undo_edit(jc)


# -- merge --------------------------------------------------------------------

@pytest.mark.parametrize("composite", ["0", "1"])
@pytest.mark.parametrize("transition,params", [
    ("crossfade", {}), ("wipe", {}), ("alpha_over", {}),
    ("dissolve", {})],
    ids=["crossfade", "wipe", "alpha_over", "dissolve"])
def test_merge_clipboard_matches_jax(tmp_path, monkeypatch, transition,
                                     params, composite):
    """The clipboard (looped, shorter than the range) merged through a
    transition over frames [1, 8), the ramp (0.2, 0.9) as its traced
    parameter, the audio crossfaded: audio, headers and undo snapshot as
    the JAX package's on the same route, frames within 1 LSB (the blend's
    multiply-add, which XLA fuses, rounds the other way on a few pixels;
    byte-identical PNGs wherever the pixels are equal). A one-instance
    chain is below the composite route's three in both packages, so the
    pref changes nothing: no K4 plan is built."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", composite)
    jc, tc = _pair_with_audio(tmp_path / "a")
    jo, to = _pair_with_audio(tmp_path / "b", seed=7)
    jcb, tcb = jce.copy_frames(jo, 0, 3), tce.copy_frames(to, 0, 3,
                                                           device=CPU)
    kw = dict(transition=transition, start=1, end=8, ramp=(0.2, 0.9),
              **params)
    prog = []
    nj = jce.merge_clipboard(jc, jcb, **kw)
    nt = tce.merge_clipboard(tc, tcb, batch_size=3, device=CPU,
                             progress=lambda a, b: prog.append(b), **kw)
    assert nt == nj == 7 and prog == [7] * 7
    assert_clips_match(jc, tc, tol=1)
    assert tree(jc.clip_dir / jce.EDIT_UNDO_DIR) == \
        tree(tc.clip_dir / tce.EDIT_UNDO_DIR)
    assert not any(isinstance(p, tnm.composite.CompositePlan)
                   for p in tnm._PLANS.values())


def test_merge_refusals_and_empty_audio_like_jax(tmp_path):
    jc, tc = _pair_with_audio(tmp_path, "images")
    cb = tce.Clipboard(frames=[np.zeros((3, 32, 48), np.uint8)])
    tce.snapshot_edit_undo(tc)
    meta = tc.clip_dir / tce.EDIT_UNDO_DIR / "meta.json"
    stamp = meta.stat().st_mtime_ns
    with pytest.raises(KeyError):
        tce.merge_clipboard(tc, cb, transition="no_such_transition",
                            device=CPU)
    with pytest.raises(ValueError, match="2-input"):
        tce.merge_clipboard(tc, cb, transition="negate", device=CPU)
    assert meta.stat().st_mtime_ns == stamp     # validation precedes it
    assert tce.merge_clipboard(tc, tce.Clipboard(), device=CPU) == 0
    jcb = jce.Clipboard(frames=[np.full((3, 16, 24), 200, np.uint8)],
                        audio=np.zeros((0, 2), np.float32), arate=RATE)
    tcb = tce.Clipboard(frames=list(jcb.frames), audio=jcb.audio,
                        arate=RATE)
    assert jce.merge_clipboard(jc, jcb) == \
        tce.merge_clipboard(tc, tcb, device=CPU) == 8
    assert_clips_match(jc, tc)


def test_merge_device_is_explicit(tmp_path):
    _, tc = image_pair(tmp_path, n=2)
    cb = tce.Clipboard(frames=[np.zeros((3, 32, 48), np.uint8)])
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        tce.merge_clipboard(tc, cb)
    with pytest.raises(RuntimeError, match="CUDA"):
        tce.copy_frames(tc, 0, 1)


# -- resample.py --------------------------------------------------------------

@pytest.mark.parametrize("fps", [50.0, 12.5, 30.0, 25.0 * 7 / 10])
@pytest.mark.parametrize("kind", ["virtual", "mixed"])
def test_resample_clip_fps_matches_jax(tmp_path, kind, fps):
    jc, tc = y4m_pair(tmp_path, n=10)
    if kind == "mixed":
        jc.realize(0, 3)
        tc.realize(0, 3, device=CPU)
    assert trs.resample_clip_fps(tc, fps) == jrs.resample_clip_fps(jc, fps)
    assert tc.fps == fps
    assert_trees_match(jc, tc)
    assert_clips_match(jc, tc)


@pytest.mark.parametrize("kind", ["virtual", "mixed"])
def test_reverse_and_speed_change_match_jax(tmp_path, kind):
    jc, tc = y4m_pair(tmp_path, n=6)
    if kind == "mixed":
        jc.realize(1, 3)
        tc.realize(1, 3, device=CPU)
    jrs.reverse_clip(jc)
    trs.reverse_clip(tc)
    assert_trees_match(jc, tc)
    assert trs.speed_change(tc, 2.0) == jrs.speed_change(jc, 2.0) == 6
    assert tc.fps == 50.0
    assert_trees_match(jc, tc)
    with pytest.raises(ValueError):
        trs.resample_clip_fps(tc, 0.0)


# -- audioedit ----------------------------------------------------------------

def _audio_pair(tmp_path):
    out = []
    for mod, sub in ((jclips, "j"), (tclips, "t")):
        c = mod.create_clip(tmp_path / sub, 64, 48, fps=10.0, name="a")
        c.frames = 20
        c.write_audio(_audio(20, fps=10.0), RATE)
        out.append(c)
    out[1].unique_id = out[0].unique_id
    for c in out:
        c.save_header()
    return out


AUDIO_OPS = {
    "fade_in": lambda m, c: m.fade_in(c, 1.0),
    "fade_out": lambda m, c: m.fade_out(c, 0.5),
    "fade_span": lambda m, c: m.fade_span(c, 0.5, 1.0, 1.0, 0.0),
    "normalize": lambda m, c: m.normalize(c),
    "voladj": lambda m, c: m.voladj(c, 1.7),
    "trim_pad_inside": lambda m, c: m.trim_pad(c, 0.5, 1.5),
    "trim_pad_beyond": lambda m, c: m.trim_pad(c, 0.25, 2.5),
    "delete_span": lambda m, c: m.delete_span(c, 0.5, 1.0),
    "delete_all": lambda m, c: m.delete_span(c),
    "insert_silence": lambda m, c: m.insert_silence(c, 0.5, 1.0),
    "append_mono_half_rate": lambda m, c: m.append_audio(
        c, np.full((RATE // 2, 1), 0.25, np.float32), RATE // 2),
    "append_stereo_rows": lambda m, c: m.append_audio(
        c, _audio(3, seed=4).T, RATE),
    "adjust_sync_delay": lambda m, c: m.adjust_sync(c, 0.5),
    "adjust_sync_advance": lambda m, c: m.adjust_sync(c, -0.25),
}


@pytest.mark.parametrize("op", sorted(AUDIO_OPS))
def test_audioedit_op_is_sample_exact_with_undo(tmp_path, op):
    """Each op twice in a row (chained edits must not decay the track),
    then the one-slot undo: the audio files and headers equal the JAX
    package's at every step."""
    jc, tc = _audio_pair(tmp_path)
    for _ in range(2):
        assert AUDIO_OPS[op](tae, tc) == AUDIO_OPS[op](jae, jc)
        assert_trees_match(jc, tc)
    assert tae.undo_audio(tc) == jae.undo_audio(jc) is True
    assert_trees_match(jc, tc)
    assert tae.undo_audio(tc) == jae.undo_audio(jc) is False


def test_audioedit_refuses_without_a_rate(tmp_path):
    c = tclips.create_clip(tmp_path, 8, 8)
    with pytest.raises(RuntimeError, match="audio rate"):
        tae.insert_silence(c, 0.0, 1.0)
    c.write_audio(np.zeros((10, 1), np.float32), RATE)
    assert tae.normalize(c) == 1.0     # silent: gain 1, no snapshot
    assert not tae.undo_audio(c)
