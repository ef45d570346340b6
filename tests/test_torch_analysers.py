"""`analysers.py`'s nine filters and host helpers of lives_tpu_torch
against lives_tpu, on the same seeded frames and parameters.

The reference is the JITTED JAX filter (see test_torch_alpha.py, whose
helpers these tests use). A stateless analyser takes the port's batch of
B frames, each of its out-values a (B,) tensor, against the JAX filter's
frames one by one; the stateful ones (motion_analyser, scene_change,
template_tracker) run several frames with their states carried.

Tolerances: the video passes through unchanged; blank_frame_detector's
flag, histogram counts, scene_change's cut, tracker positions and haar
signatures exact; float out-values and carried float state within
1e-5."""

import numpy as np
import pytest
import torch

from lives_tpu.effects.builtin import analysers as ja
from lives_tpu_torch.effects.builtin import analysers as ta
from test_torch_alpha import (B, FPS, SIZES, close, frames, jax_step,
                              port_step, run_stateful, same_state)


def _batch(name, vals, ins, alphas=()):
    got, inst = port_step(name, ins, vals, slice(0, B), range(B),
                          np.arange(B) / FPS, alphas=alphas)
    refs = [jax_step(name, ins, vals, b, b, b / FPS, alphas=alphas)
            for b in range(B)]
    np.testing.assert_array_equal(got, ins[0])   # the video passes through
    ov = {k: np.stack([r[2][k] for r in refs]) for k in refs[0][2]}
    assert set(inst.out_values) == set(ov)
    return {k: v.numpy() for k, v in inst.out_values.items()}, ov


def _dark(seed, h, w):
    """B frames: a near-black one, a mid-grey one, random noise."""
    f = frames(seed, B, h, w)
    f[0] = f[0] // 16
    f[1] = 128
    return f


@pytest.mark.parametrize("h,w", SIZES)
def test_blank_frame_detector(h, w):
    vals = {"threshold": np.array([0.05, 0.6, 0.3], np.float32)}
    got, ref = _batch("blank_frame_detector", vals, [_dark(20, h, w)])
    np.testing.assert_array_equal(got["blank"], ref["blank"])
    assert got["blank"].tolist() == [1.0, 1.0, 0.0]
    close(got["mean_luma"], ref["mean_luma"])


@pytest.mark.parametrize("conn", [None, "A8", "AFLOAT", "A1"])
@pytest.mark.parametrize("c", [3, 4])
def test_alpha_means(conn, c):
    h, w = SIZES[1]
    alphas = ()
    if conn:
        from lives_tpu_torch.constants import Palette
        pal = int(getattr(Palette, conn))
        rng = np.random.default_rng(21)
        plane = (rng.uniform(0, 1, (B, h, w)).astype(np.float32)
                 if conn == "AFLOAT" else
                 rng.integers(0, 2 if conn == "A1" else 256, (B, h, w),
                              dtype=np.uint8))
        alphas = ((plane, pal),)
    got, ref = _batch("alpha_means", {}, [frames(22, B, h, w, c)], alphas)
    for k in ref:
        close(got[k], ref[k])


@pytest.mark.parametrize("h,w", SIZES)
def test_histogram(h, w):
    ins = [frames(23, B, h, w)]
    ins[0][1] = 255        # all white: luma at (or past) 1.0
    ins[0][2, :, :4] = 0
    got, ref = _batch("histogram", {}, ins)
    # counts exact: each bin's share times the pixel count
    np.testing.assert_array_equal(np.rint(got["histogram"] * h * w),
                                  np.rint(ref["histogram"] * h * w))
    np.testing.assert_array_equal(got["histogram"], ref["histogram"])
    for k in ("contrast", "brightness"):
        close(got[k], ref[k])


@pytest.mark.parametrize("h,w", SIZES)
def test_edge_analyser(h, w):
    got, ref = _batch("edge_analyser", {}, [frames(24, B, h, w)])
    close(got["edge_energy"], ref["edge_energy"])


@pytest.mark.parametrize("h,w", SIZES)
def test_spot_tracker(h, w):
    ins = [frames(25, B, h, w) // 2]
    ins[0][0, :, 20:28, 40:48] = 250          # a light in frame 0
    ins[0][1] = 77                            # a flat frame: ties -> first
    got, ref = _batch("spot_tracker", {}, ins)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert (got["x"][1], got["y"][1]) == (0.5 / (w // 8), 0.5 / (h // 8))
    close(got["intensity"], ref["intensity"])


@pytest.mark.parametrize("h,w,nco", [(54, 96, 1), (54, 96, 128),
                                     (41, 67, 40), (128, 128, 128),
                                     (200, 300, 40)])
def test_haar_analyser(h, w, nco):
    vals = {"nco": nco}
    got, ref = _batch("haar_analyser", vals, [frames(26, B, h, w)])
    for c in "yuv":
        np.testing.assert_array_equal(got[f"sig_{c}"], ref[f"sig_{c}"])
        assert (got[f"sig_{c}"][:, nco:] == 0).all()
        close(got[f"avg_{c}"], ref[f"avg_{c}"])


def test_haar_helpers():
    np.testing.assert_array_equal(ta.haar_matrix(), ja.haar_matrix())
    h, w = SIZES[0]
    ins = [frames(27, 2, h, w)]
    refs = [jax_step("haar_analyser", ins, {"nco": 40}, b, b, 0.0)[2]
            for b in range(2)]
    _, inst = port_step("haar_analyser", ins, {"nco": 40}, slice(0, 1),
                        [0], [0.0])
    one = inst.out_values
    _, inst = port_step("haar_analyser", ins, {"nco": 40}, slice(1, 2),
                        [1], [0.0])
    assert ta.haar_signature_distance(one, inst.out_values) == \
        ja.haar_signature_distance(refs[0], refs[1])
    assert ta.haar_signature_distance(one, one) == 0.0


def test_audio_helpers():
    rng = np.random.default_rng(28)
    block = rng.normal(0, 0.3, (2048, 2)).astype(np.float32)
    np.testing.assert_array_equal(ta.audio_fft(block, 44100),
                                  ja.audio_fft(block, 44100))
    bt, bj = ta.BeatDetector(), ja.BeatDetector()
    for k in range(200):
        amp = 1.0 if k % 20 == 0 else 0.05
        blk = rng.normal(0, amp, 512).astype(np.float32)
        assert bt.feed(blk) == bj.feed(blk)


# -- stateful analysers -------------------------------------------------------

@pytest.mark.parametrize("h,w", SIZES)
def test_motion_analyser(h, w):
    f = frames(29, 1, h, w)
    # a textured frame drifting right one pixel a frame
    ins = [np.concatenate([np.roll(f, k, 3) for k in range(4)])]
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "motion_analyser", {}, 4, h, w, 0, inputs=ins):
        np.testing.assert_array_equal(got[0], ref)
        for k in ov:
            close(inst.out_values[k].numpy(), ov[k])
        same_state(inst.state, st)


@pytest.mark.parametrize("h,w", SIZES)
def test_scene_change(h, w):
    ins = [frames(30, 5, h, w)]
    ins[0][1] = ins[0][0]            # no change
    ins[0][3] = 255 - ins[0][2] // 4  # a cut
    vals = {"threshold": np.array([0.35, 0.35, 0.1, 0.35, 0.9],
                                  np.float32)}
    cuts = []
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "scene_change", vals, 5, h, w, 0, inputs=ins):
        np.testing.assert_array_equal(inst.out_values["cut"].numpy(),
                                      ov["cut"])
        close(inst.out_values["difference"].numpy(), ov["difference"])
        np.testing.assert_array_equal(inst.state.numpy(), st)
        cuts.append(float(ov["cut"]))
    assert cuts[1] == 0.0 and cuts[3] == 1.0


@pytest.mark.parametrize("h,w", SIZES)
def test_template_tracker(h, w):
    f = frames(31, 1, h, w) // 3
    f[0, :, 10:30, 20:44] = frames(32, 1, 20, 24)[0]   # a textured object
    # the object moves (3, 2) pixels a frame
    ins = [np.concatenate([np.roll(f, (2 * k, 3 * k), (2, 3))
                           for k in range(4)])]
    vals = {"grab": np.array([1.0, 0.0, 0.0, 0.0], np.float32),
            "x": np.full(4, 32 / w, np.float32),
            "y": np.full(4, 20 / h, np.float32)}
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "template_tracker", vals, 4, h, w, 0, inputs=ins):
        for k in ("x", "y"):
            np.testing.assert_array_equal(inst.out_values[k].numpy(),
                                          ov[k])
        close(inst.out_values["score"].numpy(), ov["score"])
        same_state(inst.state, st)
    # it followed the object
    assert float(ov["x"]) == pytest.approx((32 + 9) / w, abs=1.5 / w)


def test_stateless_analysers_on_float_layers():
    """On the float chain's RGBFLOAT layers (a FrameGraph of two or more
    effects converts u8 tracks once) the analysers read the same values."""
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.host import apply_instance, instantiate
    from lives_tpu_torch.layer import Layer
    h, w = SIZES[0]
    u8 = frames(33, B, h, w)
    lays = [Layer(planes=(torch.from_numpy(u8),), palette=int(Palette.RGB24)),
            Layer(planes=(torch.from_numpy(u8).float() / 255.0,),
                  palette=int(Palette.RGBFLOAT))]
    for name in ("blank_frame_detector", "alpha_means", "edge_analyser",
                 "spot_tracker", "haar_analyser"):
        vals = [apply_instance(i, [lay]) and i.out_values
                for i, lay in ((instantiate(name), l) for l in lays)]
        for k in vals[0]:
            a, b = (np.asarray(v[k], np.float64) for v in vals)
            assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max()), \
                (name, k)
