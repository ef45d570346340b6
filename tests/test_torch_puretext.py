"""puretext of lives_tpu_torch against lives_tpu: the host atlas and
hash, every letter's cell origin, rotation and opacity against the jitted
JAX filter, and frames through both FrameGraphs and both renderers. The
JAX plan's spiral and spinning positions contract an FMA only where LLVM
keeps the letter loop, and a one-letter starfield contracts its distance
(`tools/puretext_forms.py` maps it, `puretext.contracted` holds the rule):
the tests hold letter counts from 1 to 256 across the loops' boundaries
and their vector tails, at batch sizes of 1, 8, 96 and 2,000.

Tolerances: letters exact; frames +/-1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import letters_text
from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.effects.builtin import puretext as jpt
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects import host as t_host
from lives_tpu_torch.effects.builtin import puretext
from lives_tpu_torch.effects.host import Instance
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer
from tools.puretext_forms import samples
from tools.puretext_positions import jax_letters


PT_TEXTS = [("HELLO WORLD, pure text sweeps", 54, 96, 12),
            ("odd size titles", 41, 67, 8)]


@pytest.mark.parametrize("text,h,w,size", PT_TEXTS, ids=["96x54", "67x41"])
@pytest.mark.parametrize("mode", range(7), ids=puretext.MODES)
def test_puretext_letters_exact(mode, text, h, w, size):
    """Every letter's cell origin, rotation and opacity over a sweep of
    2,000 (tc, speed) pairs, as one batch and one frame at a time (every
    20th of the first 300): equal to the jitted JAX filter's."""
    rng = np.random.default_rng(mode)
    tc = np.concatenate([np.arange(0, 15, 0.01),
                         rng.uniform(0, 30, 500)]).astype(np.float32)
    sp = rng.uniform(0.05, 10.0, len(tc)).astype(np.float32)
    sp[:500] = 1.0
    ref = jax_letters(mode, text, size, w, h)(jnp.asarray(tc),
                                               jnp.asarray(sp))
    got = puretext.letters(
        mode, torch.from_numpy(tc)[:, None], torch.from_numpy(sp)[:, None],
        puretext._atlas_on(text, size, w, h, mode == 1, "cpu"), w, h)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    fn = jax_letters(mode, text, size, w, h)
    on = puretext._atlas_on(text, size, w, h, mode == 1, "cpu")
    for k in range(0, 300, 20):
        ref = fn(jnp.asarray(tc[k:k + 1]), jnp.asarray(sp[k:k + 1]))
        got = puretext.letters(mode, torch.from_numpy(tc[k:k + 1])[:, None],
                               torch.from_numpy(sp[k:k + 1])[:, None], on,
                               w, h)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("text,h,w,size", PT_TEXTS, ids=["96x54", "67x41"])
@pytest.mark.parametrize("mode", range(7), ids=puretext.MODES)
def test_puretext_through_frame_graphs(mode, text, h, w, size):
    """Frames over a sweep of tc through both FrameGraphs: letters blended
    in index order, +/-1 LSB."""
    rng = np.random.default_rng(10 + mode)
    n = 8
    frames = rng.integers(0, 256, (n, 3, h, w), np.uint8)
    tcs = np.sort(rng.uniform(0, 12, n)).astype(np.float32)
    params = {"speed": rng.uniform(0.05, 4, n).astype(np.float32),
              **{c: rng.random(n).astype(np.float32)
                 for c in ("red", "green", "blue")}}
    vals = {"text": text, "mode": mode, "size": size}
    ref = JGraph([j_instantiate("puretext", **vals)], JSink(),
                 fps=30.0).run_batch(
        [JLayer(planes=(jnp.asarray(frames),),
                palette=int(JPalette.RGB24))], tcs,
        np.arange(n, dtype=np.int32), [params])
    got = TGraph([Instance(filter=puretext.FILTER, values=dict(vals))],
                 TSink(),
                 fps=30.0).run_batch(
        [TLayer(planes=(torch.from_numpy(frames),),
                palette=int(Palette.RGB24))], tcs,
        np.arange(n, dtype=np.int32), [params])
    ref = np.asarray(ref.planes[0])
    d = np.abs(got.planes[0].numpy().astype(int) - ref)
    assert d.max() <= 1, d.max()
    assert (ref != frames).any()


def test_puretext_atlas_and_hash_are_the_jax_ones():
    for rot in (False, True):
        ref = jpt._text_atlas("Ab c\nDe", 14, 96, 54, rot)
        got = puretext._text_atlas("Ab c\nDe", 14, 96, 54, rot)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    i = np.arange(300)
    np.testing.assert_array_equal(puretext._hash01(i, 11), jpt._hash01(i, 11))


#: (mode, letters): the kept loops' boundaries (spiral 56 in a batch and
#: 64 for one frame, spinning 104) and vector tails (70, 111), up to the
#: atlas' cap; the one-letter starfield
LONG_CASES = ([(0, n) for n in (55, 56, 63, 64, 70, 128, 256)]
              + [(1, n) for n in (103, 104, 111, 200, 256)] + [(2, 1)])


@pytest.mark.parametrize("mode,n", LONG_CASES)
def test_puretext_letters_exact_at_long_texts(mode, n):
    """Every letter of a text of n glyphs at 640x360, one frame at a time,
    in batches of 8 and of 96: equal to the jitted JAX filter's."""
    text, w, h, size = letters_text(n), 640, 360, 14
    rng = np.random.default_rng(n + 1000 * mode)
    tc = rng.uniform(0, 30, 192).astype(np.float32)
    sp = rng.uniform(0.05, 10.0, 192).astype(np.float32)
    sp[:64] = 1.0
    on = puretext._atlas_on(text, size, w, h, mode == 1, "cpu")
    assert on[0].shape[0] == n
    fn = jax_letters(mode, text, size, w, h)
    for B, stop in ((1, 48), (8, 192), (96, 192)):
        for k in range(0, stop, B):
            ref = fn(jnp.asarray(tc[k:k + B]), jnp.asarray(sp[k:k + B]))
            got = puretext.letters(
                mode, torch.from_numpy(tc[k:k + B])[:, None],
                torch.from_numpy(sp[k:k + B])[:, None], on, w, h, B)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("B", [2, 5, 17, 33, 95])
def test_puretext_letters_exact_at_other_batches(B):
    """At the kept loops' boundaries and vector tails, in batches of B
    frames (a render's last chunk, a caller's `batch_size`), on the form
    map's (tc, speed) samples, whose even steps of tc catch an ulp of
    rotation that random ones miss: every letter equal to the jitted JAX
    filter's."""
    w, h, size = 640, 360, 14
    for mode, n in ((0, 55), (0, 56), (0, 63), (0, 64), (1, 103),
                    (1, 104), (1, 111)):
        text = letters_text(n)
        on = puretext._atlas_on(text, size, w, h, mode == 1, "cpu")
        fn = jax_letters(mode, text, size, w, h)
        for tc, sp in zip(*samples(768, B)):
            ref = fn(jnp.asarray(tc), jnp.asarray(sp))
            got = puretext.letters(
                mode, torch.from_numpy(tc)[:, None],
                torch.from_numpy(sp)[:, None], on, w, h, B)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", [56, 104, 256])
@pytest.mark.parametrize("mode", [0, 1])
def test_puretext_is_registered_and_renders_long_texts(mode, n):
    """Registered and deferred no more (it was until its letter forms
    were matched): `render_events` renders a timeline of it at n letters
    over the synthetic source, in chunks of 4 frames and then of 1, within
    1 LSB of the JAX renderer."""
    from lives_tpu.events import renderer as jr
    from lives_tpu.events.event_list import EventList as JEventList
    from lives_tpu.scenes import DeviceSyntheticSource as JSource
    from lives_tpu_torch.events import renderer as tr
    from lives_tpu_torch.events.event_list import (EventList,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    assert "puretext" in t_host.list_filters()
    assert "puretext" not in t_host.DEFERRED
    el = EventList(fps=25.0, width=96, height=54)
    init = filter_init_event(0, "puretext", values={
        "text": letters_text(n), "mode": mode, "size": 8, "speed": 2.5})
    el.insert(init)
    el.insert(filter_map_event(0, [init.event_id]))
    for i in range(4):
        el.insert(frame_event(i * 40_000_000 + 7_000_000, [1], [i]))
    for B in (4, 1):
        got, _ = tr.render_to_arrays(
            el, DeviceSyntheticSource(54, 96, device="cpu"),
            TSink(96, 54), batch_size=B)
        ref, _ = jr.render_to_arrays(JEventList.from_json(el.to_json()),
                                     JSource(54, 96), JSink(96, 54),
                                     batch_size=B)
        assert got.shape == (4, 3, 54, 96)
        assert np.abs(got.astype(int) - np.asarray(ref).astype(int)) \
            .max() <= 1
