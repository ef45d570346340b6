"""puretext of lives_tpu_torch against lives_tpu: the host atlas and
hash, every letter's cell origin, rotation and opacity against the jitted
JAX filter, and frames through both FrameGraphs. The filter is written but
deferred (`effects.host.DEFERRED`): the JAX plan's spiral and spinning
positions contract an FMA only where LLVM keeps the letter loop
(`tools/puretext_positions.py`), so the tests hold the letter counts the
port matches, 11 to 29 letters, at batch sizes of 1 and 2,000.

Tolerances: letters exact; frames +/-1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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




def test_puretext_is_deferred_naming_its_reason():
    """Not registered; a timeline naming it raises with DEFERRED's reason,
    which names the positions' FMA."""
    from lives_tpu_torch.events import renderer as tr
    from lives_tpu_torch.events.event_list import (EventList,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    assert "puretext" not in t_host.list_filters()
    assert "FMA" in t_host.DEFERRED["puretext"]
    el = EventList(fps=25.0, width=16, height=8)
    init = filter_init_event(0, "puretext")
    el.insert(init)
    el.insert(filter_map_event(0, [init.event_id]))
    el.insert(frame_event(0, [1], [0]))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        list(tr.render_events(el, DeviceSyntheticSource(8, 16, device="cpu")))
