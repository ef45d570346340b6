"""lives_tpu_torch.scenes and the copied event list against lives_tpu.

The synthetic source is integer-exact with the JAX package's; the
benchmark timeline is the same event list; EventList JSON crosses between
the two packages byte for byte."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.events.event_list import EventList as JEventList
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu.scenes import multitrack_timeline as j_timeline
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.scenes import DeviceSyntheticSource as TSource
from lives_tpu_torch.scenes import multitrack_timeline as t_timeline


def _channels_both(c, f, x, y):
    j = JSource._channels(jnp.asarray(c, jnp.int32), jnp.asarray(f, jnp.int32),
                          jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))
    t = TSource._channels(torch.from_numpy(np.asarray(c, np.int32)),
                          torch.from_numpy(np.asarray(f, np.int32)),
                          torch.from_numpy(np.asarray(x, np.int32)),
                          torch.from_numpy(np.asarray(y, np.int32)))
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("clip", range(-1, 41))
def test_channels_integer_exact(clip):
    """Every frame 0..300 over a pixel grid, per clip id: the blank c<0
    branch, every c % 5 and c % 3 class, and the negative g intermediate
    (y*(2+c%3)//8 - 2*phase) before the & 0xFF wrap."""
    f = np.arange(301, dtype=np.int32)[:, None, None]
    y = np.arange(16, dtype=np.int32)[None, :, None]
    x = np.arange(0, 1920, 37, dtype=np.int32)[None, None, :]
    js, ts = _channels_both(np.int32(clip), f, x, y)
    for jc, tc in zip(js, ts):
        assert tc.dtype == np.int32 and tc.shape == jc.shape
        np.testing.assert_array_equal(tc, jc)
        assert tc.min() >= 0 and tc.max() <= 255
    if clip < 0:
        assert all(not tc.any() for tc in ts)


def test_channels_floor_division_semantics():
    """torch's // and % floor like jnp's, also on negative operands (C's /
    and % truncate; the CUDA kernel only divides non-negative operands,
    which is all a non-blank clip at frame coordinates gives it)."""
    c = np.arange(-7, 45, dtype=np.int32)[:, None, None, None]
    f = np.arange(-3, 4, dtype=np.int32)[None, :, None, None]
    y = np.arange(-20, 20, 3, dtype=np.int32)[None, None, :, None]
    x = np.arange(-40, 40, 7, dtype=np.int32)[None, None, None, :]
    js, ts = _channels_both(c, f, x, y)
    for jc, tc in zip(js, ts):
        np.testing.assert_array_equal(tc, jc)
    v = torch.tensor([-7, -1, 0, 5, 13], dtype=torch.int32)
    np.testing.assert_array_equal((v // 4).numpy(),
                                  np.asarray(jnp.asarray(v.numpy()) // 4))
    np.testing.assert_array_equal((v % 5).numpy(),
                                  np.asarray(jnp.asarray(v.numpy()) % 5))


@pytest.mark.parametrize("alpha", [False, True])
def test_make_matches_jax(alpha):
    h, w = 24, 72
    clips = np.array([3, -1, 17, 40, 2 ** 40 + 5], np.int64)
    frames = np.array([0, 9, 150, 299, 7], np.int64)
    ref = np.asarray(JSource(h, w, alpha=alpha).get_batch(
        clips.astype(np.int32), frames.astype(np.int32)).planes[0])
    src = TSource(h, w, device="cpu", alpha=alpha)
    got = src.get_batch(clips, frames)
    assert got.planes[0].dtype == torch.uint8
    np.testing.assert_array_equal(got.planes[0].numpy(), ref)
    traced = src.traced_layer(torch.from_numpy(clips.astype(np.int32)),
                              torch.from_numpy(frames.astype(np.int32)))
    np.testing.assert_array_equal(traced.planes[0].numpy(), ref)
    assert got.palette == int(JSource(h, w, alpha=alpha).get_batch(
        [1], [0]).palette)
    assert src.source_key() == JSource(h, w, alpha=alpha).source_key()


def _canonical(el_json: str) -> str:
    """Event-list JSON with the random event ids replaced by ordinals."""
    d = json.loads(el_json)
    ids: dict[str, str] = {}

    def canon(eid):
        return ids.setdefault(eid, f"e{len(ids)}")
    for e in d["events"]:
        e["event_id"] = canon(e["event_id"])
    for e in d["events"]:
        p = e["props"]
        if "init_event" in p:
            p["init_event"] = canon(p["init_event"])
        if "init_events" in p:
            p["init_events"] = [canon(i) for i in p["init_events"]]
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("n_tracks,n_frames,w,h,fps", [
    (10, 300, 1920, 1080, 30.0), (4, 8, 256, 48, 25.0), (1, 3, 64, 16, 24.0)])
def test_multitrack_timeline_same_events(n_tracks, n_frames, w, h, fps):
    a = j_timeline(n_tracks=n_tracks, n_frames=n_frames, width=w, height=h,
                   fps=fps)
    b = t_timeline(n_tracks=n_tracks, n_frames=n_frames, width=w, height=h,
                   fps=fps)
    assert _canonical(a.to_json()) == _canonical(b.to_json())


def test_event_list_json_round_trip_both_directions():
    j_text = j_timeline(n_tracks=4, n_frames=12, width=256, height=48,
                        fps=25.0).to_json()
    assert TEventList.from_json(j_text).to_json() == j_text
    t_text = t_timeline(n_tracks=4, n_frames=12, width=256, height=48,
                        fps=25.0).to_json()
    assert JEventList.from_json(t_text).to_json() == t_text
