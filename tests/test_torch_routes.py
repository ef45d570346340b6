"""Config D's two routes at full width, in both packages: the composite
route (its 9 transitions quantised to u8 after every stage, as the
composite kernel computes them) against the float route (the whole chain in
float32, quantised once at the sink).

tests/test_pallas.py:115-117 bounds the gap between the JAX package's two
routes by 2 LSB on a 3-stage chain. Over config D's 9 stages at 1920x1080
the per-stage rounding accumulates, and saturation (1.3) and
colour_balance amplify it: on frames 0-3 of chip_smoke.py's 192-frame
timeline the JAX package's routes differ by up to 6 LSB, in 281 values
above 2 LSB (0, 9, 182 and 90 a frame). The port's routes (plain versions,
on the CPU) reproduce that gap value for value, and each port route is
within 1 LSB of the JAX package's; chip_smoke.py holds the card to it.

Frames of 1920x1080 over 10 tracks, each track's synthetic frame through
YUV420P and back (the decoded clips' content); the JAX composite route is
computed as its kernel traces it, each prefix filter's process on u8
layers (`pallas_composite.py:145-157`), then its float tail.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lives_tpu.constants import Palette
from lives_tpu.effects.host import FrameContext, Instance, apply_instance
from lives_tpu.events.renderer import _chain_for as j_chain_for
from lives_tpu.events.renderer import _interp_arrays as j_interp
from lives_tpu.events.renderer import segment_events as j_segments
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.graph.nodemodel import _split_params as j_split
from lives_tpu.layer import Layer as JLayer
from lives_tpu.ops.colorspace import convert_layer as j_convert
from lives_tpu.scenes import DeviceSyntheticSource as JSource
from lives_tpu.scenes import multitrack_timeline
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.events.renderer import _chain_for as t_chain_for
from lives_tpu_torch.events.renderer import segment_events as t_segments
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.layer import Layer as TLayer

H, W, T, PREFIX = 1080, 1920, 10, 9


#: chip_smoke.py's frames 0-3: (max |gap|, values above 2 LSB) a frame
GAPS = [(2, 0), (3, 9), (6, 182), (4, 90)]


@pytest.fixture(scope="module")
def timeline():
    """The main path's 192-frame timeline (as chip_smoke.py renders config
    D), its first segment's chain in both packages and the per-frame
    parameter values."""
    el = multitrack_timeline(n_tracks=T, n_frames=192, width=W, height=H,
                             fps=30.0)
    seg = j_segments(el)[0]
    inits, jchain = j_chain_for(seg.inits, el, seg.frames[0].tc)
    tel = TEventList.from_json(el.to_json())
    tseg = t_segments(tel)[0]
    _, tchain = t_chain_for(tseg.inits, tel, tseg.frames[0].tc)
    return el, seg, inits, jchain, tchain


def frame_inputs(timeline, f):
    el, seg, inits, jchain, _ = timeline
    params = j_interp(el, inits, jchain, [seg.frames[f].tc])
    src = JSource(H, W)
    tracks = []
    for t in range(T):
        one = JLayer(planes=(src.get_batch([t + 1], [f]).planes[0][0],),
                     palette=int(Palette.RGB24))
        tracks.append(np.array(j_convert(j_convert(
            one, Palette.YUV420P), Palette.RGB24).planes[0]))
    return tracks, params


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_routes(tracks, params, chain):
    layers = [JLayer(planes=(jnp.asarray(t),), palette=int(Palette.RGB24))
              for t in tracks]
    ctx = FrameContext(tc=jnp.float32(0), frame=jnp.int32(0), fps=30.0,
                       width=W, height=H)
    for i, inst in enumerate(chain[:PREFIX]):
        vals = {**j_split(inst)[0],
                **{k: jnp.float32(v[0]) for k, v in params[i].items()}}
        layers = apply_instance(Instance(
            filter=inst.filter, values=vals, in_tracks=inst.in_tracks,
            out_tracks=inst.out_tracks), layers, ctx)
    zeros = (np.zeros(1, np.float32), np.zeros(1, np.int32))
    tail = [Instance(filter=i.filter, values=dict(i.values),
                     in_tracks=i.in_tracks, out_tracks=i.out_tracks)
            for i in chain[PREFIX:]]
    comp = JGraph(tail, JSink(), fps=30.0).run_batch(
        [JLayer(planes=(layers[0].planes[0][None],), palette=1)], *zeros,
        params[PREFIX:]).planes[0]
    flt = JGraph(chain, JSink(), fps=30.0).run_batch(
        [JLayer(planes=(jnp.asarray(t)[None],), palette=1) for t in tracks],
        *zeros, params).planes[0]
    return np.asarray(comp).astype(int), np.asarray(flt).astype(int)


def port_route(tracks, params, chain):
    return TGraph(chain, TSink(), fps=30.0).run_batch(
        [TLayer(planes=(torch.from_numpy(t)[None],), palette=1)
         for t in tracks], np.zeros(1, np.float32), np.zeros(1, np.int32),
        params).planes[0].numpy().astype(int)


@pytest.fixture(scope="module")
def routes(timeline):
    """[frame][package] -> (composite route, float route) of frames 0-3."""
    f32 = {"LIVES_TPU_CHAIN_DTYPE": "f32"}
    _, _, _, jchain, tchain = timeline
    out = []
    for f in range(len(GAPS)):
        tracks, params = frame_inputs(timeline, f)
        out.append({
            "lives_tpu": _with_env(
                dict(f32, LIVES_TPU_PALLAS_COMPOSITE="0"),
                lambda: jax_routes(tracks, params, jchain)),
            "lives_tpu_torch": tuple(
                _with_env(dict(f32, LIVES_TPU_PALLAS_COMPOSITE=pref),
                          lambda: port_route(tracks, params, tchain))
                for pref in ("1", "0"))})
    return out


@pytest.mark.parametrize("package", ["lives_tpu", "lives_tpu_torch"])
def test_route_gap_over_nine_stages(routes, package):
    """Each package's composite route against its float route, frame by
    frame: the gap of GAPS (the 2-LSB bound of a 3-stage chain does not
    carry to 9 stages)."""
    for f, (worst, over2) in enumerate(GAPS):
        comp, flt = routes[f][package]
        d = np.abs(comp - flt)
        assert (d.max(), (d > 2).sum()) == (worst, over2), f


@pytest.mark.parametrize("route", ["composite", "float"])
def test_routes_match_jax_at_full_width(routes, route):
    """The port's route against the same route of the JAX package, frames
    0-3: +/-1 LSB."""
    k = 0 if route == "composite" else 1
    for f in range(len(GAPS)):
        d = np.abs(routes[f]["lives_tpu_torch"][k]
                   - routes[f]["lives_tpu"][k])
        assert d.max() <= 1, (f, d.max())
