"""Decoded-clip rendering of lives_tpu_torch against lives_tpu: the
composite kernel's plain version, `FrameGraph.run_batch` on the composite
route and without it, the YUV4MPEG decoder, `ClipFrameSource`,
`render_recording` and `render_to_encoder`, each on the same seeded inputs
as the JAX package.

The reference is the JAX package with `LIVES_TPU_CHAIN_DTYPE=f32` (its bf16
comps are a TPU bandwidth choice), its composite kernel in Pallas interpret
mode. `pallas_composite.supported` asks for a TPU backend, so the tests
monkeypatch it to True, as the JAX route is read at call time
(`nodemodel.py:490`). On the CPU every kernel of the port runs its plain
version.

Tolerances: frames +/-1 LSB (torch's and XLA's float orders and `exp`
differ by an ulp, and a u8 stage quantise can flip on one); decoded planes
and clip metadata exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import lives_tpu.graph.pallas_composite as jpc
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu.events import renderer as jr
from lives_tpu.events.event_list import (EventList, TICKS_PER_SECOND,
                                         filter_init_event, filter_map_event,
                                         frame_event)
from lives_tpu.graph import SinkSpec as JSink
from lives_tpu.graph.nodemodel import FrameGraph as JGraph
from lives_tpu.io import clips as jclips
from lives_tpu.io import decoders as jdec
from lives_tpu.layer import Layer as JLayer
from lives_tpu.transcode import render_to_encoder as j_render_to_encoder
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import instantiate
from lives_tpu_torch.events import renderer as tr
from lives_tpu_torch.events.event_list import EventList as TEventList
from lives_tpu_torch.graph import FrameGraph as TGraph
from lives_tpu_torch.graph import SinkSpec as TSink
from lives_tpu_torch.graph import composite, nodemodel
from lives_tpu_torch.graph.nodemodel import (_split_params, chain_spec_of,
                                             composite_prefix, pack_params)
from lives_tpu_torch.io import clips as tclips
from lives_tpu_torch.io import decoders as tdec
from lives_tpu_torch.io import encoders as tenc
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.ops import yuv_kernels
from lives_tpu_torch.transcode import render_to_encoder

H, W, B = 32, 256, 4  # the JAX kernel's tile rule: w % 128, h % 8
TRANSITIONS = ["crossfade", "blend_screen", "blend_overlay", "luma_key",
               "blend_add", "blend_multiply", "chroma_key", "blend_lighten",
               "blend_difference"]
TAIL = [("gaussian_blur", {"radius": 3, "amount": 0.6}),
        ("colour_balance", {"red": 1.1, "green": 1.0, "blue": 0.9}),
        ("saturation", {"saturation": 1.3}), ("vignette", {"amount": 0.7})]


def assert_frames_match(got, ref, tol=1):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= tol, d.max()


@pytest.fixture
def jax_composite(monkeypatch):
    """The JAX package's composite route on the CPU: its Pallas kernel in
    interpret mode, f32 comps, `supported` patched."""
    monkeypatch.setenv("LIVES_TPU_CHAIN_DTYPE", "f32")
    monkeypatch.setattr(jpc, "supported", lambda h, w: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def specs(kind, n_tracks):
    """(name, values, in_tracks) items of the test chains: config D's nine
    transitions over `n_tracks` tracks then its tail ("D"), and prefixes
    that bite on the kernel's vocabulary."""
    def tr_tracks(i):
        return (0, 1 + i % (n_tracks - 1))
    if kind == "D":
        return ([(n, {"amount": 0.5} if n.startswith(("cross", "blend"))
                  else {}, tr_tracks(i)) for i, n in enumerate(TRANSITIONS)]
                + [(n, v, (0,)) for n, v in TAIL])
    if kind == "keys":
        return [("luma_key", {"threshold": 0.4, "invert": 1.0}, (0, 1)),
                ("chroma_key", {"green": 0.7, "tolerance": 0.3}, (2, 0)),
                ("colour_balance", {"red": 1.8, "blue": 0.4}, (1,)),
                ("saturation", {"saturation": 2.5}, (0,)),
                ("blend_dodge", {"amount": 0.8}, (0, 2))]
    if kind == "blends":
        from lives_tpu_torch.effects.builtin.blends import _BLEND_MODES
        return [(n, {"amount": 0.2 + 0.05 * i}, tr_tracks(i))
                for i, n in enumerate(_BLEND_MODES)]
    if kind == "vocab":  # the PALLAS_SAFE ops the sweep's vocabulary gained
        return [("chroma_blend", {}, (0, 1)), ("alpha_over", {}, (0, 2)),
                ("mask_overlay", {}, (0, 3 % n_tracks)),
                ("luma_overlay", {}, (0, 1)), ("luma_underlay", {}, (0, 2)),
                ("negative_luma_overlay", {}, (1, 0)),
                ("negate", {}, (0,)), ("brightness_contrast", {}, (0,)),
                ("gamma_adjust", {}, (0,)), ("levels", {}, (0,)),
                ("sepia", {}, (0,)), ("posterize", {}, (0,)),
                ("solarize", {}, (0,)), ("softlight", {}, (0,)),
                ("tint", {}, (0,)), ("hue_rotate", {}, (0,)),
                ("modulate", {}, (0,)), ("colour_replace", {}, (0,)),
                ("greyscale", {}, (2,)), ("threshold", {}, (0,))]
    raise KeyError(kind)


def chains(kind, n_tracks):
    """The same chain as lives_tpu and lives_tpu_torch instances."""
    out = []
    for make in (j_instantiate, instantiate):
        chain = []
        for name, vals, tracks in specs(kind, n_tracks):
            inst = make(name, **vals)
            inst.in_tracks = tracks
            chain.append(inst)
        out.append(chain)
    return out


def random_tracks(n_tracks, seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)
            for _ in range(n_tracks)]


def per_frame_params(chain, seed, b=B):
    """Per-frame traced values drawn inside each parameter's range (and a
    little past its max, which the kernel clamps as Param.clamp does)."""
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(inst.filter.param(k).min,
                            inst.filter.param(k).max * 1.1, b)
             .astype(np.float32) for k in _split_params(inst)[1]}
            for inst in chain]


# -- the composite kernel's plain version ---------------------------------------

@pytest.mark.parametrize("kind,n_tracks", [("D", 4), ("keys", 3),
                                           ("blends", 3), ("vocab", 4)])
def test_plain_composite_matches_pallas_kernel(kind, n_tracks,
                                               jax_composite):
    """`plain_composite` against the JAX `build_composite` kernel on the
    same tracks and packed rows: +/-1 LSB."""
    jchain, tchain = chains(kind, n_tracks)
    n = jpc.splittable_prefix(jchain)
    assert n == composite.splittable_prefix(tchain) >= 3
    params = per_frame_params(tchain[:n], seed=n_tracks)
    packed, rows = pack_params(params, np.arange(B) / 30.0, np.arange(B))
    tracks = random_tracks(n_tracks, seed=len(kind))
    jspec = [(i.filter, _split_params(i)[0], i.in_tracks, i.out_tracks,
              i.enabled) for i in jchain[:n]]
    run = jpc.build_composite(jspec, n_tracks, B, H, W, rows, 30.0)
    ref = np.asarray(run([jnp.asarray(t) for t in tracks],
                         jnp.asarray(packed)))
    plan = composite.build_composite(chain_spec_of(tchain[:n]), n_tracks,
                                     rows, 30.0, "cpu")
    assert plan is not None and plan.ops.shape[0] == n
    got = composite.composite(plan, [torch.from_numpy(t) for t in tracks],
                              torch.from_numpy(packed))
    assert composite.LAUNCHES == 0  # CPU tensors: the plain version
    assert_frames_match(got.numpy(), ref)


# -- run_batch on the composite route ---------------------------------------

class _UsedKeys(dict):
    """A JAX graph's template cache that records the keys asked for."""

    def __init__(self, *a):
        super().__init__(*a)
        self.used = set()

    def get(self, key, default=None):
        self.used.add(key)
        return super().get(key, default)


@pytest.mark.parametrize("pref", ["1", "0"])
@pytest.mark.parametrize("kind,n_tracks", [("D", 4), ("D", 10),
                                           ("keys", 3), ("vocab", 4)])
def test_run_batch_matches_jax(kind, n_tracks, pref, jax_composite,
                               monkeypatch):
    """Decoded layers through `run_batch`, with the composite pref on both
    sides and off on both sides: +/-1 LSB; the same prefix length in both
    plan keys; the port's plan is the composite kernel's under the pref."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", pref)
    jchain, tchain = chains(kind, n_tracks)
    params = per_frame_params(tchain, seed=n_tracks + 1)
    tracks = random_tracks(n_tracks, seed=n_tracks)
    tcs = np.arange(B, dtype=np.float32) / 30.0
    frames = np.arange(B, dtype=np.int32)
    jg = JGraph(jchain, JSink(), fps=30.0)
    jg._templates = _UsedKeys(jg._templates)
    ref = jg.run_batch([JLayer(planes=(jnp.asarray(t),),
                               palette=int(Palette.RGB24)) for t in tracks],
                       tcs, frames, params)
    (jkey,) = jg._templates.used
    nodemodel._PLANS.clear()
    got = TGraph(tchain, TSink(), fps=30.0).run_batch(
        [TLayer(planes=(torch.from_numpy(t),), palette=int(Palette.RGB24))
         for t in tracks], tcs, frames, params)
    (key, plan), = nodemodel._PLANS.items()
    assert key[-1] == jkey[7]  # comp_n, in both plan keys
    assert (key[-1] > 0) == (pref == "1")
    assert isinstance(plan, composite.CompositePlan) == (pref == "1")
    assert_frames_match(got.planes[0].numpy(), np.asarray(ref.planes[0]))


def test_composite_eligibility_rules(monkeypatch):
    """Prefix lengths as the JAX package counts them; a stateful chain,
    cconx, a short prefix, non-RGB24 or float layers never take the
    kernel; tracks the stack lacks clamp to track 0; comp_n is in the plan
    key."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "1")
    for kind, n_tracks in (("D", 4), ("keys", 3), ("blends", 3)):
        jchain, tchain = chains(kind, n_tracks)
        assert composite.splittable_prefix(tchain) == \
            jpc.splittable_prefix(jchain)
    jd, td = chains("D", 4)
    td[1].enabled = False          # disabled instances pass through
    jd[1].enabled = False
    td[4].out_tracks = (1,)        # ... a write to another track ends it
    jd[4].out_tracks = (1,)
    assert composite.splittable_prefix(td) == jpc.splittable_prefix(jd) == 4
    assert composite.PALLAS_SAFE == jpc.PALLAS_SAFE
    assert composite.VOCABULARY <= composite.PALLAS_SAFE

    u8 = [TLayer(planes=(torch.zeros((2, 3, 8, 16), dtype=torch.uint8),),
                 palette=int(Palette.RGB24)) for _ in range(3)]
    _, tchain = chains("keys", 3)
    assert TGraph(tchain, TSink())._composite_len(u8) == 5
    assert TGraph(tchain[:2], TSink())._composite_len(u8) == 0  # < 3
    f32 = [l.replace(planes=(l.planes[0].float(),),
                     palette=int(Palette.RGBFLOAT)) for l in u8]
    assert TGraph(tchain, TSink())._composite_len(f32) == 0
    assert TGraph(tchain, TSink())._composite_len(
        [l.replace(planes=(l.planes[0][0],)) for l in u8]) == 0  # not 4-D
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "0")
    assert TGraph(tchain, TSink())._composite_len(u8) == 0
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "1")
    # a graph with cconx takes no composite prefix (`nodemodel.py:488`);
    # the same chain without its wiring does
    from lives_tpu_torch.effects.host import ChannelTemplate, Filter
    probe = Filter(name="probe_alpha_out", process=lambda ins, p, c: ins[0],
                   alpha_outs=(ChannelTemplate("mask"),))
    wired = tchain + [instantiate(probe), instantiate("mask_overlay")]
    assert TGraph(wired, TSink())._composite_len(u8) == 5
    assert TGraph(wired, TSink(), cconx=[(5, "mask", 6, 0)]) \
        ._composite_len(u8) == 0

    # a stateful chain takes route (c), never the composite
    stateful = [instantiate("crossfade"), instantiate("blend_add"),
                instantiate("blend_screen"), instantiate("fire")]
    for i in stateful[:3]:
        i.in_tracks = (0, 1)
    nodemodel._PLANS.clear()
    TGraph(stateful, TSink()).run_batch(
        [l.replace(planes=(l.planes[0][:1],)) for l in u8],
        np.zeros(1, np.float32), np.zeros(1, np.int32))
    assert not any(isinstance(p, composite.CompositePlan)
                   for p in nodemodel._PLANS.values())

    # the track clamp: track 5 of a 3-layer stack reads track 0
    spec = chain_spec_of(tchain[:3])
    spec[0] = spec[0][:2] + ((0, 5),) + spec[0][3:]
    prefix, comp_tracks = composite_prefix(spec, 3)
    assert prefix[0][2] == (0, 0) and comp_tracks == 3
    _, n_avail = composite_prefix(spec, 6)
    assert n_avail == 6

    # comp_n keys the plan
    nodemodel._PLANS.clear()
    g = TGraph(tchain, TSink())
    for pref in ("1", "0"):
        monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", pref)
        g.run_batch(u8, np.zeros(2, np.float32), np.zeros(2, np.int32))
    assert sorted(k[-1] for k in nodemodel._PLANS) == [0, 5]


def test_sink_step_matches_jax(jax_composite, monkeypatch):
    """The full sink step after the composite route, letterbox + gamma +
    palette and a plain resize to YUV420P: +/-1 LSB. The JAX package feeds
    its float comp to the YUV conversion as if it were 0..255 (ROADMAP
    Queue 3), so the YUV sink is held to its RGB24 sink and its own
    conversion of each frame."""
    from lives_tpu.constants import Gamma
    from lives_tpu.ops.colorspace import convert_layer as j_convert
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", "1")
    jchain, tchain = chains("D", 4)
    tracks = random_tracks(4, seed=9, b=2)
    params = per_frame_params(tchain, seed=4, b=2)
    tcs, frames = np.zeros(2, np.float32), np.arange(2, dtype=np.int32)
    for kw in (dict(width=96, height=96, letterbox=True,
                    gamma=int(Gamma.LINEAR), palette=int(Palette.RGBA32)),
               dict(width=128, height=24, palette=int(Palette.YUV420P))):
        jkw = dict(kw, palette=int(Palette.RGB24)) \
            if kw["palette"] == Palette.YUV420P else kw
        ref = JGraph(jchain, JSink(**jkw), fps=30.0).run_batch(
            [JLayer(planes=(jnp.asarray(t),), palette=int(Palette.RGB24))
             for t in tracks], tcs, frames, params)
        ref_planes = [np.asarray(p) for p in ref.planes]
        if kw["palette"] == Palette.YUV420P:
            per_frame = [j_convert(JLayer(planes=(f,), palette=1),
                                   Palette.YUV420P).planes
                         for f in ref_planes[0]]
            ref_planes = [np.stack([np.asarray(f[i]) for f in per_frame])
                          for i in range(3)]
        got = TGraph(tchain, TSink(**kw), fps=30.0).run_batch(
            [TLayer(planes=(torch.from_numpy(t),),
                    palette=int(Palette.RGB24)) for t in tracks],
            tcs, frames, params)
        assert got.palette == kw["palette"] and got.gamma == kw.get(
            "gamma", int(Gamma.SRGB))
        assert len(got.planes) == len(ref_planes)
        for g, r in zip(got.planes, ref_planes):
            assert_frames_match(g.numpy(), r)


# -- the YUV4MPEG decoder ------------------------------------------------------

def write_clips(tmp_path, n_clips, n_frames, seed=0, h=H, w=W):
    """Y4M files of random YUV420P frames, written by the port."""
    rng = np.random.default_rng(seed)
    paths = []
    for c in range(n_clips):
        path = tmp_path / f"clip{c}.y4m"
        tdec.write_y4m(str(path), [
            (rng.integers(16, 236, (h, w), dtype=np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n_frames)], 30.0)
        paths.append(str(path))
    return paths


def test_y4m_decoder_matches_jax(tmp_path):
    """A file written by the port, and one with FRAME headers of varying
    length, read by both packages: identical planes and clip data."""
    (path,) = write_clips(tmp_path, 1, 5)
    raw = open(path, "rb").read()
    hdr, rest = raw.split(b"\n", 1)
    varied = tmp_path / "varied.y4m"
    frames = rest.split(b"FRAME\n")[1:]
    varied.write_bytes(hdr + b"\n" + b"".join(
        (b"FRAME Ixp\n" if i % 2 else b"FRAME\n") + f
        for i, f in enumerate(frames)))
    for p in (path, str(varied)):
        tcd, jcd = tdec.try_decoders(p), jdec.try_decoders(p)
        assert (tcd.nframes, tcd.width, tcd.height, tcd.fps, tcd.palette) \
            == (jcd.nframes, jcd.width, jcd.height, jcd.fps, jcd.palette) \
            == (5, W, H, 30.0, int(Palette.YUV420P))
        assert (tcd.decoder.offsets is None) == (p == path)
        for n in (0, 3, 4):
            got = tcd.decoder.get_frame(n)
            ref = jcd.decoder.get_frame(n)
            assert got.device.type == "cpu"
            assert (got.palette, got.clamping, got.subspace) == \
                (ref.palette, ref.clamping, ref.subspace)
            for g, r in zip(got.planes, ref.planes):
                assert np.array_equal(g.numpy(), np.asarray(r))
        tcd.decoder.close()
        jcd.decoder.close()
    assert tdec.try_decoders(str(tmp_path / "missing.y4m")) is None


def test_clip_frame_access(tmp_path):
    """open_clip, the frame index ops and their frame mapping, as the JAX
    package's clips do them; the written header and index agree."""
    (path,) = write_clips(tmp_path, 1, 6)
    tc = tclips.open_clip(path, tmp_path / "t")
    jc = jclips.open_clip(path, tmp_path / "j")
    for c in (tc, jc):
        c.delete_frames(1, 2)
        c.insert_frames(2, np.array([5, 0]))
        c.reverse()
    assert np.array_equal(tc.frame_index, jc.frame_index)
    assert tc.frames == jc.frames == 6
    for n in range(-1, tc.frames + 1):
        assert all(np.array_equal(g.numpy(), np.asarray(r)) for g, r in
                   zip(tc.get_frame(n).planes, jc.get_frame(n).planes))
    assert tc.frame_config(0) == (int(Palette.YUV420P), W, H, 0, 1, 1)
    hdr = (tc.clip_dir / "header.lives").read_text()
    assert f"<unique_id>\n{tc.unique_id}\n</unique_id>" in hdr
    tc.insert_frames(0, np.array([-1]))
    jc.insert_frames(0, np.array([-1]))
    assert not tc.is_virtual_frame(0) and tc.frame_config(0) is None
    # an image frame: written through PIL and read back as the JAX clip
    # reads its own
    img = np.random.default_rng(0).integers(0, 256, (3, H, W), np.uint8)
    tc.put_frame(0, tclips.rgb_layer(img))
    jc.put_frame(0, JLayer(planes=(jnp.asarray(img),)))
    assert tc.image_path(0).read_bytes() == jc.image_path(0).read_bytes()
    assert tc.get_frame(0).palette == jc.get_frame(0).palette
    assert np.array_equal(tc.get_frame(0).planes[0].numpy(), img)
    tc.close()
    jc.close()


# -- ClipFrameSource, render_recording, render_to_encoder ----------------------

#: 63-bit unique_ids, as live recordings store them
UIDS = [(1 << 62) + 12345, (1 << 62) + 1, 7]


def open_both(paths, tmp_path):
    out = []
    for pkg, d in ((tclips, "t"), (jclips, "j")):
        clips = {}
        for uid, p in zip(UIDS, paths):
            c = pkg.open_clip(p, tmp_path / d)
            c.unique_id = uid
            clips[uid] = c
        out.append(clips)
    return out


def recorded_take(n_frames=10, kind="D", fps=30.0):
    """A VJ's recorded take against three clips: the chain's init events,
    then FRAME events whose timing jitters off the fps grid and whose
    source frames jump (scratching)."""
    el = EventList(fps=fps, width=W, height=H)
    inits = [filter_init_event(0, n, in_tracks=list(t), out_tracks=[0],
                               values=v) for n, v, t in specs(kind, 3)]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = TICKS_PER_SECOND / fps
    rng = np.random.default_rng(3)
    for i in range(n_frames):
        el.insert(frame_event(int(i * tpf + rng.integers(0, tpf // 3)),
                              UIDS, [int(x) for x in rng.integers(0, 6, 3)]))
    return el


@pytest.mark.parametrize("pref", ["1", "0"])
def test_render_recording_matches_jax(tmp_path, pref, jax_composite,
                                      monkeypatch):
    """A 3-clip recorded take re-rendered by both packages: +/-1 LSB, the
    same timecodes; the port converts each track's chunk once."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", pref)
    tclip, jclip = open_both(write_clips(tmp_path, 3, 6), tmp_path)
    el = recorded_take()
    ref, ref_tcs = jr.render_recording(el, jclip, batch_size=4)
    nodemodel._PLANS.clear()
    got, tcs = tr.render_recording(TEventList.from_json(el.to_json()), tclip,
                                   batch_size=4, device="cpu")
    assert tcs == ref_tcs
    assert_frames_match(got, ref)
    assert any(isinstance(p, composite.CompositePlan)
               for p in nodemodel._PLANS.values()) == (pref == "1")


def test_get_batch_matches_jax(tmp_path, monkeypatch):
    """`get_batch` over one track's chunk: uniform frames (one conversion),
    a clip id the source lacks (a blank row), and a second geometry (frame
    by frame): the JAX package's frames exactly (K2's plain version and
    the XLA formulas agree bit for bit here)."""
    (tmp_path / "small").mkdir()
    paths = (write_clips(tmp_path, 2, 6)
             + write_clips(tmp_path / "small", 1, 6, h=16, w=128))
    tclip, jclip = open_both(paths, tmp_path)
    tsrc = tr.ClipFrameSource(tclip, device="cpu")
    jsrc = jr.ClipFrameSource(jclip)
    calls = []
    real = tr.convert_layer
    monkeypatch.setattr(tr, "convert_layer",
                        lambda l, p: calls.append(l.planes[0].shape) or
                        real(l, p))
    cases = {"uniform": ([UIDS[0], UIDS[1], UIDS[0]], [0, 5, 9], 1),
             "blank": ([UIDS[1], 99, UIDS[0]], [2, 0, 3], 1)}
    for name, (ids, nums, n_conv) in cases.items():
        calls.clear()
        got = tsrc.get_batch(np.asarray(ids, np.int64), nums)
        ref = jsrc.get_batch(np.asarray(ids, np.int64), nums)
        assert len(calls) == n_conv and calls[0][0] == len(ids), name
        assert got.palette == ref.palette == int(Palette.RGB24)
        assert np.array_equal(got.planes[0].numpy(),
                              np.asarray(ref.planes[0])), name
    # a chunk mixing geometries converts frame by frame: JAX's np.stack
    # refuses it, so the port's frames are held to its single frames
    calls.clear()
    got = tsrc.get_batch([UIDS[2]], [1])
    assert len(calls) == 1 and got.planes[0].shape == (1, 3, 16, 128)
    ref = jsrc.get_batch([UIDS[2]], [1])
    assert np.array_equal(got.planes[0].numpy(), np.asarray(ref.planes[0]))
    with pytest.raises(RuntimeError, match="stack"):
        tsrc.get_batch([UIDS[0], UIDS[2]], [0, 0])


@pytest.mark.parametrize("pref", ["1", "0"])
def test_render_to_encoder_matches_jax(tmp_path, pref, jax_composite,
                                       monkeypatch):
    """Config D over decoded clips into a YUV4MPEG file, by both packages:
    the files' planes within +/-1 LSB, the same frame count and header."""
    monkeypatch.setenv("LIVES_TPU_PALLAS_COMPOSITE", pref)
    tclip, jclip = open_both(write_clips(tmp_path, 3, 6), tmp_path)
    el = recorded_take(n_frames=6).quantise(30.0)
    out_t, out_j = tmp_path / "t.y4m", tmp_path / "j.y4m"
    j_render_to_encoder(el, jr.ClipFrameSource(jclip), str(out_j),
                        encoder="yuv4mpeg", batch_size=4)
    before = dict(yuv_kernels.LAUNCHES)
    assert render_to_encoder(TEventList.from_json(el.to_json()),
                             tr.ClipFrameSource(tclip, device="cpu"),
                             str(out_t), encoder="yuv4mpeg", batch_size=4)
    assert yuv_kernels.LAUNCHES == before  # CPU tensors: plain versions
    assert open(out_t, "rb").readline() == open(out_j, "rb").readline()
    tcd, jcd = tdec.try_decoders(str(out_t)), jdec.try_decoders(str(out_j))
    assert tcd.nframes == jcd.nframes == 6
    for n in range(6):
        for g, r in zip(tcd.decoder.get_frame(n).planes,
                        jcd.decoder.get_frame(n).planes):
            assert_frames_match(g.numpy(), np.asarray(r))
    tcd.decoder.close()
    jcd.decoder.close()


def test_encoders_refuse_what_is_not_ported(tmp_path):
    # every JAX encoder is ported (`DEFERRED` is empty); "ffmpeg" stands
    # in the registry only where the binary is on PATH
    # (tests/test_torch_ffmpeg.py)
    import shutil
    assert not tenc.DEFERRED
    assert ("ffmpeg" in tenc.list_encoders()) == bool(shutil.which("ffmpeg"))
    if not shutil.which("ffmpeg"):
        with pytest.raises(KeyError):
            tenc.get_encoder("ffmpeg")
    # the MJPEG, PNG, PDF and WAV encoders are ported
    # (tests/test_torch_mjpeg.py, tests/test_torch_clips.py)
    assert isinstance(tenc.get_encoder("mjpeg"), tenc.MJPEGDeviceEncoder)
    assert isinstance(tenc.get_encoder("pngseq"), tenc.PNGSeqEncoder)
    with pytest.raises(KeyError):
        tenc.get_encoder("no-such-encoder")
    enc = tenc.get_encoder("yuv4mpeg")
    assert enc.accepts_device_frames
    # audio goes beside the stream, through WavEncoder
    assert enc.encode(str(tmp_path / "a.y4m"), [], 30.0,
                      audio=np.zeros((4, 2), np.float32))
    assert (tmp_path / "a.wav").read_bytes()[:4] == b"RIFF"
    # (H, W, 3) numpy frames and (3, H, W) tensors alike
    frames = [np.zeros((H, W, 3), np.uint8),
              torch.full((3, H, W), 255, dtype=torch.uint8)]
    assert enc.encode(str(tmp_path / "b.y4m"), frames, 25.0)
    cd = tdec.try_decoders(str(tmp_path / "b.y4m"))
    assert cd.nframes == 2 and cd.fps == 25.0
    assert int(cd.decoder.get_frame(0).planes[0][0, 0]) == 16
    assert int(cd.decoder.get_frame(1).planes[0][0, 0]) == 235
    cd.decoder.close()
