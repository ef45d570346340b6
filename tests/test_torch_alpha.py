"""`alpha.py`'s six filters and `io/kinect.py`'s depth_key of
lives_tpu_torch against lives_tpu, on the same seeded frames, parameters
and alpha channels.

The reference is the JITTED JAX filter (`apply_instance` inside
`jax.jit`, as its `FrameGraph` runs it). A stateless filter takes the
port's batch of B frames and the JAX filter's frames one by one; a
stateful one runs several frames in both packages, each carrying its own
state, compared after every frame.

Tolerances: u8 frames and A8 masks +/-1 LSB; fg_bg_removal's noise hash
and its mask exact; float out-values and carried float state within
1e-5. farneback_analyser's flow is held to 1e-4 of the largest flow
magnitude (plus 1e-6): its 2x2 determinant comes near 1e-8 on flat
regions, where one ulp of a box sum moves the flow by about that much,
and its means sum 2-D planes in another order than XLA's.
vector_visualiser is fed the same flow planes in both packages.

The helpers here (`jax_step`, `port_step`, `frames`) serve
test_torch_analysers.py and test_torch_dataplugins.py too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects.builtin.alpha import _hash01 as j_hash01
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import Instance as JInstance
from lives_tpu.effects.host import apply_instance as j_apply
from lives_tpu.effects.host import get_filter as j_get_filter
from lives_tpu.layer import Layer as JLayer
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.builtin import alpha
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import Instance as TInstance
from lives_tpu_torch.effects.host import apply_instance as t_apply
from lives_tpu_torch.effects.host import get_filter as t_get_filter
from lives_tpu_torch.graph.nodemodel import states_to_numpy
from lives_tpu_torch.layer import Layer as TLayer

B = 3
SIZES = [(54, 96), (41, 67)]
FPS = 25.0
_JIT: dict = {}


def frames(seed, n, h, w, c=3):
    """n seeded u8 frames (n, c, h, w)."""
    return np.random.default_rng(seed).integers(0, 256, (n, c, h, w),
                                                dtype=np.uint8)


def params(name, rng, n, **fixed):
    """Seeded values of a filter's num params for n frames ((n,) float32
    each), the other kinds at their defaults, `fixed` over both."""
    out = {}
    for p in t_get_filter(name).params:
        if p.kind == "num":
            out[p.name] = rng.uniform(p.min, p.max, n).astype(np.float32)
        else:
            out[p.name] = p.default
    for k, v in fixed.items():
        out[k] = np.full(n, v, np.float32) if isinstance(
            out.get(k), np.ndarray) else v
    return out


def _jax_fn(name, static, alpha_pals, h, w):
    key = (name, tuple(sorted(static.items())), alpha_pals, h, w)
    if key not in _JIT:
        f = j_get_filter(name)

        def fn(planes, traced, state, frame, tc, alphas):
            inst = JInstance(filter=f, values={**static, **traced},
                             state=state, in_tracks=tuple(range(f.n_in)))
            lays = [JLayer(planes=(p,), palette=int(JPalette.RGB24))
                    for p in planes]
            a = {j: JLayer(planes=(ap,), palette=pal)
                 for j, (ap, pal) in enumerate(zip(alphas, alpha_pals))
                 if pal is not None} or None
            out = j_apply(inst, lays, JContext(tc=tc, frame=frame, fps=FPS,
                                               width=w, height=h),
                          alpha_ins=a)
            return (out[0].planes[0], inst.state, inst.out_values,
                    {k: v.planes[0] for k, v in inst.out_channels.items()})
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


def jax_step(name, ins, vals, b, frame, tc, state=None, alphas=()):
    """Frame b of the inputs `ins` ((n, C, H, W) u8 arrays) through the
    jitted JAX filter with frame b's values: (out frame, new state,
    out-values, out-channels), numpy. `alphas`: ((n, H, W) array, JAX
    palette) or None per alpha-in slot."""
    f = j_get_filter(name)
    h, w = ins[0].shape[-2:]
    static = {k: v for k, v in vals.items() if not isinstance(v, np.ndarray)}
    traced = {k: jnp.float32(v[b]) for k, v in vals.items()
              if isinstance(v, np.ndarray)}
    if state is None and f.init_state is not None:
        state = f.init_state(w, h, int(JPalette.RGB24))
    pals = tuple(a[1] if a is not None else None for a in alphas)
    arrs = tuple(jnp.asarray(a[0][b]) for a in alphas if a is not None)
    out, st, ov, oc = _jax_fn(name, static, pals, h, w)(
        [jnp.asarray(x[b]) for x in ins], traced, state,
        jnp.int32(frame), jnp.float32(tc), arrs)
    return (np.asarray(out), st, jax.tree_util.tree_map(np.asarray, ov),
            {k: np.asarray(v) for k, v in oc.items()})


def port_step(name, ins, vals, sel, frames_, tcs, state=None, alphas=(),
              device="cpu"):
    """Frames `sel` (a slice) of the inputs through the port's filter in
    one call: (out (n, C, H, W), instance)."""
    f = t_get_filter(name)
    lays = [TLayer(planes=(torch.from_numpy(x[sel]).to(device),),
                   palette=int(Palette.RGB24)) for x in ins]
    values = {k: torch.from_numpy(v[sel]).to(device)
              if isinstance(v, np.ndarray) else v for k, v in vals.items()}
    inst = TInstance(filter=f, values=values, state=state,
                     in_tracks=tuple(range(f.n_in)))
    a = {j: TLayer(planes=(torch.from_numpy(x[sel]).to(device),),
                   palette=pal)
         for j, (x, pal) in enumerate(a for a in alphas) if x is not None}
    h, w = ins[0].shape[-2:]
    ctx = TContext(tc=torch.from_numpy(np.asarray(tcs, np.float32)).to(
        device), frame=torch.from_numpy(np.asarray(frames_, np.int32)).to(
        device), fps=FPS, width=w, height=h, device=device)
    out = t_apply(inst, lays, ctx, alpha_ins=a or None)
    return out[0].planes[0].cpu().numpy(), inst


def lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32)
                      - np.asarray(b).astype(np.int32)).max())


def close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def same_state(t_state, j_state, tol=1e-5):
    """The port's state (tensors) against the JAX one: integer and boolean
    leaves exact, float leaves within `tol`."""
    got = jax.tree_util.tree_leaves(states_to_numpy([t_state])[0])
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           j_state))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if np.issubdtype(r.dtype, np.floating):
            close(g, r, tol)
        else:
            np.testing.assert_array_equal(g, r)


def run_stateful(name, vals, n, h, w, seed, inputs=None):
    """n frames of seeded input through both packages, frame by frame,
    each carrying its state. Yields (frame index, port out, port
    instance, JAX (out, state, out-values, out-channels))."""
    ins = inputs if inputs is not None else [frames(seed, n, h, w)]
    inst_state, j_state = None, None
    for b in range(n):
        got, inst = port_step(name, ins, vals, slice(b, b + 1), [b],
                              [b / FPS], state=inst_state)
        inst_state = inst.state
        ref = jax_step(name, ins, vals, b, b, b / FPS, state=j_state)
        j_state = ref[1]
        yield b, got, inst, ref


# -- stateful producers -------------------------------------------------------

@pytest.mark.parametrize("h,w", SIZES)
def test_motion_mask(h, w):
    vals = params("motion_mask", np.random.default_rng(1), 4,
                  threshold=0.05, softness=0.1)
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "motion_mask", vals, 4, h, w, seed=11):
        assert lsb(got, ref[None]) == 0      # the frame passes through
        m = inst.out_channels["mask"]
        assert m.palette == int(Palette.A8) and m.planes[0].shape == (1, h, w)
        assert lsb(m.planes[0][0], oc["mask"]) <= 1
        close(inst.out_values["motion"], ov["motion"])
        same_state(inst.state, st)


@pytest.mark.parametrize("pattern", ["noise", "smooth"])
def test_farneback_analyser(pattern):
    h, w = 48, 128
    if pattern == "noise":
        ins = [frames(12, 3, h, w)]
    else:   # a smooth pattern shifted one pixel a frame
        x = np.arange(w)[None, :].repeat(h, 0)
        y = np.arange(h)[:, None].repeat(w, 1)
        img = (127 + 90 * np.sin(x / 9.0) * np.cos(y / 11.0)).astype(np.uint8)
        ins = [np.stack([np.stack([np.roll(img, k, 1)] * 3)
                         for k in range(3)])]
    vals = params("farneback_analyser", np.random.default_rng(2), 3,
                  scale=1.5)
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "farneback_analyser", vals, 3, h, w, 0, inputs=ins):
        assert lsb(got, ref[None]) == 0
        for k in ("flow_x", "flow_y"):
            lay = inst.out_channels[k]
            assert lay.palette == int(Palette.AFLOAT)
            g, r = lay.planes[0][0].numpy(), oc[k]
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-6
        for k, r in ov.items():
            g = inst.out_values[k].numpy()
            assert abs(g - r) <= 1e-4 * max(abs(r), 1.0), (k, g, r)
        same_state(inst.state, st)
    if pattern == "smooth":   # the shift is along x
        assert abs(float(inst.out_values["mean_flow_x"])) > \
            2 * abs(float(inst.out_values["mean_flow_y"]))


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("h,w", SIZES)
def test_fg_bg_removal(kind, h, w):
    vals = params("fg_bg_removal", np.random.default_rng(3), 4,
                  threshold=0.2, type=kind)
    vals["history"] = np.array([3.0, 255.0, 2.0, 9.0], np.float32)
    for b, got, inst, (ref, st, ov, oc) in run_stateful(
            "fg_bg_removal", vals, 4, h, w, seed=13):
        assert lsb(got, ref[None]) <= 1
        np.testing.assert_array_equal(
            inst.out_channels["mask"].planes[0][0].numpy(), oc["mask"])
        same_state(inst.state, st)


@pytest.mark.parametrize("salt", [0, 1, 7919, 100_000, 2 ** 31 - 1, -5])
def test_hash01_matches_jax(salt):
    """fg_bg_removal's noise field bit for bit, salts past int32's wrap."""
    got = alpha.hash01(41, 67, torch.tensor(salt, dtype=torch.int64), "cpu")
    ref = np.asarray(jax.jit(lambda s: j_hash01(41, 67, s))(
        jnp.int32(np.int64(salt).astype(np.int32))))
    np.testing.assert_array_equal(got.numpy(), ref)


# -- stateless consumers ------------------------------------------------------

def _alpha_plane(seed, h, w, pal):
    rng = np.random.default_rng(seed)
    if pal == int(Palette.AFLOAT):
        return rng.uniform(-0.2, 1.2, (B, h, w)).astype(np.float32)
    if pal == int(Palette.A1):
        return rng.integers(0, 2, (B, h, w), dtype=np.uint8)
    return rng.integers(0, 256, (B, h, w), dtype=np.uint8)


def _stateless(name, vals, h, w, seed, alphas=(), c=3):
    ins = [frames(seed, B, h, w, c)]
    got, inst = port_step(name, ins, vals, slice(0, B), range(B),
                          np.arange(B) / FPS, alphas=alphas)
    refs = [jax_step(name, ins, vals, b, b, b / FPS, alphas=alphas)
            for b in range(B)]
    return ins, got, inst, refs


@pytest.mark.parametrize("pal", [None, Palette.A8, Palette.AFLOAT,
                                 Palette.A1])
@pytest.mark.parametrize("h,w", SIZES)
def test_alpha_visualizer(pal, h, w):
    vals = params("alpha_visualizer", np.random.default_rng(4), B)
    vals["fmin"] = np.array([0.0, -0.5, 0.2], np.float32)
    vals["fmax"] = np.array([1.0, 2.0, 0.2], np.float32)   # span 0 too
    alphas = ((_alpha_plane(5, h, w, int(pal)), int(pal)),) if pal else ()
    _, got, _, refs = _stateless("alpha_visualizer", vals, h, w, 14,
                                 alphas=alphas)
    assert lsb(got, np.stack([r[0] for r in refs])) <= 1


@pytest.mark.parametrize("h,w", SIZES)
def test_alpha_visualizer_rgba_unconnected(h, w):
    vals = params("alpha_visualizer", np.random.default_rng(6), B)
    ins = [frames(15, B, h, w, 4)]
    f = "alpha_visualizer"
    got, _ = port_step(f, ins, vals, slice(0, B), range(B), [0] * B)
    ref = np.stack([jax_step(f, ins, vals, b, b, 0.0)[0] for b in range(B)])
    assert lsb(got, ref) <= 1


@pytest.mark.parametrize("connected", [False, True])
@pytest.mark.parametrize("h,w", [(54, 96), (41, 67), (25, 19)])
def test_vector_visualiser(connected, h, w):
    vals = params("vector_visualiser", np.random.default_rng(7), B)
    rng = np.random.default_rng(8)
    alphas = ()
    if connected:
        alphas = tuple((rng.normal(0, 0.6, (B, h, w)).astype(np.float32),
                        int(Palette.AFLOAT)) for _ in range(2))
    _, got, _, refs = _stateless("vector_visualiser", vals, h, w, 16,
                                 alphas=alphas)
    ref = np.stack([r[0] for r in refs])
    assert lsb(got, ref) <= 1
    if connected:
        assert (got != frames(16, B, h, w)).any()   # arrows drawn


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("h,w", SIZES)
def test_alpha_to_grey(c, h, w):
    ins = [frames(17, B, h, w, c)]
    got, _ = port_step("alpha_to_grey", ins, {}, slice(0, B), range(B),
                       [0] * B)
    ref = np.stack([jax_step("alpha_to_grey", ins, {}, b, b, 0.0)[0]
                    for b in range(B)])
    assert lsb(got, ref) <= 1


@pytest.mark.parametrize("connected", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_depth_key(connected, h, w):
    vals = params("depth_key", np.random.default_rng(9), B)
    vals["minthresh"] = np.array([0.0, 9000.0, 30000.0], np.float32)
    vals["maxthresh"] = np.array([65536.0, 40000.0, 30000.0], np.float32)
    alphas = ((np.random.default_rng(10).uniform(0, 1, (B, h, w))
               .astype(np.float32), int(Palette.AFLOAT)),) if connected \
        else ()
    _, got, _, refs = _stateless("depth_key", vals, h, w, 18, alphas=alphas)
    ref = np.stack([r[0] for r in refs])
    assert got.shape == ref.shape
    assert lsb(got, ref) <= 1


def test_connected_alpha_negotiates_palette_and_size():
    """A connected alpha layer is converted to the slot's palette and
    resized to the first input's geometry before the filter sees it, as
    the JAX host negotiates it (cconx_convert_pixel_data)."""
    h, w = 24, 40
    seen = {}
    f = t_get_filter("alpha_visualizer")
    probe = TInstance(filter=dataclasses.replace(f, process=(
        lambda ins, p, c: seen.setdefault("a", ins[1]) and ins[0])))
    small = TLayer(planes=(torch.from_numpy(_alpha_plane(3, 12, 20,
                                                         int(Palette.A8))),),
                   palette=int(Palette.A8))
    lay = TLayer(planes=(torch.from_numpy(frames(1, B, h, w)),),
                 palette=int(Palette.RGB24))
    t_apply(probe, [lay], alpha_ins={0: small})
    assert seen["a"].palette == int(Palette.A8)
    assert seen["a"].planes[0].shape == (B, h, w)
    vv = TInstance(filter=t_get_filter("vector_visualiser"))
    out = t_apply(vv, [lay], alpha_ins={0: small, 1: small})[0]
    assert out.planes[0].shape == (B, 3, h, w)
