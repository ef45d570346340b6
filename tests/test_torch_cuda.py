"""The fused sweep's CUDA kernel against its plain version, on a GPU.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor lives_tpu, so they also run where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py configures jax for the rest of the suite.) Kernel and
plain version get the same inputs on the card and agree to +/-1 LSB:
both compute in float32, the kernel with fused multiply-adds and CUDA's
own expf."""

import random

import numpy as np
import pytest
import torch

from lives_tpu_torch.effects.builtin.blends import _BLEND_MODES
from lives_tpu_torch.effects.host import get_filter, instantiate
from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
from lives_tpu_torch.events.renderer import (_chain_for, _interp_arrays,
                                             render_to_arrays,
                                             segment_events)
from lives_tpu_torch.graph import SinkSpec, fused_sweep
from lives_tpu_torch.graph.nodemodel import (_split_params, chain_spec_of,
                                             pack_params)
from lives_tpu_torch.scenes import DeviceSyntheticSource, multitrack_timeline


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    return torch.device("cuda")


def _check(plan, ids, packed):
    before = fused_sweep.LAUNCHES
    got = fused_sweep.fused_sweep(plan, ids, packed)
    torch.cuda.synchronize()
    assert fused_sweep.LAUNCHES == before + 1
    ref = fused_sweep.plain_sweep(plan, ids, packed)
    assert got.shape == ref.shape and got.dtype == torch.uint8
    diff = (got.int() - ref.int()).abs().max().item()
    assert diff <= 1, diff


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,n_tracks,B", [
    (256, 48, 4, 4), (100, 37, 3, 3), (1920, 1080, 10, 2), (33, 7, 10, 2)])
def test_main_chain_kernel_matches_plain(cuda, w, h, n_tracks, B):
    el = multitrack_timeline(n_tracks=n_tracks, n_frames=B + 5, width=w,
                             height=h, fps=30.0)
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[3:3 + B]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(_interp_arrays(el, inits, chain, tcs),
                               np.asarray(tcs) / TICKS_PER_SECOND,
                               np.arange(3, 3 + B))
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), n_tracks, h, w, rows, 30.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(ids).to(cuda),
           torch.from_numpy(packed).to(cuda))


CHAINS = {
    "empty": [],
    "multi_stencil": [("crossfade", {"amount": 0.4}, (0, 1)),
                      ("gaussian_blur", {"radius": 2, "amount": 0.8}, (0,)),
                      ("sharpen", {"radius": 1, "amount": 0.5}, (0,)),
                      ("vignette", {"amount": 0.5}, (0,))],
    "box_r16_sharpen": [("box_blur", {"radius": 16, "amount": 0.9}, (0,)),
                        ("sharpen", {"radius": 3, "amount": 3.0}, (0,))],
    "all_blends": [(n, {"amount": 0.3 + 0.05 * i}, (0, 1 + i % 2))
                   for i, n in enumerate(_BLEND_MODES)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("w,h", [(160, 72), (70, 45)])
def test_chain_kernel_matches_plain(cuda, name, w, h):
    """Default parameter rows (no traced params): each slot takes its
    constant; three tracks, one of them blank (clip id -1)."""
    chain = []
    for n, vals, tracks in CHAINS[name]:
        inst = instantiate(n, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    B = 3
    packed = np.stack([np.linspace(0, 0.1, B), np.arange(B)]).astype(
        np.float32)
    ids = np.array([[[1, 2, 3], [4, -1, 6], [7, 8, 9]],
                    [[0, 1, 2], [3, 4, 5], [6, 7, 8]]], np.int32)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 3, h, w, (), 25.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(ids).to(cuda),
           torch.from_numpy(packed).to(cuda))


@pytest.mark.cuda
def test_render_launches_once_per_chunk(cuda):
    el = multitrack_timeline(n_tracks=4, n_frames=10, width=128, height=40,
                             fps=25.0)
    before = fused_sweep.LAUNCHES
    arr, _ = render_to_arrays(el, DeviceSyntheticSource(40, 128, device=cuda),
                              SinkSpec(128, 40), batch_size=4)
    assert fused_sweep.LAUNCHES - before == 3
    assert arr.shape == (10, 3, 40, 128)


@pytest.mark.cuda
def test_wrapper_refuses_wrong_inputs(cuda):
    el = multitrack_timeline(n_tracks=2, n_frames=2, width=64, height=16)
    seg = segment_events(el)[0]
    _, chain = _chain_for(seg.inits, el)
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 2, 16, 64, (), 30.0,
        DeviceSyntheticSource(16, 64, device=cuda), SinkSpec(64, 16), cuda)
    ids = torch.zeros((2, 2, 2), dtype=torch.int32, device=cuda)
    packed = torch.zeros((2, 2), device=cuda)
    with pytest.raises(TypeError):
        fused_sweep.fused_sweep(plan, ids.long(), packed)
    with pytest.raises(ValueError):
        fused_sweep.fused_sweep(plan, ids[:, :1], packed)
    with pytest.raises(ValueError):
        fused_sweep.fused_sweep(plan, ids, packed[:1])


_POINT = ["crossfade", *_BLEND_MODES, "luma_key", "chroma_key",
          "colour_balance", "saturation", "vignette"]


def random_chain(seed: int, n_tracks: int):
    """A random chain inside the sweep kernel's contract, as (name, values,
    in_tracks) items: 2-6 point ops on any tracks (a single-input op may
    read another track into track 0), then 0-2 stencils of r 1..4, each
    maybe followed by a single-input op on track 0. Every numeric value is
    drawn inside its range."""
    rng = random.Random(seed)

    def values(name, **fixed):
        return {**{p.name: rng.uniform(p.min, p.max)
                   for p in get_filter(name).params if p.kind == "num"},
                **fixed}
    items = []
    for _ in range(rng.randint(2, 6)):
        name = rng.choice(_POINT)
        n_in = get_filter(name).n_in
        items.append((name, values(name),
                      tuple(rng.randrange(n_tracks) for _ in range(n_in))))
    for _ in range(rng.randint(0, 2)):
        name = rng.choice(["gaussian_blur", "box_blur", "sharpen"])
        items.append((name, values(name, radius=rng.randint(1, 4)), (0,)))
        if rng.random() < 0.7:
            post = rng.choice(["colour_balance", "saturation", "vignette"])
            items.append((post, values(post), (0,)))
    return items


def instances(items):
    chain = []
    for name, vals, tracks in items:
        inst = instantiate(name, **vals)
        inst.in_tracks = tracks
        chain.append(inst)
    return chain


#: (2, T=4, B=3) clip ids (one blank track) and frame numbers
RANDOM_IDS = np.array([[[1, 2, 3], [5, -1, 7], [9, 10, 11], [40, 3, 17]],
                       [[0, 1, 2], [3, 4, 5], [6, 7, 8], [299, 0, 150]]],
                      np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_random_chain_kernel_matches_plain(cuda, seed):
    chain = instances(random_chain(seed, 4))
    B = RANDOM_IDS.shape[2]
    packed, rows = pack_params(
        [{k: np.full(B, v, np.float32)
          for k, v in _split_params(i)[1].items()} for i in chain],
        np.arange(B) / 25.0, np.arange(B))
    h, w = 45, 70
    plan = fused_sweep.build_fused_sweep(
        chain_spec_of(chain), 4, h, w, rows, 25.0,
        DeviceSyntheticSource(h, w, device=cuda), SinkSpec(w, h), cuda)
    assert plan is not None
    _check(plan, torch.from_numpy(RANDOM_IDS).to(cuda),
           torch.from_numpy(packed).to(cuda))
