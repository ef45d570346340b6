"""A dry run of the multi-device layer on explicit devices.

Counterpart of `__graft_entry__.py:17-49,73-270` (`FLAGSHIP_TRANS`,
`_build_graph_and_inputs`, `dryrun_multichip`): the flagship graph (the
main path's 10 tracks and 13 effects) at a small geometry through every
path of `parallel.mesh`: frame-batch DP, spatial bands, a DP x SP grid,
the band sweep (which must engage), a stateful chain over bands, and a
pipeline over four one-input filters. The JAX dry run's DP steps over the
JPEG device decoder and encoder (`__graft_entry__.py:186-238`) come with
`shard_decode_batch` and `shard_encode_batch` over the port's `Mesh`
(ROADMAP Queue 1 item 25) and are left out.

    from lives_tpu_torch.parallel import dryrun_multichip
    dryrun_multichip(["cpu"] * 8)        # or ["cuda:0"] * 4, or 4 cards

or from a shell, one argument a mesh entry:

    python -m lives_tpu_torch.parallel cuda:0 cuda:1 cuda:2 cuda:3
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..constants import Palette
from ..effects.host import FrameContext, instantiate
from ..graph.nodemodel import FrameGraph, SinkSpec, _split_params
from ..layer import Layer
from ..scenes import DeviceSyntheticSource
from .mesh import (frame_mesh, grid_batch_fn, grid_mesh, pipeline_chain_fn,
                   sharded_batch_fn, spatial_batch_fn, spatial_stateful_fn,
                   spatial_sweep_fn)

FLAGSHIP_TRANS = ["crossfade", "blend_screen", "blend_overlay", "luma_key",
                  "blend_add", "blend_multiply", "chroma_key",
                  "blend_lighten", "blend_difference"]
#: the pipeline's four stages, one-input filters the port holds
PIPELINE = [("colour_balance", {"red": 1.1, "blue": 0.9}),
            ("saturation", {"saturation": 1.3}),
            ("vignette", {"amount": 0.7}),
            ("gaussian_blur", {"radius": 2, "amount": 0.5})]


def build_graph_and_inputs(device, h: int = 1080, w: int = 1920,
                           n_tracks: int = 10, B: int = 4, seed: int = 0):
    """The flagship chain (`scenes.multitrack_timeline`'s structure) as a
    FrameGraph, and n_tracks random (B,3,h,w) RGB24 layers on `device`."""
    chain = []
    for t in range(1, n_tracks):
        name = FLAGSHIP_TRANS[(t - 1) % len(FLAGSHIP_TRANS)]
        kw = {"amount": 0.5} if name.startswith(("crossfade", "blend")) \
            else {}
        inst = instantiate(name, **kw)
        inst.in_tracks = (0, t)
        chain.append(inst)
    chain += [instantiate("gaussian_blur", radius=3, amount=0.6),
              instantiate("colour_balance", red=1.1, green=1.0, blue=0.9),
              instantiate("saturation", saturation=1.3),
              instantiate("vignette", amount=0.7)]
    graph = FrameGraph(chain, SinkSpec(width=w, height=h), fps=30.0)
    rng = np.random.default_rng(seed)
    layers = [Layer(planes=(torch.from_numpy(
        rng.integers(0, 256, (B, 3, h, w), np.uint8)).to(device),),
        palette=int(Palette.RGB24)) for _ in range(n_tracks)]
    return graph, layers


def _within_1(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    worst = int((a.cpu().int() - b.cpu().int()).abs().max())
    assert worst <= 1, f"{what}: max |diff| {worst} > 1"


def dryrun_multichip(devices: Sequence) -> None:
    """The flagship graph through every multi-device path on `devices`
    (n entries, repeats allowed), at a small geometry: checks that each
    runs and agrees with the frame-batch DP render (+/-1 LSB)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    B = max(n, 2) * 2
    h, w = max(16 * n, 96), 256   # bands must exceed the blur's halo
    graph, layers = build_graph_and_inputs(devices[0], h=h, w=w, B=B)
    mesh = frame_mesh(devices)
    tcs = np.arange(B, dtype=np.float32) / 30.0
    frames = np.arange(B, dtype=np.int32)

    # DP: the frame batch cut over the mesh through the whole chain
    out = sharded_batch_fn(graph, mesh)(layers, tcs, frames).planes[0]
    assert tuple(out.shape) == (B, 3, h, w)

    # SP: H-bands with halo rows from the neighbours, the same graph
    out_sp = spatial_batch_fn(graph, mesh)(layers, tcs, frames).planes[0]
    _within_1(out_sp, out, "spatial bands vs DP")

    # DP x SP on a 2-D mesh
    if n >= 4:
        gmesh = grid_mesh(devices[:n // 2 * 2], n // 2, 2)
        out_g = grid_batch_fn(graph, gmesh)(layers, tcs, frames).planes[0]
        _within_1(out_g, out, "DP x SP grid vs DP")

    # the band sweep: K1's band mode on every band (its plain version on
    # the CPU), each band generating its own halo
    src = DeviceSyntheticSource(h, w, device=devices[0])
    sweep = spatial_sweep_fn(graph, frame_mesh(devices, axis="s"), src, B,
                             h, w, axis="s")
    assert sweep is not None, \
        "spatial_sweep_fn declined the flagship geometry"
    rows = [(i, k) for i, inst in enumerate(graph.chain)
            for k in sorted(_split_params(inst)[1])]
    packed = np.stack(
        [np.broadcast_to(np.float32(_split_params(graph.chain[i])[1][k]),
                         (B,)) for i, k in rows]
        + [tcs, frames.astype(np.float32)])
    ids = np.zeros((2, 10, B), np.int32)
    ids[0] = np.arange(1, 11)[:, None]
    ids[1] = np.arange(B)
    out_sw = sweep(ids, packed)
    assert out_sw is not None, "the flagship chain must qualify for the sweep"
    assert tuple(out_sw.shape) == (B, 3, h, w)
    ref = graph.run_batch([], tcs, frames, source=src,
                          src_args=(ids[0], ids[1])).planes[0]
    _within_1(out_sw, ref, "band sweep vs run_batch")

    # a stateful chain over bands: fire + rgb_delay, then transitions
    st_chain = [instantiate("fire", threshold=0.5),
                instantiate("rgb_delay", delay_r=0.0, delay_g=1.0,
                            delay_b=2.0)]
    for t in range(1, 4):
        tr = instantiate("crossfade", amount=0.5)
        tr.in_tracks = (0, t)
        st_chain.append(tr)
    st_chain.append(instantiate("saturation", saturation=1.2))
    st_graph = FrameGraph(st_chain, SinkSpec(width=w, height=h), fps=30.0)
    out_st = spatial_stateful_fn(st_graph, mesh)(layers[:4], tcs,
                                                 frames).planes[0]
    assert tuple(out_st.shape) == (B, 3, h, w)
    assert st_graph.states[0] is not None  # fire's state carried out

    # PP: one stage a device, frames streamed through the stages
    insts = ([instantiate(nm, **kw) for nm, kw in PIPELINE]
             + [None] * max(n - len(PIPELINE), 0))[:n]
    run_pp = pipeline_chain_fn(insts, mesh)
    bp = np.random.default_rng(7).random((n, 3, 16, 24)).astype(np.float32)
    tp = np.arange(n, dtype=np.float32) / 25.0
    out_pp = run_pp(bp, tp)
    x = torch.from_numpy(bp[:1]).to(devices[0])
    for inst in insts:
        if inst is None:
            continue
        x = inst.filter.process(
            [Layer(planes=(x,), palette=int(Palette.RGBFLOAT))],
            inst.param_values(),
            FrameContext(tc=0.0, frame=0, fps=25.0, width=24,
                         height=16)).planes[0]
    assert torch.allclose(out_pp[:1], x, rtol=1e-5, atol=1e-5)

