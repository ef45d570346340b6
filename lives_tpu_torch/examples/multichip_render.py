"""Multi-device rendering example: the three sharding modes over a device
mesh.

Counterpart of `examples/multichip_render.py:1-81` over the port's
`parallel.mesh.Mesh` of explicit devices: `--n` entries of `--device`
(`cuda` by default, which raises without CUDA). One card may fill every
entry (`[cuda:0] * 4`, each band then runs at its true rows on the one
card); the tests use `[cpu] * 4`. The batch is 2n frames of 16n x 256,
as the JAX example's over its n devices. `render` returns the three
modes' frames.

1. batch-DP      — frames shard over the mesh (sharded_batch_fn)
2. spatial bands — each frame's rows shard, halo rows copied from the
                   neighbours (spatial_batch_fn; works for decoded tracks)
3. band sweep    — each entry runs K1's band mode (`band_h = H / n`) on
                   its band with a LOCALLY generated halo: nothing moves
                   between devices until the gather (spatial_sweep_fn;
                   traceable sources only)

Usage: python -m lives_tpu_torch.examples.multichip_render
    [--device cuda] [--n 4]
"""

import argparse

import numpy as np
import torch

from ..constants import Palette
from ..effects import instantiate
from ..graph import FrameGraph, SinkSpec
from ..graph.nodemodel import _split_params
from ..layer import Layer
from ..parallel import frame_mesh, sharded_batch_fn, spatial_batch_fn
from ..parallel.mesh import spatial_sweep_fn
from ..scenes import DeviceSyntheticSource
from ..utils.device import resolve_device


def render(devices) -> dict:
    """The three modes over a mesh of `devices` (n entries): {"dp",
    "spatial", "sweep"} -> (2n, 3, 16n, 256) u8 frames on devices[0]
    ("sweep" None where the chain does not qualify for the kernel)."""
    n = len(devices)
    B, H, W = 2 * n, 16 * n, 256
    chain = [instantiate("crossfade", amount=0.5),
             instantiate("gaussian_blur", radius=2, amount=0.8),
             instantiate("vignette", amount=0.6)]
    chain[0].in_tracks = (0, 1)
    graph = FrameGraph(chain, SinkSpec(width=W, height=H), fps=30.0)
    rng = np.random.default_rng(0)
    layers = [Layer(planes=(torch.from_numpy(
        rng.integers(0, 256, (B, 3, H, W), np.uint8)).to(devices[0]),),
        palette=int(Palette.RGB24)) for _ in range(2)]
    tcs = np.arange(B, dtype=np.float32) / 30.0
    frames = np.arange(B, dtype=np.int32)
    out = {}

    mesh = frame_mesh(devices)
    out["dp"] = sharded_batch_fn(graph, mesh)(layers, tcs, frames).planes[0]
    print(f"DP over {n} devices:", tuple(out["dp"].shape))

    out["spatial"] = spatial_batch_fn(graph, mesh)(
        layers, tcs, frames).planes[0]
    print("spatial bands (halo rows from the neighbours):",
          tuple(out["spatial"].shape))

    src = DeviceSyntheticSource(H, W, device=devices[0])
    smesh = frame_mesh(devices, axis="s")
    run = spatial_sweep_fn(graph, smesh, src, B, H, W, axis="s")
    out["sweep"] = None
    if run is not None:
        vals = []
        for i, inst in enumerate(graph.chain):
            _, tp = _split_params(inst)
            for k in sorted(tp):
                vals.append(np.broadcast_to(np.float32(tp[k]), (B,)))
        packed = np.stack(vals + [tcs, frames.astype(np.float32)])
        ids = np.zeros((2, 2, B), np.int32)
        ids[0, 0], ids[0, 1] = 1, 2
        ids[1] = np.arange(B)
        out["sweep"] = run(ids, packed)
        if out["sweep"] is not None:
            print("band sweep (zero collectives):",
                  tuple(out["sweep"].shape))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4,
                    help="mesh entries, each on --device")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "multichip_render")
    render([dev] * a.n)


if __name__ == "__main__":
    main()
