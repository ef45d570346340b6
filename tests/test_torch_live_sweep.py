"""The live sweep K7 (`graph/live_sweep.py`, `csrc/live_sweep.cu`) and route
(d) of `FrameGraph.run`.

On the CPU: the rule takes the chains of the 4K live cell (luma_key over
plasma and colour_bars, then the chain) and refuses, case by case, what
keeps a frame on the eager route; the plan's rows read the column
`FrameGraph.run` packs (the plain version over them is `run` bit for bit);
and `run` on the CPU stays the eager route. On a CUDA card (marked `cuda`,
skipped without one): K7 against the eager route on the same column, at
4K and at an odd small size, within 1 LSB on at most 1e-4 of the values;
each generator alone; a GenSlot on its own clock; the counters and a fresh
output each call.

The file imports neither jax nor lives_tpu, so the card's tests also run
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_live_sweep.py -q
"""

import pytest
import torch

from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects.host import instantiate, split_params
from lives_tpu_torch.graph import FrameGraph, GenSlot, SinkSpec, live_sweep
from lives_tpu_torch.graph import nodemodel
from lives_tpu_torch.graph.nodemodel import chain_spec_of
from lives_tpu_torch.io.genclip import GeneratorClip
from lives_tpu_torch.layer import Layer
from lives_tpu_torch.utils.transfer import pack_column

#: the chains of the live cell (cardbench/configs/vj_4k60.json), each behind
#: luma_key
CHAINS = [["saturation"], ["saturation", "vignette"], ["vignette"],
          ["vignette", "brightness_contrast"], ["brightness_contrast"],
          ["saturation", "brightness_contrast"], [], ["negate"]]
VALUES = {"saturation": {"saturation": 1.6},
          "vignette": {"amount": 0.7, "strength": 1.2},
          "brightness_contrast": {"brightness": 0.1, "contrast": 1.3},
          "negate": {}}
FPS = 60.0
W, H = 250, 142
#: the card's limits against the eager route
MAX_LSB, MAX_SHARE = 1, 1e-4


def clips(w=W, h=H, device="cpu"):
    return [GeneratorClip("plasma", w, h, fps=FPS, device=device, speed=0.7,
                          scale=0.37),
            GeneratorClip("colour_bars", w, h, fps=FPS, device=device)]


def graph(names, w=W, h=H, sink=None, key="luma_key"):
    chain = [instantiate(key, threshold=0.3, softness=0.1)] if key else []
    chain += [instantiate(n, **VALUES.get(n, {})) for n in names]
    return FrameGraph(chain, sink or SinkSpec(width=w, height=h), fps=FPS)


def rows_key(g):
    return tuple((i, k) for i, inst in enumerate(g.chain)
                 for k in sorted(split_params(inst)[1]))


def column(g, gens, tc, frame, device):
    """The (P+2, 1) column `FrameGraph.run` packs for bare generator clips
    `gens` at (tc, frame)."""
    ds = [split_params(i)[1] for i in g.chain] + \
        [split_params(c.inst)[1] for c in gens]
    vals = [d[k] for d in ds for k in sorted(d)]
    for _ in gens:
        vals += [tc, frame]
    return pack_column(vals + [tc, frame], device)


def plan_of(g, gens, device, w=W, h=H):
    return live_sweep.build_live_sweep(chain_spec_of(g.chain), gens,
                                       rows_key(g), g.sink, h, w, device,
                                       fps=g.fps)


# -- the rule, on the CPU ------------------------------------------------------

@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_rule_takes_the_cells_chains(names):
    g = graph(names)
    enc = live_sweep.encode_live(chain_spec_of(g.chain), clips(),
                                 rows_key(g), g.sink, H, W)
    assert enc is not None
    ops, slot_rows, slot_vals, consts, table, n_rows = enc
    assert ops.shape == (1 + len(names), 7)
    assert [r[0] for r in table.tolist()] == [0, 1]  # plasma, colour_bars
    # the chain's rows, plasma's two, a (tc, frame) a track and the frame's
    assert n_rows == len(rows_key(g)) + 2 + 2 * 2 + 2


def _refused(case):
    """(graph, clips, real layers, device) of a frame the rule refuses."""
    gens = clips()
    if case == "stateful":
        return graph(["saturation", "fire"]), gens, [], "cuda"
    if case == "cconx":
        mm = instantiate("motion_mask", threshold=0.02)
        mo = instantiate("mask_overlay")
        mo.in_tracks = (0, 0)
        return (FrameGraph([mm, mo], SinkSpec(W, H), fps=FPS,
                           cconx=[(0, "mask", 1, 0)]), gens, [], "cuda")
    if case == "stencil":
        return graph(["saturation", "gaussian_blur"]), gens, [], "cuda"
    if case == "decoded":
        lay = Layer(planes=(torch.zeros(3, H, W, dtype=torch.uint8),))
        return graph(["saturation"]), gens[:1], [lay], "cuda"
    if case == "generator":
        return (graph(["saturation"]),
                [gens[0], GeneratorClip("noise", W, H, fps=FPS,
                                        device="cpu")], [], "cuda")
    if case == "geometry":
        return (graph(["saturation"]),
                [gens[0], GeneratorClip("colour_bars", W + 8, H, fps=FPS,
                                        device="cpu")], [], "cuda")
    if case == "resize":
        return (graph(["saturation"], sink=SinkSpec(W // 2, H // 2)), gens,
                [], "cuda")
    if case == "letterbox":
        return (graph(["saturation"], sink=SinkSpec(W, H, letterbox=True)),
                gens, [], "cuda")
    if case == "palette":
        return (graph(["saturation"],
                      sink=SinkSpec(W, H, palette=Palette.RGBA32)), gens, [],
                "cuda")
    if case == "track":
        g = graph(["saturation"])
        g.chain[0].in_tracks = (0, 2)  # a track the frame does not have
        return g, gens, [], "cuda"
    assert case == "cpu"
    return graph(["saturation"]), gens, [], "cpu"


@pytest.mark.parametrize("case", ["stateful", "cconx", "stencil", "decoded",
                                  "generator", "geometry", "resize",
                                  "letterbox", "palette", "track", "cpu"])
def test_rule_refuses(case):
    """Each refusal before any upload: the frame runs eagerly."""
    g, gens, real, device = _refused(case)
    key = ("refused", case)
    assert g._live_plan(key, gens, real, rows_key(g), device) is None
    made = ("live", key, str(torch.device(device))) in nodemodel._PLANS
    # the cheap checks refuse before a plan is looked for
    assert made == (case not in ("cconx", "decoded", "cpu"))


@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_plain_version_reads_the_column_run_packs(names):
    """The plan's rows (the chain's, each generator's parameters, tc and
    frame) name the values `run` packs: the plain version over a CPU plan
    is `run`'s eager frame bit for bit."""
    g, gens = graph(names), clips()
    n = 12345
    plan = plan_of(g, gens, "cpu")
    got = live_sweep.live_sweep(plan, column(g, gens, n / FPS, n, "cpu"))
    want = g.run(gens, n / FPS, n).planes[0]
    assert got.shape == (3, H, W) and got.dtype == torch.uint8
    assert torch.equal(got, want)


@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_run_on_the_cpu_stays_eager(names):
    """On the CPU `run` takes the eager route: no launch, no live plan, no
    plain frame counted, and the frame the eager route makes."""
    g, gens = graph(names), clips()
    launches, plain = live_sweep.LAUNCHES, nodemodel.PLAIN_FRAMES
    plans = len(nodemodel._PLANS)
    n = 777
    out = g.run(gens, n / FPS, n).planes[0]
    assert (live_sweep.LAUNCHES, nodemodel.PLAIN_FRAMES) == (launches, plain)
    assert len(nodemodel._PLANS) == plans
    col = column(g, gens, n / FPS, n, "cpu")
    r = len(rows_key(g))
    t0 = r + 2  # after plasma's two rows: each track's (tc, frame)
    layers = []
    for i, c in enumerate(gens):
        names = sorted(split_params(c.inst)[1])
        layers.append(c.generate(dict(zip(names, col[r:r + len(names)])),
                                 col[t0 + 2 * i], col[t0 + 2 * i + 1], FPS))
        r += len(names)
    want = nodemodel.run_chain(chain_spec_of(g.chain), layers, col,
                               rows_key(g), FPS, g.sink)
    assert torch.equal(out, want.planes[0][0])


# -- K7 on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the live sweep has no CPU mode")
    return torch.device("cuda")


def lsb_stats(got, want):
    """(largest |difference| in LSB, share of values that differ)."""
    d = (got.int() - want.int()).abs()
    return d.max().item(), (d > 0).float().mean().item()


def _held(got, want):
    worst, share = lsb_stats(got, want)
    assert worst <= MAX_LSB and share <= MAX_SHARE, (worst, share)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(3840, 2160), (W, H)])
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_k7_matches_the_eager_route(cuda, names, w, h):
    g, gens = graph(names, w, h), clips(w, h, cuda)
    plan = plan_of(g, gens, cuda, w, h)
    for n in (0, 217, 12345, 35999):
        col = column(g, gens, n / FPS, n, cuda)
        got = live_sweep.live_sweep(plan, col)
        torch.cuda.synchronize()
        _held(got, live_sweep.plain_live_sweep(plan, col))


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["plasma", "colour_bars"])
def test_each_generator_alone(cuda, gen):
    g = graph(["saturation", "vignette"], key=None)
    clip = [c for c in clips(device=cuda) if c.name == gen]
    plan = plan_of(g, clip, cuda)
    for n in (3, 4321):
        col = column(g, clip, n / FPS, n, cuda)
        _held(live_sweep.live_sweep(plan, col),
              live_sweep.plain_live_sweep(plan, col))


@pytest.mark.cuda
def test_genslot_on_its_own_clock(cuda):
    """plasma's frame n on its own clock (tc = n / its fps) through K7,
    against the eager route over the frames `get_frame` pulls."""
    g = graph(["saturation", "vignette"])
    fg, bg = clips(device=cuda)
    fg.fps = 24.0
    launches = live_sweep.LAUNCHES
    for n, frame in ((1234, 30), (7, 9000)):
        got = g.run([GenSlot(fg, n), bg], frame / FPS, frame).planes[0]
        want = g.run([fg.get_frame(n), bg.get_frame(frame)], frame / FPS,
                     frame).planes[0]
        torch.cuda.synchronize()
        _held(got, want)
    assert live_sweep.LAUNCHES == launches + 2


@pytest.mark.cuda
def test_counts_and_a_fresh_frame_each_call(cuda):
    g, gens = graph(["saturation", "vignette"]), clips(device=cuda)
    launches, plain = live_sweep.LAUNCHES, nodemodel.PLAIN_FRAMES
    first = g.run(gens, 0.0, 0).planes[0]
    kept = first.clone()
    second = g.run(gens, 1.0, 60).planes[0]
    torch.cuda.synchronize()
    assert live_sweep.LAUNCHES == launches + 2
    assert nodemodel.PLAIN_FRAMES == plain
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    # a stencil keeps the frame eager, and is counted
    graph(["gaussian_blur"]).run(gens, 0.0, 0)
    assert live_sweep.LAUNCHES == launches + 2
    assert nodemodel.PLAIN_FRAMES == plain + 1
