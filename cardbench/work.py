"""The frozen yardstick of work: the least operations and bytes each cell's
frames need, and the card's published peaks.

The counts are a function of the configuration and the frame shapes alone,
never of the kernel that runs the work, so a roofline share reads the same
work whatever implements it. Counted a pixel, from the reference's
formulas (`cardbench/reference/ops.py`):

- an operation is one multiply, add, subtract, min, max, compare, divide,
  square root, exponential, sine, cosine, floor or integer shift or mask;
- each op at the least its published algorithm needs: a radius-r Gaussian
  as two separable passes of 2r + 1 taps (12 a tap over three channels:
  a multiply and an add a channel in each pass) plus the mix with its
  input and the clamp (15);
- bringing a u8 frame in is a multiply a channel (3); the sink's
  quantise is 5 a channel (multiply, add, floor and a two-sided clamp);
- the synthetic source's integer formula is 4 a channel (multiply, shift,
  add, mask: 12 a pixel a track); plasma.c is 44 a pixel (its row and
  column terms once a row or column, the rest a pixel, its quantise
  included); colour bars vary along a row alone, so their work is once a
  column and counts 0 a pixel;
- bytes: each output byte written once. Every input is generated on the
  card, and a chunk's parameter column (under 200 bytes a frame) is left
  out.

The per-op counts are those of the repository's `chip_smoke.py`
(`BLEND_COST`, `_op_flops`, `table_flops`), copied, not imported.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
F32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12

LOAD = 3        # a u8 frame brought into [0, 1]
SINK = 15       # the quantise to u8
SOURCE = 12     # the synthetic source's integer formula
PLASMA = 44

#: multi_blends.c's modes: operations a channel of the blend itself
BLEND_COST = {"blend_add": 1, "blend_multiply": 1, "blend_screen": 4,
              "blend_lighten": 1, "blend_difference": 2, "blend_overlay": 5}


def op_cost(name: str, static: dict | None = None) -> int:
    """Operations a pixel of one filter."""
    static = static or {}
    if name in BLEND_COST:
        return 16 + 3 * BLEND_COST[name]
    if name == "gaussian_blur":
        r = int(static["radius"])
        return 12 * (2 * r + 1) + 15
    return {"crossfade": 16, "luma_key": 25, "chroma_key": 31,
            "colour_balance": 9, "saturation": 20, "vignette": 23,
            "negate": 9, "brightness_contrast": 18}[name]


def render_frame(tracks: int, transitions, effects, width: int,
                 height: int) -> tuple[int, int]:
    """(operations, bytes) of one timeline frame: every track generated
    and brought in, the transitions folding tracks 1.. into track 0, the
    effects, the sink."""
    px = width * height
    ops = tracks * (SOURCE + LOAD) + SINK
    ops += sum(op_cost(name) for name in transitions)
    ops += sum(op_cost(name, static) for name, static in effects)
    return px * ops, px * 3


def live_frame(key: str, chain, width: int, height: int) -> tuple[int, int]:
    """(operations, bytes) of one live frame: plasma and the colour bars
    generated and brought in, plasma keyed over the bars by `key`, a
    chain of one-input effects, the sink."""
    px = width * height
    ops = PLASMA + 2 * LOAD + op_cost(key) + SINK
    ops += sum(op_cost(name) for name in chain)
    return px * ops, px * 3


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work, and which of its
    two bounds sets it."""
    t_ops, t_bytes = ops / F32_OPS_S, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
