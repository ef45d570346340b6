"""The frozen yardstick of the MJPEG export's work: the least operations
and bytes one exported frame needs, by `work.py`'s rules (an operation is
one multiply, add, subtract, min, max, compare, divide, floor or round;
each step at the least its published algorithm needs; never counted from
the kernels that run it), from the formulas of
`cardbench/reference/mjpeg.py`:

- the decode, a coefficient of each track's source frame: the dequantise
  (a multiply, 1), the inverse DCT as two 8x8 matrix products (8
  multiply-adds a coefficient in each, 32), the level shift with the
  rounding, `floor(P + 128.5)`, and the two-sided clamp (4): 37;
- the 4:2:0 YCbCr to RGB24 conversion (K2's), a pixel of each source
  frame: the two chroma offsets (2), the four products and four sums of
  R, G and B (8), three floors and three two-sided clamps (9): 19;
- the timeline, a pixel: `work.render_frame`'s count less the synthetic
  source's 12 a track (the tracks here are decoded, not generated);
- the encode, a pixel: RGB to YCbCr (Y three products and two sums, Cb
  and Cr three products and three sums each: 17); a chroma sample: the
  2x2 mean (three sums and a multiply, 4); a coefficient: the level shift
  (1), the DCT's two products (32), the quantise (a divide and a round,
  2): 35;
- bytes: the source frames' dense int16 coefficients read once and the
  output's written once, 2 bytes each; every stage between could keep its
  values on chip.

Coefficients are counted by whole blocks at 4:2:0 (a plane's edge
replicated out to its blocks, as the reference transforms it).
"""

from __future__ import annotations

from cardbench import work

DECODE = 37        # a source coefficient
TO_RGB = 19        # a source pixel
FROM_RGB = 17      # an output pixel
CHROMA_MEAN = 4    # an output chroma sample
ENCODE = 35        # an output coefficient
COEF_BYTES = 2


def coefficients(width: int, height: int) -> int:
    """Coefficients of one 4:2:0 frame, by whole 8x8 blocks."""
    cw, ch = -(-width // 2), -(-height // 2)
    return 64 * (-(-height // 8) * -(-width // 8)
                 + 2 * -(-ch // 8) * -(-cw // 8))


def export_frame(tracks: int, transitions, effects, width: int,
                 height: int) -> tuple[int, int]:
    """(operations, bytes) of one exported frame: each track's source
    frame decoded and converted to RGB, the timeline over them, the
    output frame encoded."""
    px, co = width * height, coefficients(width, height)
    chroma = 2 * -(-width // 2) * -(-height // 2)
    timeline, _ = work.render_frame(tracks, transitions, effects, width,
                                    height)
    ops = tracks * (co * DECODE + px * TO_RGB)
    ops += timeline - tracks * work.SOURCE * px
    ops += px * FROM_RGB + chroma * CHROMA_MEAN + co * ENCODE
    return ops, (tracks + 1) * co * COEF_BYTES
