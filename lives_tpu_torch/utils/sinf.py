"""A twin of the float32 `sin` the JAX package's CPU route computes.

XLA's CPU backend lowers `jnp.sin` on float32 to a call of the C library's
`sinf`; on an x86-64 host with FMA and AVX2 that is glibc's `__sinf_fma`
(sysdeps/ieee754/flt-32/s_sinf.c with sincosf.h and sincosf_data.c, built
with contraction on). It evaluates in float64 and rounds once to float32,
and is not correctly rounded: about 1.3 % of its results are the other
neighbour of sin(x). `torch.sin` is another approximation, so a filter
that amplifies a one-ulp difference (`effects/builtin/geometry.py`
`spread`'s hash, `fract(sin(.) * 43758.5453)`) needs this function.

`sinf` repeats that algorithm on tensors with eager float64 `+`, `-`, `*`
and int64 integer operations only, which round the same on the CPU and on
a GPU: every fused multiply-add of the library becomes Dekker's exact
product and a two-sum (`_fma`), since an eager PyTorch op never contracts.
The three ranges are the library's: the polynomial alone below 0.75,
the reduction by one multiply-subtract below 120, and the Payne-Hanek
reduction with 4/pi to 192 bits above. The results equal `jnp.sin` on
every float32 from 0 to 2^17 (`tools/sinf_exhaustive.py`; a stride and
the path edges in tests/test_torch_geometry.py).
"""

from __future__ import annotations

import torch

#: sincosf_data.c `__sincosf_table[0]` (the cosine terms negated in [1]):
#: c0, c1, s1, c2, s2, c3, s3, c4
_C0, _C1, _S1, _C2, _S2, _C3, _S3, _C4 = (
    float.fromhex("0x1p0"), float.fromhex("-0x1.ffffffd0c621cp-2"),
    float.fromhex("-0x1.555545995a603p-3"),
    float.fromhex("0x1.55553e1068f19p-5"),
    float.fromhex("0x1.1107605230bc4p-7"),
    float.fromhex("-0x1.6c087e89a359dp-10"),
    float.fromhex("-0x1.994eb3774cf24p-13"),
    float.fromhex("0x1.99343027bf8c3p-16"))
#: 2/pi * 2^24, pi/2, and 2 pi * 2^-64
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p0")
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
#: `__inv_pio4`: 4/pi to 192 bits, eight new bits an entry
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_M32 = 0xFFFFFFFF


def _split(a):
    """Veltkamp's split: a == hi + lo, each with at most 26 bits."""
    t = a * 134217729.0   # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """a * b + c rounded once, as the hardware's fused multiply-add: the
    product exact as p + e (Dekker), p + c exact as s + t (Knuth's
    two-sum), then s + (t + e). `b` may be a Python float."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)   # Python floats split as exactly as tensors
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _poly(x, x2, odd, neg):
    """sincosf.h `sinf_poly` over both quadrant kinds: the sine polynomial
    of x where `odd` is False, the cosine polynomial (negated where `neg`,
    the library's second table) where it is True; float64."""
    x3 = x * x2
    s = _fma(_fma(x2, _S3, _S2), x3 * x2, _fma(x3, _S1, x))
    x4 = x2 * x2
    c = _fma(_fma(x2, _C4, _C3), x4 * x2, _fma(x4, _C2, _fma(x2, _C1, _C0)))
    # the negated table's terms round to the negated result
    return torch.where(odd, torch.where(neg, -c, c), s)


def _reduce_large(xi):
    """sincosf.h `reduce_large`: (x, n) for the float32 bit patterns `xi`
    (int64, the sign ignored): the residue of |y| * 4/pi in 2.62 fixed
    point from a 32 x 96 -> 128-bit product, in 32-bit limbs, and the
    quadrant n (0-3)."""
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=xi.device)
    idx = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift          # < 2^31
    # every product below is < 2^63: exact in int64
    r0 = (m * table[idx]) & _M32                       # 32-bit product
    r1 = m * table[idx + 4]
    r2 = m * table[idx + 8]
    # res0 = ((r2 >> 32) | (r0 << 32)) + r1, mod 2^64, as (hi, lo) limbs
    lo = (r2 >> 32) + (r1 & _M32)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30
    hi = (hi - (n << 30)) & _M32
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)  # signed
    return (hi * (1 << 32) + lo).to(torch.float64) * _PI63, n


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """s_sinf.c's `sinf` (cos False) or s_cosf.c's `cosf` (cos True): the
    same reductions, and the other polynomial for cos (`sinf_poly` of n ^
    1), which below pi/4 is the cosine polynomial of x itself."""
    name = "cosf" if cos else "sinf"
    if y.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {y.dtype}")
    xi = y.view(torch.int32).to(torch.int64) & _M32
    top = (xi >> 20) & 0x7FF                           # abstop12
    x = y.to(torch.float64)
    small, fast = top < 0x3F4, top < 0x42F
    # |y| < 120: one multiply-subtract by pi/2 (reduce_fast)
    nf = (((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24).to(torch.int64)
    rf = _fma(nf.to(torch.float64), -_HPI, x)
    # |y| >= 120: Payne-Hanek
    rl, nl = _reduce_large(xi)
    # below pi/4 the polynomial of x itself (quadrant 0)
    r = torch.where(small, x, torch.where(fast, rf, rl))
    n = torch.where(small, 0, torch.where(fast, nf, nl))
    q = torch.where(fast, n, n + (xi >> 31)) & 3       # the sign's quadrant
    sgn = torch.where((q == 1) | (q == 2), -1.0, 1.0).to(torch.float64)
    odd = (n & 1) == (0 if cos else 1)
    out = _poly(r * sgn, r * r, odd, (q & 2) == 2).to(torch.float32)
    # |y| < 2^-12: y (sin), 1 (cos)
    out = torch.where(top < 0x398, torch.ones_like(y) if cos else y, out)
    return torch.where(top >= 0x7F8, y - y, out)       # inf, nan: nan


def sinf(y: torch.Tensor) -> torch.Tensor:
    """float32 sin, bit for bit the C library's `sinf` that XLA's CPU
    backend calls (see the module's docstring). Any shape and device."""
    return _sincosf(y, False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """float32 cos, bit for bit the C library's `cosf` (`__cosf_fma`),
    which XLA's CPU backend calls for `jnp.cos`. Any shape and device."""
    return _sincosf(y, True)
