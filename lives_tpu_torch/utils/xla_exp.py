"""A twin of the float32 `exp` the JAX package's CPU route computes, and a
float32 fused multiply-add from eager operations.

XLA's CPU backend does not call the C library for `jnp.exp` on float32: it
inlines a Cephes-style approximation (the IR of a jitted `jnp.exp` holds
`llvm.exp.f32`, which XLA's own pass expands), and its code generator
contracts each multiply-add of that expansion into an FMA instruction on a
host with FMA. About 10 % of its results differ from the C library's
`expf` by an ulp. The expansion, read from the object code XLA emits for
`jax.jit(jnp.exp)`:

    x  = clamp(x, -87.8, 88.8)
    fx = clamp(floor(fma(x, log2(e), 0.5)), -127, 127)
    r  = fma(-fx, C2, fma(-fx, C1, x))            # C1 + C2 = ln 2
    p  = Horner(p0 .. p4, 0.5) in r, each step an fma
    y  = (fma(p, r * r, r) + 1) * 2^fx, a subnormal y flushed to 0

`fma32` rounds a * b + c once to float32 with eager float64 operations
(the float32 product is exact in float64; a two-sum and rounding to odd
keep the float64 sum's rounding from doubling), so it gives the same bits
on the CPU and on a GPU. `expf` is held bit for bit against `jnp.exp` by
tests/test_torch_text.py and `tools/sinf_exhaustive.py --exp`.
"""

from __future__ import annotations

import struct

import torch


def _f32(hexbits: int) -> float:
    """The float32 whose bit pattern is `hexbits`, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", hexbits))[0]


_LO, _HI = _f32(0xC2AF999A), _f32(0x42B1999A)       # -87.8, 88.8
_LOG2E = _f32(0x3FB8AA3B)
_C1, _C2 = _f32(0x3F318000), _f32(0xB95E8083)
_P = (_f32(0x39506967), _f32(0x3AB743CE), _f32(0x3C088908),
      _f32(0x3D2AA9C1), _f32(0x3E2AAAAA), 0.5)
_TINY = _f32(0x00800000)                             # 2^-126


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c for float32 operands (tensors or Python floats that are
    float32 values), rounded once to float32, as an FMA instruction
    computes it. Any device; a Python number never becomes a tensor on
    it (a copy from the host's pageable memory would wait for the card's
    queue)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    p = a.to(torch.float64) * b          # exact: 24 + 24 bits
    c = c.to(torch.float32).to(torch.float64) \
        if isinstance(c, torch.Tensor) else float(struct.unpack(
            "<f", struct.pack("<f", c))[0])
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)        # p + c == s + t exactly
    # round to odd where the float64 sum was inexact: float32 rounding of
    # the result is then the rounding of the exact value
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(t > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((t != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def expf(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, bit for bit what XLA's CPU backend computes for
    `jnp.exp` (see the module's docstring). Any shape and device."""
    if x.dtype != torch.float32:
        raise TypeError(f"expf takes float32, got {x.dtype}")
    x = torch.clamp(x, _LO, _HI)
    fx = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma32(-fx, _C2, fma32(-fx, _C1, x))
    p = torch.full_like(r, _P[0])
    for coef in _P[1:]:
        p = fma32(p, r, coef)
    y = fma32(p, r * r, r) + 1.0
    pow2 = ((fx.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    out = y * pow2
    # XLA's CPU runtime flushes subnormal results to zero
    return torch.where(out < _TINY, torch.zeros_like(out), out)
