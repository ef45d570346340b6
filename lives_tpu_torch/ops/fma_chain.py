"""K6, the float32 fused-multiply-add probe: wrapper, plain version, launch
count.

Counterpart of `benchmarks/sweep_profile.py:146-164` (`mk(K)`), the TPU
kernel with which the JAX package's roofline study reads the chip's
compute peak: ``acc = a``, then K times ``acc = acc * 1.0000001f + a``, over
a float32 frame. Here it is CUDA C++ for the H100 (`csrc/fma_chain.cu`),
built with contraction on, so a step is one FFMA; its note says what
bounds it (bytes at K = 32, the FFMA issue rate from K = 128) and what the
design does about that (a pair of float4s a thread, so 8 independent
accumulators, the steps unrolled by 16, a grid that gives every thread the
same work, the ragged tail in the kernel). `chip_smoke.py` phase 13 is the
port's roofline study: it reads the card's float32 ceiling from K6's times
at several depths.

- `fma_chain(x, K)`: float32, contiguous, any shape -> the same shape. On a
  CUDA tensor it launches the kernel, counting the launch in `LAUNCHES`;
  it raises on another dtype, a tensor that is not contiguous or not
  16-byte aligned. On a CPU tensor it takes the plain version; any other
  device raises.
- `plain_fma_chain(x, K)`: the same loop in PyTorch, a multiply and then an
  add, each rounded on its own. The kernel rounds once a step, so the two
  agree within a relative error of K * 2^-23 (`tolerance`), not bit for
  bit.
- `build()` compiles the library with nvcc on first use (`native.load`)
  and binds it with ctypes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: the multiplier of sweep_profile.py:151, as the float32 it is there
M = float(np.float32(1.0000001))

#: kernel launches since the count was last set to 0
LAUNCHES = 0


def tolerance(K: int) -> float:
    """The relative error the kernel (one rounding a step) may show against
    the plain version (two): K * 2^-23."""
    return K * 2.0 ** -23


def flops(n: int, K: int) -> int:
    """Float operations of a call over n values: an FFMA a step a value,
    counted as 2 (the data sheet's 67 TFLOP/s counts them so, and so does
    sweep_profile.py:180)."""
    return 2 * K * n


def plain_fma_chain(x: torch.Tensor, K: int) -> torch.Tensor:
    """K6's plain version: ``acc = acc * M + x``, K times, a multiply and
    an add each rounded to float32."""
    _check(x, K)
    acc = x.clone()
    for _ in range(K):
        acc = acc * M + x
    return acc


def fma_chain(x: torch.Tensor, K: int) -> torch.Tensor:
    """The K-deep chain: K6 on a CUDA tensor, its plain version on a CPU
    tensor."""
    _check(x, K)
    if x.device.type == "cpu":
        return plain_fma_chain(x, K)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain: no kernel for {x.device}")
    return _launch(x, K)


def _check(x: torch.Tensor, K: int):
    if x.dtype != torch.float32:
        raise TypeError(f"fma_chain: float32 only, got {x.dtype}")
    if K < 0:
        raise ValueError(f"fma_chain: K = {K} < 0")


def build():
    """Build (on first use) and bind the kernel library; returns the
    `native.Built` record with the build's time and nvcc/ptxas log."""
    from ..native import load
    built = load("fma_chain")
    lib = built.lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lives_fma_chain.argtypes = [p, p, ctypes.c_longlong, i,
                                    ctypes.c_float, i, p]
    lib.lives_fma_chain.restype = i
    lib.lives_fma_chain_threads.restype = i
    lib.lives_cuda_error_string.argtypes = [i]
    lib.lives_cuda_error_string.restype = ctypes.c_char_p
    return built


def blocks(n: int, threads: int) -> int:
    """The grid over n values: a thread a pair of float4s, and at least
    one block for the n mod 4 tail."""
    pairs = -(-(n // 4) // 2)
    return max(1, -(-pairs // threads))


def _launch(x: torch.Tensor, K: int) -> torch.Tensor:
    global LAUNCHES
    if not x.is_contiguous():
        raise ValueError("fma_chain: the tensor must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fma_chain: the tensor must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build().lib
    grid = blocks(x.numel(), lib.lives_fma_chain_threads())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lives_fma_chain(x.data_ptr(), out.data_ptr(), x.numel(),
                                  K, M, grid, stream)
    if err != 0:
        msg = lib.lives_cuda_error_string(err).decode()
        raise RuntimeError(f"fma_chain launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return out
