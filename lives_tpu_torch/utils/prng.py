"""JAX's threefry random numbers, bit for bit, on PyTorch tensors.

A port of the parts of `jax.random` the JAX package's filters draw from,
for JAX's default configuration (`jax_threefry_partitionable=True`):

- `threefry_2x32`, the Threefry-2x32 hash with 20 rounds
  (`jax/_src/prng.py:883-933` `_threefry2x32_lowering`);
- `prng_key` (`jax.random.PRNGKey`, `prng.py:802` `threefry_seed`) and
  `fold_in` (`prng.py:1163`);
- `random_bits`, the partitionable 32-bit draw (`prng.py:1184`): the
  hash of each element's flat index, split into 32-bit halves, its two
  words xor-ed;
- `uniform` (`jax/_src/random.py:435` `_uniform`) for float32, with its
  bounds, and
  `randint` (`random.py:581` `_randint`) for int32.

A key is an int64 tensor of shape (..., 2) holding two 32-bit words; every
word is an int64 in [0, 2^32), masked after each add, shift and product,
so nothing overflows and the arithmetic is the same on the CPU and on a
GPU. Everything stays on the device the key lies on: nothing is read back
to the host, so a frame number that is a device tensor (a packed column's)
keys a draw without a synchronisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .xla_exp import fma32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry_2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block of the counts (x1, x2) under the key words
    (k1, k2); int64 tensors of 32-bit words that broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x[0] + x[1]) & _M32
            x = [x0, _rotl(x[1], r) ^ x0]
        x = [(x[0] + ks[(i + 1) % 3]) & _M32,
             (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32]
    return x[0], x[1]


def prng_key(seed: int, device) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in int32 range, as the JAX
    package's 32-bit mode takes it: the words (0, seed mod 2^32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"prng_key: seed {seed} is outside int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of the counts (0, data
    mod 2^32). `data` is an int or an integer tensor (a frame number a
    frame, (B,)); the keys broadcast against it: (..., 2)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y1, y2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([y1, y2], -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`, the partitionable form: subkey i is
    the hash of the counts (0, i). (..., 2) -> (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry_2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                           i & _M32)
    return torch.stack([y1, y2], -1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element of `shape` under each key of (..., 2):
    the hash of each element's flat index, its words xor-ed. Returns
    int64 words, (..., *shape)."""
    shape = tuple(shape)
    lead = tuple(key.shape[:-1])
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y1, y2 = threefry_2x32(k1, k2, i >> 32, i & _M32)
    return (y1 ^ y2).reshape(lead + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)` in float32, in
    [minval, maxval): the top 23 bits as the mantissa of a float in
    [1, 2), less 1, times (maxval - minval) plus minval in one FMA (as
    XLA contracts the jitted `_uniform`), at least minval
    (`random.py:435-470`)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(fma32(floats, float(hi - lo), float(lo)),
                       min=float(lo))


def _mul32(a, b: int):
    """(a * b) mod 2^32 of 32-bit words a (tensor) and b, in int64 without
    overflow: a's 16-bit halves times b."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & _M32


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 and
    bounds in int32 range: two draws from a split key, the higher one's
    residue times a multiplier plus the lower one's, mod span. Returns
    int32, (..., *shape)."""
    span = maxval - minval if maxval > minval else 1
    # (2^16 mod span)^2 mod span, squared in uint32 as JAX squares it
    # (wrapping), so not 2^32 mod span for every span
    multiplier = ((2 ** 16 % span) ** 2 & _M32) % span
    # both draws in one hash call: (..., 2 subkeys, *shape)
    bits = random_bits(split(key), shape)
    higher, lower = bits.unbind(len(key.shape) - 1)
    offset = ((_mul32(higher % span, multiplier) + lower % span) & _M32) \
        % span
    return (offset + minval).to(torch.int32)
