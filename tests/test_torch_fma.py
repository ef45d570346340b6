"""K6, the fused-multiply-add probe (lives_tpu_torch/ops/fma_chain.py),
against the TPU kernel it replaces (benchmarks/sweep_profile.py:146-164).

On the CPU `fma_chain` takes its plain version, a multiply and an add each
rounded to float32, which equals a numpy float32 recurrence bit for bit.
The TPU kernel's body, copied here and run as `pl.pallas_call(...,
interpret=True)`, is contracted by XLA's CPU into one fused multiply-add a
step (its values are those of a once-rounded recurrence, as the CUDA kernel
computes them), so it agrees with the plain version within a relative error
of K * 2^-23, not exactly. The kernel itself runs only on the card:
tests/test_torch_cuda.py holds it against the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lives_tpu_torch.ops import fma_chain as fc


def np_recurrence(x, K):
    """sweep_profile.py:149-152 in numpy float32: a multiply, then an
    add."""
    acc = x.copy()
    for _ in range(K):
        acc = acc * np.float32(1.0000001) + x
    return acc


def pallas_k6(x, K, TH):
    """The TPU kernel's body and grid (sweep_profile.py:146-164), in
    interpret mode."""
    _, h, w = x.shape

    def kernel(x_ref, o_ref):
        a = x_ref[...]
        acc = a
        for _ in range(K):
            acc = acc * np.float32(1.0000001) + a
        o_ref[...] = acc

    return np.asarray(pl.pallas_call(
        kernel, grid=(h // TH,),
        in_specs=[pl.BlockSpec((3, TH, w), lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((3, TH, w), lambda i: (0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((3, h, w), jnp.float32),
        interpret=True)(jnp.asarray(x)))


def frame(shape, seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, shape).astype(
        np.float32)


@pytest.mark.parametrize("K", [0, 1, 7, 32, 128])
@pytest.mark.parametrize("shape", [(3, 24, 128), (5, 7), (1,)])
def test_plain_is_the_float32_recurrence(K, shape):
    x = frame(shape)
    got = fc.plain_fma_chain(torch.from_numpy(x), K).numpy()
    np.testing.assert_array_equal(got, np_recurrence(x, K))


@pytest.mark.parametrize("K", [1, 32, 128])
def test_plain_matches_the_tpu_kernel(K):
    """(3, 24, 128) in bands of TH = 8 rows: XLA's CPU fuses each step, so
    within K * 2^-23 of the plain version, relative to its values."""
    x = frame((3, 24, 128), seed=K)
    ref = pallas_k6(x, K, TH=8)
    got = fc.plain_fma_chain(torch.from_numpy(x), K).numpy()
    rel = np.abs(got.astype(np.float64) - ref) / np.abs(ref)
    assert rel.max() <= fc.tolerance(K), rel.max()


def test_cpu_tensor_takes_the_plain_version():
    x = torch.from_numpy(frame((3, 24, 128)))
    before = fc.LAUNCHES
    got = fc.fma_chain(x, 32)
    assert fc.LAUNCHES == before
    torch.testing.assert_close(got, fc.plain_fma_chain(x, 32), rtol=0,
                               atol=0)
    with pytest.raises(TypeError):
        fc.fma_chain(x.double(), 32)


def test_multiplier_is_the_reference_float32():
    assert np.float32(fc.M) == np.float32(1.0000001)
    assert fc.M == 1.0 + 2.0 ** -23
    assert fc.flops(3 * 1080 * 1920, 128) == 1_592_524_800


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 8, 9, 31, 32, 33, 1000, 1027])
def test_grid_covers_every_value_once(n):
    """csrc/fma_chain.cu's index arithmetic over the wrapper's grid, at 4
    threads a block: every value is taken by exactly one thread."""
    threads = 4
    blocks = fc.blocks(n, threads)
    stride = blocks * threads
    n4 = n // 4
    seen = np.zeros(n, np.int64)
    for tid in range(stride):
        for i in range(tid, n4, 2 * stride):
            seen[4 * i:4 * i + 4] += 1
            if i + stride < n4:
                seen[4 * (i + stride):4 * (i + stride) + 4] += 1
        if n4 * 4 + tid < n:
            seen[n4 * 4 + tid] += 1
    assert (seen == 1).all()
    # one pair of float4s a thread: no thread takes a second round
    assert stride >= -(-n4 // 2)
