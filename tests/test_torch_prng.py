"""`lives_tpu_torch.utils.prng`, the port of JAX's threefry, bit for bit
against `jax.random` (jax_threefry_partitionable, JAX's default): the raw
Threefry-2x32 block, `PRNGKey`, `fold_in` (frames 0, 1, 2^24 - 1 and
2^31 - 1), `split`, the 32-bit draw, `uniform` and `randint`; and the two
filters that draw from it: `noise`'s frames and nervous's slots.

(A known-answer test that needs no jax, the Random123 vector, runs in
tests/test_torch_cuda.py on the CPU and on the card.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from lives_tpu_torch.effects.builtin.effectv import nervous_slot
from lives_tpu_torch.utils import prng

FRAMES = [0, 1, 2, 7, 2 ** 24 - 1, 2 ** 31 - 1]


def test_threefry_block_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 257), dtype=np.uint64).astype(np.uint32)
    ref = jprng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
        jnp.asarray(x[1]))
    t = [torch.from_numpy(np.asarray(a, np.int64)) for a in (k[0], k[1], *x)]
    got = prng.threefry_2x32(*t)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 1234, 2 ** 31 - 1, -1, -2 ** 31])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed, "cpu").numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_a_seed_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31, "cpu")


@pytest.mark.parametrize("seed", [42, 1234])
def test_fold_in_matches_jax(seed):
    """A batch of frame numbers folds into a batch of keys at once."""
    got = prng.fold_in(prng.prng_key(seed, "cpu"), torch.tensor(FRAMES))
    ref = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  f)) for f in FRAMES])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_split_and_random_bits_match_jax():
    key = prng.prng_key(5, "cpu")
    jkey = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(prng.split(key, 3).numpy(),
                                  np.asarray(jax.random.split(jkey, 3)))
    np.testing.assert_array_equal(
        prng.random_bits(key, (4, 6)).numpy(),
        np.asarray(jax.random.bits(jkey, (4, 6), jnp.uint32), np.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 9)])
def test_uniform_matches_jax(shape):
    keys = prng.fold_in(prng.prng_key(42, "cpu"), torch.tensor(FRAMES))
    got = prng.uniform(keys, shape)
    assert got.dtype == torch.float32 and got.shape == (len(FRAMES), *shape)
    for i, f in enumerate(FRAMES):
        ref = jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(42), f), shape)
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("lo,hi,shape", [
    (0, 8, ()), (0, 8, (5,)), (-7, 1000, (3, 4)), (3, 3, (2,)),
    (0, 2 ** 31 - 1, (6,)), (-2 ** 31, 2 ** 31 - 1, (4,)), (5, 2, (3,))])
def test_randint_matches_jax(lo, hi, shape):
    got = prng.randint(prng.prng_key(7, "cpu"), shape, lo, hi)
    ref = jax.random.randint(jax.random.PRNGKey(7), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_nervous_slots_match_jax():
    """The slot nervous shows at each frame: randint(fold_in(PRNGKey(1234),
    frame), (), 0, 8), for a batch of frames at once."""
    frames = list(range(40)) + FRAMES
    got = nervous_slot(torch.tensor(frames, dtype=torch.int32), "cpu")
    ref = [int(jax.random.randint(jax.random.fold_in(
        jax.random.PRNGKey(1234), jnp.int32(f)), (), 0, 8)) for f in frames]
    np.testing.assert_array_equal(got.numpy(), ref)
