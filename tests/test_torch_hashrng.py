"""hoomd_tpu_torch.ops.hashrng is bit-equal to hoomd_tpu.ops.hashrng.

The JAX package computes murmur3 in int32 with wrapping multiplies and
logical shifts; the port emulates it in int64 with 32-bit masks.  Every
word and every uniform must agree bit for bit, over seeds, timesteps,
tags (padding tag -1 and large tags included) and salts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoomd_tpu.ops import hashrng as jh
from hoomd_tpu_torch.ops import hashrng as th

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

TAGS = np.concatenate([np.arange(-1, 300), [2 ** 20 + 3, 2 ** 31 - 1],
                       np.full(5, -1)]).astype(np.int32)


@pytest.mark.parametrize('seed', [0, 7, 12345, 2 ** 31 - 1, -5])
@pytest.mark.parametrize('salt', [0, 1, 2, 3])
def test_counter_bits_and_uniform_bit_equal(seed, salt):
    for ts in (0, 1, 999, 123456, 2 ** 31 - 1):
        want = np.asarray(jh.counter_bits(seed, ts, jnp.asarray(TAGS),
                                          salt=salt)).view(np.uint32)
        got = th.counter_bits(seed, ts, torch.from_numpy(TAGS), salt=salt)
        assert np.array_equal(got.numpy().astype(np.uint32), want)
        uj = np.asarray(jh.uniform_pm1(seed, ts, jnp.asarray(TAGS),
                                       salt=salt))
        ut = th.uniform_pm1(seed, ts, torch.from_numpy(TAGS), salt=salt)
        assert ut.dtype == torch.float32
        assert np.array_equal(ut.numpy().view(np.uint32),
                              uj.view(np.uint32))
        assert ut.min() >= -1.0 and ut.max() < 1.0


def test_mix32_bit_equal():
    rng = np.random.RandomState(0)
    h = rng.randint(-2 ** 31, 2 ** 31 - 1, 4096, dtype=np.int64).astype(
        np.int32)
    want = np.asarray(jh.mix32(jnp.asarray(h))).view(np.uint32)
    got = th.mix32(torch.from_numpy(h.astype(np.int64)) & 0xFFFFFFFF)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_timestep_planes_broadcast_like_the_noise_planes():
    """(k, 1, 1, 1, 1) timesteps against (nz, ny, nx, C) tag planes, the
    shape the Langevin noise planes use."""
    tag = TAGS[:240].reshape(1, 3, 4, 5, 4)
    ts = np.arange(50, 53, dtype=np.int32).reshape(3, 1, 1, 1, 1)
    want = np.asarray(jh.uniform_pm1(7, jnp.asarray(ts), jnp.asarray(tag),
                                     salt=2))
    got = th.uniform_pm1(7, torch.from_numpy(ts), torch.from_numpy(tag),
                         salt=2)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
