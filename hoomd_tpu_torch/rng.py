"""Counter-based random streams of the general engine's stochastic
methods (counterpart of hoomd_tpu/rng.py).

The JAX package draws them with jax.random's threefry2x32: a key per
(user seed, consumer salt, timestep) from ``key(seed)`` and two
``fold_in``s, then ``uniform`` / ``normal`` of shape (n_tags, ...) with
row t given to the particle of tag t, so a draw does not depend on the
particles' order.  This module reproduces those bits: threefry2x32 in
integer ops (Salmon et al., SC'11; the round structure of
jax/_src/prng.py ``_threefry2x32_lowering``), the partitionable random
bits (``jax_threefry_partitionable``, the default: the counter of
element i is the 64-bit i as (hi, lo), the bits are the two outputs
xor-ed), and the mantissa trick of ``uniform``.  Integer arithmetic is
exact on every device, so the uniforms equal the JAX package's bit for
bit.  ``normal`` maps them through erfinv in the single-precision form
XLA lowers it to (M. Giles, "Approximating the erfinv function", GPU
Computing Gems Jade, 2011: a degree-8 polynomial in w = -log1p(-x^2)),
so it agrees with the JAX package's to a few ulps (log1p and sqrt round
as each library's own), not bit for bit.

Keys are host pairs of python ints (the host knows every timestep);
the per-element hash runs on int64 tensors holding 32-bit words.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 under the
    key (k0, k1): python ints or int64 tensors of 32-bit values.
    Returns the two output words, of the same kind."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed):
    """jax.random.key(seed) for a 32-bit seed: the words (0, seed)."""
    return (0, int(seed) & _M32)


def fold_in(k, data):
    """jax.random.fold_in: the hash of the counter (0, data) under k."""
    return threefry2x32(k, 0, int(data) & _M32)


def step_key(seed, timestep, salt=0):
    """Key for one (user seed, timestep, consumer) tuple; ``salt``
    distinguishes consumers (hoomd_tpu/rng.py step_key)."""
    return fold_in(fold_in(key(seed), salt), timestep)


def random_bits(k, n, device):
    """n uint32 words of jax.random's partitionable bits, as int64."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniform(k, shape, dtype=torch.float32, lo=-1.0, hi=1.0, device='cpu'):
    """jax.random.uniform(k, shape, float32, lo, hi), bit for bit."""
    if dtype != torch.float32:
        raise NotImplementedError("the threefry streams draw float32 only")
    bits = random_bits(k, math.prod(shape), device)
    # 23 random mantissa bits under the exponent of 1.0: a float in [1, 2)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=dtype, device=device)
    hi_t = torch.tensor(hi, dtype=dtype, device=device)
    out = f * (hi_t - lo_t) + lo_t
    return torch.maximum(lo_t, out).reshape(shape)


def uniform_by_tag(k, tag, shape_per_tag, dtype=torch.float32, lo=-1.0,
                   hi=1.0):
    """(len(tag), *shape_per_tag) uniforms in [lo, hi), row t drawn from
    the tag-t substream: invariant to particle ordering."""
    draws = uniform(k, (tag.shape[0],) + tuple(shape_per_tag), dtype, lo, hi,
                    tag.device)
    return draws[tag.long()]


# Giles' coefficients, highest power first, for w < 5 and for w >= 5
_ERFINV_W5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_WG = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)


def erfinv(x):
    """float32 erfinv in XLA's form (Giles), +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W5, _ERFINV_WG):
        c = torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                        torch.tensor(b, dtype=x.dtype, device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(x.dtype).max, p * x)


def normal_by_tag(k, tag, shape_per_tag, dtype=torch.float32):
    """(len(tag), *shape_per_tag) standard normals by tag:
    sqrt(2) erfinv(u), u uniform in (-1, 1), as jax.random.normal."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, (tag.shape[0],) + tuple(shape_per_tag), dtype, lo, 1.0,
                tag.device)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=tag.device)
    return (sqrt2 * erfinv(u))[tag.long()]
