"""Counter-based per-particle RNG, bit-exact with hoomd_tpu/ops/hashrng.py.

murmur3 fmix32 finalizers keyed by (seed, timestep, tag, salt).  The
JAX package computes them in int32 with wrapping multiplies and LOGICAL
right shifts.  Torch has no logical shift on int32 (``>>`` is
arithmetic), so every word here is an int64 holding the unsigned 32-bit
value, re-masked with 0xFFFFFFFF after each add and multiply.  The
products of two 32-bit values fit in 64 bits only when both are below
2**32, which the masks keep true, so the low 32 bits are exact.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_PHI = 0x9E3779B9


def _u32(x):
    """int64 tensor holding the two's-complement bits of int32 ``x``."""
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _mul(a, b):
    # (a * b) mod 2^32 for a, b < 2^32: split b to keep the int64
    # product below 2^63
    lo = (a * (b & 0xFFFF)) & _M32
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(h):
    """murmur3 fmix32 on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul(h, _C1)
    h = h ^ (h >> 13)
    h = _mul(h, _C2)
    h = h ^ (h >> 16)
    return h


def counter_bits(seed, timestep, tag, salt=0):
    """32-bit words keyed by (seed, timestep, tag, salt), as uint32 values
    in an int64 tensor on ``tag``'s device."""
    tag = torch.as_tensor(tag)
    dev = tag.device
    s = _u32(torch.as_tensor(seed, device=dev))
    t = _u32(torch.as_tensor(timestep, device=dev))
    a = _u32(torch.as_tensor(salt, device=dev))
    key = mix32((_mul(s, _PHI) + t) & _M32) ^ _mul(a, _C2)
    h = mix32((_mul(_u32(tag), _PHI) + key) & _M32)
    return mix32(h ^ key)


def uniform_pm1(seed, timestep, tag, salt=0):
    """Uniform in [-1, 1): the 24 high bits as an exact float32 in
    [0, 2), shifted down by one."""
    u24 = counter_bits(seed, timestep, tag, salt) >> 8
    return u24.to(torch.float32) * (2.0 ** -23) - 1.0
