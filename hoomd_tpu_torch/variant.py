"""Time-dependent scalar values (counterpart of hoomd_tpu/variant.py).

``constant`` wraps a number; ``linear_interp`` interpolates a point list.
``pack`` gives (xs, ys) tables and ``eval_packed`` evaluates them on the
device at one or many timesteps, so a window's per-step kT table never
leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch


class _variant:
    def pack(self, dtype, device='cpu'):
        raise NotImplementedError


class constant(_variant):
    def __init__(self, val):
        self.val = float(val)

    def pack(self, dtype, device='cpu'):
        return (torch.tensor([0.0], dtype=dtype, device=device),
                torch.tensor([self.val], dtype=dtype, device=device))


class linear_interp(_variant):
    """points = [(step, value), ...]; ``zero`` offsets the time origin."""

    def __init__(self, points, zero='now'):
        if zero == 'now':
            from . import context
            zero = (0 if context.current is None
                    or context.current.system is None
                    else context.current.system.timestep)
        self.zero = int(zero)
        pts = sorted((float(t), float(v)) for t, v in points)
        self.xs = np.array([t for t, _ in pts]) + self.zero
        self.ys = np.array([v for _, v in pts])

    def pack(self, dtype, device='cpu'):
        return (torch.as_tensor(self.xs, dtype=dtype, device=device),
                torch.as_tensor(self.ys, dtype=dtype, device=device))


def as_variant(v):
    if isinstance(v, _variant):
        return v
    return constant(v)


def eval_packed(packed, timestep):
    """Evaluate a packed table at ``timestep`` (int, or int tensor of any
    shape): piecewise linear, clamped to the end values."""
    xs, ys = packed
    t = torch.as_tensor(timestep, device=ys.device).to(ys.dtype)
    if xs.numel() == 1:
        return ys[0].expand(t.shape).clone() if t.dim() else ys[0].clone()
    i = torch.clamp(torch.searchsorted(xs, t, right=True), 1,
                    xs.numel() - 1)
    # the same operation order as jnp.interp, so both packages agree
    f = ys[i - 1] + ((t - xs[i - 1]) / (xs[i] - xs[i - 1])) \
        * (ys[i] - ys[i - 1])
    return torch.where(t < xs[0], ys[0], torch.where(t > xs[-1], ys[-1], f))
