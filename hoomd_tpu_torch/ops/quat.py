"""Quaternion algebra (counterpart of hoomd_tpu/ops/quat.py:18-51).

Orientation quaternions q = (w, x, y, z) in the last dimension, as in the
reference's VectorMath.h.  The same formulas, term for term, as the JAX
package, so the two agree to float32 round-off.
"""

from __future__ import annotations

import torch


def multiply(a, b):
    """Hamilton product, (...,4) x (...,4) -> (...,4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qv = q[..., 1:]
    qw = q[..., 0:1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)
