"""System initialization (counterpart of hoomd_tpu/init.py)."""

from __future__ import annotations

from . import context, data
from .system import System


def _finish_init(snap):
    if context.current is None:
        context.initialize('')
    if context.current.system is not None:
        raise RuntimeError("system already initialized "
                           "(call context.initialize() to reset)")
    sys_ = System(snap, device=context.current.device)
    context.current.system = sys_
    return data.system_data(sys_)


def read_snapshot(snapshot):
    """Initialize from a snapshot."""
    return _finish_init(snapshot)


def create_lattice(unitcell, n):
    """Replicate a unit cell n (or (nx, ny, nz)) times."""
    snap = unitcell.get_snapshot()
    if isinstance(n, (list, tuple)):
        nx, ny, nz = (list(n) + [1, 1, 1])[:3]
    else:
        nx = ny = nz = int(n)
    if snap.box.dimensions == 2:
        nz = 1
    return _finish_init(snap.replicate(nx, ny, nz))
