"""System initialization (counterpart of hoomd_tpu/init.py)."""

from __future__ import annotations

import os

from . import context, data
from .io.frames import FrameReader
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


def read_gsd(filename, restart=None, frame=-1, time_step=None):
    """Initialize from a frame of a GSD file, or from ``restart`` when
    that file exists (the restartable-job idiom): the snapshot, its step,
    and the integration methods' saved variables, which each method takes
    back with ``restore_state()``."""
    fn = filename
    if restart is not None and os.path.exists(restart):
        fn, frame = restart, -1
    snap, ts, op_state = FrameReader(fn).read(frame)
    sysdata = _finish_init(snap)
    system = context.current.system
    system.state = system.state.replace(
        timestep=int(ts if time_step is None else time_step))
    restored = {}
    for k, v in op_state.items():
        method, _, var = k.partition('/')
        restored.setdefault(method, {})[var] = v
    system._restored_method_state = restored
    return sysdata
