"""Device-resident particle state (counterpart of hoomd_tpu/state.py).

The same structure-of-arrays layout as the JAX package, as a small
dataclass of torch tensors on the context's device.  The timestep is a
host int: the host drives every step, so it always knows it, and the
Langevin noise keyed by it needs no device round-trip.  Orientations
live on the device (hard-particle MC rotates them); angular momentum and
moment of inertia stay in the snapshot template: the MD engine gates out
rotational degrees of freedom.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ._config import int_dtype, real_dtype
from .box import Box
from .snapshot import Snapshot


@dataclass
class State:
    pos: torch.Tensor           # (N,3) real
    vel: torch.Tensor           # (N,3) real
    image: torch.Tensor         # (N,3) int
    typeid: torch.Tensor        # (N,)  int
    tag: torch.Tensor           # (N,)  int — identity of particle in slot i
    rtag: torch.Tensor          # (N,)  int — slot of particle with tag t
    mass: torch.Tensor          # (N,)  real
    charge: torch.Tensor        # (N,)  real
    diameter: torch.Tensor      # (N,)  real
    body: torch.Tensor          # (N,)  int
    net_force: torch.Tensor     # (N,3) real
    net_pe: torch.Tensor        # (N,)  real
    net_virial: torch.Tensor    # (N,6) real — xx,xy,xz,yy,yz,zz
    orientation: torch.Tensor   # (N,4) real — quaternion (w, x, y, z)
    box: Box
    timestep: int

    @property
    def N(self) -> int:
        return self.pos.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def state_from_snapshot(snap: Snapshot, device='cpu') -> State:
    """Load a host snapshot into device tensors."""
    dt = real_dtype()
    idt = int_dtype()
    p = snap.particles
    N = p.N

    def T(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    ar = torch.arange(N, dtype=idt, device=device)
    box = snap.box.to_box(device=device)
    state = State(
        pos=T(p.position, dt), vel=T(p.velocity, dt),
        image=T(p.image, idt), typeid=T(p.typeid, idt),
        tag=ar, rtag=ar.clone(), mass=T(p.mass, dt),
        charge=T(p.charge, dt), diameter=T(p.diameter, dt),
        body=T(p.body, idt),
        net_force=torch.zeros((N, 3), dtype=dt, device=device),
        net_pe=torch.zeros((N,), dtype=dt, device=device),
        net_virial=torch.zeros((N, 6), dtype=dt, device=device),
        orientation=T(p.orientation, dt), box=box, timestep=0)
    # wrap any out-of-box initial positions
    pos, image = box.wrap(state.pos, state.image)
    return state.replace(pos=pos, image=image)


def snapshot_from_state(state: State, snap_template: Snapshot) -> Snapshot:
    """Gather device state back to a host snapshot in tag order."""
    snap = Snapshot(state.N, particle_types=snap_template.particles.types)
    L, tilt, _ = state.box.to_numpy()
    snap.box.Lx, snap.box.Ly, snap.box.Lz = (float(L[0]), float(L[1]),
                                             float(L[2]))
    snap.box.xy, snap.box.xz, snap.box.yz = (float(tilt[0]), float(tilt[1]),
                                             float(tilt[2]))
    snap.box.dimensions = state.box.dimensions
    order = state.rtag.cpu().numpy()  # tag t lives at slot rtag[t]

    def H(a):
        return a.cpu().numpy()[order]
    p = snap.particles
    tp = snap_template.particles
    p.position[:] = H(state.pos)
    p.velocity[:] = H(state.vel)
    m = H(state.mass)
    p.acceleration[:] = H(state.net_force) / m[:, None]
    p.typeid[:] = H(state.typeid)
    p.mass[:] = m
    p.charge[:] = H(state.charge)
    p.diameter[:] = H(state.diameter)
    p.image[:] = H(state.image)
    p.body[:] = H(state.body)
    p.orientation[:] = H(state.orientation)
    p.angmom[:] = tp.angmom
    p.moment_inertia[:] = tp.moment_inertia
    for name in ('bonds', 'angles', 'dihedrals', 'impropers', 'constraints',
                 'pairs'):
        src = getattr(snap_template, name)
        dst = getattr(snap, name)
        dst.types = list(src.types)
        dst.resize(src.N)
        dst.typeid[:] = src.typeid
        dst.group[:] = src.group
        dst.value[:] = src.value
    return snap
