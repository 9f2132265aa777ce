"""Host-side system snapshot (numpy) — init/IO interchange format.

Counterpart of hoomd_tpu/snapshot.py, unchanged in content: a complete,
host-resident description of the system used for initialization and
restore.  Device placement happens when the snapshot is loaded into a
State (state.py).
"""

from __future__ import annotations

import numpy as np


class ParticleDataSnapshot:
    """Global per-particle data (reference ParticleData.h:75-88 fields)."""

    def __init__(self, N=0, types=None):
        self.N = int(N)
        self.types = list(types) if types else ['A']
        self.position = np.zeros((N, 3), dtype=np.float64)
        self.velocity = np.zeros((N, 3), dtype=np.float64)
        self.acceleration = np.zeros((N, 3), dtype=np.float64)
        self.typeid = np.zeros(N, dtype=np.int32)
        self.mass = np.ones(N, dtype=np.float64)
        self.charge = np.zeros(N, dtype=np.float64)
        self.diameter = np.ones(N, dtype=np.float64)
        self.image = np.zeros((N, 3), dtype=np.int32)
        self.body = np.full(N, -1, dtype=np.int32)
        self.orientation = np.tile(
            np.array([1.0, 0, 0, 0]), (N, 1)).astype(np.float64)
        self.angmom = np.zeros((N, 4), dtype=np.float64)
        self.moment_inertia = np.zeros((N, 3), dtype=np.float64)


class BondDataSnapshot:
    """Fixed-arity bonded-group table (reference BondedGroupData.h).

    ``group`` holds particle *tags*; arity = 2 (bonds, special pairs,
    constraints), 3 (angles), 4 (dihedrals, impropers).
    """

    def __init__(self, N=0, arity=2, types=None):
        self.arity = arity
        self.N = int(N)
        self.types = list(types) if types else []
        self.typeid = np.zeros(N, dtype=np.int32)
        self.group = np.zeros((N, arity), dtype=np.int32)
        # only used for distance constraints
        self.value = np.zeros(N, dtype=np.float64)

    def resize(self, N):
        N = int(N)
        n = min(self.N, N)
        typeid = np.zeros(N, dtype=np.int32)
        group = np.zeros((N, self.arity), dtype=np.int32)
        value = np.zeros(N, dtype=np.float64)
        typeid[:n] = self.typeid[:n]
        group[:n] = self.group[:n]
        value[:n] = self.value[:n]
        self.typeid, self.group, self.value, self.N = typeid, group, value, N


class BoxSnapshot:
    """Plain-python box description used at the API boundary
    (mirrors hoomd.data.boxdim, reference hoomd/data.py)."""

    def __init__(self, Lx=1.0, Ly=1.0, Lz=1.0, xy=0.0, xz=0.0, yz=0.0,
                 dimensions=3, L=None):
        if L is not None:
            Lx = Ly = Lz = L
        if dimensions == 2:
            Lz = 1.0
        self.Lx, self.Ly, self.Lz = float(Lx), float(Ly), float(Lz)
        self.xy, self.xz, self.yz = float(xy), float(xz), float(yz)
        self.dimensions = int(dimensions)

    def to_box(self, device='cpu'):
        from .box import Box
        return Box.create(self.Lx, self.Ly, self.Lz, self.xy, self.xz,
                          self.yz, dimensions=self.dimensions, device=device)

    def __repr__(self):
        return (f"boxdim(Lx={self.Lx:g}, Ly={self.Ly:g}, Lz={self.Lz:g}, "
                f"xy={self.xy:g}, xz={self.xz:g}, yz={self.yz:g}, "
                f"dimensions={self.dimensions})")


class Snapshot:
    """Full system snapshot: box + particles + topology
    (reference SnapshotSystemData.h)."""

    def __init__(self, N=0, box=None, particle_types=None, bond_types=None,
                 angle_types=None, dihedral_types=None, improper_types=None,
                 pair_types=None):
        self.box = box if box is not None else BoxSnapshot(1, 1, 1)
        self.particles = ParticleDataSnapshot(N, particle_types)
        self.bonds = BondDataSnapshot(0, 2, bond_types)
        self.angles = BondDataSnapshot(0, 3, angle_types)
        self.dihedrals = BondDataSnapshot(0, 4, dihedral_types)
        self.impropers = BondDataSnapshot(0, 4, improper_types)
        self.constraints = BondDataSnapshot(0, 2, None)
        self.pairs = BondDataSnapshot(0, 2, pair_types)

    def replicate(self, nx, ny, nz):
        """Tile the system nx*ny*nz times (reference SnapshotSystemData
        replicate, used by init.create_lattice, hoomd/init.py:86-89)."""
        nx, ny, nz = int(nx), int(ny), int(nz)
        nrep = nx * ny * nz
        p = self.particles
        N = p.N
        old_box = self.box
        h = np.array([
            [old_box.Lx, old_box.xy * old_box.Ly, old_box.xz * old_box.Lz],
            [0.0, old_box.Ly, old_box.yz * old_box.Lz],
            [0.0, 0.0, old_box.Lz],
        ])
        # integer unit-cell offsets in fractional space
        shifts = np.stack(np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz),
            indexing='ij'), axis=-1).reshape(-1, 3)
        # center offsets: copy c spans [-n/2, n/2)
        frac_shift = shifts - np.array([nx, ny, nz]) / 2.0 + 0.5
        cart_shift = frac_shift @ h.T  # (nrep, 3)

        new = Snapshot(N * nrep,
                       BoxSnapshot(old_box.Lx * nx, old_box.Ly * ny,
                                   old_box.Lz * nz, old_box.xy,
                                   old_box.xz, old_box.yz,
                                   dimensions=old_box.dimensions),
                       particle_types=p.types)
        q = new.particles
        # positions: original (centered in old box) + shift
        q.position[:] = (np.tile(p.position, (nrep, 1))
                         + np.repeat(cart_shift, N, axis=0))
        for name in ('velocity', 'acceleration', 'orientation', 'angmom',
                     'moment_inertia'):
            getattr(q, name)[:] = np.tile(getattr(p, name), (nrep, 1))
        for name in ('typeid', 'mass', 'charge', 'diameter', 'body'):
            getattr(q, name)[:] = np.tile(getattr(p, name), nrep)
        q.image[:] = 0

        # topology: shift tags per replica
        for name in ('bonds', 'angles', 'dihedrals', 'impropers',
                     'constraints', 'pairs'):
            src = getattr(self, name)
            dst = getattr(new, name)
            dst.types = list(src.types)
            if src.N:
                dst.resize(src.N * nrep)
                dst.typeid[:] = np.tile(src.typeid, nrep)
                offs = np.repeat(np.arange(nrep) * N, src.N)
                dst.group[:] = (np.tile(src.group, (nrep, 1))
                                + offs[:, None])
                dst.value[:] = np.tile(src.value, nrep)
        return new
