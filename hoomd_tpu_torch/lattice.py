"""Lattice unit cells and generators (counterpart of hoomd_tpu/lattice.py;
reference hoomd/lattice.py:102-421).

``unitcell`` describes one triclinic unit cell with an arbitrary basis;
helpers sc/bcc/fcc build the standard 3D cells (the slice runs 3D boxes
only).  ``unitcell.get_snapshot`` produces a host Snapshot which
init.create_lattice replicates.
"""

from __future__ import annotations

import numpy as np

from .snapshot import BoxSnapshot, Snapshot


class unitcell:
    """A triclinic unit cell with N basis particles (lattice.py:102)."""

    def __init__(self, N, a1, a2, a3, dimensions=3, position=None,
                 type_name=None, mass=None, charge=None, diameter=None,
                 moment_inertia=None, orientation=None):
        self.N = int(N)
        self.a1 = np.asarray(a1, dtype=np.float64)
        self.a2 = np.asarray(a2, dtype=np.float64)
        self.a3 = np.asarray(a3, dtype=np.float64)
        self.dimensions = dimensions
        self.position = (np.zeros((N, 3)) if position is None
                         else np.asarray(position, dtype=np.float64))
        self.type_name = (['A'] * N if type_name is None else list(type_name))
        self.mass = np.ones(N) if mass is None else np.asarray(mass)
        self.charge = np.zeros(N) if charge is None else np.asarray(charge)
        self.diameter = (np.ones(N) if diameter is None
                         else np.asarray(diameter))
        self.moment_inertia = (np.zeros((N, 3)) if moment_inertia is None
                               else np.asarray(moment_inertia))
        self.orientation = (np.tile([1.0, 0, 0, 0], (N, 1))
                            if orientation is None
                            else np.asarray(orientation))

    def get_snapshot(self) -> Snapshot:
        """Build a one-cell snapshot; box from the lattice vectors
        (lattice.py:247).  Requires a1 along x, a2 in the xy plane."""
        a1, a2, a3 = self.a1, self.a2, self.a3
        if abs(a1[1]) > 1e-12 or abs(a1[2]) > 1e-12 or abs(a2[2]) > 1e-12:
            raise ValueError("unitcell requires a1 along x and a2 in the "
                             "xy plane (as the reference does)")
        Lx = a1[0]
        Ly = a2[1]
        Lz = a3[2] if self.dimensions == 3 else 1.0
        xy = a2[0] / Ly
        xz = a3[0] / Lz if self.dimensions == 3 else 0.0
        yz = a3[1] / Lz if self.dimensions == 3 else 0.0
        types = sorted(set(self.type_name))
        box = BoxSnapshot(Lx, Ly, Lz, xy, xz, yz,
                          dimensions=self.dimensions)
        snap = Snapshot(self.N, box, particle_types=types)
        p = snap.particles
        # center basis positions in the box
        lo = -0.5 * (a1 + a2 + (a3 if self.dimensions == 3
                                else np.array([0, 0, 0.0])))
        if self.dimensions == 2:
            lo[2] = 0.0
        p.position[:] = self.position + lo
        p.typeid[:] = [types.index(t) for t in self.type_name]
        p.mass[:] = self.mass
        p.charge[:] = self.charge
        p.diameter[:] = self.diameter
        p.moment_inertia[:] = self.moment_inertia
        p.orientation[:] = self.orientation
        return snap


def sc(a, type_name='A'):
    """Simple cubic (lattice.py:262)."""
    return unitcell(1, [a, 0, 0], [0, a, 0], [0, 0, a],
                    position=[[a / 2, a / 2, a / 2]], type_name=[type_name])


def bcc(a, type_name='A'):
    return unitcell(2, [a, 0, 0], [0, a, 0], [0, 0, a],
                    position=[[0, 0, 0], [a / 2, a / 2, a / 2]],
                    type_name=[type_name] * 2)


def fcc(a, type_name='A'):
    return unitcell(4, [a, 0, 0], [0, a, 0], [0, 0, a],
                    position=[[0, 0, 0], [0, a / 2, a / 2],
                              [a / 2, 0, a / 2], [a / 2, a / 2, 0]],
                    type_name=[type_name] * 4)
