"""Snapshot construction and live system data access
(counterpart of hoomd_tpu/data.py)."""

from __future__ import annotations

from .snapshot import BoxSnapshot as boxdim  # noqa: F401  (hoomd.data.boxdim)
from .snapshot import Snapshot


def make_snapshot(N, box, particle_types=None, bond_types=None,
                  angle_types=None, dihedral_types=None,
                  improper_types=None, pair_types=None, dtype='float'):
    """Empty snapshot with N particles."""
    if particle_types is None:
        particle_types = ['A']
    return Snapshot(N, box, particle_types=particle_types,
                    bond_types=bond_types, angle_types=angle_types,
                    dihedral_types=dihedral_types,
                    improper_types=improper_types, pair_types=pair_types)


class system_data:
    """Live access to the running system."""

    def __init__(self, system):
        self._system = system

    @property
    def box(self):
        st = self._system.state
        L, t, _ = st.box.to_numpy()
        return boxdim(L[0], L[1], L[2], t[0], t[1], t[2],
                      dimensions=st.box.dimensions)

    def take_snapshot(self, particles=True, bonds=False, all=False,
                      dtype='float'):
        return self._system.take_snapshot()

    def restore_snapshot(self, snapshot):
        self._system.restore_snapshot(snapshot)
