"""Thermodynamic computes (counterpart of hoomd_tpu/compute.py):
``thermo(group)`` reads a group's temperature, pressure and energies
from System.thermo_quantities."""

from __future__ import annotations

from . import context


def _sys():
    return context.current.system


class thermo:
    """Group thermodynamics (reference compute.thermo)."""

    def __init__(self, group):
        self.group = group

    def _q(self):
        return _sys().thermo_quantities(self.group.member_tags)

    @property
    def temperature(self):
        return self._q()['temperature']

    @property
    def pressure(self):
        return self._q()['pressure']

    @property
    def kinetic_energy(self):
        return self._q()['kinetic_energy']

    @property
    def potential_energy(self):
        return self._q()['potential_energy']

    def query(self, name):
        return self._q()[name]

    def disable(self):
        pass

    def enable(self):
        pass
