"""Bond potentials (counterpart of hoomd_tpu/md/bond.py): harmonic and
fene, whose forces are written out in ops/bonded.py.  The tabulated bond
raises NotImplementedError, as the JAX package's fast engine declines
it."""

from __future__ import annotations

from ..ops import bonded as _ops
from ._bonded import BondedForce, declined_table


class harmonic(BondedForce):
    """V = k/2 (r - r0)^2.  bond_coeff.set('type', k=..., r0=...)."""
    _topology = 'bonds'
    _term = staticmethod(_ops.bond_harmonic)
    _coeff_names = ('k', 'r0')

    def __init__(self, name=None):
        BondedForce.__init__(self, name)
        self.bond_coeff = self.coeff


class fene(BondedForce):
    """FENE + WCA bond (md/bond.py fene).
    bond_coeff.set('type', k=..., r0=..., sigma=..., epsilon=...)."""
    _topology = 'bonds'
    _term = staticmethod(_ops.bond_fene)
    _coeff_names = ('k', 'r0', 'sigma', 'epsilon')

    def __init__(self, name=None):
        BondedForce.__init__(self, name)
        self.bond_coeff = self.coeff


table = declined_table('bond')
