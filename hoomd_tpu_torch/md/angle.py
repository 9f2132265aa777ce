"""Angle potentials (counterpart of hoomd_tpu/md/angle.py): harmonic and
cosinesq, whose forces are written out in ops/bonded.py.  The tabulated
angle raises NotImplementedError, as the JAX package's fast engine
declines it."""

from __future__ import annotations

from ..ops import bonded as _ops
from ._bonded import BondedForce, declined_table


class harmonic(BondedForce):
    """V = k/2 (theta - t0)^2 (md/HarmonicAngleForceCompute.cc).
    angle_coeff.set('type', k=..., t0=...)."""
    _topology = 'angles'
    _term = staticmethod(_ops.angle_harmonic)
    _coeff_names = ('k', 't0')

    def __init__(self, name=None):
        BondedForce.__init__(self, name)
        self.angle_coeff = self.coeff


class cosinesq(BondedForce):
    """V = k/2 (cos theta - cos t0)^2 (md/CosineSqAngleForceCompute.cc)."""
    _topology = 'angles'
    _term = staticmethod(_ops.angle_cosinesq)
    _coeff_names = ('k', 't0')

    def __init__(self, name=None):
        BondedForce.__init__(self, name)
        self.angle_coeff = self.coeff


table = declined_table('angle')
