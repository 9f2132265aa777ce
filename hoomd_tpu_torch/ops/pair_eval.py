"""Pair potential evaluators (counterpart of hoomd_tpu/ops/pair_eval.py).

The slice carries ``lj`` only.  Contract as in the JAX package: given
r^2 and per-pair parameters, return (force_divr, pair_energy) with
force_divr = -(dV/dr)/r, elementwise on tensors.
"""

from __future__ import annotations


class lj:
    """Lennard-Jones. V = 4 eps [ (sig/r)^12 - alpha (sig/r)^6 ]."""
    coeff_names = ('epsilon', 'sigma', 'alpha')
    defaults = {'alpha': 1.0}

    @staticmethod
    def derive(p):
        s6 = p['sigma'] ** 6
        return {'lj1': 4.0 * p['epsilon'] * s6 * s6,
                'lj2': 4.0 * p['epsilon'] * p['alpha'] * s6}

    @staticmethod
    def energy_force(r2, p):
        r2inv = 1.0 / r2
        r6inv = r2inv * r2inv * r2inv
        fdivr = r2inv * r6inv * (12.0 * p['lj1'] * r6inv - 6.0 * p['lj2'])
        e = r6inv * (p['lj1'] * r6inv - p['lj2'])
        return fdivr, e
