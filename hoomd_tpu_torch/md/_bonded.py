"""Shared machinery of the fixed-topology (bonded) force APIs (counterpart
of hoomd_tpu/md/_bonded.py).

Topology is the snapshot's (M, arity) tag table of a kind (bonds,
angles); the cell engine maps it to particle slots at every rebuild
(ops/fast_lj.py) and evaluates the kind's term of ops/bonded.py there.
The port has no general engine, so the JAX package's per-force compute
closure (_make_compute) has no counterpart here.
"""

from __future__ import annotations

import numpy as np

from .. import context
from ..operation import Force


class type_coeff:
    """Per-bonded-type coefficients (reference md/bond.py coeff class)."""

    def __init__(self):
        self.values = {}

    def set(self, type_name, **coeffs):
        names = (type_name if isinstance(type_name, (list, tuple))
                 else [type_name])
        for t in names:
            self.values.setdefault(t, {}).update(coeffs)

    def get(self, type_name, name, default=None):
        v = self.values.get(type_name, {})
        return v.get(name, default)

    def verify(self, types, names, defaults):
        missing = [(t, n) for t in types for n in names
                   if n not in defaults and self.get(t, n) is None]
        if missing:
            raise RuntimeError(
                "bonded coefficients missing: "
                + ", ".join(f"{t}:{n}" for t, n in missing))


class BondedForce(Force):
    """Base of the bond and angle forces.

    Subclass attributes:
      _topology: the snapshot's attribute ('bonds', 'angles')
      _term: the ops.bonded term
      _coeff_names / _defaults: per-type parameters
    """

    _topology = 'bonds'
    _term = None
    _coeff_names = ()
    _defaults = {}

    def __init__(self, name=None):
        Force.__init__(self, name)
        self.coeff = type_coeff()
        context.current.system.add_force(self)

    def _topology_data(self, system):
        data = getattr(system.snapshot_template, self._topology)
        if data.N == 0:
            raise RuntimeError(
                f"{type(self).__name__}: the system has no "
                f"{self._topology} defined")
        return data

    def _pack_params(self, system):
        """name -> (M,) float32 host numpy: each group's coefficients from
        its type (hoomd_tpu/md/_bonded.py:78-89)."""
        data = self._topology_data(system)
        types = data.types
        self.coeff.verify(types, self._coeff_names, self._defaults)
        params = {}
        for n in self._coeff_names:
            per_type = np.array(
                [float(self.coeff.get(t, n, self._defaults.get(n)))
                 for t in types])
            params[n] = per_type[np.asarray(data.typeid)].astype(np.float32)
        return params


def declined_table(kind):
    """A tabulated bonded potential, which the JAX package's fast engine
    declines (hoomd_tpu/system.py:468-469) and the port does not run."""
    class table:
        def __init__(self, width, name=None):
            raise NotImplementedError(
                f"hoomd_tpu_torch runs the cell-major LJ engine only, and "
                f"{kind}.table is outside it: table bonded potential")
    table.__qualname__ = 'table'
    table.__doc__ = (f"Tabulated {kind} potential: not run by the port "
                     f"(NotImplementedError).")
    return table
