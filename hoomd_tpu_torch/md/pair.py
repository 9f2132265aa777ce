"""Pair potentials — python API (counterpart of hoomd_tpu/md/pair.py).

The ten pair potentials the cell-stencil engine runs (lj, gauss, yukawa,
morse, mie, buckingham, lj1208, force_shifted_lj, dpd_conservative,
moliere).  The JAX package's slj, reaction_field, ewald, zbl and dlvo
need diameters or charges, which its stencil engine declines too; they
are not ported.  Coefficients follow the reference's
``pair_coeff.set('A', 'B', epsilon=..., ...)`` protocol, with per-pair
r_cut overrides and shift modes 'none' / 'shift' / 'xplor' (the System
gates 'xplor' out of the slice).
"""

from __future__ import annotations

import numpy as np

from .. import context
from ..operation import Force
from ..ops import pair_eval


class coeff:
    """Pair coefficient matrix."""

    def __init__(self):
        self.values = {}
        self.defaults = {}

    @staticmethod
    def _listify(x):
        return x if isinstance(x, (list, tuple)) else [x]

    def set(self, a, b, **coeffs):
        for ta in self._listify(a):
            for tb in self._listify(b):
                key = tuple(sorted((ta, tb)))
                self.values.setdefault(key, {}).update(coeffs)

    def get(self, a, b, name):
        key = tuple(sorted((a, b)))
        if key in self.values and name in self.values[key]:
            return self.values[key][name]
        return self.defaults.get(name)

    def verify(self, types, names, defaults):
        missing = []
        for i, a in enumerate(types):
            for b in types[i:]:
                for n in names:
                    if n not in defaults and self.get(a, b, n) is None:
                        missing.append((a, b, n))
        if missing:
            raise RuntimeError(
                "pair coefficients missing: " +
                ", ".join(f"{a}-{b}:{n}" for a, b, n in missing) +
                " — set them with pair_coeff.set() before run()")


class pair(Force):
    """Shared machinery of isotropic pair potentials."""

    _evaluator = None  # override

    def __init__(self, r_cut, nlist, name=None):
        Force.__init__(self, name)
        self.r_cut = float(r_cut) if r_cut is not None else None
        self.pair_coeff = coeff()
        self.mode = 'none'
        self._nlist = nlist
        context.current.system.add_force(self)

    def set_params(self, mode=None):
        """Energy shift mode: 'none' | 'shift' | 'xplor'."""
        if mode is not None:
            if mode == 'no_shift':
                mode = 'none'
            if mode not in ('none', 'shift', 'xplor'):
                raise ValueError(f"invalid shift mode {mode!r}")
            self.mode = mode
            context.current.system._dirty()

    def _rcut_matrix(self, types):
        nt = len(types)
        m = np.zeros((nt, nt))
        for i, a in enumerate(types):
            for j, b in enumerate(types):
                rc = self.pair_coeff.get(a, b, 'r_cut')
                m[i, j] = self.r_cut if rc is None else rc
        return m

    def _coeff_tables(self, types):
        ev = self._evaluator
        self.pair_coeff.verify(types, ev.coeff_names, ev.defaults)
        nt = len(types)
        raw = {}
        for name in ev.coeff_names:
            t = np.zeros((nt, nt))
            for i, a in enumerate(types):
                for j, b in enumerate(types):
                    v = self.pair_coeff.get(a, b, name)
                    t[i, j] = float(ev.defaults[name] if v is None else v)
            raw[name] = t
        return raw

    def _pack_params(self, system):
        """{'tables': derived coefficient tables, 'rcut': (T, T)}, float32
        host numpy: derived in float32 as the JAX package derives them."""
        types = system.particle_types
        raw = {k: v.astype(np.float32)
               for k, v in self._coeff_tables(types).items()}
        derived = self._evaluator.derive(raw)
        return {'tables': {k: np.asarray(v, np.float32)
                           for k, v in derived.items()},
                'rcut': self._rcut_matrix(types).astype(np.float32)}


def _make_pair_class(eval_name, doc):
    class _P(pair):
        __doc__ = doc
        _evaluator = pair_eval.ALL_EVALUATORS[eval_name]
    _P.__name__ = eval_name
    _P.__qualname__ = eval_name
    return _P


lj = _make_pair_class('lj', "Lennard-Jones pair (md/pair.py lj).")
gauss = _make_pair_class('gauss', "Gaussian pair (md/pair.py gauss).")
yukawa = _make_pair_class('yukawa', "Yukawa pair (md/pair.py yukawa).")
morse = _make_pair_class('morse', "Morse pair (md/pair.py morse).")
mie = _make_pair_class('mie', "Mie pair (md/pair.py mie).")
buckingham = _make_pair_class('buckingham',
                              "Buckingham pair (md/pair.py buckingham).")
lj1208 = _make_pair_class('lj1208', "LJ 12-8 pair (md/pair.py lj1208).")
force_shifted_lj = _make_pair_class(
    'force_shifted_lj', "Force-shifted LJ (md/pair.py force_shifted_lj).")
dpd_conservative = _make_pair_class(
    'dpd_conservative', "Conservative DPD (md/pair.py dpd_conservative).")
moliere = _make_pair_class('moliere', "Moliere screening (md/pair.py).")
