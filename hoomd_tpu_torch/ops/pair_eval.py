"""Pair potential evaluators (counterpart of hoomd_tpu/ops/pair_eval.py).

The ten evaluators the cell-stencil engine runs, the JAX package's
``FAST_EVALS``: lj, gauss, yukawa, morse, mie, buckingham, lj1208,
force_shifted_lj, dpd_conservative and moliere.  Contract as in the JAX
package: given r^2 and per-pair parameters, return (force_divr,
pair_energy) with force_divr = -(dV/dr)/r, elementwise on tensors.
``derive`` runs on the host's float32 numpy coefficient tables.

The CUDA kernels (csrc/cell_stencil.cuh) carry one device evaluator per
name, picked by ``EVAL_IDS``; each reads its parameters in the order of
``kernel_pnames``: the derived table names sorted, then 'rcut' — the
tuple the System builds for the kernels' parameter vector [rc2, e_shift,
*pnames].
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


class gauss:
    """Gaussian. V = eps exp(-r^2/(2 sig^2))."""
    coeff_names = ('epsilon', 'sigma')
    defaults = {}

    @staticmethod
    def derive(p):
        return {'epsilon': p['epsilon'], 'sigma2': p['sigma'] ** 2}

    @staticmethod
    def energy_force(r2, p):
        e = p['epsilon'] * torch.exp(-0.5 * r2 / p['sigma2'])
        fdivr = e / p['sigma2']
        return fdivr, e


class yukawa:
    """Screened Coulomb. V = eps exp(-kappa r)/r."""
    coeff_names = ('epsilon', 'kappa')
    defaults = {}

    @staticmethod
    def derive(p):
        return dict(p)

    @staticmethod
    def energy_force(r2, p):
        r = torch.sqrt(r2)
        ex = torch.exp(-p['kappa'] * r)
        e = p['epsilon'] * ex / r
        fdivr = e * (p['kappa'] * r + 1.0) / r2
        return fdivr, e


class morse:
    """Morse. V = D0 [exp(-2 alpha (r-r0)) - 2 exp(-alpha (r-r0))]."""
    coeff_names = ('D0', 'alpha', 'r0')
    defaults = {}

    @staticmethod
    def derive(p):
        return dict(p)

    @staticmethod
    def energy_force(r2, p):
        r = torch.sqrt(r2)
        ex = torch.exp(-p['alpha'] * (r - p['r0']))
        e = p['D0'] * (ex * ex - 2.0 * ex)
        fdivr = 2.0 * p['D0'] * p['alpha'] * (ex * ex - ex) / r
        return fdivr, e


class mie:
    """Mie n-m potential."""
    coeff_names = ('epsilon', 'sigma', 'n', 'm')
    defaults = {'n': 12.0, 'm': 6.0}

    @staticmethod
    def derive(p):
        n, m = p['n'], p['m']
        pref = (n / (n - m)) * (n / m) ** (m / (n - m)) * p['epsilon']
        return {'c_n': pref * p['sigma'] ** n,
                'c_m': pref * p['sigma'] ** m,
                'n': n, 'm': m}

    @staticmethod
    def energy_force(r2, p):
        r = torch.sqrt(r2)
        rn = r ** (-p['n'])
        rm = r ** (-p['m'])
        e = p['c_n'] * rn - p['c_m'] * rm
        fdivr = (p['n'] * p['c_n'] * rn - p['m'] * p['c_m'] * rm) / r2
        return fdivr, e


class buckingham:
    """Buckingham. V = A exp(-r/rho) - C/r^6."""
    coeff_names = ('A', 'rho', 'C')
    defaults = {}

    @staticmethod
    def derive(p):
        return dict(p)

    @staticmethod
    def energy_force(r2, p):
        r = torch.sqrt(r2)
        ex = p['A'] * torch.exp(-r / p['rho'])
        r2inv = 1.0 / r2
        r6inv = r2inv * r2inv * r2inv
        e = ex - p['C'] * r6inv
        fdivr = ex / (p['rho'] * r) - 6.0 * p['C'] * r6inv * r2inv
        return fdivr, e


class lj1208:
    """12-8 LJ. V = 4 eps [ (sig/r)^12 - alpha (sig/r)^8 ]."""
    coeff_names = ('epsilon', 'sigma', 'alpha')
    defaults = {'alpha': 1.0}

    @staticmethod
    def derive(p):
        s8 = p['sigma'] ** 8
        return {'lj1': 4.0 * p['epsilon'] * p['sigma'] ** 12,
                'lj2': 4.0 * p['epsilon'] * p['alpha'] * s8}

    @staticmethod
    def energy_force(r2, p):
        r2inv = 1.0 / r2
        r4inv = r2inv * r2inv
        r8inv = r4inv * r4inv
        e = p['lj1'] * r8inv * r4inv - p['lj2'] * r8inv
        fdivr = r2inv * r8inv * (12.0 * p['lj1'] * r4inv - 8.0 * p['lj2'])
        return fdivr, e


class force_shifted_lj:
    """Force-shifted LJ: F goes smoothly to zero at r_cut; reads
    p['rcut'], which the System appends."""
    coeff_names = ('epsilon', 'sigma', 'alpha')
    defaults = {'alpha': 1.0}

    @staticmethod
    def derive(p):
        s6 = p['sigma'] ** 6
        return {'lj1': 4.0 * p['epsilon'] * s6 * s6,
                'lj2': 4.0 * p['epsilon'] * p['alpha'] * s6}

    @staticmethod
    def energy_force(r2, p):
        def raw(r2):
            r2inv = 1.0 / r2
            r6inv = r2inv * r2inv * r2inv
            f = r2inv * r6inv * (12.0 * p['lj1'] * r6inv - 6.0 * p['lj2'])
            e = r6inv * (p['lj1'] * r6inv - p['lj2'])
            return f, e
        f, e = raw(r2)
        rc = p['rcut']
        f_rc, e_rc = raw(rc ** 2)
        r = torch.sqrt(r2)
        # F_fs(r) = F(r) - F(rc);  V_fs(r) = V(r) - V(rc) + (r - rc) F(rc)
        fmag_rc = f_rc * rc
        return f - fmag_rc / r, e - e_rc + (r - rc) * fmag_rc


class dpd_conservative:
    """Conservative DPD: F = A (1 - r/rc) rhat; V = A rc/2 (1 - r/rc)^2;
    reads p['rcut']."""
    coeff_names = ('A',)
    defaults = {}

    @staticmethod
    def derive(p):
        return dict(p)

    @staticmethod
    def energy_force(r2, p):
        r = torch.sqrt(r2)
        rc = p['rcut']
        w = torch.clamp(1.0 - r / rc, min=0.0)
        e = 0.5 * p['A'] * rc * w * w
        fdivr = p['A'] * w / r
        return fdivr, e


class moliere:
    """Moliere screened Coulomb.
    V = Zi Zj e^2 / r * sum_k c_k exp(-d_k r / aF)."""
    coeff_names = ('Z_i', 'Z_j', 'elementary_charge', 'a_0')
    defaults = {'elementary_charge': 1.0, 'a_0': 1.0}
    # the screening function's coefficients, as float32 literals in the
    # kernels (csrc/cell_stencil.cuh)
    _c = (0.35, 0.55, 0.10)
    _d = (0.3, 1.2, 6.0)

    @staticmethod
    def derive(p):
        e2 = p['elementary_charge'] ** 2
        Zsq = p['Z_i'] * p['Z_j'] * e2
        aF = 0.8853 * p['a_0'] / (np.sqrt(p['Z_i'])
                                  + np.sqrt(p['Z_j'])) ** (2.0 / 3.0)
        return {'Zsq': Zsq, 'aF': aF}

    @classmethod
    def energy_force(cls, r2, p):
        r = torch.sqrt(r2)
        e = torch.zeros_like(r)
        fdivr = torch.zeros_like(r)
        for c, d in zip(cls._c, cls._d):
            ex = torch.exp(-d * r / p['aF'])
            e = e + c * ex
            fdivr = fdivr + c * ex * (1.0 / r + d / p['aF'])
        pref = p['Zsq'] / r
        return pref * fdivr / r, pref * e


# the stencil engine's evaluators (hoomd_tpu/system.py FAST_EVALS), by the
# id the kernels take (enum Eval in csrc/cell_stencil.cuh, same order)
FAST_EVALS = ('lj', 'gauss', 'yukawa', 'morse', 'mie', 'buckingham',
              'lj1208', 'force_shifted_lj', 'dpd_conservative', 'moliere')
ALL_EVALUATORS = {name: globals()[name] for name in FAST_EVALS}
EVAL_IDS = {name: i for i, name in enumerate(FAST_EVALS)}


@functools.lru_cache(maxsize=None)
def kernel_pnames(eval_name):
    """The parameter names of ``eval_name`` in the order the kernels read
    them after [rc2, e_shift]: its derived table names, sorted, then
    'rcut' (as the System builds pnames from the packed tables)."""
    ev = ALL_EVALUATORS[eval_name]
    probe = {n: np.ones(1, np.float32) * np.float32(ev.defaults.get(n, 1.0))
             for n in ev.coeff_names}
    return tuple(sorted(ev.derive(probe).keys())) + ('rcut',)


def params_dict(params_vec, pnames, ti=None, tj=None):
    """[rc2, e_shift, *pnames] -> (rc2, e_shift, {name: value}).

    One type: params_vec is (2 + NP,) and every value a scalar.  A
    mixture: params_vec is the (2 + NP, T, T) per-pair table and ti, tj
    are the two particles' type ids (int tensors that broadcast against
    each other); every value is then gathered per pair as
    table[k, ti, tj] (hoomd_tpu/ops/pallas_pair.py:252-262)."""
    if ti is not None:
        params_vec = params_vec[:, ti, tj]
    return params_vec[0], params_vec[1], {
        nm: params_vec[2 + k] for k, nm in enumerate(pnames)}
