"""Integration mode and two-step methods (counterpart of
hoomd_tpu/md/integrate.py): mode_standard, nve, langevin and nvt.

The methods describe the integrator; the cell-major engine
(ops/fast_lj.py) does the stepping.  Nose-Hoover's xi and eta are the
method's aux state, carried across runs as 0-d tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context, variant
from ..operation import IntegrationMethod


class mode_standard:
    """Enables integration methods with a shared dt."""

    def __init__(self, dt, aniso=None):
        self.dt = float(dt)
        self.aniso = aniso
        context.current.system.set_integrator_mode(self)

    def set_params(self, dt=None, aniso=None):
        if dt is not None:
            self.dt = float(dt)
        if aniso is not None:
            self.aniso = aniso
        if context.current and context.current.system:
            context.current.system._refresh_params()


class _method(IntegrationMethod):
    def __init__(self, group):
        IntegrationMethod.__init__(self, group)
        context.current.system.add_integration_method(self)

    def _pack_params(self, system):
        return {}


class nve(_method):
    """Constant-energy velocity Verlet."""

    def __init__(self, group, limit=None, zero_force=False):
        _method.__init__(self, group)
        self.limit = limit
        self.zero_force = bool(zero_force)


class langevin(_method):
    """Langevin dynamics: velocity Verlet with drag -gamma v and uniform
    random kicks sqrt(6 gamma kT / dt) * U(-1, 1) in the second half
    step, keyed by (seed, timestep, tag, axis).  gamma is per type
    (set_gamma, default 1.0): each particle takes its own type's, which
    reaches the engine as a (T,) table."""

    def __init__(self, group, kT, seed, dscale=False, tally=False,
                 noiseless_t=False, noiseless_r=False):
        _method.__init__(self, group)
        self.kT = variant.as_variant(kT)
        self.seed = int(seed)
        self.dscale = dscale
        self.noiseless_t = bool(noiseless_t)
        self.gamma = {}

    def set_gamma(self, type_name, gamma):
        self.gamma[type_name] = float(gamma)
        context.current.system._dirty()

    def set_params(self, kT=None):
        if kT is not None:
            self.kT = variant.as_variant(kT)
            context.current.system._refresh_params()

    def _pack_params(self, system):
        gam = np.array([self.gamma.get(t, 1.0)
                        for t in system.particle_types])
        return {'gamma': gam, 'kT': self.kT.pack(torch.float32,
                                                 system.device)}


class nvt(_method):
    """Nose-Hoover (MTK) thermostat with thermostat variables xi and
    eta."""

    def __init__(self, group, kT, tau):
        _method.__init__(self, group)
        self.kT = variant.as_variant(kT)
        self.tau = float(tau)

    def set_params(self, kT=None, tau=None):
        if kT is not None:
            self.kT = variant.as_variant(kT)
        if tau is not None:
            self.tau = float(tau)
        context.current.system._refresh_params()

    def _pack_params(self, system):
        return {'kT': self.kT.pack(torch.float32, system.device),
                'tau': self.tau}

    def _init_aux(self, device):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return {'xi': z, 'eta': z.clone()}
