"""Integration mode and two-step methods (counterpart of
hoomd_tpu/md/integrate.py): mode_standard, nve, langevin and nvt.

The methods describe the integrator.  On the cell-major engine
(ops/fast_lj.py) the engine does the stepping; on the general engine
each method's ``_step1`` (drift) and ``_step2`` (kick) advance the
particles of its group, out of place, in the JAX package's operation
order: velocity Verlet split around the force evaluation, the group a
per-tag mask.  Langevin draws its noise from the threefry streams of
rng.py keyed by (seed, timestep, tag), bit for bit the JAX package's,
and keeps its drag and noise in net_force for the next half-kick, as the
reference does.  Nose-Hoover's xi and eta are the method's aux state,
carried across runs and engines as 0-d tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context, rng, variant
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
    """Common packing (the group's per-tag mask) and the velocity-Verlet
    halves of the general engine."""

    # the salt of the general engine's step keys: methods that draw noise
    _needs_key = False

    def __init__(self, group):
        IntegrationMethod.__init__(self, group)
        context.current.system.add_integration_method(self)

    def _base_params(self, system):
        member = np.zeros(system.state.N, dtype=bool)
        member[self.group.member_tags] = True
        return {'member': torch.as_tensor(member, device=system.device)}

    def _ndof(self, system):
        """Translational degrees of freedom of this group."""
        return system.state.box.dimensions * len(self.group.member_tags)

    @staticmethod
    def _mask(state, params):
        return params['member'][state.tag.long()]

    @staticmethod
    def _vv_drift(state, params, dt):
        """v += a dt/2; x += v dt; wrap."""
        mask = _method._mask(state, params)[:, None]
        a = state.net_force / state.mass[:, None]
        v = torch.where(mask, state.vel + 0.5 * dt * a, state.vel)
        pos = torch.where(mask, state.pos + dt * v, state.pos)
        pos, image = state.box.wrap(pos, state.image)
        return state.replace(pos=pos, vel=v, image=image)

    @staticmethod
    def _vv_kick(state, params, dt):
        """v += a dt/2."""
        mask = _method._mask(state, params)[:, None]
        a = state.net_force / state.mass[:, None]
        v = torch.where(mask, state.vel + 0.5 * dt * a, state.vel)
        return state.replace(vel=v)

    @staticmethod
    def _group_temperature(state, params, ndof):
        mask = _method._mask(state, params)
        ke2 = torch.where(mask, state.mass * (state.vel ** 2).sum(-1),
                          0.0).sum()
        return ke2 / ndof

    def _pack_params(self, system):
        return self._base_params(system)

    def _step1(self, state, aux, params, dt, key):
        return self._vv_drift(state, params, dt), aux

    def _step2(self, state, aux, params, dt, key):
        return self._vv_kick(state, params, dt), aux


class nve(_method):
    """Constant-energy velocity Verlet; ``limit`` caps each step's
    displacement, ``zero_force`` integrates with the forces ignored."""

    def __init__(self, group, limit=None, zero_force=False):
        _method.__init__(self, group)
        self.limit = limit
        self.zero_force = bool(zero_force)

    def set_params(self, limit=None, zero_force=None):
        if limit is not None:
            self.limit = limit
        if zero_force is not None:
            self.zero_force = bool(zero_force)
        context.current.system._dirty()

    def _step1(self, state, aux, params, dt, key):
        mask = self._mask(state, params)[:, None]
        a = 0.0 if self.zero_force else state.net_force / state.mass[:, None]
        v = torch.where(mask, state.vel + 0.5 * dt * a, state.vel)
        dx = dt * v
        if self.limit is not None:
            lim = torch.tensor(float(self.limit), dtype=state.pos.dtype,
                               device=state.pos.device)
            n = torch.sqrt((dx * dx).sum(-1, keepdim=True))
            dx = torch.where(n > lim, dx * (lim / n), dx)
        pos = torch.where(mask, state.pos + dx, state.pos)
        pos, image = state.box.wrap(pos, state.image)
        return state.replace(pos=pos, vel=v, image=image), aux

    def _step2(self, state, aux, params, dt, key):
        if self.zero_force:
            return state, aux
        return self._vv_kick(state, params, dt), aux


class langevin(_method):
    """Langevin dynamics: velocity Verlet with drag -gamma v and uniform
    random kicks sqrt(6 gamma kT / dt) * U(-1, 1) in the second half
    step, keyed by (seed, timestep, tag, axis).  gamma is per type
    (set_gamma, default 1.0), or with ``dscale`` the particle's diameter
    times it; ``noiseless_t`` drops the kicks."""

    _needs_key = True

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
        """'gamma' per type as host numpy (the cell engine's), and as a
        device tensor beside the mask and kT."""
        gam = np.array([self.gamma.get(t, 1.0)
                        for t in system.particle_types])
        p = self._base_params(system)
        p.update(gamma=gam,
                 gamma_dev=torch.as_tensor(gam, dtype=torch.float32,
                                           device=system.device),
                 kT=self.kT.pack(torch.float32, system.device))
        return p

    def _step2(self, state, aux, params, dt, key):
        mask = self._mask(state, params)[:, None]
        kT = variant.eval_packed(params['kT'], state.timestep)
        if self.dscale:
            gamma = (torch.tensor(float(self.dscale), dtype=state.pos.dtype,
                                  device=state.pos.device)
                     * state.diameter)[:, None]
        else:
            gamma = params['gamma_dev'][state.typeid.long()][:, None]
        if self.noiseless_t:
            f_rand = 0.0
        else:
            coeff = torch.sqrt(6.0 * gamma * kT / dt)
            f_rand = coeff * rng.uniform_by_tag(key, state.tag, (3,))
        # the drag and noise join the stored force, so they also drive the
        # next step's first half-kick (TwoStepLangevin.cc:299-315)
        f_tot = state.net_force + f_rand - gamma * state.vel
        v = torch.where(mask,
                        state.vel + 0.5 * dt * f_tot / state.mass[:, None],
                        state.vel)
        f_keep = torch.where(mask, f_tot, state.net_force)
        return state.replace(vel=v, net_force=f_keep), aux


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
        """'tau' a host float (the cell engine's), and as a device tensor
        beside the mask, kT and the group's degrees of freedom."""
        dev = system.device
        p = self._base_params(system)
        p.update(kT=self.kT.pack(torch.float32, dev), tau=self.tau,
                 tau_dev=torch.tensor(self.tau, dtype=torch.float32,
                                      device=dev),
                 ndof=torch.tensor(float(self._ndof(system)),
                                   dtype=torch.float32, device=dev))
        return p

    def _init_aux(self, device):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return {'xi': z, 'eta': z.clone()}

    def _step1(self, state, aux, params, dt, key):
        kT0 = variant.eval_packed(params['kT'], state.timestep)
        T = self._group_temperature(state, params, params['ndof'])
        xi = aux['xi'] + 0.5 * dt * (T / kT0 - 1.0) / params['tau_dev'] ** 2
        s = torch.exp(-0.5 * dt * xi)
        mask = self._mask(state, params)[:, None]
        state = state.replace(vel=torch.where(mask, state.vel * s, state.vel))
        state = self._vv_drift(state, params, dt)
        return state, {'xi': xi, 'eta': aux['eta'] + dt * xi}

    def _step2(self, state, aux, params, dt, key):
        state = self._vv_kick(state, params, dt)
        kT0 = variant.eval_packed(params['kT'], state.timestep)
        xi = aux['xi']
        s = torch.exp(-0.5 * dt * xi)
        mask = self._mask(state, params)[:, None]
        state = state.replace(vel=torch.where(mask, state.vel * s, state.vel))
        T = self._group_temperature(state, params, params['ndof'])
        xi = xi + 0.5 * dt * (T / kT0 - 1.0) / params['tau_dev'] ** 2
        return state, dict(aux, xi=xi)
