"""Fixed-topology (bonded) force terms (counterpart of
hoomd_tpu/ops/bonded.py): bonds, angles and the cell engine's
nlist-exclusion corrections.

Each term is a function ``term(disps, p, want_e) -> (energy, grads)`` of
the min-imaged displacement vectors along a group, disps = (b_0, ...,
b_{arity-2}) with b_k = r_{k+1} - r_k, each (M, 3), and of its per-group
parameters p (name -> (M,) tensor): the group's energy (M,) (None unless
want_e) and g_k = dE/db_k, each (M, 3).  The JAX package takes g_k from
``jax.grad`` of the energy; here each term writes its derivative out, with
the JAX forms' branches: every clip and ``where`` there has a zero
gradient on its far side, so a clipped FENE bond, a WCA pair past 2^(1/6)
sigma and an angle outside the clip of its cosine give no force.

``bonded_force`` sums one kind over its groups (F_i = g_i - g_{i-1}), with
the group's energy and virial (-sum_k b_k (x) g_k) split equally among its
members, as the JAX driver does.  Group tables hold slot indices; a row
with an index >= the number of positions is padding and adds nothing.
The box is orthorhombic and periodic (the cell engine's gate), so the
minimum image is d - L round(d / L) per axis, which rounds as the JAX
package's Box.min_image does on such a box.
"""

from __future__ import annotations

import math

import torch

# 2^(-1/3): the WCA cut of the FENE bond in (sigma / r)^2
_WCA_S2 = 2.0 ** (-1.0 / 3.0)
# the clip of an angle's cosine (hoomd_tpu/ops/bonded.py:57-59)
_COS_CLIP = 1.0 - 1e-7
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def min_image(d, L):
    """Nearest periodic image of displacements d (..., 3) in the
    orthorhombic periodic box of edge lengths L (3,)."""
    return d - L * torch.round(d / L)


def _norm(b):
    """The JAX package's _safe_norm sqrt(max(|b|^2, 1e-12)), the clamped
    square it takes, and where |b|^2 lies above the clamp (the clamp's
    gradient: 1 there, else 0)."""
    s_raw = (b * b).sum(-1)
    s = torch.clamp(s_raw, min=1e-12)
    return torch.sqrt(s), s, s_raw > 1e-12


# --------------------------------------------------------------------------
# bonds


def bond_harmonic(disps, p, want_e):
    """V = k/2 (r - r0)^2 (md/bond.py harmonic)."""
    b = disps[0]
    r, _, free = _norm(b)
    dr = r - p['r0']
    dedr = p['k'] * dr * free
    e = 0.5 * p['k'] * dr * dr if want_e else None
    return e, ((dedr / r)[:, None] * b,)


def bond_fene(disps, p, want_e):
    """FENE + WCA (md/bond.py fene): V = -k/2 r0^2 ln(1 - x) with x =
    (r / r0)^2 clipped to [0, 0.99], plus 4 eps (s^12 - s^6) + eps with s =
    sigma / r where (sigma / r)^2 > 2^(-1/3), else 0."""
    b = disps[0]
    r, _, free = _norm(b)
    x_raw = (r / p['r0']) ** 2
    x = torch.clamp(x_raw, 0.0, 0.99)
    # dV/dr of the FENE part: k r / (1 - x) inside the clip, else 0
    dfene = torch.where((x_raw > 0.0) & (x_raw < 0.99),
                        p['k'] * r / (1.0 - x), 0.0)
    r2 = r * r
    s2 = p['sigma'] ** 2 / torch.clamp(r2, min=1e-12)
    s6 = s2 * s2 * s2
    on = s2 > _WCA_S2
    # dV/dr of the WCA part: -24 eps s^6 (2 s^6 - 1) / r where it is on
    dwca = torch.where(on & (r2 > 1e-12),
                       -24.0 * p['epsilon'] * s6 * (2.0 * s6 - 1.0) / r, 0.0)
    dedr = (dfene + dwca) * free
    e = None
    if want_e:
        fene = -0.5 * p['k'] * p['r0'] ** 2 * torch.log1p(-x)
        wca = torch.where(on, 4.0 * p['epsilon'] * (s6 * s6 - s6)
                          + p['epsilon'], 0.0)
        e = fene + wca
    return e, ((dedr / r)[:, None] * b,)


# --------------------------------------------------------------------------
# angles: group (a, b, c), disps (b - a, c - b); theta is the angle at b
# between a - b and c - b, cos theta = (-d1) . d2 / (|d1| |d2|)


def _cos_and_grads(disps):
    """cos theta clipped to +-(1 - 1e-7), whether it lies strictly inside
    the clip, and d cos / d d1, d cos / d d2."""
    d1, d2 = disps
    n1, s1, free1 = _norm(d1)
    n2, s2, free2 = _norm(d2)
    u = (-d1 * d2).sum(-1)
    nn = n1 * n2
    c_raw = u / nn
    c = torch.clamp(c_raw, -_COS_CLIP, _COS_CLIP)
    inside = (c_raw > -_COS_CLIP) & (c_raw < _COS_CLIP)
    # d c / d d1 = -d2 / (n1 n2) - c d1 / n1^2 (the norm's term only where
    # its clamp is off), and the same with d1, d2 swapped
    dc1 = -d2 / nn[:, None] - (c_raw * free1 / s1)[:, None] * d1
    dc2 = -d1 / nn[:, None] - (c_raw * free2 / s2)[:, None] * d2
    return c, inside, dc1, dc2


def angle_harmonic(disps, p, want_e):
    """V = k/2 (theta - t0)^2 (md/angle.py harmonic).  Outside the clip of
    cos theta, at theta within ~5e-4 of 0 or pi, there is no force: with
    t0 = pi and a straight chain every angle starts there."""
    c, inside, dc1, dc2 = _cos_and_grads(disps)
    theta = torch.arccos(c)
    dth = theta - p['t0']
    # dV/dc = k (theta - t0) d theta / dc, d theta / dc = -1 / sqrt(1 - c^2)
    dedc = torch.where(inside, -p['k'] * dth / torch.sqrt(1.0 - c * c), 0.0)
    e = 0.5 * p['k'] * dth * dth if want_e else None
    return e, (dedc[:, None] * dc1, dedc[:, None] * dc2)


def angle_cosinesq(disps, p, want_e):
    """V = k/2 (cos theta - cos t0)^2 (md/angle.py cosinesq)."""
    c, inside, dc1, dc2 = _cos_and_grads(disps)
    dc = c - torch.cos(p['t0'])
    dedc = torch.where(inside, p['k'] * dc, 0.0)
    e = 0.5 * p['k'] * dc * dc if want_e else None
    return e, (dedc[:, None] * dc1, dedc[:, None] * dc2)


# --------------------------------------------------------------------------
# the cell engine's exclusion corrections: the stencil kernels sum every
# pair, so each excluded pair's pair term is subtracted here


def exclusion(evaluator, shifted):
    """The term that subtracts ``evaluator``'s pair energy, less p['e_shift']
    when ``shifted``, on an excluded pair inside r_cut (p['rcut2'])
    (hoomd_tpu/system.py:833-847)."""
    def term(disps, p, want_e):
        d = disps[0]
        r2 = (d * d).sum(-1)
        fdivr, v = evaluator.energy_force(r2, p)
        inside = r2 < p['rcut2']
        g = torch.where(inside, fdivr, 0.0)[:, None] * d
        e = None
        if want_e:
            if shifted:
                v = v - p['e_shift']
            e = -torch.where(inside, v, 0.0)
        return e, (g,)
    return term


def charged_exclusion(lj_evaluator, mesh):
    """The charged engine's correction (hoomd_tpu/system.py:807-832): on an
    excluded pair it subtracts qiqj erfc(kappa r)/r and, where the charged
    evaluator is lj_ewald, the LJ term, inside r_cut; and with a PPPM mesh
    the mesh's qiqj erf(kappa r)/r at any distance."""
    def term(disps, p, want_e):
        d = disps[0]
        r2 = (d * d).sum(-1)
        r = torch.sqrt(r2)
        inside = r2 < p['rcut2']
        kap, qq = p['kappa'], p['qiqj']
        kr = kap * r
        erfc = torch.special.erfc(kr)
        gauss = _TWO_OVER_SQRT_PI * kap * torch.exp(-kr * kr)
        # d/dr of qq erfc(kr)/r and of qq erf(kr)/r, over r
        dr_in = -qq * (gauss + erfc / r) / r2
        e_in = qq * erfc / r
        if lj_evaluator is not None:
            fdivr, v = lj_evaluator.energy_force(r2, p)
            dr_in = dr_in - fdivr
            e_in = e_in + v
        dedr_r = -torch.where(inside, dr_in, 0.0)
        e = -torch.where(inside, e_in, 0.0) if want_e else None
        if mesh:
            erf = torch.special.erf(kr)
            dedr_r = dedr_r - qq * (gauss - erf / r) / r2
            if want_e:
                e = e - qq * erf / r
        return e, (dedr_r[:, None] * d,)
    return term


# --------------------------------------------------------------------------
# the driver

_VIRIAL_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def group_slots(groups, N):
    """What every evaluation of a group table over N positions reads: the
    slot indices with padding rows sent to slot 0 (long), which rows are
    real (a (M, 1) bool), and the members' slots in the order of
    group_terms' rows (member-major, long)."""
    valid = (groups < N).all(1)
    g = torch.where(valid[:, None], groups, 0).long()
    return g, valid[:, None], g.t().reshape(-1)


def group_terms(pos, L, slots, params, term, want_pv):
    """One bonded kind's contribution to each member of each group, in
    member-major order (the rows of slots[2]): the force (arity M, 3), and
    with want_pv the share of the group's energy (arity M,) and virial
    (arity M, 6) that each member takes, else None, None."""
    g, valid, _ = slots
    arity = g.shape[1]
    r = pos[g]                                          # (M, arity, 3)
    disps = tuple(min_image(r[:, k + 1] - r[:, k], L)
                  for k in range(arity - 1))
    energy, grads = term(disps, params, want_pv)
    grads = [torch.where(valid, gk, 0.0) for gk in grads]
    # F_i = g_i - g_{i-1}, an out-of-range g zero
    members = [grads[0]]
    members += [grads[k] - grads[k - 1] for k in range(1, arity - 1)]
    members.append(-grads[-1])
    force = torch.cat(members)
    if not want_pv:
        return force, None, None
    energy = torch.where(valid[:, 0], energy, 0.0)
    vir = sum(torch.stack([-bk[:, a] * gk[:, c] for a, c in _VIRIAL_PAIRS],
                          dim=-1) for bk, gk in zip(disps, grads)) / arity
    return force, (energy / arity).repeat(arity), vir.repeat(arity, 1)


def bonded_force(pos, L, groups, params, term, want_pv=True):
    """One bonded kind over all its groups (hoomd_tpu/ops/bonded.py:131-197).

    pos (N, 3); L (3,) the box's edge lengths; groups (M, arity) int slot
    indices, a row with any index >= N padding; params name -> (M,);
    term one of the terms above.  Returns (force (N, 3), pe (N,), virial
    (N, 6)), or (force, None, None) without want_pv."""
    N = pos.shape[0]
    force = torch.zeros_like(pos)
    pe = virial = None
    if want_pv:
        pe, virial = pos.new_zeros((N,)), pos.new_zeros((N, 6))
    if groups.shape[0] == 0:
        return force, pe, virial
    slots = group_slots(groups, N)
    f, e, v = group_terms(pos, L, slots, params, term, want_pv)
    idx = slots[2]
    force.index_add_(0, idx, f)
    if want_pv:
        pe.index_add_(0, idx, e)
        virial.index_add_(0, idx, v)
    return force, pe, virial
