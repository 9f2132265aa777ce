"""The general engine's neighbour-list pair force (counterpart of
hoomd_tpu/ops/pair_force.py).

One pass over the padded (N, K) list computes force, energy and virial.
Every pair sits in both particles' lists, so it is evaluated twice and
nothing is scattered; the energy and virial take a factor 0.5 for that.
Shift modes: 'none', 'shift' (the energy shifted to zero at r_cut) and
'xplor' (a smoothing function between r_on and r_cut; with r_on >= r_cut
plain shifting, as the reference falls back).  The operation order is
the JAX package's, so single evaluations agree to float32 round-off (the
K-axis sums may add in another order).
"""

from __future__ import annotations

import torch

from .._config import PAD_COORD


def _pair_table(tbl, ti, tj):
    """A (T, T) table gathered per pair; one type's as its 0-d value."""
    if tbl.shape == (1, 1):
        return tbl.reshape(())
    return tbl[ti, tj]


def pair_force_nlist(pos, typeid, charge, diameter, nbr_idx, box, evaluator,
                     param_tables, rcut_table, ron_table=None, mode='none'):
    """(force (N, 3), pe (N,), virial (N, 6)) from a padded list.

    param_tables: name -> (T, T) derived parameter tables; rcut_table
    (T, T), a pair beyond its r_cut contributing nothing; ron_table
    (T, T), XPLOR's r_on (mode 'xplor' only).  Virial components xx, xy,
    xz, yy, yz, zz."""
    N = pos.shape[0]
    dev = pos.device
    pos_pad = torch.cat([pos, torch.full((1, 3), PAD_COORD, dtype=pos.dtype,
                                         device=dev)])
    t_pad = torch.cat([typeid.long(), torch.zeros(1, dtype=torch.long,
                                                  device=dev)])
    j = nbr_idx
    dr = box.min_image(pos[:, None, :] - pos_pad[j])
    r2 = (dr * dr).sum(-1)
    ti, tj = typeid.long()[:, None], t_pad[j]
    p = {name: _pair_table(tbl, ti, tj) for name, tbl in param_tables.items()}
    rcut = _pair_table(rcut_table, ti, tj)
    rc2 = rcut * rcut
    p['rcut'] = rcut
    if getattr(evaluator, 'needs_charge', False):
        q_pad = torch.cat([charge, charge.new_zeros(1)])
        p['qiqj'] = charge[:, None] * q_pad[j]
    valid = (j < N) & (r2 < rc2) & (rc2 > 0.0)
    # masked lanes stay numerically tame before the evaluator sees them
    r2s = torch.where(valid, r2, 1.0)
    fdivr, e = evaluator.energy_force(r2s, p)
    if mode == 'shift':
        _, e_rc = evaluator.energy_force(rc2, p)
        e = e - e_rc
    elif mode == 'xplor':
        ron = _pair_table(ron_table, ti, tj)
        ron2 = ron * ron
        denom = (rc2 - ron2) ** 3
        above = r2s > ron2
        s = torch.where(above, (rc2 - r2s) ** 2
                        * (rc2 + 2.0 * r2s - 3.0 * ron2) / denom, 1.0)
        ds_dr2 = torch.where(
            above, (-2.0 * (rc2 - r2s) * (rc2 + 2.0 * r2s - 3.0 * ron2)
                    + (rc2 - r2s) ** 2 * 2.0) / denom, 0.0)
        f_x = fdivr * s - e * 2.0 * ds_dr2
        e_x = e * s
        _, e_rc = evaluator.energy_force(rc2, p)
        fallback = ron2 >= rc2
        fdivr = torch.where(fallback, fdivr, f_x)
        e = torch.where(fallback, e - e_rc, e_x)
    fdivr = torch.where(valid, fdivr, 0.0)
    e = torch.where(valid, e, 0.0)
    force = (fdivr[:, :, None] * dr).sum(1)
    pe = 0.5 * e.sum(1)
    virial = torch.stack([0.5 * (fdivr * dr[:, :, a] * dr[:, :, b]).sum(1)
                          for a, b in ((0, 0), (0, 1), (0, 2), (1, 1),
                                       (1, 2), (2, 2))], dim=-1)
    return force, pe, virial
