"""Cell-major pair engine for one to four particle types (counterpart of
hoomd_tpu/ops/fast_lj.py).

The state lives in cell-major layout (ncells, C, ...): drift, kick and
thermostat are elementwise on padded slots, forces come from the cell
stencil kernels (ops/cell_pair.py), and positions stay unwrapped between
rebuilds so the stencil image shifts stay exact.  A per-axis drift
monitor inside every step raises a sticky ``danger`` flag when a pair
could have been missed; the host (System._run_fast_chunk) then retries
the segment with a shorter rebuild cadence.

Rebuilds run one of the JAX engine's three rebins, chosen by the host
(System._build_fast, with the JAX package's gates): the stable sort
('sort'), the staged select ('xsel', plain torch, as the JAX package
computes it outside any Pallas kernel) or the plane-local migration
('pallas': the sweep and place kernels of ops/cell_rebin.py).  A
failed xsel or migration rebuild raises the sticky ``rebin_ovf`` (a
stage or buffer overflowed) or ``rebin_lost`` (xsel lost a particle);
the host retries the segment (System._rebin_fallback).

Forces come from the force path ``impl`` (HOOMD_TPU_FAST_IMPL, chosen
by the host), branch by branch as the JAX engine's ``_forces``: 'plane'
(the default) steps on cell_pair_plane, with the k-step megastep
(cell_megastep_planes) for whole windows unless the host turned it off
(HOOMD_TPU_MEGA=off); with HOOMD_TPU_FUSED=on and NVE or NVT, its single
steps are fused steps (cell_step_plane_planes, one kernel call each, the
Nose-Hoover algebra between them on device scalars); every other impl
runs each step as one_step, on its own kernel.  The pair evaluator
(``eval_name``, one of pair_eval.FAST_EVALS) rides the kernels of
'plane', 'planar', 'planar_n3l' and 'xla'; the other impls are LJ only.
PE and virial, read at chunk boundaries, come from cell_pair_planar, but
for 'pallas' (its kernel returns them) and 'pallas3d', 'row' and 'xla'
(the XLA formulation, plain torch, as the JAX engine computes it outside
any kernel).

A mixture (ntypes 2 to 4, hoomd_tpu/ops/fast_lj.py:372-467, 692-707)
takes the per-pair (2 + NP, T, T) parameter table and the carry's typ:
every step is a one_step (no megastep, no fused step), its forces from
the typed cell_pair_planar on 'plane' and 'planar', the typed half
stencil on 'planar_n3l' and the typed XLA formulation on 'xla'; the
LJ-only impls are single-type and refuse it.  Its Langevin friction is
each particle's type's (hoomd_tpu/md/integrate.py:234); the JAX fast
engine takes type 0's for all (hoomd_tpu/system.py:1139-1141), which
this engine does not copy.

A charged job (hoomd_tpu/ops/fast_lj.py:226-267, 372-391, 622-636,
1144-1159: md.charge.pppm with its real-space pair, or md.pair.ewald
alone) keeps each tag's charge (q_tab) and gathers the slots' charges
from the tags at every force evaluation.  Its pair force is a charged
evaluator (ewald, or lj_ewald: pair.lj fused with the real-space Ewald
pair) on the charged cell_pair_planar for 'plane', 'planar' and
'planar_n3l', on cell_pair_xla with cell_q for 'xla'; the PPPM mesh
(``mesh_cfg``, md/charge.py mesh_compute) adds its force every step and
its PE and virial at refresh.  Every step is a one_step: the megastep
and the fused step are off.

Bond and angle forces and the neighbour list's exclusion corrections
(``bonded_cfg``, hoomd_tpu/ops/fast_lj.py:469-571) are tag-space terms
(ops/bonded.py) evaluated in slot space: every rebuild maps each term's
tag groups to the slots of the new layout (the carry's bslots), and every
step adds their forces to the pair force before the kick or the Langevin
bath, refresh_forces their PE and virial too.  Such a program runs every
step as a one_step: the megastep and the fused step are off.

A megastep program keeps, beside each reference (ref_pos), its
MegaCycle: the candidate set of that reference (cell_pair.mega_candidates,
built by rebuild_carry and to_fast, once per rebuild) and the mass and
tag planes; its windows write fresh plane copies of the state in place
(cell_pair.megastep_window), so the carry a retry restarts from is never
written.

Differences from the JAX engine, by design:
  * the loops are plain Python loops around kernel launches, so the host
    knows the timestep and every window count without a device fetch;
  * every rebuild cycle is windows then rebuild_carry, with the xsel
    rebin too: the JAX engine's plane-layout xsel cycle loop
    (_plane_cycles) saves TPU layout transposes, and on the H100 it ran
    no faster than this loop (PERF.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .._config import PAD_COORD, int_dtype
from .. import variant as variant_mod
from . import bonded as ops_bonded
from . import hashrng
from .cell_pair import (LJ_PNAMES, MegaWorkspace, build_cell_shifts,
                        candidate_pads, cell_pair_lj, cell_pair_lj_pallas3d,
                        cell_pair_lj_row, cell_pair_plane, cell_pair_planar,
                        cell_pair_planar_n3l, cell_pair_xla,
                        cell_step_plane_planes, mega_candidates,
                        megastep_window)
from .cell_rebin import cell_rebin_plane, cell_rebin_xsel

# the force paths of HOOMD_TPU_FAST_IMPL (hoomd_tpu/ops/fast_lj.py _forces)
FAST_IMPLS = ('plane', 'planar', 'planar_n3l', 'pallas', 'pallas3d', 'row',
              'xla')


@dataclass
class FastCarry:
    pos: torch.Tensor        # (nc, C, 3) unwrapped since last rebuild
    vel: torch.Tensor        # (nc, C, 3)
    frc: torch.Tensor        # (nc, C, 3)
    pe: torch.Tensor         # (nc, C)
    vir: torch.Tensor        # (nc, C, 6)
    img: torch.Tensor        # (nc, C, 3) int
    tag: torch.Tensor        # (nc, C) int, -1 padding
    typ: torch.Tensor        # (nc, C) int, 0 padding
    mass: torch.Tensor       # (nc, C)
    ref_pos: torch.Tensor    # (nc, C, 3) at last rebuild
    timestep: int
    aux: dict                # thermostat variables (0-d tensors)
    overflow: torch.Tensor   # () bool sticky: a cell held more than C
    n_rebuilds: int
    danger: torch.Tensor     # () bool sticky: skin crossed mid-window
    since: int               # steps since last rebuild
    wmax: torch.Tensor       # () largest normalised drift ratio seen
    rebin_ovf: torch.Tensor  # () bool sticky: an xsel transient stage or a
                             # migration buffer overflowed
    rebin_lost: torch.Tensor  # () bool sticky: an xsel rebuild lost a
                              # particle with no stage overflowing; either
                              # flag makes the host retry
    cycle: object = None     # MegaCycle of ref_pos (megastep programs)
    bslots: tuple = ()       # per bonded term, its groups' slots in this
                             # layout (ops/bonded.group_slots), set at every
                             # rebuild; then the members' slots of all terms

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MegaCycle:
    """What every megastep window of one rebuild cycle takes: the
    candidate set of its reference positions ``ref`` (the carry's ref_pos
    tensor, by identity), and the 1/m, m and int32 tag planes."""
    ref: torch.Tensor
    cand: object             # cell_pair.MegaCandidates
    gw: torch.Tensor
    gm: torch.Tensor
    gt: torch.Tensor


def plan_fast_lj(N, box_L, rcut, r_buff, conservative=False, frac=None):
    """Static planning: cell grid and capacity.  Host numpy, the JAX
    package's planner verbatim, so both give the same (cell_dim, nc, C).

    The planner scans every feasible grid (width >= rcut + r_buff) and
    picks the one with the fewest padded slots; C covers the mean
    occupancy plus ~4 sigma of dense-liquid count fluctuations (plus an
    absolute pad of 2 when conservative), and never less than the real
    occupancy of ``frac`` (fractional positions) when given.  Its 3C <= 128
    rule is the TPU's lane tile; it is kept so the two packages plan the
    same grid, and C beyond it only changes the choice of grid here.
    (The JAX planner's max_C cap and HOOMD_TPU_FAST_GRID override have
    no caller in the port and are left out.)"""
    from itertools import product
    w0 = rcut + r_buff
    L = np.asarray(box_L, float)
    dmax = tuple(max(1, int(np.floor(l / w0))) for l in L)

    def cap_for(mean):
        C = int(np.ceil(mean + 2.0 * np.sqrt(mean)))
        if conservative:
            C += 2
        return max(16, ((C + 7) // 8) * 8)

    _axcache = {}

    def _ax_idx(axis, r):
        key = (axis, r)
        if key not in _axcache:
            _axcache[key] = np.minimum(
                (frac[:, axis] * r).astype(np.int64), r - 1)
        return _axcache[key]

    def maxocc_of(cdim):
        flat = (_ax_idx(0, cdim[0]) + cdim[0]
                * (_ax_idx(1, cdim[1])
                   + cdim[1] * _ax_idx(2, cdim[2])))
        return int(np.bincount(flat,
                               minlength=int(np.prod(cdim))).max())

    def cap_round(c):
        return max(16, ((int(c) + 7) // 8) * 8)

    ranges = [range(1, d + 1) for d in dmax]
    cands = []
    for cdim in product(*ranges):
        nc = int(np.prod(cdim))
        C = cap_for(N / nc)
        key = (min(cdim) < 3, nc * C, -(-cdim[1] // 7), cdim[2],
               cdim[1])
        cands.append((key, cdim, nc, C))
    cands.sort(key=lambda t: t[0])
    best = None
    for key, cdim, nc, C in cands:
        if best is not None:
            if (key[0], nc * C) > (best[0][0], best[0][1]):
                break
        if frac is not None:
            C = max(C, cap_round(maxocc_of(cdim) + 1))
            key = (key[0], nc * C) + key[2:]
        if 3 * C > 128:
            continue
        if best is None or key < best[0]:
            best = (key, cdim, nc, C)
    if best is None:
        nc = int(np.prod(dmax))
        C = cap_for(N / nc)
        if frac is not None:
            C = max(C, cap_round(maxocc_of(dmax) + 1))
        return dmax, nc, C
    _, cell_dim, ncells, C = best
    return cell_dim, ncells, C


def build_fast_lj_chunk(*, N, box, cell_dim, C, r_buff, rcut, method_kind,
                        method_seed, k_rebuild=4, rebin_impl='sort',
                        rebin_E=8, impl='plane', mega=True, fused=False,
                        eval_name='lj', pnames=LJ_PNAMES, ntypes=1,
                        charges=None, mesh_cfg=None, bonded_cfg=(),
                        device='cpu'):
    """Returns (to_fast, refresh_forces, run, to_state).

    rebin_impl: 'sort', 'xsel' or 'pallas' (the migration sweep and place
    with rebin_E emigrant slots per cell face).  impl: the force path, one
    of FAST_IMPLS; mega: run whole k-step windows on the megastep kernel
    (only with impl 'plane'); fused: run single steps as fused steps
    (only with impl 'plane' and nve or nvt; the megastep, where it runs,
    still takes the windows, as in the JAX engine).  eval_name / pnames:
    the pair evaluator and its parameter order (pair_eval.kernel_pnames).
    ntypes: the particle types; with more than one, the megastep and the
    fused step are off and 'pallas', 'pallas3d' and 'row' raise
    NotImplementedError.  charges: the (N,) charge of each tag, for a
    charged evaluator (ewald, lj_ewald); mesh_cfg: {'fn': the PPPM mesh
    hook fn(pos, q, box, params, want_pv)}, with its parameters in
    dyn['mesh'].  A charged program runs no megastep and no fused step.
    bonded_cfg: the tag-space terms, each {'term': an ops.bonded term,
    'groups': (Mb, arity) tag table}, with their parameters in
    dyn['bonded'] (name -> (Mb,) device tensor, in the same order); with
    any, the megastep and the fused step are off.

    dyn layout: {'pv': device tensor [rc2, e_shift, *pnames], of shape
    (2 + NP, T, T) for a mixture, 'lj' (lj, one type): device tensor
    [lj1, lj2, rc2, e_shift], 'dt': float, 'kT': packed variant on the
    device, 'tau': float, 'gamma': float (type 0's), 'gamma_t': (T,)
    device tensor of every type's Langevin friction}."""
    if impl not in FAST_IMPLS:
        raise ValueError(f"force impl (HOOMD_TPU_FAST_IMPL) {impl!r} is not "
                         f"one of {', '.join(FAST_IMPLS)}")
    if ntypes > 1 and impl in ('pallas', 'pallas3d', 'row'):
        raise NotImplementedError(f"HOOMD_TPU_FAST_IMPL={impl} runs one "
                                  f"particle type only ({ntypes} particle "
                                  f"types)")
    needs_q = charges is not None
    have_bonded = len(bonded_cfg) > 0
    # hoomd_tpu/ops/fast_lj.py:692-707: the megastep and the fused step
    # are single-type, uncharged (the mesh hook runs between force and
    # kick) and free of tag-space terms (added between force and kick)
    use_mega = (mega and impl == 'plane' and ntypes == 1 and not needs_q
                and not have_bonded)
    # hoomd_tpu/ops/fast_lj.py:692-695: the fused single step serves the
    # windows only with the megastep off, and the head and tail single
    # steps whenever it holds
    use_fused = (fused and impl == 'plane' and ntypes == 1 and not needs_q
                 and not have_bonded and method_kind in ('nve', 'nvt'))
    ev_kw = dict(eval_name=eval_name, pnames=pnames)
    idt = int_dtype()
    fdt = torch.float32
    dev = torch.device(device)
    nc = int(np.prod(cell_dim))
    M = nc * C
    nx, ny, nz = cell_dim
    plane4 = (nz, ny, nx, C)
    L_np = np.asarray(box.L.cpu().numpy(), dtype=np.float64)
    # per-axis Verlet skins: stencil coverage is per axis, so each axis
    # earns its own danger budget (the real slack of the cell width)
    skin3_np = np.maximum(L_np / np.asarray(cell_dim, float) - rcut, r_buff)
    skin3 = torch.as_tensor(skin3_np, dtype=fdt, device=dev)
    # the fused step's scalar skin (hoomd_tpu/ops/fast_lj.py:274-275): its
    # danger check is max |x - ref|^2 > (skin / 2)^2, not the per-axis one
    skin = max(float(min(L_np / np.asarray(cell_dim, float)) - rcut), r_buff)
    inv_thr3 = 1.0 / (0.5 * skin3) ** 2
    # the megastep's candidate test: the guard's skins plus the rounding
    # margin, and r_cut^2 rounded as the kernels' parameter vector has it
    cand_pads = candidate_pads(skin3_np, L_np)
    cand_rc2 = float(np.float32(rcut) * np.float32(rcut))
    adj_np, shift_np = build_cell_shifts(cell_dim, L_np)
    adj = torch.as_tensor(adj_np, dtype=torch.int32, device=dev)
    shifts = torch.as_tensor(shift_np, dtype=fdt, device=dev)
    nxyz = torch.as_tensor(cell_dim, dtype=fdt, device=dev)
    nxyz_i = torch.as_tensor(cell_dim, dtype=torch.int64, device=dev)
    ndof = 3.0 * N
    recip = 'approx' if method_kind in ('nvt', 'langevin') else 'div'
    if needs_q:
        # each tag's charge, and 0 for the padding's tag N
        q_tab = torch.cat([torch.as_tensor(np.asarray(charges), dtype=fdt,
                                           device=dev),
                           torch.zeros(1, dtype=fdt, device=dev)])

    def _cid_flat(pos_w):
        f = box.make_fraction(pos_w)
        f = f - torch.floor(f)
        c3 = torch.minimum(torch.clamp((f * nxyz).to(torch.int64), min=0),
                           nxyz_i - 1)
        return c3[..., 0] + nx * (c3[..., 1] + ny * c3[..., 2])

    # one padding row of the rebin payload: pos, vel, img, tag, typ, mass
    # (+ frc); the int columns are float32 bit patterns
    _fill = torch.tensor([PAD_COORD] * 3 + [0.0] * 3, dtype=fdt)
    _fill_i = torch.tensor([0, 0, 0, -1, 0], dtype=idt).view(fdt)
    fill_row = torch.cat([_fill, _fill_i, torch.ones(1, dtype=fdt)]).to(dev)

    def _rebin(pos_f, vel_f, img_f, tag_f, typ_f, mass_f, frc_f=None):
        """Flat (M, ...) arrays -> fresh cell-major layout, by one stable
        sort on the cell id: rank within a cell from a cummax of segment
        starts, one scatter of all columns (ints as float32 bit
        patterns) into padded slots, and the overflow flag."""
        valid = tag_f >= 0
        pos_w, img_w = box.wrap(pos_f, img_f)
        cid = torch.where(valid, _cid_flat(pos_w), nc)
        scid, order = torch.sort(cid, stable=True)
        idx = torch.arange(M, device=dev)
        start = torch.ones(M, dtype=torch.bool, device=dev)
        start[1:] = scid[1:] != scid[:-1]
        first = torch.cummax(torch.where(start, idx, 0), 0).values
        rank = idx - first
        ok = (rank < C) & (scid < nc)
        slot = torch.where(ok, scid * C + rank, M)
        ovf = ((scid < nc) & (rank >= C)).any()
        cols = [pos_w, vel_f, img_w.to(idt).view(fdt),
                tag_f.to(idt).view(fdt)[:, None],
                typ_f.to(idt).view(fdt)[:, None], mass_f[:, None]]
        fill = fill_row
        if frc_f is not None:
            cols.append(frc_f)
            fill = torch.cat([fill_row, torch.zeros(3, dtype=fdt,
                                                    device=dev)])
        out = fill.repeat(M + 1, 1)
        out[slot] = torch.cat(cols, dim=1)[order]
        out = out[:M]
        res = (out[:, 0:3], out[:, 3:6], out[:, 6:9].contiguous().view(idt),
               out[:, 9].contiguous().view(idt),
               out[:, 10].contiguous().view(idt), out[:, 11])
        if frc_f is not None:
            res = res + (out[:, 12:15],)
        return res + (ovf,)

    def _all_forces(pos, tag, typ, dyn, want_pv):
        """The pair force on the path of ``impl`` (_forces) and, in a
        charged program, the PPPM mesh's (hoomd_tpu/ops/fast_lj.py:622-636,
        1144-1159): F, or (F, pe, vir) with want_pv."""
        if not needs_q:
            return _forces(pos, tag, typ, dyn, want_pv)
        # the slots' charges from their tags, 0 on padding
        qc = torch.where(tag >= 0, q_tab[tag.long().clamp(0, N)], 0.0)
        out = _forces(pos, tag, typ, dyn, want_pv, qc)
        if mesh_cfg is None:
            return out
        fm, pm, vm = mesh_cfg['fn'](pos.reshape(M, 3), qc.reshape(M), box,
                                    dyn['mesh'], want_pv=want_pv)
        if not want_pv:
            return out + fm.reshape(nc, C, 3)
        return (out[0] + fm.reshape(nc, C, 3), out[1] + pm.reshape(nc, C),
                out[2] + vm.reshape(nc, C, 6))

    def _forces(pos, tag, typ, dyn, want_pv, q_cells=None):
        """F, or (F, pe, vir) with want_pv, on the path of ``impl``
        (hoomd_tpu/ops/fast_lj.py:372-467); a mixture's on the typed
        kernels, every step's on cell_pair_planar for 'plane' and
        'planar'; a charged evaluator's (q_cells, the slots' charges) on
        the charged cell_pair_planar, or cell_pair_xla for 'xla'."""
        if q_cells is not None:
            qk = dict(ev_kw, ntypes=ntypes, cell_q=q_cells,
                      cell_typ=typ if ntypes > 1 else None)
            if impl == 'xla':
                out = cell_pair_xla(pos, cell_dim, shifts, dyn['pv'], **qk)
                return out if want_pv else out[0]
            return cell_pair_planar(pos, cell_dim, shifts, dyn['pv'], C=C,
                                    cell_tag=tag, want_pv=want_pv, **qk)
        if ntypes > 1:
            tk = dict(ev_kw, ntypes=ntypes, cell_typ=typ)
            if impl == 'planar_n3l' and not want_pv:
                return cell_pair_planar_n3l(pos, cell_dim, shifts, dyn['pv'],
                                            C=C, cell_tag=tag, **tk)
            if impl == 'xla':
                out = cell_pair_xla(pos, cell_dim, shifts, dyn['pv'], **tk)
                return out if want_pv else out[0]
            return cell_pair_planar(pos, cell_dim, shifts, dyn['pv'], C=C,
                                    cell_tag=tag, want_pv=want_pv, **tk)
        if impl == 'pallas':
            out = cell_pair_lj(pos, adj, shifts, dyn['lj'], ncells=nc, C=C,
                               cell_tag=tag)
        elif impl in ('pallas3d', 'row'):
            kfn = cell_pair_lj_row if impl == 'row' else cell_pair_lj_pallas3d
            frc = kfn(pos, cell_dim, shifts, dyn['lj'], C=C, cell_tag=tag)
            if not want_pv:
                return frc
            _, pe, vir = cell_pair_xla(pos, cell_dim, shifts, dyn['pv'],
                                       **ev_kw)
            return frc, pe, vir
        elif impl == 'planar_n3l' and not want_pv:
            return cell_pair_planar_n3l(pos, cell_dim, shifts, dyn['pv'], C=C,
                                        cell_tag=tag, **ev_kw)
        elif impl == 'plane' and not want_pv:
            # the fast reciprocal under a thermostat, which absorbs its
            # ~1e-4 force error; NVE divides exactly (fast_lj.py:414-425)
            return cell_pair_plane(pos, cell_dim, shifts, dyn['pv'], C=C,
                                   cell_tag=tag, recip=recip, **ev_kw)
        elif impl == 'xla':
            out = cell_pair_xla(pos, cell_dim, shifts, dyn['pv'], **ev_kw)
        else:           # 'planar', and the PE / virial of 'plane', 'n3l'
            out = cell_pair_planar(pos, cell_dim, shifts, dyn['pv'], C=C,
                                   cell_tag=tag, **ev_kw)
        return out if want_pv else out[0]

    if have_bonded:
        bond_groups = [torch.as_tensor(np.asarray(cfg['groups']),
                                       dtype=torch.int64, device=dev)
                       for cfg in bonded_cfg]
        box_L = box.L.to(device=dev, dtype=fdt)

    def _slot_groups(tag_cells):
        """The tag groups -> slot groups of this layout
        (hoomd_tpu/ops/fast_lj.py:526-542): one scatter of the slots by
        tag, then a gather per term; a tag with no slot maps to M, which
        marks its group as padding.  Returns the carry's bslots: each
        term's ops_bonded.group_slots, then the members' slots of all terms
        in the order of _bonded_terms' rows."""
        if not have_bonded:
            return ()
        tag_f = tag_cells.reshape(M).long()
        live = tag_f >= 0
        s_of_t = torch.full((N + 1,), M, dtype=torch.int64, device=dev)
        s_of_t[torch.where(live, tag_f, N)] = torch.where(
            live, torch.arange(M, device=dev), M)
        slots = tuple(ops_bonded.group_slots(s_of_t[g.clamp(max=N)], M)
                      for g in bond_groups)
        return slots + (torch.cat([sl[2] for sl in slots]),)

    def _with_slots(c: FastCarry):
        return c.replace(bslots=_slot_groups(c.tag)) if have_bonded else c

    def _bonded_terms(pos_cells, bslots, dyn, want_pv):
        """The tag-space terms' force (nc, C, 3) on the slots, and with
        want_pv their PE (nc, C) and virial (nc, C, 6)
        (hoomd_tpu/ops/fast_lj.py:544-571): each term on its slot groups,
        the unwrapped positions min-imaged; all terms' member rows summed
        by one index_add_ per output."""
        pos_flat = pos_cells.reshape(M, 3)
        outs = [ops_bonded.group_terms(pos_flat, box_L, sl, p, cfg['term'],
                                       want_pv)
                for sl, p, cfg in zip(bslots, dyn['bonded'], bonded_cfg)]
        idx = bslots[-1]
        frc = torch.zeros((M, 3), dtype=fdt, device=dev).index_add_(
            0, idx, torch.cat([o[0] for o in outs]))
        if not want_pv:
            return frc.reshape(nc, C, 3), None, None
        pe = torch.zeros(M, dtype=fdt, device=dev).index_add_(
            0, idx, torch.cat([o[1] for o in outs]))
        vir = torch.zeros((M, 6), dtype=fdt, device=dev).index_add_(
            0, idx, torch.cat([o[2] for o in outs]))
        return (frc.reshape(nc, C, 3), pe.reshape(nc, C),
                vir.reshape(nc, C, 6))

    def step_force(c: FastCarry, dyn, pos=None, valid=None):
        """The force of a one_step at ``pos`` (by default the carry's
        positions): the pair force (and a charged job's mesh force) plus
        the tag-space terms, zero on padding (``valid``, the live slots'
        (nc, C, 1) mask, if the caller has it)."""
        pos = c.pos if pos is None else pos
        valid = (c.tag >= 0)[..., None] if valid is None else valid
        frc = _all_forces(pos, c.tag, c.typ, dyn, False)
        if have_bonded:
            frc = frc + _bonded_terms(pos, c.bslots, dyn, False)[0]
        return torch.where(valid, frc, 0.0)

    def _kt(dyn, ts):
        return variant_mod.eval_packed(dyn['kT'], ts)

    def one_step(c: FastCarry, dyn):
        dt = dyn['dt']
        valid = (c.tag >= 0)[..., None]
        minv = 1.0 / c.mass[..., None]
        aux = dict(c.aux)
        vel = c.vel
        if method_kind == 'nvt':
            kT0 = _kt(dyn, c.timestep)
            ke2 = torch.where(valid, c.mass[..., None] * vel * vel,
                              0.0).sum()
            T = ke2 / ndof
            xi = aux['xi'] + 0.5 * dt * (T / kT0 - 1.0) / dyn['tau'] ** 2
            s = torch.exp(-0.5 * dt * xi)
            vel = torch.where(valid, vel * s, vel)
            aux['xi'] = xi
            aux['eta'] = aux['eta'] + dt * xi
        vel = torch.where(valid, vel + 0.5 * dt * c.frc * minv, vel)
        pos = torch.where(valid, c.pos + dt * vel, c.pos)  # no wrap here

        # per-axis exact pair bound: danger iff the two largest drifts
        # along one axis sum past that axis' skin
        d = pos - c.ref_pos
        md2 = torch.zeros((), dtype=fdt, device=dev)
        dv = torch.where(valid, d, 0.0)
        for a in range(3):
            q = (dv[..., a] * dv[..., a]).reshape(-1)
            m1 = q.max()
            eq = q == m1
            tie = eq.sum() > 1
            m2 = torch.clamp(torch.where(eq, -1.0, q).max(), min=0.0)
            m2 = torch.where(tie, m1, m2)
            sd = 0.5 * (torch.sqrt(m1 * inv_thr3[a])
                        + torch.sqrt(m2 * inv_thr3[a]))
            md2 = torch.maximum(md2, sd * sd)
        danger = c.danger | (md2 > 1.0)
        wmax = torch.maximum(c.wmax, md2)

        frc = step_force(c, dyn, pos, valid)
        if method_kind == 'langevin':
            kT = _kt(dyn, c.timestep)
            u = torch.stack([hashrng.uniform_pm1(method_seed, c.timestep,
                                                 c.tag, salt=ax)
                             for ax in (1, 2, 3)], dim=-1)
            # each slot's own type's friction in a mixture; one type keeps
            # the scalar (and its bits)
            gamma = (dyn['gamma'] if ntypes == 1
                     else dyn['gamma_t'][c.typ.long()][..., None])
            noise = torch.sqrt(6.0 * gamma * kT / dt) * u
            f_tot = torch.where(valid, frc + noise - gamma * vel, 0.0)
            vel = torch.where(valid, vel + 0.5 * dt * f_tot * minv, vel)
            frc = f_tot
        else:
            vel = torch.where(valid, vel + 0.5 * dt * frc * minv, vel)
            if method_kind == 'nvt':
                kT0 = _kt(dyn, c.timestep)
                xi = aux['xi']
                s = torch.exp(-0.5 * dt * xi)
                vel = torch.where(valid, vel * s, vel)
                ke2 = torch.where(valid, c.mass[..., None] * vel * vel,
                                  0.0).sum()
                T = ke2 / ndof
                aux['xi'] = xi + 0.5 * dt * (T / kT0 - 1.0) \
                    / dyn['tau'] ** 2
        return c.replace(pos=pos, vel=vel, frc=frc, timestep=c.timestep + 1,
                         aux=aux, danger=danger, since=c.since + 1,
                         wmax=wmax)

    def _to_planes(a):
        return a.reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2, 3)

    def _from_planes(a):
        return a.permute(1, 2, 3, 4, 0).reshape(nc, C, 3)

    def _noise_planes(tag_p, dyn, ts, k):
        """(k, 3, nz, ny, nx, C) Langevin noise planes for the window
        starting at timestep ts: the per-(seed, tag, step) counter hash
        (identical bits to one_step), amplitude sqrt(6 gamma kT(t) / dt),
        zero on padding."""
        steps = torch.arange(ts, ts + k, device=dev)
        kt = _kt(dyn, steps)
        amp = torch.sqrt(6.0 * dyn['gamma'] * kt / dyn['dt'])       # (k,)
        u = torch.stack([hashrng.uniform_pm1(method_seed,
                                             steps.reshape(k, 1, 1, 1, 1),
                                             tag_p[None], salt=ax)
                         for ax in (1, 2, 3)], dim=1)
        valid = (tag_p >= 0).to(fdt)
        return amp.reshape(k, 1, 1, 1, 1, 1) * u * valid[None, None]

    def _fresh_planes(a):
        """(nc, C, 3) -> a new (3, nz, ny, nx, C) tensor, never a view of
        a: the megastep windows write their planes in place."""
        out = torch.empty((3,) + plane4, dtype=fdt, device=dev)
        out.copy_(_to_planes(a))
        return out

    def _with_cycle(c: FastCarry):
        """The carry with the megastep cycle of its reference positions
        (the candidate set, built here once per rebuild)."""
        if not use_mega:
            return c
        gt = c.tag.reshape(plane4).to(torch.int32).contiguous()
        gm = c.mass.reshape(plane4).contiguous()
        cand = mega_candidates(_fresh_planes(c.ref_pos), gt, cell_dim, shifts,
                               cand_pads, cand_rc2, C=C)
        return c.replace(cycle=MegaCycle(ref=c.ref_pos, cand=cand,
                                         gw=1.0 / gm, gm=gm, gt=gt))

    _ws = {}

    def _workspace(dyn, k):
        """The MegaWorkspace of this program, the parameters of dyn and the
        window k, built at the first window that needs it."""
        key = (k, dyn['dt'], dyn['tau'], dyn['gamma'])
        hit = _ws.get('cur')
        if hit is not None and hit[0] is dyn['pv'] and hit[1] == key:
            return hit[2]
        ti2 = 1.0 / dyn['tau'] ** 2 if method_kind == 'nvt' else 0.0
        ws = MegaWorkspace(cell_dim, C, k, method_kind, shifts, dyn['pv'],
                           dyn['dt'], skin3, ndof=ndof, tau_inv2=ti2,
                           gamma=dyn['gamma'], recip=recip, **ev_kw)
        _ws['cur'] = (dyn['pv'], key, ws)
        return ws

    def mega_windows(c: FastCarry, dyn, nw, k):
        """nw chained megastep windows of k fused steps each, in place on
        fresh plane-layout copies of the carry's state (the carry a danger
        retry restarts from is never written), each window one kernel
        call on the candidate set of c.ref_pos; the drift is monitored
        against c.ref_pos, so the danger check stays exact across chained
        windows."""
        cyc = c.cycle
        if cyc is None or cyc.ref is not c.ref_pos:
            raise RuntimeError("megastep window from reference positions "
                               "without their candidate set (rebuild_carry "
                               "and to_fast build it)")
        ws = _workspace(dyn, k)
        aux = dict(c.aux)
        gp, gv, gf = (_fresh_planes(c.pos), _fresh_planes(c.vel),
                      _fresh_planes(c.frc))
        z = torch.zeros((), dtype=fdt, device=dev)
        sc = torch.stack([aux.get('xi', z), aux.get('eta', z), z, z])
        ts = c.timestep
        if method_kind in ('nvt', 'langevin'):
            kts = _kt(dyn, torch.arange(ts, ts + nw * k, device=dev)).to(fdt)
        for i in range(nw):
            kt = (kts[i * k:(i + 1) * k] if method_kind != 'nve'
                  else ws.unit_kt)
            gn = (_noise_planes(c.tag.reshape(plane4), dyn, ts, k)
                  if method_kind == 'langevin' else None)
            megastep_window(gp, gv, gf, cyc.gw, cyc.gm, cyc.gt, cyc.cand, ws,
                            sc, kt, gn)
            ts += k
        if method_kind == 'nvt':
            aux['xi'] = sc[0]
            aux['eta'] = sc[1]
        return c.replace(pos=_from_planes(gp), vel=_from_planes(gv),
                         frc=_from_planes(gf), aux=aux,
                         danger=c.danger | (sc[3] > 1.0),
                         wmax=torch.maximum(c.wmax, sc[3]), timestep=ts,
                         since=c.since + nw * k)

    def fused_steps(c: FastCarry, dyn, m):
        """m fused velocity-Verlet steps (hoomd_tpu/ops/fast_lj.py:809-858):
        each one cell_step_plane_planes call on the plane-layout state,
        the Nose-Hoover algebra between calls on 0-d device tensors.  The
        danger check is the scalar one, md2 > (skin/2)^2; wmax is not
        updated."""
        dt = dyn['dt']
        gp, gv, gf = _to_planes(c.pos), _to_planes(c.vel), _to_planes(c.frc)
        gr = _to_planes(c.ref_pos).contiguous()
        gw = (1.0 / c.mass).reshape(plane4)
        gt = c.tag.reshape(plane4)
        ke2 = (c.mass[..., None] * c.vel * c.vel).sum()
        aux = dict(c.aux)
        z = torch.zeros((), dtype=fdt, device=dev)
        xi, eta = aux.get('xi', z), aux.get('eta', z)
        thr = (0.5 * skin) ** 2
        nvt = method_kind == 'nvt'
        if nvt:
            tau2 = dyn['tau'] ** 2
            kts = _kt(dyn, torch.arange(c.timestep, c.timestep + m,
                                        device=dev))
        s = torch.ones((), dtype=fdt, device=dev)
        danger = c.danger
        for i in range(m):
            if nvt:
                kT0 = kts[i]
                xi1 = xi + 0.5 * dt * (ke2 / ndof / kT0 - 1.0) / tau2
                s = torch.exp(-0.5 * dt * xi1)
                eta = eta + dt * xi1
            else:
                xi1 = xi
            gp, gv, gf, ke2, md2 = cell_step_plane_planes(
                gp, gv, gf, gw, gr, cell_dim, shifts, dyn['pv'], dt, s, C=C,
                gt=gt, recip=recip, **ev_kw)
            if nvt:
                xi = xi1 + 0.5 * dt * (ke2 / ndof / kT0 - 1.0) / tau2
            else:
                xi = xi1
            danger = danger | (md2 > thr)
        if nvt:
            aux['xi'] = xi
            aux['eta'] = eta
        return c.replace(pos=_from_planes(gp), vel=_from_planes(gv),
                         frc=_from_planes(gf), aux=aux, danger=danger,
                         timestep=c.timestep + m, since=c.since + m)

    def rebuild_carry(c: FastCarry):
        """Re-bin into fresh cell-major layout; forces ride along so the
        next half-kick sees them in slot order.  The sort carries typ; the
        xsel and migration rebins run for one type only (the host's gate),
        so typ stays, type 0 in every slot.  A megastep program builds the
        new reference's candidate set; a program with tag-space terms maps
        their groups to the new slots."""
        return _with_cycle(_with_slots(_rebin_carry(c)))

    def _rebin_carry(c: FastCarry):
        if rebin_impl == 'xsel':
            p, v, f, im, t, m, cap_o, lost = cell_rebin_xsel(
                c.pos, c.vel, c.frc, c.img, c.tag, c.mass, cell_dim, L_np,
                C=C)
            # a transient-stage overflow or a lost particle makes THIS
            # rebuild unusable; it says nothing about C.  An overflowing
            # stage drops particles too: a loss counts as the rebin's own
            # fault (a particle out-ran the window) only without one
            return c.replace(pos=p, vel=v, img=im, tag=t, mass=m, ref_pos=p,
                             frc=f, rebin_ovf=c.rebin_ovf | cap_o,
                             rebin_lost=c.rebin_lost | (lost & ~cap_o),
                             n_rebuilds=c.n_rebuilds + 1, since=0)
        if rebin_impl == 'pallas':
            p, v, f, im, t, m, o = cell_rebin_plane(
                c.pos, c.vel, c.frc, c.img, c.tag, c.mass, cell_dim, L_np,
                C=C, E=rebin_E)
            return c.replace(pos=p, vel=v, img=im, tag=t, mass=m, ref_pos=p,
                             frc=f, rebin_ovf=c.rebin_ovf | o,
                             n_rebuilds=c.n_rebuilds + 1, since=0)
        p, v, im, t, ty, m, f, o = _rebin(
            c.pos.reshape(M, 3), c.vel.reshape(M, 3), c.img.reshape(M, 3),
            c.tag.reshape(M), c.typ.reshape(M), c.mass.reshape(M),
            c.frc.reshape(M, 3))
        p = p.reshape(nc, C, 3)
        return c.replace(
            pos=p, vel=v.reshape(nc, C, 3), img=im.reshape(nc, C, 3),
            tag=t.reshape(nc, C), typ=ty.reshape(nc, C),
            mass=m.reshape(nc, C), ref_pos=p, frc=f.reshape(nc, C, 3),
            overflow=c.overflow | o, n_rebuilds=c.n_rebuilds + 1, since=0)

    def run_steps(c, dyn, m):
        """m single steps: fused steps where the gate holds, else one_step
        (fast_lj.py:1056-1060)."""
        if use_fused:
            return fused_steps(c, dyn, m)
        for _ in range(m):
            c = one_step(c, dyn)
        return c

    def run_wins(c, dyn, nwin, k):
        """nwin windows of k steps: megastep windows, or single steps on
        the paths that do not ride it (fast_lj.py:1046-1054)."""
        if use_mega:
            return mega_windows(c, dyn, nwin, k)
        return run_steps(c, dyn, nwin * k)

    def run_cycles(c, dyn, ncycles, nwin, k):
        """ncycles rebuild cycles of nwin windows each."""
        for _ in range(ncycles):
            c = rebuild_carry(run_wins(c, dyn, nwin, k))
        return c

    def run(carry, dyn, nsteps, nwin=1):
        """Rebuild cycles of k_rebuild * nwin steps, honoring the carry's
        steps-since-rebuild; head and tail run as whole windows plus
        single steps."""
        k = k_rebuild
        nwin = max(int(nwin), 1)
        cadence = k * nwin
        left = int(nsteps)
        since = carry.since
        if since > 0 and since + left > cadence:
            head = max(cadence - since, 0)
            if head > 0:
                hw, hrem = divmod(head, k)
                if hw > 0:
                    carry = run_wins(carry, dyn, hw, k)
                if hrem > 0:
                    carry = run_steps(carry, dyn, hrem)
                left -= head
            carry = rebuild_carry(carry)
        nb = left // cadence
        if nb > 0:
            carry = run_cycles(carry, dyn, nb, nwin, k)
            left -= nb * cadence
        tw, trem = divmod(left, k)
        if tw > 0:
            carry = run_wins(carry, dyn, tw, k)
        if trem > 0:
            carry = run_steps(carry, dyn, trem)
        return carry

    def to_fast(state, aux):
        pad = M - N

        def cat(a, fill):
            return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                            dtype=a.dtype, device=dev)])
        p, v, im, t, ty, m, ovf = _rebin(
            cat(state.pos, PAD_COORD), cat(state.vel, 0.0),
            cat(state.image, 0), cat(state.tag, -1),
            cat(state.typeid.to(idt), 0), cat(state.mass, 1.0))
        shape3 = (nc, C, 3)
        return _with_cycle(_with_slots(FastCarry(
            pos=p.reshape(shape3), vel=v.reshape(shape3),
            frc=torch.zeros(shape3, dtype=fdt, device=dev),
            pe=torch.zeros((nc, C), dtype=fdt, device=dev),
            vir=torch.zeros((nc, C, 6), dtype=fdt, device=dev),
            img=im.reshape(shape3), tag=t.reshape(nc, C),
            typ=ty.reshape(nc, C), mass=m.reshape(nc, C),
            ref_pos=p.reshape(shape3), timestep=state.timestep, aux=aux,
            overflow=ovf, n_rebuilds=0,
            danger=torch.zeros((), dtype=torch.bool, device=dev), since=0,
            wmax=torch.zeros((), dtype=fdt, device=dev),
            rebin_ovf=torch.zeros((), dtype=torch.bool, device=dev),
            rebin_lost=torch.zeros((), dtype=torch.bool, device=dev))))

    def refresh_forces(carry, dyn):
        frc, pe, vir = _all_forces(carry.pos, carry.tag, carry.typ, dyn, True)
        if have_bonded:
            fb, peb, virb = _bonded_terms(carry.pos, carry.bslots, dyn, True)
            frc, pe, vir = frc + fb, pe + peb, vir + virb
        valid = (carry.tag >= 0)[..., None]
        return carry.replace(frc=torch.where(valid, frc, 0.0), pe=pe,
                             vir=vir)

    def to_state(carry, state):
        """Scatter the cell-major carry back into the State by tag."""
        tag_f = carry.tag.reshape(M).long()
        valid = tag_f >= 0
        dst = torch.where(valid, state.rtag.long()[tag_f.clamp(min=0)], N)

        def scat(dest, src):
            out = torch.cat([dest, dest[:1]])
            out[dst] = src
            return out[:N]
        pos_w, img_w = box.wrap(carry.pos.reshape(M, 3),
                                carry.img.reshape(M, 3))
        return state.replace(
            pos=scat(state.pos, pos_w),
            vel=scat(state.vel, carry.vel.reshape(M, 3)),
            image=scat(state.image, img_w),
            net_force=scat(state.net_force, carry.frc.reshape(M, 3)),
            net_pe=scat(state.net_pe, carry.pe.reshape(M)),
            net_virial=scat(state.net_virial, carry.vir.reshape(M, 6)),
            timestep=carry.timestep)

    run.mega = use_mega
    run.fused = use_fused
    run.rebuild = rebuild_carry
    run.wins = run_wins
    run.steps = run_steps
    run.cycles = run_cycles
    run.force = step_force
    return to_fast, refresh_forces, run, to_state
