"""Cell-stencil pair kernels: counterpart of hoomd_tpu/ops/pallas_pair.py.

Eight wrappers, each beside the plain torch version of the same function.
The JAX engine's default configuration ('plane') runs three, and its
fused single step (HOOMD_TPU_FUSED=on) a fourth:

  cell_pair_plane       (pallas_pair.py _kernel_plane)     forces only
  cell_pair_planar      (pallas_pair.py _kernel_planar)    forces, PE, virial
  cell_megastep_planes  (pallas_pair.py _kernel_megastep)  k fused VV steps
                        (megastep_window: the engine's in-place form)
  cell_step_plane_planes (pallas_pair.py _kernel_step_plane) one fused VV
                                                   step, with KE and drift

The megastep walks each slot's candidate set (mega_candidates, a kernel
with no TPU counterpart: the JAX megastep walks every stencil slot),
built once per rebuild from the reference positions.

These four take any of the ten pair evaluators of ops/pair_eval.py
(``eval_name``, with the parameter vector [rc2, e_shift, *pnames] in the
order of pair_eval.kernel_pnames).  The engine's other force paths
(HOOMD_TPU_FAST_IMPL) run one kernel each, LJ only but for the half
stencil:

  cell_pair_lj          (_kernel, 'pallas')        adjacency-listed cells;
                                                   forces, PE, virial
  cell_pair_lj_pallas3d (_kernel3d, 'pallas3d')    forces only
  cell_pair_lj_row      (_kernel_row, 'row')       forces only
  cell_pair_planar_n3l  (_kernel_planar_n3l,       half stencil, forces
                         'planar_n3l')             only, every evaluator

A mixture of 2 to MAX_TYPES particle types (the typed branches of
_kernel_planar and _kernel_planar_n3l) runs on cell_pair_planar and
cell_pair_planar_n3l only: their ``ntypes`` and ``cell_typ`` arguments
take the (2 + NP, T, T) per-pair table, and each has a typed kernel
(csrc/cell_pair_typed.cu, csrc/cell_pair_impls.cu) with its own launch
counter; the other kernels are single-type, as in the JAX engine.

On a CUDA tensor a wrapper launches its hand-written kernel
(csrc/cell_pair.cu, csrc/cell_pair_typed.cu, csrc/cell_step.cu,
csrc/cell_pair_impls.cu, built by ops/_build.py) or raises; on a CPU
tensor it runs the plain version.  Nothing falls back from one to the
other.  Each wrapper counts its launches in ``<wrapper>.launches``.

Validity comes from the tag (>= 0), and the self pair is excluded by
index, in the kernels and the plain versions alike.  ``cell_pair_xla``
is the torch port of the JAX package's XLA formulation (expanded r^2,
padding excluded by magnitude), kept as a second, independent reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pair_eval

# largest cell capacity the kernels take: 27*C*13 bytes of shared memory
# per block and C threads per block
MAX_C = 512
# most particle types of a mixture (csrc/cell_stencil.cuh kMaxTypes; the
# JAX engine's limit, hoomd_tpu/system.py:463)
MAX_TYPES = 4


def build_cell_shifts(cell_dim, box_L):
    """(ncells, 27) neighbour ids and (ncells, 27, 3) periodic image
    shifts of the 27-cell stencil, (dz, dy, dx) order with dx fastest.
    Host-side numpy, identical to the JAX package's table."""
    nx, ny, nz = cell_dim
    ncells = nx * ny * nz
    ids = np.arange(ncells)
    ix = ids % nx
    iy = (ids // nx) % ny
    iz = ids // (nx * ny)
    adj = np.empty((ncells, 27), np.int32)
    sh = np.zeros((ncells, 27, 3), np.float64)
    c = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                jx, wx = (ix + dx) % nx, (ix + dx) // nx
                jy, wy = (iy + dy) % ny, (iy + dy) // ny
                jz, wz = (iz + dz) % nz, (iz + dz) // nz
                adj[:, c] = jx + nx * (jy + ny * jz)
                sh[:, c, 0] = wx * box_L[0]
                sh[:, c, 1] = wy * box_L[1]
                sh[:, c, 2] = wz * box_L[2]
                c += 1
    return adj, sh


@functools.lru_cache(maxsize=16)
def _adjacency_np(cell_dim):
    return build_cell_shifts(cell_dim, (0.0, 0.0, 0.0))[0]


def _adjacency(cell_dim, device):
    return torch.as_tensor(_adjacency_np(tuple(cell_dim)), dtype=torch.int64,
                           device=device)


# the parameter names of the LJ stencil, the default evaluator
LJ_PNAMES = ('lj1', 'lj2', 'rcut')


def _evaluator(eval_name, pnames):
    """The pair_eval evaluator of ``eval_name``, after checking that
    ``pnames`` is the order the kernels read its parameters in."""
    if eval_name not in pair_eval.EVAL_IDS:
        raise NotImplementedError(
            f"pair evaluator {eval_name!r}: the stencil kernels run "
            f"{', '.join(pair_eval.FAST_EVALS)}")
    want = pair_eval.kernel_pnames(eval_name)
    if tuple(pnames) != want:
        raise ValueError(f"pnames {tuple(pnames)} of {eval_name!r}: the "
                         f"kernels read {want}")
    return pair_eval.ALL_EVALUATORS[eval_name]


def _recip_flag(recip):
    """1 for the fast reciprocal ('approx'), 0 for the exact divide."""
    if recip not in ('div', 'approx'):
        raise ValueError(f"recip must be 'div' or 'approx', not {recip!r}")
    return int(recip == 'approx')


# ---------------------------------------------------------------------------
# plain torch versions


# the virial's six components, (u, w) of each, in the kernels' order
VIRIAL_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _stencil_plain(cell_pos, cell_tag, adj, cell_shift, params_vec,
                   want_pv, eval_name='lj', pnames=LJ_PNAMES, cell_typ=None):
    """Direct-dr stencil over all cells, each against the 27 cells of its
    row of ``adj`` (nc, 27) under the image shifts ``cell_shift``, chunked
    to bound memory.  A slot meets itself only in the entry that lists its
    own cell under a zero shift (the centre of build_cell_shifts's table).
    With ``cell_typ`` (nc, C) params_vec is the (2 + NP, T, T) table of a
    mixture, read per pair by the two slots' types: rc2 for every
    candidate, the rest for the pairs inside it only, whose sums run over
    those pairs alone.
    Returns F (nc, C, 3) and, with want_pv, pe (nc, C), vir (nc, C, 6)."""
    nc, C, _ = cell_pos.shape
    dev = cell_pos.device
    ev = _evaluator(eval_name, pnames)
    if cell_typ is None:
        rc2, e_shift, p = pair_eval.params_dict(params_vec, pnames)
    else:
        typ = cell_typ.long()
    adj = adj.long()
    own = ((adj == torch.arange(nc, device=dev)[:, None])
           & (cell_shift == 0).all(-1))                   # (nc, 27)
    eye = torch.eye(C, dtype=torch.bool, device=dev)
    valid = cell_tag >= 0
    chunk = max(1, (1 << 22) // (27 * C * C))
    F = torch.zeros((nc, C, 3), dtype=cell_pos.dtype, device=dev)
    pe = torch.zeros((nc, C), dtype=cell_pos.dtype, device=dev) \
        if want_pv else None
    vir = torch.zeros((nc, C, 6), dtype=cell_pos.dtype, device=dev) \
        if want_pv else None
    for c0 in range(0, nc, chunk):
        c1 = min(nc, c0 + chunk)
        n = c1 - c0
        a = adj[c0:c1]                                    # (n, 27)
        xj = (cell_pos[a] + cell_shift[c0:c1, :, None, :]).reshape(
            n, 27 * C, 3)
        vj = valid[a].reshape(n, 27 * C)
        if cell_typ is not None:
            ti = typ[c0:c1, :, None].expand(n, C, 27 * C)
            tj = typ[a].reshape(n, 1, 27 * C).expand(n, C, 27 * C)
            rc2 = params_vec[0][ti, tj]
        xi = cell_pos[c0:c1]
        # dr = xi - xj by component, each (n, C, 27C) contiguous
        xj = xj.permute(2, 0, 1)
        dx, dy, dz = (xi[:, :, None, d] - xj[d][:, None, :] for d in range(3))
        r2 = dx * dx + dy * dy + dz * dz
        self_pair = (own[c0:c1, None, :, None]
                     & eye[None, :, None, :]).reshape(n, C, 27 * C)
        pair = (valid[c0:c1, :, None] & vj[:, None, :] & (r2 < rc2)
                & ~self_pair)
        if cell_typ is not None:
            # the pairs inside their cut alone, each with its own
            # parameters, summed on their slot in j order
            at = pair.nonzero(as_tuple=True)
            _, es_in, p_in = pair_eval.params_dict(params_vec, pnames,
                                                   ti[at], tj[at])
            r2_in = r2[at]
            f_in, e_in = ev.energy_force(torch.clamp(r2_in, min=1e-3), p_in)
            slot = (c0 + at[0]) * C + at[1]
            d_in = torch.stack([dx[at], dy[at], dz[at]], dim=-1)
            fd = f_in[:, None] * d_in
            F.view(nc * C, 3).index_add_(0, slot, fd)
            if want_pv:
                e_in = torch.where(r2_in > 1e-6, e_in - es_in, 0.0)
                pe.view(nc * C).index_add_(0, slot, 0.5 * e_in)
                vir.view(nc * C, 6).index_add_(0, slot, 0.5 * torch.stack(
                    [fd[:, u] * d_in[:, w] for u, w in VIRIAL_PAIRS], -1))
            continue
        f_raw, e_raw = ev.energy_force(torch.clamp(r2, min=1e-3), p)
        fdivr = torch.where(pair, f_raw, 0.0)
        F[c0:c1] = torch.stack([(fdivr * dx).sum(-1), (fdivr * dy).sum(-1),
                                (fdivr * dz).sum(-1)], dim=-1)
        if want_pv:
            e = torch.where(pair & (r2 > 1e-6), e_raw - e_shift, 0.0)
            pe[c0:c1] = 0.5 * e.sum(-1)
            vir[c0:c1] = 0.5 * torch.stack(
                [(fdivr * u * w).sum(-1) for u, w in
                 ((dx, dx), (dx, dy), (dx, dz), (dy, dy), (dy, dz),
                  (dz, dz))], dim=-1)
    return F, pe, vir


def cell_pair_plane_plain(cell_pos, cell_dim, cell_shift, params_vec, *,
                          cell_tag, eval_name='lj', pnames=LJ_PNAMES):
    """Plain torch version of cell_pair_plane (exact divide)."""
    return _stencil_plain(cell_pos, cell_tag,
                          _adjacency(cell_dim, cell_pos.device), cell_shift,
                          params_vec, False, eval_name, pnames)[0]


def cell_pair_planar_plain(cell_pos, cell_dim, cell_shift, params_vec, *,
                           cell_tag, eval_name='lj', pnames=LJ_PNAMES,
                           ntypes=1, cell_typ=None):
    """Plain torch version of cell_pair_planar: (F, pe, vir); with
    ntypes > 1 the (2 + NP, T, T) table of a mixture and its cell_typ."""
    return _stencil_plain(cell_pos, cell_tag,
                          _adjacency(cell_dim, cell_pos.device), cell_shift,
                          params_vec, True, eval_name, pnames,
                          cell_typ if ntypes > 1 else None)


def _pv_of_lj(lj_params):
    """The LJ-only kernels' [lj1, lj2, rc2, e_shift] -> [rc2, e_shift,
    lj1, lj2, rcut]."""
    return torch.stack([lj_params[2], lj_params[3], lj_params[0],
                        lj_params[1], torch.sqrt(lj_params[2])])


def cell_pair_lj_plain(cell_pos, cell_adj, cell_shift, lj_params, *,
                       cell_tag):
    """Plain torch version of cell_pair_lj: (F, pe, vir) against the
    cells that ``cell_adj`` lists."""
    return _stencil_plain(cell_pos, cell_tag, cell_adj, cell_shift,
                          _pv_of_lj(lj_params), want_pv=True)


def cell_pair_lj_pallas3d_plain(cell_pos, cell_dim, cell_shift, lj_params,
                                *, cell_tag):
    """Plain torch version of cell_pair_lj_pallas3d: the forces of the
    27-cell stencil (exact divide)."""
    return cell_pair_plane_plain(cell_pos, cell_dim, cell_shift,
                                 _pv_of_lj(lj_params), cell_tag=cell_tag)


def cell_pair_lj_row_plain(cell_pos, cell_dim, cell_shift, lj_params, *,
                           cell_tag):
    """Plain torch version of cell_pair_lj_row: the same function as
    cell_pair_lj_pallas3d."""
    return cell_pair_lj_pallas3d_plain(cell_pos, cell_dim, cell_shift,
                                       lj_params, cell_tag=cell_tag)


# the half stencil's (dz, dy) rows, as pallas_pair.py _N3L_OFFS: with dx
# = -1, 0, +1 each, but for the own row, which takes dx = 0 (pairs i < j
# of the own cell) and dx = +1
N3L_ROWS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def cell_pair_planar_n3l_plain(cell_pos, cell_dim, cell_shift, params_vec,
                               *, cell_tag, eval_name='lj', pnames=LJ_PNAMES,
                               ntypes=1, cell_typ=None):
    """Plain torch version of cell_pair_planar_n3l: it walks the half
    stencil itself.  Every pair is evaluated once, its force summed on
    the home cell's slot and its -F put back on the neighbour cell's
    slot; a mixture's pair reads table[k, t_home, t_neighbour]."""
    nc, C, _ = cell_pos.shape
    dev = cell_pos.device
    ev = _evaluator(eval_name, pnames)
    typed = ntypes > 1
    if typed:
        typ = cell_typ.long()
    else:
        rc2, _, p = pair_eval.params_dict(params_vec, pnames)
    adj = _adjacency(cell_dim, dev)
    valid = cell_tag >= 0
    upper = torch.ones((C, C), dtype=torch.bool, device=dev).triu(1)
    F = torch.zeros_like(cell_pos)
    for dz, dy in N3L_ROWS:
        for dx in ((0, 1) if (dz, dy) == (0, 0) else (-1, 0, 1)):
            k = (dz + 1) * 9 + (dy + 1) * 3 + dx + 1
            nb = adj[:, k]                  # a permutation of the cells
            xj = cell_pos[nb] + cell_shift[:, k, None, :]
            dr = cell_pos[:, :, None, :] - xj[:, None, :, :]  # (nc, C, C, 3)
            r2 = (dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1]
                  + dr[..., 2] * dr[..., 2])
            if typed:
                rc2, _, p = pair_eval.params_dict(params_vec, pnames,
                                                  typ[:, :, None],
                                                  typ[nb][:, None, :])
            pair = valid[:, :, None] & valid[nb][:, None, :] & (r2 < rc2)
            if k == 13:
                pair = pair & upper
            f_raw, _ = ev.energy_force(torch.clamp(r2, min=1e-3), p)
            f = torch.where(pair, f_raw, 0.0)[..., None] * dr
            F += f.sum(2)
            F.index_add_(0, nb, -f.sum(1))
    return F


def _planes_to_cells(a, nc, C):
    """(3, nz, ny, nx, C) -> (nc, C, 3)."""
    return a.permute(1, 2, 3, 4, 0).reshape(nc, C, 3)


def _cells_to_planes(a, cell_dim, C):
    nx, ny, nz = cell_dim
    return a.reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2, 3)


def _as_scalar(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device).reshape(())


def _inv_thresholds(skin, ref):
    skin3 = torch.as_tensor(skin, dtype=ref.dtype,
                            device=ref.device).reshape(-1).expand(3)
    return 1.0 / (0.5 * skin3) ** 2


def cell_megastep_planes_plain(gp, gv, gf, gw, gm, gr, cell_dim, cell_shift,
                               params_vec, dt, kt_table, xi, eta, skin, *, C,
                               k, method, gt, ndof=1.0, tau_inv2=0.0,
                               gamma=0.0, gn=None, eval_name='lj',
                               pnames=LJ_PNAMES):
    """Plain torch version of cell_megastep_planes: the same 8-tuple,
    with exact divides."""
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    dt = _as_scalar(dt, gp)
    hdt = 0.5 * dt
    tinv2 = _as_scalar(tau_inv2, gp)
    gamma = _as_scalar(gamma, gp)
    xi = _as_scalar(xi, gp)
    eta = _as_scalar(eta, gp)
    it3 = _inv_thresholds(skin, gp)
    kt_table = torch.as_tensor(kt_table, dtype=gp.dtype, device=gp.device)
    tag_cells = gt.reshape(nc, C)
    p, v, f = gp.clone(), gv.clone(), gf.clone()
    w = gw[None]
    ke2 = (v * v * gm[None]).sum()
    mdmax = torch.zeros((), dtype=gp.dtype, device=gp.device)
    for si in range(k):
        if method == 'nvt':
            kT = kt_table[si]
            xi1 = xi + hdt * (ke2 / (ndof * kT) - 1.0) * tinv2
            s = torch.exp(-hdt * xi1)
            eta = eta + dt * xi1
        else:
            xi1 = xi
            s = 1.0
        v = s * v + hdt * f * w
        p = p + dt * v
        d = p - gr
        md2 = mdmax
        for a in range(3):
            q = (d[a] * d[a]).reshape(-1)
            m1 = q.max()
            eq = q == m1
            tie = eq.sum() > 1
            m2 = torch.clamp(torch.where(eq, -1.0, q).max(), min=0.0)
            m2 = torch.where(tie, m1, m2)
            sd = 0.5 * (torch.sqrt(m1 * it3[a]) + torch.sqrt(m2 * it3[a]))
            md2 = torch.maximum(md2, sd * sd)
        mdmax = md2
        F = cell_pair_plane_plain(_planes_to_cells(p, nc, C), cell_dim,
                                  cell_shift, params_vec, cell_tag=tag_cells,
                                  eval_name=eval_name, pnames=pnames)
        F = _cells_to_planes(F, cell_dim, C)
        if method == 'langevin':
            f = F + gn[si] - gamma * v
            v = v + hdt * f * w
            xi = xi1
            continue
        f = F
        v = v + hdt * f * w
        if method == 'nvt':
            v = v * s
            ke2 = (v * v * gm[None]).sum()
            xi = xi1 + hdt * (ke2 / (ndof * kT) - 1.0) * tinv2
        else:
            xi = xi1
    return p, v, f, xi, eta, mdmax > 1.0, ke2, mdmax


# the rounding margin of the candidate test, added to each axis' skin:
# 1e-3, or 2^-16 of the longest box edge where that is larger, many ulps
# of any coordinate in the box (an ulp of 64 is 8e-6)
CAND_MARGIN = 1e-3


def candidate_pads(skin, box_L):
    """The per-axis skins of the candidate test: skin (scalar or (3,))
    plus the rounding margin, as float32 on the host."""
    skin3 = np.broadcast_to(np.asarray(skin, np.float64).reshape(-1), (3,))
    margin = max(CAND_MARGIN, float(np.max(box_L)) * 2.0 ** -16)
    return (skin3 + margin).astype(np.float32)


class MegaCandidates:
    """The megastep's candidate set of one reference (mega_candidates).

    Slot j's candidates are the entries t of its cell's staged stencil (27
    C entries, build_cell_shifts order) that hold a live slot other than j
    which can come inside r_cut while the megastep's drift guard holds,
    measured from ``gr``, the reference planes the set was built from
    (candidate_keep).  ``count`` (M,) int32: their number per slot;
    ``listed`` (M, cap) int16: each slot's candidates in ascending order as
    indices into the kernel's staged union of a run of cells (mega_run),
    the first min(count, cap) of a row (the kernel leaves the rest
    unwritten; a slot with more candidates walks every staged slot).  A
    window takes the set only with those same planes, unmodified."""

    def __init__(self, count, listed, gr, pads, rc2):
        self.count, self.listed = count, listed
        self.cap = listed.shape[1]
        self.gr, self.version = gr, gr._version
        self.pads, self.rc2 = pads, rc2

    def check(self, gr):
        if gr is not self.gr or gr._version != self.version:
            raise ValueError("the candidate set was built from other reference "
                             "positions than the window's; build it anew "
                             "(mega_candidates) after every rebuild")


# the elements of one chunk of cells in candidate_keep and
# mega_candidates_plain
CAND_CHUNK = 1 << 22


def _candidate_cap(C):
    """The slots of a candidate list: 256, or the whole stencil when
    smaller, a multiple of 8 (the kernel reads 8 at a time)."""
    return min(256, -(-27 * C // 8) * 8)


# the megastep kernel's runs along x (csrc/cell_pair.cu mega_run): up to
# 4 cells, at most 512 slots
def mega_run(nx, C):
    return max(1, min(4, nx, 512 // C))


def _union_index(cell_dim, C):
    """(nc, 27 C) int64: the kernel's staged union index of each stencil
    entry of each cell, in its run of mega_run(nx, C) cells along x."""
    nx = cell_dim[0]
    nc = int(np.prod(cell_dim))
    R = mega_run(nx, C)
    ix = np.arange(nc) % nx
    r = ix % R
    uw = np.minimum(R, nx - (ix - r)) + 2
    k = np.arange(27)
    kz, ky, kx = k // 9, (k // 3) % 3, k % 3
    u = ((kz * 3 + ky)[None, :] * uw[:, None] + r[:, None] + kx[None, :])
    return (u[:, :, None] * C + np.arange(C)[None, None, :]).reshape(nc, -1)


def candidate_keep(gr, gt, cell_dim, cell_shift, pads, rc2, *, C):
    """The candidate test, plain torch: (nc, C, 27 C) bool, entry t of
    slot i of cell c kept when both slots are live, t is not i itself, and
    sum_a max(|dr_a| - pads_a, 0)^2 < rc2, dr = x_i - (x_t + shift) from
    the planes gr, every operation rounded in float32 as the kernel rounds
    it.  With pads 0 it keeps the pairs inside r_cut at gr."""
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    n27 = 27 * C
    dev = gr.device
    pos = _planes_to_cells(gr.float(), nc, C)
    valid = gt.reshape(nc, C) >= 0
    adj = _adjacency(cell_dim, dev)
    sh = cell_shift.float()
    pads = torch.as_tensor(pads, dtype=torch.float32, device=dev)
    rc2 = torch.tensor(rc2, dtype=torch.float32, device=dev)
    own = torch.zeros((C, n27), dtype=torch.bool, device=dev)
    own[torch.arange(C), 13 * C + torch.arange(C)] = True
    keep = torch.empty((nc, C, n27), dtype=torch.bool, device=dev)
    chunk = max(1, CAND_CHUNK // (C * n27 * 3))
    for c0 in range(0, nc, chunk):
        c1 = min(nc, c0 + chunk)
        a = adj[c0:c1]
        xj = (pos[a] + sh[c0:c1, :, None, :]).reshape(c1 - c0, n27, 3)
        d = pos[c0:c1, :, None, :] - xj[:, None, :, :]
        m = torch.clamp(d.abs() - pads, min=0.0)
        lb = (m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1]) \
            + m[..., 2] * m[..., 2]
        keep[c0:c1] = (valid[c0:c1, :, None]
                       & valid[a].reshape(c1 - c0, 1, n27)
                       & (lb < rc2) & ~own)
    return keep


def mega_candidates_plain(gr, gt, cell_dim, cell_shift, pads, rc2, *, C):
    """Plain torch version of mega_candidates: (count, listed) as
    MegaCandidates holds them (unwritten entries zero), from
    candidate_keep."""
    nc = int(np.prod(cell_dim))
    dev = gr.device
    keep = candidate_keep(gr, gt, cell_dim, cell_shift, pads, rc2, C=C)
    cap = _candidate_cap(C)
    listed = torch.zeros((nc, C, cap), dtype=torch.int16, device=dev)
    union = torch.as_tensor(_union_index(cell_dim, C), device=dev)
    chunk = max(1, CAND_CHUNK // (C * 27 * C))
    for c0 in range(0, nc, chunk):
        kc = keep[c0:c0 + chunk]
        rank = torch.cumsum(kc, -1) - 1
        ci, si, ti = torch.nonzero(kc & (rank < cap), as_tuple=True)
        listed[c0 + ci, si, rank[ci, si, ti]] = union[c0 + ci, ti].to(
            torch.int16)
    count = keep.sum(-1, dtype=torch.int32)
    return count.reshape(-1), listed.reshape(nc * C, cap)


def cell_step_plane_planes_plain(gp, gv, gf, gw, gr, cell_dim, cell_shift,
                                 params_vec, dt, s, *, C, gt, eval_name='lj',
                                 pnames=LJ_PNAMES):
    """Plain torch version of cell_step_plane_planes (exact divide), in
    the kernel's operation order: the drift as separate products and
    sums, the stencil of cell_pair_plane_plain at the drifted positions,
    the kick."""
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    dt = _as_scalar(dt, gp)
    hdt = 0.5 * dt
    s = _as_scalar(s, gp)
    w = gw[None]
    vh = s * gv + hdt * gf * w
    p = gp + dt * vh
    F = cell_pair_plane_plain(_planes_to_cells(p, nc, C), cell_dim,
                              cell_shift, params_vec,
                              cell_tag=gt.reshape(nc, C),
                              eval_name=eval_name, pnames=pnames)
    F = _cells_to_planes(F, cell_dim, C)
    v = s * (vh + hdt * F * w)
    ke2 = (v * v / w).sum()
    d = p - gr
    md2 = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).max()
    return p, v, F.contiguous(), ke2, md2


# ---------------------------------------------------------------------------
# wrappers


_LIB = []


def _kernel_lib():
    """The kernel library, built and loaded at the first launch."""
    if not _LIB:
        from ._build import load
        _LIB.append(load())
    return _LIB[0]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda_inputs(*tensors):
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError("kernel inputs must all lie on the CUDA device")


def _check_shapes(C, **shapes):
    """Raise unless every named tensor has its expected shape; the
    kernels index by these shapes."""
    if C > MAX_C:
        raise NotImplementedError(f"cell capacity C={C} exceeds the "
                                  f"kernels' limit of {MAX_C}")
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: expected shape {tuple(want)}, got "
                             f"{tuple(t.shape)}")


def _check_pair_args(cell_pos, cell_tag, cell_dim, cell_shift, params_vec,
                     C, eval_name, pnames, ntypes=1, cell_typ=None):
    """Shapes, the types of a mixture, and the evaluator: returns its
    kernel id."""
    nc = int(np.prod(cell_dim))
    shapes = dict(cell_pos=(cell_pos, (nc, C, 3)),
                  cell_tag=(cell_tag, (nc, C)),
                  cell_shift=(cell_shift, (nc, 27, 3)))
    if ntypes > 1:
        if cell_typ is None:
            raise ValueError(f"a mixture of {ntypes} types needs cell_typ")
        shapes['cell_typ'] = (cell_typ, (nc, C))
    _check_shapes(C, **shapes)
    return _eval_id(eval_name, pnames, params_vec, ntypes)


def _eval_id(eval_name, pnames, params_vec, ntypes=1):
    _evaluator(eval_name, pnames)
    if not 1 <= ntypes <= MAX_TYPES:
        raise NotImplementedError(f"{ntypes} particle types: the kernels "
                                  f"take 1 to {MAX_TYPES}")
    if ntypes == 1 and params_vec.numel() != 2 + len(pnames):
        raise ValueError(f"params_vec needs [rc2, e_shift, "
                         f"{', '.join(pnames)}], got {params_vec.numel()} "
                         f"values")
    want = (2 + len(pnames), ntypes, ntypes)
    if ntypes > 1 and tuple(params_vec.shape) != want:
        raise ValueError(f"params_vec of {ntypes} types needs the per-pair "
                         f"table [rc2, e_shift, {', '.join(pnames)}] of shape "
                         f"{want}, got {tuple(params_vec.shape)}")
    return pair_eval.EVAL_IDS[eval_name]


def _device_of(t):
    if t.device.type not in ('cuda', 'cpu'):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def cell_pair_plane(cell_pos, cell_dim, cell_shift, params_vec, *, C,
                    cell_tag, recip='div', eval_name='lj', pnames=LJ_PNAMES):
    """Forces (nc, C, 3) of the full 27-cell stencil of the pair evaluator
    ``eval_name``.  params_vec = [rc2, e_shift, *pnames].
    recip='approx' takes the fast reciprocal on the card (lj only, as in
    the JAX kernels), 'div' the exact divide."""
    approx = _recip_flag(recip)
    ev = _check_pair_args(cell_pos, cell_tag, cell_dim, cell_shift,
                          params_vec, C, eval_name, pnames)
    if _device_of(cell_pos) == 'cpu':
        return cell_pair_plane_plain(cell_pos, cell_dim, cell_shift,
                                     params_vec, cell_tag=cell_tag,
                                     eval_name=eval_name, pnames=pnames)
    _require_cuda_inputs(cell_tag, cell_shift, params_vec)
    lib = _kernel_lib()
    pos = cell_pos.contiguous().float()
    tag = cell_tag.contiguous().to(torch.int32)
    sh = cell_shift.contiguous().float()
    par = params_vec.contiguous().float()
    out = torch.empty_like(pos)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_plane(
        pos.data_ptr(), 3, 1, tag.data_ptr(), sh.data_ptr(), par.data_ptr(),
        len(pnames), out.data_ptr(), 3, 1, nx, ny, nz, C, ev, approx,
        _stream(pos))
    lib.check(err, 'cell_pair_plane')
    cell_pair_plane.launches += 1
    return out


cell_pair_plane.launches = 0


def cell_pair_planar(cell_pos, cell_dim, cell_shift, params_vec, *, C,
                     cell_tag, eval_name='lj', pnames=LJ_PNAMES, ntypes=1,
                     cell_typ=None, want_pv=True):
    """Forces, per-particle PE (1/2 per pair) and the 6-component virial
    (1/2 per pair, order xx, xy, xz, yy, yz, zz) of the stencil of the
    pair evaluator ``eval_name`` (exact divide); F alone with want_pv
    False.  One type: params_vec = [rc2, e_shift, *pnames].  A mixture of
    ntypes = 2..MAX_TYPES: params_vec is the (2 + NP, T, T) table, read
    per pair (i, j) at [k, typ_i, typ_j], and cell_typ (nc, C) the slots'
    types; its kernel (csrc/cell_pair_typed.cu) counts its launches in
    ``typed_launches``."""
    ev = _check_pair_args(cell_pos, cell_tag, cell_dim, cell_shift,
                          params_vec, C, eval_name, pnames, ntypes, cell_typ)
    if ntypes > 1:
        return _cell_pair_planar_typed(cell_pos, cell_dim, cell_shift,
                                       params_vec, C, cell_tag, cell_typ,
                                       ntypes, ev, eval_name, pnames, want_pv)
    if _device_of(cell_pos) == 'cpu':
        out = cell_pair_planar_plain(cell_pos, cell_dim, cell_shift,
                                     params_vec, cell_tag=cell_tag,
                                     eval_name=eval_name, pnames=pnames)
        return out if want_pv else out[0]
    _require_cuda_inputs(cell_tag, cell_shift, params_vec)
    lib = _kernel_lib()
    pos = cell_pos.contiguous().float()
    tag = cell_tag.contiguous().to(torch.int32)
    sh = cell_shift.contiguous().float()
    par = params_vec.contiguous().float()
    nc = pos.shape[0]
    F = torch.empty_like(pos)
    pe = torch.empty((nc, C), dtype=pos.dtype, device=pos.device)
    vir = torch.empty((nc, C, 6), dtype=pos.dtype, device=pos.device)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_planar(
        pos.data_ptr(), 3, 1, tag.data_ptr(), sh.data_ptr(), par.data_ptr(),
        len(pnames), F.data_ptr(), pe.data_ptr(), vir.data_ptr(), nx, ny, nz,
        C, ev, _stream(pos))
    lib.check(err, 'cell_pair_planar')
    cell_pair_planar.launches += 1
    return (F, pe, vir) if want_pv else F


def _cell_pair_planar_typed(cell_pos, cell_dim, cell_shift, params_vec, C,
                            cell_tag, cell_typ, ntypes, ev, eval_name, pnames,
                            want_pv):
    if _device_of(cell_pos) == 'cpu':
        out = cell_pair_planar_plain(cell_pos, cell_dim, cell_shift,
                                     params_vec, cell_tag=cell_tag,
                                     eval_name=eval_name, pnames=pnames,
                                     ntypes=ntypes, cell_typ=cell_typ)
        return out if want_pv else out[0]
    _require_cuda_inputs(cell_tag, cell_typ, cell_shift, params_vec)
    lib = _kernel_lib()
    pos, tag, sh, par = _lj_args(cell_pos, cell_tag, cell_shift, params_vec)
    typ = cell_typ.contiguous().to(torch.int32)
    nc = pos.shape[0]
    F = torch.empty_like(pos)
    pe = vir = None
    if want_pv:
        pe = torch.empty((nc, C), dtype=pos.dtype, device=pos.device)
        vir = torch.empty((nc, C, 6), dtype=pos.dtype, device=pos.device)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_planar_typed(
        pos.data_ptr(), tag.data_ptr(), typ.data_ptr(), sh.data_ptr(),
        par.data_ptr(), len(pnames), ntypes, F.data_ptr(),
        pe.data_ptr() if want_pv else None,
        vir.data_ptr() if want_pv else None, nx, ny, nz, C, ev, int(want_pv),
        _stream(pos))
    lib.check(err, 'cell_pair_planar (typed)')
    cell_pair_planar.typed_launches += 1
    return (F, pe, vir) if want_pv else F


cell_pair_planar.launches = 0
cell_pair_planar.typed_launches = 0

_METHODS = {'nve': 0, 'nvt': 1, 'langevin': 2}


def mega_candidates(gr, gt, cell_dim, cell_shift, pads, rc2, *, C):
    """The megastep's candidate set of the reference planes gr (3, nz, ny,
    nx, C) float32, contiguous, with the tag planes gt (nz, ny, nx, C):
    a MegaCandidates.  pads: the per-axis skins of the drift guard plus
    the rounding margin (candidate_pads); rc2: r_cut^2, a float.  A slot
    keeps a staged entry when the pair can come inside r_cut while every
    particle stays within the guard (mega_candidates_plain)."""
    nx, ny, nz = cell_dim
    _check_shapes(C, gr=(gr, (3, nz, ny, nx, C)), gt=(gt, (nz, ny, nx, C)),
                  cell_shift=(cell_shift, (nx * ny * nz, 27, 3)))
    if gr.dtype != torch.float32 or not gr.is_contiguous():
        raise ValueError("gr: the reference planes must be contiguous float32")
    pads = np.asarray(pads, np.float32).reshape(3)
    rc2 = float(np.float32(rc2))
    if _device_of(gr) == 'cpu':
        out = mega_candidates_plain(gr, gt, cell_dim, cell_shift, pads, rc2,
                                    C=C)
        return MegaCandidates(*out, gr, pads, rc2)
    _require_cuda_inputs(gt, cell_shift)
    lib = _kernel_lib()
    tag = gt.contiguous().to(torch.int32)
    sh = cell_shift.contiguous().float()
    M = gr[0].numel()
    count = torch.empty((M,), dtype=torch.int32, device=gr.device)
    listed = torch.empty((M, _candidate_cap(C)), dtype=torch.int16,
                         device=gr.device)
    err = lib.lib.hoomd_mega_candidates(
        gr.data_ptr(), tag.data_ptr(), sh.data_ptr(), float(pads[0]),
        float(pads[1]), float(pads[2]), rc2, listed.data_ptr(), count.data_ptr(), listed.shape[1], nx, ny, nz, C,
        _stream(gr))
    lib.check(err, 'mega_candidates')
    mega_candidates.launches += 1
    return MegaCandidates(count, listed, gr, pads, rc2)


mega_candidates.launches = 0


class MegaWorkspace:
    """What every megastep window of one program and parameter set
    reuses: the parameter vector mp = [dt, 1/tau^2, it_x, it_y, it_z,
    gamma, ndof, rc2, e_shift, *pnames] on the device, the kernel's
    scratch, and the launch's static arguments."""

    def __init__(self, cell_dim, C, k, method, cell_shift, params_vec, dt,
                 skin, *, ndof=1.0, tau_inv2=0.0, gamma=0.0, recip='approx',
                 eval_name='lj', pnames=LJ_PNAMES):
        if method not in _METHODS:
            raise NotImplementedError(f"megastep method {method!r}")
        self.approx = _recip_flag(recip)
        self.ev = _eval_id(eval_name, pnames, params_vec)
        self.cell_dim, self.C, self.k, self.method = tuple(cell_dim), C, k, \
            method
        self.eval_name, self.pnames = eval_name, tuple(pnames)
        self.shift = cell_shift.contiguous().float()
        self.params_vec = params_vec
        self.dt, self.skin, self.ndof = dt, skin, ndof
        self.tau_inv2, self.gamma = tau_inv2, gamma
        dev = cell_shift.device
        f32 = torch.float32
        it3 = _inv_thresholds(skin, self.shift)
        host = [dt, tau_inv2, gamma, ndof]
        if all(isinstance(x, (int, float)) for x in host):
            dts, ti2, gam, nd = torch.tensor(host, dtype=f32).to(dev)
        else:
            dts, ti2, gam, nd = (_as_scalar(x, self.shift) for x in host)
        self.mp = torch.cat([torch.stack([dts, ti2, it3[0], it3[1], it3[2],
                                          gam, nd]),
                             params_vec.to(f32).reshape(-1)]).contiguous()
        nx, ny, nz = cell_dim
        M = nx * ny * nz * C
        nb = -(-M // 256)
        # Top2 records of 12 bytes per axis and chunk; per-cell KE
        self.dpart = torch.empty((nb * 3 * 3,), dtype=f32, device=dev)
        self.kpart = torch.empty((max(nb, nx * ny * nz),), dtype=f32,
                                 device=dev)
        # the kT table of an NVE window, which the kernel does not read
        self.unit_kt = torch.ones((k,), dtype=f32, device=dev)


def megastep_window(gp, gv, gf, gw, gm, gt, cand, ws, sc, kt, gn=None):
    """One window of ws.k fused velocity-Verlet steps, in place: gp, gv,
    gf (3, nz, ny, nx, C) float32 contiguous are advanced, and sc (4,)
    float32 = [xi, eta, ke2, mdmax] is read and written (mdmax the
    running maximum of the drift ratio, so windows chained on one sc
    carry it).  gw = 1/m, gm = m float32 and gt int32 (nz, ny, nx, C),
    contiguous; cand the MegaCandidates of the window's reference
    planes; ws its MegaWorkspace; kt (k,) float32 per-step kT; gn the (k,
    3, nz, ny, nx, C) Langevin noise planes.  On the CPU the plain
    version computes the window and its results are copied in."""
    nx, ny, nz = ws.cell_dim
    C, k = ws.C, ws.k
    if _device_of(gp) == 'cpu':
        out = cell_megastep_planes_plain(
            gp, gv, gf, gw, gm, cand.gr, ws.cell_dim, ws.shift,
            ws.params_vec, ws.dt, kt, sc[0], sc[1], ws.skin, C=C, k=k,
            method=ws.method, gt=gt, ndof=ws.ndof, tau_inv2=ws.tau_inv2,
            gamma=ws.gamma, gn=gn, eval_name=ws.eval_name, pnames=ws.pnames)
        gp.copy_(out[0])
        gv.copy_(out[1])
        gf.copy_(out[2])
        sc.copy_(torch.stack([out[3], out[4], out[6],
                              torch.maximum(sc[3], out[7])]))
        return
    for t in (gp, gv, gf, sc, kt, gw, gm):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("megastep_window takes contiguous float32 "
                             "state, scalars and kT")
    if gt.dtype != torch.int32:
        raise ValueError("megastep_window takes int32 tag planes")
    lib = _kernel_lib()
    err = lib.lib.hoomd_megastep(
        gp.data_ptr(), gv.data_ptr(), gf.data_ptr(), gw.data_ptr(),
        gm.data_ptr(), cand.gr.data_ptr(), gt.data_ptr(), ws.shift.data_ptr(),
        ws.mp.data_ptr(), len(ws.pnames), sc.data_ptr(), kt.data_ptr(),
        gn.data_ptr() if gn is not None else None, cand.listed.data_ptr(),
        cand.count.data_ptr(),
        cand.cap, ws.dpart.data_ptr(), ws.kpart.data_ptr(), nx, ny, nz, C, k,
        _METHODS[ws.method], ws.ev, ws.approx, _stream(gp))
    lib.check(err, 'cell_megastep_planes')
    cell_megastep_planes.launches += 1


def cell_megastep_planes(gp, gv, gf, gw, gm, gr, cell_dim, cell_shift,
                         params_vec, dt, kt_table, xi, eta, skin, *, C, k,
                         method, gt, recip='approx', ndof=1.0, tau_inv2=0.0,
                         gamma=0.0, gn=None, eval_name='lj',
                         pnames=LJ_PNAMES, cand=None):
    """k fused velocity-Verlet steps on plane-layout state.

    gp/gv/gf/gr (3, nz, ny, nx, C); gw = 1/m and gm = m (nz, ny, nx, C);
    gt the tag planes (nz, ny, nx, C), which give slot validity;
    kt_table (k,) per-step kT; xi/eta the Nose-Hoover scalars; skin a
    scalar or per-axis (3,) Verlet skin.  method 'langevin' takes gamma
    and gn, the (k, 3, nz, ny, nx, C) amplitude-scaled noise planes.
    Forces from the pair evaluator ``eval_name``, params_vec = [rc2,
    e_shift, *pnames].  Returns (pos, vel, frc, xi, eta, danger, ke2,
    mdmax) as in the JAX package: danger is mdmax > 1, mdmax the largest
    normalised drift ratio ((d1 + d2) / skin_a)^2 of the window.
    recip='approx' takes the fast reciprocal on the card (lj only), 'div'
    the exact divide.  cand: the MegaCandidates of gr (mega_candidates
    with candidate_pads of skin), required on the card.  The outputs are
    new tensors (megastep_window is the in-place form)."""
    _recip_flag(recip)
    if method not in _METHODS:
        raise NotImplementedError(f"megastep method {method!r}")
    if method == 'langevin' and gn is None:
        raise ValueError("langevin needs the noise planes gn")
    nx, ny, nz = cell_dim
    p5, p4 = (3, nz, ny, nx, C), (nz, ny, nx, C)
    shapes = dict(gp=(gp, p5), gv=(gv, p5), gf=(gf, p5), gr=(gr, p5),
                  gw=(gw, p4), gm=(gm, p4), gt=(gt, p4),
                  cell_shift=(cell_shift, (nx * ny * nz, 27, 3)),
                  kt_table=(torch.as_tensor(kt_table).reshape(-1), (k,)))
    if method == 'langevin':
        shapes['gn'] = (gn, (k,) + p5)
    _check_shapes(C, **shapes)
    _eval_id(eval_name, pnames, params_vec)
    if cand is not None:
        cand.check(gr)
    if _device_of(gp) == 'cpu':
        return cell_megastep_planes_plain(
            gp, gv, gf, gw, gm, gr, cell_dim, cell_shift, params_vec, dt,
            kt_table, xi, eta, skin, C=C, k=k, method=method, gt=gt,
            ndof=ndof, tau_inv2=tau_inv2, gamma=gamma, gn=gn,
            eval_name=eval_name, pnames=pnames)
    _require_cuda_inputs(gv, gf, gw, gm, gr, gt, cell_shift, params_vec)
    if cand is None:
        raise ValueError("cell_megastep_planes on the card takes the "
                         "candidate set of gr (cand=mega_candidates(...))")
    f32 = torch.float32
    dev = gp.device
    ws = MegaWorkspace(cell_dim, C, k, method, cell_shift, params_vec, dt,
                       skin, ndof=ndof, tau_inv2=tau_inv2, gamma=gamma,
                       recip=recip, eval_name=eval_name, pnames=pnames)
    tag = gt.contiguous().to(torch.int32)
    p = gp.contiguous().to(f32).clone()
    v = gv.contiguous().to(f32).clone()
    f = gf.contiguous().to(f32).clone()
    z = torch.zeros((), dtype=f32, device=dev)
    sc = torch.stack([_as_scalar(xi, p), _as_scalar(eta, p), z,
                      z]).contiguous()
    kt = torch.as_tensor(kt_table, dtype=f32, device=dev).reshape(
        -1).contiguous()
    noise = gn.contiguous().to(f32) if method == 'langevin' else None
    megastep_window(p, v, f, gw.contiguous().to(f32),
                    gm.contiguous().to(f32), tag, cand, ws, sc, kt, noise)
    return p, v, f, sc[0], sc[1], sc[3] > 1.0, sc[2], sc[3]


cell_megastep_planes.launches = 0


def cell_step_plane_planes(gp, gv, gf, gw, gr, cell_dim, cell_shift,
                           params_vec, dt, s, *, C, gt, eval_name='lj',
                           pnames=LJ_PNAMES, recip='approx'):
    """One fused velocity-Verlet step on plane-layout state
    (pallas_pair.py cell_step_plane_planes).

    gp/gv/gf/gr (3, nz, ny, nx, C); gw = 1/m and gt the tag planes (nz,
    ny, nx, C); params_vec = [rc2, e_shift, *pnames] of the pair
    evaluator ``eval_name``; dt the timestep (a float); s the thermostat
    scale (exp(-dt/2 xi) for NVT, 1 for NVE; a 0-d tensor stays on the
    device).  Every slot drifts, x' = x + dt (s v + dt/2 f/m); the force
    is the 27-cell stencil at the drifted positions; the kick is v' =
    s (vh + dt/2 F/m).  Returns (gp', gv', gf', ke2, md2): ke2 = sum m
    v'^2, md2 = max |x' - gr|^2, 0-d.  The outputs are new tensors: the
    kernel reads its neighbours' pre-step state while it writes.
    recip='approx' takes the fast reciprocal on the card (lj only)."""
    approx = _recip_flag(recip)
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    p5, p4 = (3, nz, ny, nx, C), (nz, ny, nx, C)
    _check_shapes(C, gp=(gp, p5), gv=(gv, p5), gf=(gf, p5), gr=(gr, p5),
                  gw=(gw, p4), gt=(gt, p4),
                  cell_shift=(cell_shift, (nc, 27, 3)))
    ev = _eval_id(eval_name, pnames, params_vec)
    if _device_of(gp) == 'cpu':
        return cell_step_plane_planes_plain(
            gp, gv, gf, gw, gr, cell_dim, cell_shift, params_vec, dt, s, C=C,
            gt=gt, eval_name=eval_name, pnames=pnames)
    _require_cuda_inputs(gv, gf, gw, gr, gt, cell_shift, params_vec)
    lib = _kernel_lib()
    f32 = torch.float32
    p = gp.contiguous().to(f32)
    v = gv.contiguous().to(f32)
    f = gf.contiguous().to(f32)
    w = gw.contiguous().to(f32)
    r = gr.contiguous().to(f32)
    tag = gt.contiguous().to(torch.int32)
    sh = cell_shift.contiguous().to(f32)
    par = params_vec.contiguous().to(f32)
    s_t = _as_scalar(s, p).contiguous()
    po, vo, fo = torch.empty_like(p), torch.empty_like(p), torch.empty_like(p)
    part = torch.empty((2 * nc,), dtype=f32, device=p.device)
    out = torch.empty((2,), dtype=f32, device=p.device)
    err = lib.lib.hoomd_step_plane(
        p.data_ptr(), v.data_ptr(), f.data_ptr(), w.data_ptr(), r.data_ptr(),
        tag.data_ptr(), sh.data_ptr(), par.data_ptr(), len(pnames),
        s_t.data_ptr(), float(np.float32(dt)), po.data_ptr(), vo.data_ptr(),
        fo.data_ptr(), part.data_ptr(), out.data_ptr(), nx, ny, nz, C, ev,
        approx, _stream(p))
    lib.check(err, 'cell_step_plane_planes')
    cell_step_plane_planes.launches += 1
    return po, vo, fo, out[0], out[1]


cell_step_plane_planes.launches = 0


def _lj_args(cell_pos, cell_tag, cell_shift, params):
    """The contiguous float32 / int32 operands of a stencil launch."""
    return (cell_pos.contiguous().float(),
            cell_tag.contiguous().to(torch.int32),
            cell_shift.contiguous().float(), params.contiguous().float())


def cell_pair_lj(cell_pos, cell_adj, cell_shift, lj_params, *, ncells, C,
                 cell_tag):
    """Forces (nc, C, 3), per-particle PE (nc, C) and virial (nc, C, 6),
    1/2 per pair each, of every cell against the 27 cells its row of
    ``cell_adj`` (ncells, 27; entries in [0, ncells)) lists, each under
    its image shift.  lj_params = [lj1, lj2, rc2, e_shift].  The kernel
    skips an id outside the grid rather than read past the positions;
    the plain version raises on it."""
    _check_shapes(C, cell_pos=(cell_pos, (ncells, C, 3)),
                  cell_tag=(cell_tag, (ncells, C)),
                  cell_adj=(cell_adj, (ncells, 27)),
                  cell_shift=(cell_shift, (ncells, 27, 3)),
                  lj_params=(lj_params.reshape(-1), (4,)))
    if _device_of(cell_pos) == 'cpu':
        return cell_pair_lj_plain(cell_pos, cell_adj, cell_shift, lj_params,
                                  cell_tag=cell_tag)
    _require_cuda_inputs(cell_tag, cell_adj, cell_shift, lj_params)
    lib = _kernel_lib()
    pos, tag, sh, par = _lj_args(cell_pos, cell_tag, cell_shift, lj_params)
    adj = cell_adj.contiguous().to(torch.int32)
    F = torch.empty_like(pos)
    pe = torch.empty((ncells, C), dtype=pos.dtype, device=pos.device)
    vir = torch.empty((ncells, C, 6), dtype=pos.dtype, device=pos.device)
    err = lib.lib.hoomd_cell_pair_lj(
        pos.data_ptr(), tag.data_ptr(), adj.data_ptr(), sh.data_ptr(),
        par.data_ptr(), F.data_ptr(), pe.data_ptr(), vir.data_ptr(), ncells,
        C, _stream(pos))
    lib.check(err, 'cell_pair_lj')
    cell_pair_lj.launches += 1
    return F, pe, vir


cell_pair_lj.launches = 0


def _check_lj_args(cell_pos, cell_tag, cell_dim, cell_shift, lj_params, C):
    nc = int(np.prod(cell_dim))
    _check_shapes(C, cell_pos=(cell_pos, (nc, C, 3)),
                  cell_tag=(cell_tag, (nc, C)),
                  cell_shift=(cell_shift, (nc, 27, 3)),
                  lj_params=(lj_params.reshape(-1), (4,)))


def cell_pair_lj_pallas3d(cell_pos, cell_dim, cell_shift, lj_params, *, C,
                          cell_tag):
    """Forces (nc, C, 3) of the 27-cell stencil, a cell against its
    modular-indexed neighbours one at a time.  lj_params = [lj1, lj2,
    rc2, e_shift].  The JAX function's want_pv=True form has no caller
    in either engine and is not ported."""
    _check_lj_args(cell_pos, cell_tag, cell_dim, cell_shift, lj_params, C)
    if _device_of(cell_pos) == 'cpu':
        return cell_pair_lj_pallas3d_plain(cell_pos, cell_dim, cell_shift,
                                           lj_params, cell_tag=cell_tag)
    _require_cuda_inputs(cell_tag, cell_shift, lj_params)
    lib = _kernel_lib()
    pos, tag, sh, par = _lj_args(cell_pos, cell_tag, cell_shift, lj_params)
    F = torch.empty_like(pos)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_lj3d(
        pos.data_ptr(), tag.data_ptr(), sh.data_ptr(), par.data_ptr(),
        F.data_ptr(), nx, ny, nz, C, _stream(pos))
    lib.check(err, 'cell_pair_lj_pallas3d')
    cell_pair_lj_pallas3d.launches += 1
    return F


cell_pair_lj_pallas3d.launches = 0

# threads of one block of the row kernel, at most: a tile of an x-row
# holds at most ROW_THREADS // C cells
ROW_THREADS = 512


def row_tile(nx, C):
    """Cells per tile of the row kernel: the x-row in equal tiles of at
    most ROW_THREADS // C cells (one at MAX_C)."""
    tiles = -(-nx // max(1, ROW_THREADS // C))
    return -(-nx // tiles)


def cell_pair_lj_row(cell_pos, cell_dim, cell_shift, lj_params, *, C,
                     cell_tag):
    """Forces (nc, C, 3) of the 27-cell stencil, by x-rows of cells: each
    (dz, dy) stencil row is staged once and serves dx = -1, 0, +1.  The
    same function as cell_pair_lj_pallas3d; lj_params = [lj1, lj2, rc2,
    e_shift]; no want_pv=True form either."""
    _check_lj_args(cell_pos, cell_tag, cell_dim, cell_shift, lj_params, C)
    if _device_of(cell_pos) == 'cpu':
        return cell_pair_lj_row_plain(cell_pos, cell_dim, cell_shift,
                                      lj_params, cell_tag=cell_tag)
    _require_cuda_inputs(cell_tag, cell_shift, lj_params)
    lib = _kernel_lib()
    pos, tag, sh, par = _lj_args(cell_pos, cell_tag, cell_shift, lj_params)
    F = torch.empty_like(pos)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_lj_row(
        pos.data_ptr(), tag.data_ptr(), sh.data_ptr(), par.data_ptr(),
        F.data_ptr(), nx, ny, nz, C, row_tile(nx, C), _stream(pos))
    lib.check(err, 'cell_pair_lj_row')
    cell_pair_lj_row.launches += 1
    return F


cell_pair_lj_row.launches = 0


def cell_pair_planar_n3l(cell_pos, cell_dim, cell_shift, params_vec, *, C,
                         cell_tag, eval_name='lj', pnames=LJ_PNAMES, ntypes=1,
                         cell_typ=None):
    """Forces (nc, C, 3) of the stencil of the pair evaluator
    ``eval_name`` by Newton's third law: the half stencil (own cell with
    i < j, then (0,0,+1), the (0,+1) row and the three dz = +1 rows)
    evaluates each pair once and puts -F on the other particle.
    params_vec and cell_typ as cell_pair_planar's; a mixture's launches
    count in ``typed_launches``.  The kernel sums without atomics, in a
    fixed order (csrc/cell_pair_impls.cu), so equal inputs give equal
    bits; its order is not the plain version's, and the two agree to
    rounding."""
    ev = _check_pair_args(cell_pos, cell_tag, cell_dim, cell_shift,
                          params_vec, C, eval_name, pnames, ntypes, cell_typ)
    if _device_of(cell_pos) == 'cpu':
        return cell_pair_planar_n3l_plain(cell_pos, cell_dim, cell_shift,
                                          params_vec, cell_tag=cell_tag,
                                          eval_name=eval_name, pnames=pnames,
                                          ntypes=ntypes, cell_typ=cell_typ)
    typed = ntypes > 1
    _require_cuda_inputs(cell_tag, cell_shift, params_vec,
                         *((cell_typ,) if typed else ()))
    lib = _kernel_lib()
    pos, tag, sh, par = _lj_args(cell_pos, cell_tag, cell_shift, params_vec)
    typ = cell_typ.contiguous().to(torch.int32) if typed else None
    F = torch.empty_like(pos)
    part = torch.empty((13,) + tuple(pos.shape), dtype=pos.dtype,
                       device=pos.device)
    nx, ny, nz = cell_dim
    err = lib.lib.hoomd_cell_pair_n3l(
        pos.data_ptr(), tag.data_ptr(), typ.data_ptr() if typed else None,
        sh.data_ptr(), par.data_ptr(), len(pnames), ntypes, F.data_ptr(),
        part.data_ptr(), nx, ny, nz, C, ev, _stream(pos))
    lib.check(err, 'cell_pair_planar_n3l')
    if typed:
        cell_pair_planar_n3l.typed_launches += 1
    else:
        cell_pair_planar_n3l.launches += 1
    return F


cell_pair_planar_n3l.launches = 0
cell_pair_planar_n3l.typed_launches = 0

KERNEL_WRAPPERS = (cell_pair_plane, cell_pair_planar, cell_megastep_planes,
                   mega_candidates, cell_step_plane_planes, cell_pair_lj,
                   cell_pair_lj_pallas3d, cell_pair_lj_row,
                   cell_pair_planar_n3l)


# the wrappers whose mixtures launch kernels of their own, counted apart
# as '<wrapper>_typed'
TYPED_WRAPPERS = (cell_pair_planar, cell_pair_planar_n3l)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in TYPED_WRAPPERS:
        fn.typed_launches = 0


def launch_counts():
    return {**{fn.__name__: fn.launches for fn in KERNEL_WRAPPERS},
            **{fn.__name__ + '_typed': fn.typed_launches
               for fn in TYPED_WRAPPERS}}


# ---------------------------------------------------------------------------
# independent reference: the JAX package's XLA formulation, in torch


def _rolled_stencil(g, nc, C):
    """(nz, ny, nx, C, ...) -> (nc, 27 C, ...): the 27 neighbour cells of
    every cell by periodic rolls, in build_cell_shifts order."""
    blocks = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nb = torch.roll(g, shifts=(-dz, -dy, -dx), dims=(0, 1, 2))
                blocks.append(nb.reshape((nc, C) + g.shape[4:]))
    return torch.stack(blocks, dim=1).reshape((nc, 27 * C) + g.shape[4:])


def cell_pair_xla(cell_pos, cell_dim, cell_shift, params_vec, *,
                  eval_name='lj', pnames=LJ_PNAMES, ntypes=1, cell_typ=None):
    """Roll-and-matmul formulation of the cell-pair computation
    (pallas_pair.py cell_pair_xla): expanded r^2, padding excluded by
    magnitude and the self pair by r^2 > 1e-3.  With ntypes > 1 the
    (2 + NP, T, T) table of a mixture, gathered per pair by cell_typ.
    Returns (F, pe, vir)."""
    nc, C, _ = cell_pos.shape
    nx, ny, nz = cell_dim
    xj = (_rolled_stencil(cell_pos.reshape(nz, ny, nx, C, 3), nc, C)
          + cell_shift.repeat_interleave(C, dim=1))       # (nc, 27C, 3)
    ev = _evaluator(eval_name, pnames)
    if ntypes > 1:
        tj = _rolled_stencil(cell_typ.long().reshape(nz, ny, nx, C), nc, C)
        rc2, e_shift, p = pair_eval.params_dict(
            params_vec, pnames, cell_typ.long()[:, :, None], tj[:, None, :])
    else:
        rc2, e_shift, p = pair_eval.params_dict(params_vec, pnames)
    xi = cell_pos
    xi2 = (xi * xi).sum(-1)
    xj2 = (xj * xj).sum(-1)
    S = torch.einsum('ncd,nkd->nck', xi, xj)
    r2 = xi2[:, :, None] + xj2[:, None, :] - 2.0 * S
    finite = (xi2[:, :, None] < 1e16) & (xj2[:, None, :] < 1e16)
    valid = (r2 > 1e-3) & (r2 < rc2) & finite
    r2s = torch.where(valid, r2, 1.0)
    f_raw, e_raw = ev.energy_force(r2s, p)
    fdivr = torch.where(valid, f_raw, 0.0)
    e = torch.where(valid, e_raw - e_shift, 0.0)
    w = fdivr.sum(2)
    fxj = torch.einsum('nck,nkd->ncd', fdivr, xj)
    F = w[:, :, None] * xi - fxj
    pe = 0.5 * e.sum(2)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    xj_sq = torch.stack([xj[..., a] * xj[..., b] for a, b in pairs], -1)
    fq = torch.einsum('nck,nkp->ncp', fdivr, xj_sq)
    vir = torch.stack(
        [w * xi[..., a] * xi[..., b] - xi[..., a] * fxj[..., b]
         - xi[..., b] * fxj[..., a] + fq[..., kk]
         for kk, (a, b) in enumerate(pairs)], dim=-1)
    return F, pe, 0.5 * vir
