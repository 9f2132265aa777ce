"""The megastep's candidate set (hoomd_tpu_torch/ops/cell_pair.py
mega_candidates), and the megastep on windows at the edge of its drift
guard.

A slot's candidate set keeps a staged stencil entry when the pair can
come inside r_cut while the megastep's drift guard holds
(|d_ia| + |d_ja| <= skin_a on each axis, d measured from the reference
positions the set was built from).  On the CPU:
  * the plain candidate test against a brute-force numpy enumeration of
    the stencil, on tests/test_torch_cell_pair.py's megastep fills and on
    a ragged grid: the same sets, entry for entry, and the counts their
    sizes; each slot's list of candidates names, in the kernel's staged
    union of a run of cells, the positions of its candidates in stencil
    order; a list that overflows holds the first cap of them;
  * adversarial drifts: pairs outside r_cut at the reference are moved
    toward each other by 0.999 of each axis' guard (half each), so the
    drift monitor stays under its bound; every pair inside r_cut at the
    drifted positions is in the set (so every pair left out is outside);
  * the plain megastep, unchanged, still matches the JAX package's
    Pallas megastep in interpret mode on such a window (positions to
    1e-5, the rest to rtol 1e-4 as in test_torch_cell_pair.py);
  * the engine refuses a window whose reference has no candidate set.
The cases marked ``gpu`` hold the kernels against the plain versions on
the card: the kernel-built set (counts, lists) equals the plain one;
the megastep with the set matches the plain megastep for nve, nvt and
langevin, k = 1 and 4, on the guard-edge window and on a window that
trips the guard (equal danger flags; past the trip the kernel walks
every staged slot); two launches give equal bits; where the lists
overflow, the walk of every staged slot gives the listed walk's bits.
The set is also built on the edge fills of CAND_EDGE (runs of 1 to 4
cells along x, ragged runs, C up to MAX_C, a full, an empty and a
one-particle cell) with pads 0, SKIN's and pads that overflow the lists:
counts and written lists equal to the plain version's bit for bit, and
two builds equal.

    python -m pytest tests/test_torch_megastep.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from hoomd_tpu_torch.ops import cell_pair as tcp
from test_torch_cell_pair import (RCUT, _jax_mega, _mega_args, _mega_inputs,
                                  _torch_mega)

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

# (cell grid, seed): test_torch_cell_pair.py's megastep fill and a ragged
# grid
FILLS = [((4, 3, 5), 2), ((5, 3, 4), 6)]
C = 16
SKIN = np.array([0.6, 0.55, 0.65], np.float32)


def _cells_of(planes, cell_dim):
    nx, ny, nz = cell_dim
    return planes.reshape(3, nx * ny * nz, C).transpose(1, 2, 0)


def _brute_force(gr, gt, cell_dim, L, pads, rc2):
    """The candidate set (nc, C, 27 C) bool by direct enumeration in numpy
    float32: each slot against each slot of the 27 cells around its own,
    in build_cell_shifts' (dz, dy, dx) order, the neighbour at its
    periodic image."""
    nx, ny, nz = cell_dim
    pos = _cells_of(gr, cell_dim)
    live = gt.reshape(-1, C) >= 0
    keeps = np.zeros((nx * ny * nz, C, 27 * C), bool)
    zero, rc2 = np.float32(0), np.float32(rc2)
    for iz, iy, ix in np.ndindex(nz, ny, nx):
        c = ix + nx * (iy + ny * iz)
        for k, (dz, dy, dx) in enumerate(np.ndindex(3, 3, 3)):
            jx, jy, jz = ix + dx - 1, iy + dy - 1, iz + dz - 1
            sh = (np.array([jx // nx, jy // ny, jz // nz]) * L).astype(
                np.float32)
            cj = jx % nx + nx * (jy % ny + ny * (jz % nz))
            for s in range(C):
                t = k * C + s
                m = np.maximum(np.abs(pos[c] - (pos[cj, s] + sh)) - pads,
                               zero)                          # (C, 3)
                lb = (m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]) \
                    + m[:, 2] * m[:, 2]
                keep = live[c] & live[cj, s] & (lb < rc2)
                keep[np.arange(C) + 13 * C == t] = False
                keeps[c, :, t] = keep
    return keeps


def _build(d, cell_dim, pads, device='cpu', C=C):
    T = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,  # noqa
                                                    device=device)
    return tcp.mega_candidates(T(d['gr']).contiguous(),
                               T(d['gt'], torch.int32), cell_dim,
                               T(d['shift']), pads, RCUT * RCUT, C=C)


def _keep(planes, d, cell_dim, pads):
    """The plain candidate test at ``planes`` (nc, C, 27 C) bool."""
    return tcp.candidate_keep(torch.as_tensor(planes), torch.as_tensor(
        d['gt']), cell_dim, torch.as_tensor(d['shift']), pads, RCUT * RCUT,
        C=C).numpy()


def _pads(d):
    return tcp.candidate_pads(SKIN, d['L'])


def _inside(planes, d, cell_dim):
    """The pairs inside r_cut at ``planes``: the candidate test with no
    skin is r^2 < rc2, rounded as the kernels round it."""
    return _keep(planes, d, cell_dim, np.zeros(3, np.float32))


def _guard_edge(d, cell_dim, frac=0.999, seed=0):
    """Planes drifted from the reference: disjoint pairs outside r_cut at
    the reference, whose bound lets them come inside, each moved toward
    the other by frac / 2 of each axis' skin, so every moved particle
    sits at frac / 2 of the guard on every axis and the two largest
    drifts of an axis sum to frac of its skin.  A move that would bring
    either particle within 0.9 of any other is not made (a closer
    encounter's force would make the window chaotic).  Returns the
    planes and the moved slots (nc, C)."""
    nc = int(np.prod(cell_dim))
    pos = _cells_of(d['gr'], cell_dim).copy()
    live = d['gt'].reshape(-1, C) >= 0
    adj, _ = tcp.build_cell_shifts(cell_dim, d['L'])
    sh = d['shift'].astype(np.float32)
    step = np.float32(0.5 * frac) * SKIN
    # every (cell, slot, entry, slot) pair that can come inside r_cut
    xj = pos[adj] + sh[:, :, None, :]                     # (nc, 27, C, 3)
    dr = pos[:, :, None, None, :] - xj[:, None]           # (nc, C, 27, C, 3)
    r2 = (dr * dr).sum(-1)
    m = np.maximum(np.abs(dr) - 2 * step, 0)
    lb = (m * m).sum(-1)
    ok = ((r2 >= RCUT * RCUT) & (lb >= 0.8 * RCUT * RCUT)
          & (lb < 0.98 * RCUT * RCUT)
          & live[:, :, None, None] & live[adj][:, None])
    pairs = np.argwhere(ok)
    moved = np.zeros((nc, C), bool)
    L = np.asarray(d['L'], np.float64)

    def crowded(c, i):
        dd = pos[live] - pos[c, i]
        dd -= L * np.round(dd / L)
        r = np.sqrt((dd * dd).sum(-1))
        return np.sort(r)[1] < 0.9          # the nearest other particle

    for c, i, k, s in pairs[np.random.RandomState(seed).permutation(
            len(pairs))]:
        cj = adj[c, k]
        if moved[c, i] or moved[cj, s] or (cj == c and s == i):
            continue
        sgn = np.sign(dr[c, i, k, s])
        old = pos[c, i].copy(), pos[cj, s].copy()
        pos[c, i] -= step * sgn
        pos[cj, s] += step * sgn
        if crowded(c, i) or crowded(cj, s):
            pos[c, i], pos[cj, s] = old
            continue
        moved[c, i] = moved[cj, s] = True
    planes = np.ascontiguousarray(pos.transpose(2, 0, 1)).reshape(
        d['gr'].shape).astype(np.float32)
    return planes, moved


@pytest.mark.parametrize('cell_dim,seed', FILLS)
def test_plain_candidates_match_brute_force(cell_dim, seed, monkeypatch):
    d = _mega_inputs(cell_dim, C, seed)
    pads = _pads(d)
    # chunks of 7 cells, so the plain builder's chunks meet too
    monkeypatch.setattr(tcp, 'CAND_CHUNK', 7 * C * 27 * C * 3)
    keep = _keep(d['gr'], d, cell_dim, pads)
    cand = _build(d, cell_dim, pads)
    nc = int(np.prod(cell_dim))
    want = _brute_force(d['gr'], d['gt'], cell_dim, d['L'], pads,
                        RCUT * RCUT)
    np.testing.assert_array_equal(keep, want)
    np.testing.assert_array_equal(cand.count.numpy(),
                                  want.sum(-1).reshape(nc * C))
    # the set is a small part of the live stencil, and holds every pair
    # inside r_cut at the reference
    inside = _inside(d['gr'], d, cell_dim)
    assert not (inside & ~keep).any()
    # and the chunked lists are the whole-grid ones
    monkeypatch.setattr(tcp, 'CAND_CHUNK', 1 << 22)
    whole = _build(d, cell_dim, pads)
    assert torch.equal(whole.count, cand.count)
    assert torch.equal(whole.listed, cand.listed)
    n_in, n_cand = int(inside.sum()), int(cand.count.sum())
    assert n_in < n_cand < 27 * C * int((d['gt'] >= 0).sum()) // 2


@pytest.mark.parametrize('cell_dim,seed', FILLS + [((2, 2, 2), 4)])
def test_candidate_lists_point_at_the_staged_slots(cell_dim, seed):
    """Each slot's list holds its candidates in ascending stencil order,
    as indices into the kernel's staged union of a run of cells along x:
    the union staged as the kernel stages it (3 x 3 x (run + 2) cells,
    each at the image shift of a cell of the run that has it in its
    stencil) holds at that index the position of the stencil entry the
    candidate test kept."""
    d = _mega_inputs(cell_dim, C, seed)
    cand = _build(d, cell_dim, _pads(d))
    keep = _keep(d['gr'], d, cell_dim, _pads(d)).reshape(-1, 27 * C)
    nx, ny, nz = cell_dim
    pos = _cells_of(d['gr'], cell_dim)
    adj, _ = tcp.build_cell_shifts(cell_dim, d['L'])
    sh = d['shift'].astype(np.float32)
    R = tcp.mega_run(nx, C)
    count, listed = cand.count.numpy(), cand.listed.numpy().astype(np.int64)
    assert cand.cap == 256 and (count <= cand.cap).all()
    checked = 0
    for c in range(nx * ny * nz):
        ix, row = c % nx, c // nx
        ix0 = ix - ix % R
        rlen = min(R, nx - ix0)
        # the kernel's staging of this run
        staged = {}
        for u in range(9 * (rlen + 2)):
            ux, uyz = u % (rlen + 2), u // (rlen + 2)
            rh = min(max(ux - 1, 0), rlen - 1)
            k = uyz * 3 + ux - rh
            home = ix0 + rh + nx * row
            for s in range(C):
                staged[u * C + s] = pos[adj[home, k], s] + sh[home, k]
        for i in range(C):
            j = c * C + i
            kept = np.flatnonzero(keep[j])
            assert count[j] == len(kept)
            for n, t in enumerate(kept):
                k, s = divmod(t, C)
                want = pos[adj[c, k], s] + sh[c, k]
                np.testing.assert_array_equal(staged[listed[j, n]], want)
                checked += 1
    assert checked == count.sum() > 0


@pytest.mark.parametrize('cell_dim,seed', FILLS)
def test_guard_edge_drift_stays_in_the_candidate_set(cell_dim, seed):
    d = _mega_inputs(cell_dim, C, seed)
    planes, moved = _guard_edge(d, cell_dim, seed=seed)
    assert moved.sum() >= 20
    # the drift monitor of the megastep stays under its bound
    dr = np.abs(planes - d['gr']).reshape(3, -1)
    top2 = np.sort(dr, axis=1)[:, -2:].sum(1)
    assert (top2 <= 0.999 * SKIN * (1 + 1e-5)).all() and (
        top2 >= 0.998 * SKIN).all()
    before = _inside(d['gr'], d, cell_dim)
    after = _inside(planes, d, cell_dim)
    # pairs came inside r_cut that were outside at the reference ...
    assert (after & ~before).any()
    # ... and every pair inside r_cut is a candidate
    assert not (after & ~_keep(d['gr'], d, cell_dim, _pads(d))).any()


# a fill of 22 particles at most in a cell of 32 slots: skins of 2.5 keep
# up to 342 candidates of a slot, past the lists' 256 (SKIN keeps 122)
DENSE = dict(cell_dim=(4, 3, 5), C=32, seed=3, spacing=0.9)
WIDE = np.full(3, 2.5, np.float32)


def _dense():
    return _mega_inputs(DENSE['cell_dim'], DENSE['C'], DENSE['seed'],
                        spacing=DENSE['spacing'])


def test_overflowing_lists_hold_their_first_candidates():
    """A slot with more candidates than its list holds keeps the first
    cap of them, and its count says how many it has."""
    d, cell_dim, Cd = _dense(), DENSE['cell_dim'], DENSE['C']
    pads = tcp.candidate_pads(WIDE, d['L'])
    cand = _build(d, cell_dim, pads, C=Cd)
    keep = tcp.candidate_keep(torch.as_tensor(d['gr']), torch.as_tensor(
        d['gt']), cell_dim, torch.as_tensor(d['shift']), pads, RCUT * RCUT,
        C=Cd).reshape(-1, 27 * Cd)
    count = cand.count.numpy()
    assert cand.cap == 256 and (count > cand.cap).sum() > 100
    np.testing.assert_array_equal(count, keep.sum(-1).numpy())
    union = tcp._union_index(cell_dim, Cd)
    for j in np.flatnonzero(count > cand.cap)[:20]:
        first = np.flatnonzero(keep[j].numpy())[:cand.cap]
        np.testing.assert_array_equal(cand.listed[j].numpy(),
                                      union[j // Cd, first])


@pytest.mark.parametrize('method', ['nvt', 'langevin'])
def test_plain_megastep_matches_jax_at_the_guard_edge(method):
    cell_dim, seed = FILLS[0]
    d = _mega_inputs(cell_dim, C, seed)
    planes, moved = _guard_edge(d, cell_dim, seed=seed)
    d = dict(d, gp=planes)
    _, kt, kw = _mega_args(d, cell_dim, 4, method, SKIN, seed)
    j = _jax_mega(d, cell_dim, C, kt, SKIN, kw)
    t = _torch_mega(d, cell_dim, C, kt, SKIN, kw)
    valid = np.broadcast_to(d['gt'] >= 0, d['gp'].shape)
    np.testing.assert_allclose(t[0][valid], j[0][valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-4, atol=1e-4)
    for i in (3, 4, 6, 7):          # xi, eta, ke2, mdmax
        np.testing.assert_allclose(t[i], j[i], rtol=1e-4, atol=1e-6)
    assert bool(t[5]) == bool(j[5])


def test_stale_candidate_set_is_refused():
    """A window takes the set only with the reference planes it was
    built from, unmodified; the engine's windows refuse a carry whose
    reference has no set."""
    import dataclasses
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    cell_dim, seed = FILLS[0]
    d = _mega_inputs(cell_dim, C, seed)
    cand = _build(d, cell_dim, _pads(d))
    with pytest.raises(ValueError, match='other reference'):
        cand.check(cand.gr.clone())
    cand.gr.add_(0.0)
    with pytest.raises(ValueError, match='other reference'):
        cand.check(cand.gr)

    import hoomd_tpu_torch as th
    from test_torch_slice import _start_snapshot
    from hoomd_tpu_torch import interop
    from hoomd_tpu_torch.state import state_from_snapshot
    st = state_from_snapshot(interop.snapshot_from_numpy(_start_snapshot()),
                             'cpu')
    to_fast, refresh, run, _ = build_fast_lj_chunk(
        N=st.N, box=st.box, cell_dim=(3, 3, 3), C=32, r_buff=0.4, rcut=2.5,
        method_kind='nve', method_seed=0)
    assert run.mega
    c = to_fast(st, {})
    assert c.cycle.ref is c.ref_pos
    stale = dataclasses.replace(c, ref_pos=c.ref_pos.clone())
    with pytest.raises(RuntimeError, match='candidate set'):
        run.wins(stale, {'pv': torch.ones(5), 'dt': 0.005, 'tau': 1.0,
                         'gamma': 1.0}, 1, 4)
    th.context.current = None


# ---------------------------------------------------------------------------
# the kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


# the candidate build's edge fills (test_torch_force_impls._edge_fill: a
# cell filled to C, an empty cell, a one-particle cell, live slots among
# padding): the megastep's runs along x of 1, 2, 3 and 4 + 1 cells (nx =
# 1, 2, 3, 5), C = 200 (runs of 2 + 1) and MAX_C (runs of 1); each with
# pads 0, SKIN's and pads wide enough that the lists overflow their cap
CAND_EDGE = [((1, 3, 2), 16), ((2, 2, 3), 33), ((3, 2, 2), 16),
             ((5, 2, 2), 33), ((3, 2, 2), 200), ((2, 2, 2), tcp.MAX_C)]


def _written(cand):
    """(count, each row of listed as far as it is written, zero after)."""
    n = torch.clamp(cand.count, max=cand.cap).long()
    used = torch.arange(cand.cap, device=n.device)[None, :] < n[:, None]
    return cand.count.cpu(), torch.where(used, cand.listed, 0).cpu()


def _cuda_candidates_match_plain(gr, gt, cell_dim, sh, pads, Cb):
    """The kernel's set of one build (one launch counted) against the plain
    version's, bit for bit; a second build gives the same bits."""
    n0 = tcp.mega_candidates.launches
    got = tcp.mega_candidates(gr, gt, cell_dim, sh, pads, RCUT * RCUT, C=Cb)
    again = tcp.mega_candidates(gr, gt, cell_dim, sh, pads, RCUT * RCUT,
                                C=Cb)
    assert tcp.mega_candidates.launches == n0 + 2
    count, listed = tcp.mega_candidates_plain(gr, gt, cell_dim, sh, pads,
                                              RCUT * RCUT, C=Cb)
    g, a = _written(got), _written(again)
    assert torch.equal(g[0], count.cpu())
    assert torch.equal(g[1], listed.cpu())
    assert torch.equal(g[0], a[0]) and torch.equal(g[1], a[1])
    return count


@pytest.mark.gpu
@pytest.mark.parametrize('cell_dim,seed', FILLS)
def test_cuda_candidates_match_plain(cuda, cell_dim, seed):
    from test_torch_force_impls import _edge_fill
    d = _mega_inputs(cell_dim, C, seed)
    T = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,  # noqa
                                                    device=cuda)
    _cuda_candidates_match_plain(T(d['gr']).contiguous(),
                                 T(d['gt'], torch.int32), cell_dim,
                                 T(d['shift']), _pads(d), C)
    # the edge fills, half of them in each case
    for cd, Ce in CAND_EDGE[FILLS.index((cell_dim, seed))::len(FILLS)]:
        cell_pos, cell_tag, _, shifts = _edge_fill(cd, Ce, seed)
        nx, ny, nz = cd
        gr = T(cell_pos.reshape(nz, ny, nx, Ce, 3)).permute(
            4, 0, 1, 2, 3).contiguous()
        gt = T(cell_tag.reshape(nz, ny, nx, Ce), torch.int32)
        L = np.abs(shifts).max(axis=(0, 1))
        for pads in (np.zeros(3, np.float32), tcp.candidate_pads(SKIN, L),
                     np.full(3, 100.0, np.float32)):
            count = _cuda_candidates_match_plain(gr, gt, cd, T(shifts), pads,
                                                 Ce)
            assert int(count.max()) > 0
            if pads[0] == 100.0 and Ce > 16:
                assert int((count > tcp._candidate_cap(Ce)).sum()) > 0


def _window_inputs(cell_dim, seed, edge):
    """The guard-edge window (moved particles at rest, a short dt, so the
    window stays under the guard) or a window that trips it (skin far
    below the drift)."""
    d = _mega_inputs(cell_dim, C, seed)
    if edge:
        planes, moved = _guard_edge(d, cell_dim, seed=seed)
        gv = d['gv'].copy()
        gv[:, moved.reshape(d['gt'].shape)] = 0.0
        return dict(d, gp=planes, gv=gv), SKIN, 0.0001
    return d, np.array([0.02, 0.03, 0.025], np.float32), 0.004


def _cuda_window(d, cell_dim, kt, skin, kw, dt, cuda, plain=False, C=C):
    T = lambda a, t=torch.float32: torch.as_tensor(a, dtype=t,  # noqa
                                                   device=cuda)
    kw = dict(kw)
    if kw['gn'] is not None:
        kw['gn'] = T(kw['gn'])
    args = [T(d[k]) for k in ('gp', 'gv', 'gf', 'gw', 'gm')]
    gr = T(d['gr']).contiguous()
    gt = T(d['gt'], torch.int32)
    sh = T(d['shift'])
    if plain:
        del kw['recip']
        return tcp.cell_megastep_planes_plain(
            *args, gr, cell_dim, sh, T(d['pv']), dt, T(kt), 0.05, 0.0,
            T(skin), C=C, gt=gt, **kw)
    cand = tcp.mega_candidates(gr, gt, cell_dim, sh,
                               tcp.candidate_pads(skin, d['L']),
                               RCUT * RCUT, C=C)
    return tcp.cell_megastep_planes(*args, gr, cell_dim, sh, T(d['pv']), dt,
                                    T(kt), 0.05, 0.0, T(skin), C=C, gt=gt,
                                    cand=cand, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize('edge', [True, False], ids=['guard_edge', 'danger'])
@pytest.mark.parametrize('k', [1, 4])
@pytest.mark.parametrize('method', ['nve', 'nvt', 'langevin'])
def test_cuda_megastep_matches_plain_at_the_guard(cuda, method, k, edge):
    cell_dim, seed = FILLS[1]
    d, skin, dt = _window_inputs(cell_dim, seed, edge)
    _, kt, kw = _mega_args(d, cell_dim, k, method, skin, seed)
    n0 = tcp.cell_megastep_planes.launches
    got = _cuda_window(d, cell_dim, kt, skin, kw, dt, cuda)
    assert tcp.cell_megastep_planes.launches == n0 + 1
    want = _cuda_window(d, cell_dim, kt, skin, kw, dt, cuda, plain=True)
    assert bool(got[5]) == bool(want[5]) == (not edge)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 2, 3, 4, 6, 7):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-5)
    again = _cuda_window(d, cell_dim, kt, skin, kw, dt, cuda)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_cuda_megastep_walks_every_slot_past_the_list_cap(cuda):
    """A slot with more candidates than its list holds walks every staged
    slot: with skins of 2.5 (hundreds of slots overflow) the window gives
    the bits of the window with SKIN (every list whole); only the drift
    ratio, which the skin scales, differs."""
    d, cell_dim, Cd = _dense(), DENSE['cell_dim'], DENSE['C']
    _, kt, kw = _mega_args(d, cell_dim, 4, 'nvt', SKIN, DENSE['seed'])
    wide = _build(d, cell_dim, tcp.candidate_pads(WIDE, d['L']),
                  device=cuda, C=Cd)
    assert int((wide.count > wide.cap).sum()) > 100
    want = _cuda_window(d, cell_dim, kt, SKIN, kw, 0.004, cuda, C=Cd)
    got = _cuda_window(d, cell_dim, kt, WIDE, kw, 0.004, cuda, C=Cd)
    assert not bool(want[5]) and not bool(got[5])
    for i in (0, 1, 2, 3, 4, 6):            # all but danger and mdmax
        assert torch.equal(got[i], want[i])
