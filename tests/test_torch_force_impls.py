"""The LJ engine's other force paths against the JAX package.

The plain torch versions of cell_pair_lj ('pallas'), cell_pair_lj_pallas3d
('pallas3d'), cell_pair_lj_row ('row') and cell_pair_planar_n3l
('planar_n3l') in hoomd_tpu_torch/ops/cell_pair.py are held against the
JAX package's Pallas functions in interpret mode, on identical numpy
inputs made from a seed, at the shapes of tests/test_pallas_pair.py: a
6^3 jittered lattice (L = 8.4, r_cut = 2, C = 24), a 2x2x2 grid (L = 6,
r_cut = 2.5, C = 16) on which a neighbour cell is reached under two
image shifts, and the half stencil at (3, 3, 3), C = 48 and at (2, 2, 2),
C = 80 (r_cut = 2.5).

Tolerances, on the live slots: forces to 1e-4 max|F| for the three
explicit-dr kernels (the sides sum ~27 C candidates in different
orders); to 5e-4 max|F| for 'pallas', whose TPU kernel forms
r^2 = |xi|^2 + |xj|^2 - 2 xi.xj and its force and virial from moment
products, losing digits at |x| ~ 5 that the port's direct dr keeps
(tests/test_pallas_pair.py allows that kernel 2e-4 max|F| against f64);
total PE to 1e-2 and the virial's trace to rel 1e-3.  The half stencil's
plain version is also held to the full stencil's (cell_pair_plane_plain)
at 1e-5 max|F|.

The cases marked ``gpu`` hold each CUDA kernel against its plain version
on the card; they skip where torch sees no CUDA device.  The half
stencil's (and, in tests/test_torch_types.py, the typed planar kernel's)
also run on the edge fills of ``_edge_fill`` (EDGE: C = 33, 56, 72 and
MAX_C, a cell filled to C, an empty cell, a cell of one particle, live
slots scattered among padding) for lj, mie and moliere, on a pair one
ulp inside r_cut and one a ulp outside (``_cut_pairs``, r^2 rounded as
the plain version's torch ops), and give equal bits in two calls.  JAX
is imported only inside the JAX-side helpers, so they also run where it
is missing:

    python -m pytest tests/test_torch_force_impls.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from hoomd_tpu_torch.ops import cell_pair as tcp

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PAD = 1.0e9


def _fill(n, a, cell_dim, C, seed, jitter):
    """An n^3 sc lattice of spacing a in the box L = n a, jittered by up
    to ``jitter``, binned into (nc, C, 3) cell-major slots with padding
    slots (tag -1, PAD coordinates); numpy.  Returns (cell_pos, cell_tag,
    L, shifts, adj)."""
    rng = np.random.RandomState(seed)
    L = n * a
    g = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    pos = pos + rng.uniform(-jitter, jitter, pos.shape)
    pos -= L * np.round(pos / L)
    cdim = np.asarray(cell_dim)
    f = (pos / L + 0.5) % 1.0
    c3 = np.minimum((f * cdim).astype(int), cdim - 1)
    cid = c3[:, 0] + cdim[0] * (c3[:, 1] + cdim[1] * c3[:, 2])
    nc = int(np.prod(cdim))
    cell_pos = np.full((nc, C, 3), PAD, np.float32)
    cell_tag = np.full((nc, C), -1, np.int32)
    fill = np.zeros(nc, int)
    for t, c in enumerate(cid):
        assert fill[c] < C, "test fill overflows C"
        cell_pos[c, fill[c]] = pos[t]
        cell_tag[c, fill[c]] = t
        fill[c] += 1
    assert (fill < C).all(), "want padding slots in every cell"
    adj, shifts = tcp.build_cell_shifts(cell_dim, (L, L, L))
    return cell_pos, cell_tag, L, shifts.astype(np.float32), adj


# the edge fills of the tile kernels: (cell_dim, C), from the narrowest
# capacity the engine plans to the kernels' limit
EDGE = {'C33': ((4, 3, 3), 33), 'C56': ((3, 4, 3), 56),
        'C72': ((3, 3, 4), 72), 'MAX_C': ((2, 2, 2), tcp.MAX_C)}


def _edge_fill(cell_dim, C, seed, ntypes=1):
    """A cell-major fill of cubic cells, each holding its particles on the
    sites of a sub-lattice of spacing ~1.05 (jittered by 5%): cell 0
    filled to C, cell 1 empty, cell 2 a single particle, the last cell
    filled to C, the others 40-80% of C, every partly filled cell's live
    slots scattered among its padding slots; with ntypes a random type
    per live slot (0 on padding).  numpy; returns (cell_pos, cell_tag,
    typ, shifts)."""
    rng = np.random.RandomState(seed)
    m = int(np.ceil(C ** (1.0 / 3.0) - 1e-9))
    h = 1.05
    w = m * h
    cd = np.asarray(cell_dim)
    L = cd * w
    nc = int(np.prod(cd))
    counts = rng.randint(int(0.4 * C), int(0.8 * C) + 1, nc)
    counts[[0, -1]] = C
    counts[1], counts[2] = 0, 1
    sites = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing='ij'), -1)
             .reshape(-1, 3) + 0.5) * h
    cell_pos = np.full((nc, C, 3), PAD, np.float32)
    cell_tag = np.full((nc, C), -1, np.int32)
    t = 0
    for c in range(nc):
        c3 = np.array([c % cd[0], (c // cd[0]) % cd[1], c // (cd[0] * cd[1])])
        pick = rng.choice(len(sites), counts[c], replace=False)
        xyz = (c3 * w + sites[pick] + rng.uniform(-0.05, 0.05, (counts[c], 3)) * h
               - L / 2)
        slots = rng.choice(C, counts[c], replace=False)
        cell_pos[c, slots] = xyz
        cell_tag[c, slots] = t + np.arange(counts[c])
        t += counts[c]
    typ = np.where(cell_tag >= 0, rng.randint(0, ntypes, cell_tag.shape),
                   0).astype(np.int32)
    _, shifts = tcp.build_cell_shifts(cell_dim, tuple(L))
    return cell_pos, cell_tag, typ, shifts.astype(np.float32)


def _cut_pairs(rc2, ti=0, tj=0):
    """Two pairs on the x axis of a (4, 3, 3) grid of 2.6-wide cells, i
    at x = 0 and j at x = -d: the first with the largest float32 d whose
    rounded d * d is below rc2 (inside the cut by one ulp of d), the
    second with the next d (outside).  The pairs lie 2.6 apart in y.
    Returns (cell_pos, cell_tag, typ, shifts, cell_dim, C)."""
    rc2 = np.float32(rc2)
    d = np.float32(np.sqrt(rc2))
    while d * d >= rc2:
        d = np.nextafter(d, np.float32(0))
    while np.nextafter(d, np.float32(9)) * np.nextafter(d, np.float32(9)) < rc2:
        d = np.nextafter(d, np.float32(9))
    d_out = np.nextafter(d, np.float32(9))
    assert d * d < rc2 <= d_out * d_out
    cd, C, w = (4, 3, 3), 4, 2.6
    L = np.asarray(cd) * w
    pts = [((0.0, 0.0, 0.0), ti), ((-d, 0.0, 0.0), tj),
           ((0.0, 2.6, 0.0), ti), ((-d_out, 2.6, 0.0), tj)]
    nc = int(np.prod(cd))
    cell_pos = np.full((nc, C, 3), PAD, np.float32)
    cell_tag = np.full((nc, C), -1, np.int32)
    typ = np.zeros((nc, C), np.int32)
    fill = np.zeros(nc, int)
    for t, (x, ty) in enumerate(pts):
        x = np.asarray(x, np.float32)
        c3 = np.minimum(((x + L / 2) // w).astype(int), np.asarray(cd) - 1)
        c = c3[0] + cd[0] * (c3[1] + cd[1] * c3[2])
        cell_pos[c, fill[c]], cell_tag[c, fill[c]] = x, t
        typ[c, fill[c]] = ty
        fill[c] += 1
    _, shifts = tcp.build_cell_shifts(cd, tuple(L))
    return cell_pos, cell_tag, typ, shifts.astype(np.float32), cd, C


def _lj(rc):
    """[lj1, lj2, rc2, e_shift] and [rc2, e_shift, lj1, lj2, rcut] of
    eps = sigma = 1 in shift mode."""
    r6 = 1.0 / rc ** 6
    es = r6 * (4.0 * r6 - 4.0)
    return (np.array([4.0, 4.0, rc * rc, es], np.float32),
            np.array([rc * rc, es, 4.0, 4.0, rc], np.float32))


# (name, n, a, cell_dim, C, rc, jitter): tests/test_pallas_pair.py's
# lattice and a 2x2x2 grid where one neighbour cell has two images
STENCIL = [('lattice6', 6, 1.4, (4, 4, 4), 24, 2.0, 0.2),
           ('dup2x2x2', 4, 1.5, (2, 2, 2), 16, 2.5, 0.1)]
# the half stencil's shapes of tests/test_pallas_pair.py
N3L = [('n3l3', 8, 1.2, (3, 3, 3), 48, 2.5, 0.12),
       ('n3l2', 6, 1.6, (2, 2, 2), 80, 2.5, 0.12)]


def _jax(name, cell_pos, cell_dim, shifts, adj, ljp, pv, C):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    pos = jnp.asarray(cell_pos)
    sh = jnp.asarray(shifts)
    if name == 'pallas':
        out = jp.cell_pair_lj(pos, jnp.asarray(adj), sh, jnp.asarray(ljp),
                              ncells=pos.shape[0], C=C, interpret=True)
        return tuple(np.asarray(o) for o in out)
    if name == 'n3l':
        return np.asarray(jp.cell_pair_planar_n3l(
            pos, cell_dim, sh, jnp.asarray(pv[:4]), C=C, eval_name='lj',
            pnames=('lj1', 'lj2'), interpret=True))
    fn = jp.cell_pair_lj_row if name == 'row' else jp.cell_pair_lj_pallas3d
    return np.asarray(fn(pos, cell_dim, sh, jnp.asarray(ljp), C=C,
                         interpret=True, want_pv=False))


def _close(got, want, valid, frac, what):
    scale = np.abs(want[valid]).max()
    err = np.abs(got[valid] - want[valid]).max()
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


def _torch_inputs(cell_pos, cell_tag, shifts, adj, device='cpu'):
    return (torch.as_tensor(cell_pos, device=device),
            torch.as_tensor(cell_tag, device=device),
            torch.as_tensor(shifts, device=device),
            torch.as_tensor(adj, device=device))


@pytest.mark.parametrize('case', STENCIL, ids=lambda c: c[0])
def test_plain_pallas_matches_jax(case):
    """'pallas': F, PE and virial against the adjacency-listed cells."""
    _, n, a, cd, C, rc, jit = case
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, 0, jit)
    ljp, pv = _lj(rc)
    Fj, pej, virj = _jax('pallas', cell_pos, cd, shifts, adj, ljp, pv, C)
    pos, tag, sh, ad = _torch_inputs(cell_pos, cell_tag, shifts, adj)
    F, pe, vir = tcp.cell_pair_lj(pos, ad, sh, torch.as_tensor(ljp),
                                  ncells=pos.shape[0], C=C, cell_tag=tag)
    valid = cell_tag >= 0
    _close(F.numpy(), Fj, valid, 5e-4, 'F')
    assert float(pe.sum()) == pytest.approx(float(pej[valid].sum()),
                                            abs=1e-2)
    tr, trj = (v[valid][:, [0, 3, 5]].sum() for v in (vir.numpy(), virj))
    assert tr == pytest.approx(trj, rel=1e-3)
    # padding slots carry nothing
    assert not F.numpy()[~valid].any() and not pe.numpy()[~valid].any()


@pytest.mark.parametrize('case', STENCIL, ids=lambda c: c[0])
@pytest.mark.parametrize('name', ['pallas3d', 'row'])
def test_plain_stencil_forces_match_jax(case, name):
    """'pallas3d' and 'row': the same function, each against its own
    JAX kernel."""
    _, n, a, cd, C, rc, jit = case
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, 1, jit)
    ljp, pv = _lj(rc)
    Fj = _jax(name, cell_pos, cd, shifts, adj, ljp, pv, C)
    pos, tag, sh, _ = _torch_inputs(cell_pos, cell_tag, shifts, adj)
    fn = tcp.cell_pair_lj_row if name == 'row' else tcp.cell_pair_lj_pallas3d
    F = fn(pos, cd, sh, torch.as_tensor(ljp), C=C, cell_tag=tag).numpy()
    _close(F, Fj, cell_tag >= 0, 1e-4, name)


@pytest.mark.parametrize('case', N3L, ids=lambda c: c[0])
def test_plain_n3l_matches_jax_and_full_stencil(case):
    _, n, a, cd, C, rc, jit = case
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, 3, jit)
    ljp, pv = _lj(rc)
    Fj = _jax('n3l', cell_pos, cd, shifts, adj, ljp, pv, C)
    pos, tag, sh, _ = _torch_inputs(cell_pos, cell_tag, shifts, adj)
    pvt = torch.as_tensor(pv)
    F = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag).numpy()
    valid = cell_tag >= 0
    _close(F, Fj, valid, 1e-4, 'n3l vs JAX')
    full = tcp.cell_pair_plane_plain(pos, cd, sh, pvt, cell_tag=tag).numpy()
    _close(F, full, valid, 1e-5, 'n3l vs the full stencil')
    assert not F[~valid].any()


def test_pallas_reads_the_adjacency_table():
    """The 'pallas' function takes its neighbours from cell_adj: each
    row's 27 entries permuted (shifts with them) give the same forces
    and energies, and a table that lists the own cell where the centre
    was loses the pairs of that image.  On the 2x2x2 grid the permuted
    table lists a neighbour id twice under different shifts."""
    _, n, a, cd, C, rc, jit = STENCIL[1]
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, 2, jit)
    ljp, _ = _lj(rc)
    pos, tag, sh, ad = _torch_inputs(cell_pos, cell_tag, shifts, adj)
    lj = torch.as_tensor(ljp)
    nc = pos.shape[0]
    want = tcp.cell_pair_lj(pos, ad, sh, lj, ncells=nc, C=C, cell_tag=tag)
    perm = torch.stack([torch.randperm(27, generator=torch.Generator()
                                       .manual_seed(c)) for c in range(nc)])
    got = tcp.cell_pair_lj(pos, torch.gather(ad, 1, perm),
                           torch.gather(sh, 1, perm[..., None].expand(-1, -1,
                                                                      3)),
                           lj, ncells=nc, C=C, cell_tag=tag)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    # entry 14 (dx = +1) relisted as entry 12 (dx = -1): the dx = +1 image
    # is gone twice over, the dx = -1 one counted twice
    ad2, sh2 = ad.clone(), sh.clone()
    ad2[:, 14], sh2[:, 14] = ad2[:, 12], sh2[:, 12]
    F2 = tcp.cell_pair_lj(pos, ad2, sh2, lj, ncells=nc, C=C, cell_tag=tag)[0]
    assert (F2 - want[0]).abs().max() > 1.0


def test_lj_wrappers_check_their_parameter_vector():
    pos = torch.zeros((1, 4, 3))
    tag = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='lj_params'):
        tcp.cell_pair_lj_row(pos, (1, 1, 1), torch.zeros((1, 27, 3)),
                             torch.ones(5), C=4, cell_tag=tag)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('case', STENCIL + N3L, ids=lambda c: c[0])
def test_cuda_force_kernels_match_plain(cuda, case):
    _, n, a, cd, C, rc, jit = case
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, 4, jit)
    ljp, pv = _lj(rc)
    pos, tag, sh, ad = _torch_inputs(cell_pos, cell_tag, shifts, adj, cuda)
    lj = torch.as_tensor(ljp, device=cuda)
    pvt = torch.as_tensor(pv, device=cuda)
    calls = {
        tcp.cell_pair_lj: ((pos, ad, sh, lj), dict(ncells=pos.shape[0])),
        tcp.cell_pair_lj_pallas3d: ((pos, cd, sh, lj), {}),
        tcp.cell_pair_lj_row: ((pos, cd, sh, lj), {}),
        tcp.cell_pair_planar_n3l: ((pos, cd, sh, pvt), {}),
    }
    for fn, (args, kw) in calls.items():
        plain = getattr(tcp, fn.__name__ + '_plain')
        n0 = fn.launches
        got = fn(*args, C=C, cell_tag=tag, **kw)
        want = plain(*args, cell_tag=tag)
        assert fn.launches == n0 + 1
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # the half stencil sums in a fixed order: the same bits every call
    a1 = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag)
    a2 = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag)
    assert torch.equal(a1, a2)


@pytest.mark.gpu
@pytest.mark.parametrize('eval_name', ['lj', 'mie', 'moliere'])
@pytest.mark.parametrize('fill', list(EDGE))
def test_cuda_n3l_edge_fills_match_plain(cuda, fill, eval_name):
    from test_torch_types import _typed_table
    cd, C = EDGE[fill]
    cell_pos, cell_tag, _, shifts = _edge_fill(cd, C, 21)
    pv, pn = _typed_table(eval_name, 1)
    pos, tag, sh, pvt = (torch.as_tensor(x, device=cuda) for x in
                         (cell_pos, cell_tag, shifts, pv[:, 0, 0]))
    kw = dict(eval_name=eval_name, pnames=pn)
    got = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    again = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag,
                                     **kw)
    want = tcp.cell_pair_planar_n3l_plain(pos, cd, sh, pvt, cell_tag=tag,
                                          **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    assert float(want.abs().max()) > 1.0      # the fill has pairs in the cut


@pytest.mark.gpu
def test_cuda_n3l_cuts_at_the_rounded_r2(cuda):
    ljp, pv = _lj(2.5)
    cell_pos, cell_tag, _, shifts, cd, C = _cut_pairs(pv[0])
    pos, tag, sh, pvt = (torch.as_tensor(x, device=cuda) for x in
                         (cell_pos, cell_tag, shifts, pv))
    got = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag)
    want = tcp.cell_pair_planar_n3l_plain(pos, cd, sh, pvt, cell_tag=tag)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    f = got[tag >= 0]                        # tags 0, 1 inside; 2, 3 out
    order = torch.argsort(tag[tag >= 0])
    assert float(f[order][0].abs().max()) > 1e-2
    assert not f[order][2:].any()


@pytest.mark.gpu
def test_cuda_kernels_reject_cpu_operands(cuda):
    cell_pos, cell_tag, L, shifts, adj = _fill(*STENCIL[0][1:5], 5, 0.2)
    ljp, _ = _lj(2.0)
    pos = torch.as_tensor(cell_pos, device=cuda)
    with pytest.raises(ValueError, match='CUDA'):
        tcp.cell_pair_lj_pallas3d(pos, (4, 4, 4), torch.as_tensor(shifts),
                                  torch.as_tensor(ljp, device=cuda), C=24,
                                  cell_tag=torch.as_tensor(cell_tag,
                                                           device=cuda))
