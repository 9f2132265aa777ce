"""hoomd_tpu_torch cell-stencil kernels against the JAX package.

The plain torch versions of cell_pair_plane / cell_pair_planar /
cell_megastep_planes (hoomd_tpu_torch/ops/cell_pair.py) are held against
the JAX package's Pallas functions in interpret mode and against its XLA
formulation, on identical numpy inputs made from a seed: small grids
(3x3x3 and 4x3x5 cells), C = 16 with padding slots.

Tolerances: forces, PE and virial to rtol 1e-4 / atol 1e-5 against the
Pallas kernels — the two sides sum ~27*C candidates in different orders.
Against cell_pair_xla the absolute tolerance is 5e-4: its expanded
r^2 = |xi|^2 + |xj|^2 - 2 xi.xj form cancels |xj|^2 up to ~100 here, an
error of ~1e-5 in r^2 that the r^-14 force amplifies ~7x, and its virial
w xi_a xi_b - xi_a (f.xj)_b - ... cancels terms of |x|^2 |F| ~ 400; the
direct dr form keeps those digits.  Megastep positions to 1e-5 and the
danger flag exactly.

The cases marked ``gpu`` hold each CUDA kernel against its plain version
on the card; they skip where torch sees no CUDA device.  This file
imports jax only inside the JAX-side helpers, so the gpu cases also run
where jax is not installed:

    python -m pytest tests/test_torch_cell_pair.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from hoomd_tpu_torch import interop
from hoomd_tpu_torch.ops import cell_pair as tcp

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PAD = 1.0e9
RCUT = 2.0
XLA_ATOL = 5e-4


def _cells(cell_dim, width, C, spacing, seed, jitter=0.12):
    """Jittered lattice binned into (nc, C, 3) cell-major slots, with
    padding slots (tag -1, PAD coordinates); numpy."""
    rng = np.random.RandomState(seed)
    cdim = np.asarray(cell_dim)
    L = cdim * width
    n = np.floor(L / spacing).astype(int)
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in n], indexing='ij'),
                    -1).reshape(-1, 3)
    pos = (grid + 0.5) * (L / n) - L / 2 + rng.uniform(-jitter, jitter,
                                                       grid.shape)
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
    return cell_pos, cell_tag, L, len(pos)


def _params(rcut=RCUT):
    r6 = 1.0 / rcut ** 6
    # [rc2, e_shift, lj1, lj2, rcut] for eps = sigma = 1, shift mode
    return np.array([rcut * rcut, r6 * (4.0 * r6 - 4.0), 4.0, 4.0, rcut],
                    np.float32)


GRIDS = [((3, 3, 3), 0), ((4, 3, 5), 1)]


def _jax_pair(name, cell_pos, cell_dim, shift, pv, C):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    pos = jnp.asarray(cell_pos)
    sh = jnp.asarray(shift, jnp.float32)
    par = jnp.asarray(pv)
    pn = ('lj1', 'lj2', 'rcut')
    if name == 'plane':
        return (np.asarray(jp.cell_pair_plane(pos, cell_dim, sh, par, C=C,
                                              pnames=pn, interpret=True)),)
    if name == 'planar':
        out = jp.cell_pair_planar(pos, cell_dim, sh, par, C=C,
                                  eval_name='lj', pnames=pn, interpret=True)
    else:
        out = jp.cell_pair_xla(pos, cell_dim, sh, par, eval_name='lj',
                               pnames=pn)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize('cell_dim,seed', GRIDS)
@pytest.mark.parametrize('ref', ['pallas', 'xla'])
def test_plain_pair_matches_jax(cell_dim, seed, ref):
    C = 16
    cell_pos, cell_tag, L, _ = _cells(cell_dim, 2.1, C, 1.25, seed)
    _, shift = tcp.build_cell_shifts(cell_dim, L)
    pv = _params()
    cells = interop.carry_from_numpy({'pos': cell_pos, 'tag': cell_tag})
    pos_t, tag_t = cells['pos'], cells['tag']
    sh_t = torch.as_tensor(shift, dtype=torch.float32)
    pv_t = interop.lj_params_from_numpy(pv)
    F, pe, vir = tcp.cell_pair_planar(pos_t, cell_dim, sh_t, pv_t, C=C,
                                      cell_tag=tag_t)
    Fp = tcp.cell_pair_plane(pos_t, cell_dim, sh_t, pv_t, C=C,
                             cell_tag=tag_t)
    if ref == 'pallas':
        (Fj,) = _jax_pair('plane', cell_pos, cell_dim, shift, pv, C)
        Fj2, pej, virj = _jax_pair('planar', cell_pos, cell_dim, shift, pv,
                                   C)
        np.testing.assert_allclose(Fj2, Fj, rtol=1e-4, atol=1e-5)
        atol = 1e-5
    else:
        Fj, pej, virj = _jax_pair('xla', cell_pos, cell_dim, shift, pv, C)
        atol = XLA_ATOL
    valid = cell_tag >= 0
    for got, want in ((Fp.numpy(), Fj), (F.numpy(), Fj), (pe.numpy(), pej),
                      (vir.numpy(), virj)):
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4,
                                   atol=atol)
    # padding slots carry nothing
    assert not F.numpy()[~valid].any() and not pe.numpy()[~valid].any()
    # the torch port of the XLA formulation is the same reference
    Fx, pex, virx = tcp.cell_pair_xla(pos_t, cell_dim, sh_t, pv_t)
    np.testing.assert_allclose(Fx.numpy()[valid], F.numpy()[valid],
                               rtol=1e-4, atol=1e-4)


def _mega_inputs(cell_dim, C, seed, spacing=1.25):
    cell_pos, cell_tag, L, N = _cells(cell_dim, 2.1, C, spacing, seed)
    rng = np.random.RandomState(seed + 100)
    nx, ny, nz = cell_dim
    valid = cell_tag >= 0
    vel = np.where(valid[..., None], rng.normal(0, 1.0, cell_pos.shape),
                   0.0).astype(np.float32)
    mass = np.where(valid, rng.uniform(0.8, 1.2, valid.shape),
                    1.0).astype(np.float32)

    def planes(a):
        return np.ascontiguousarray(
            a.reshape(nz, ny, nx, C, 3).transpose(4, 0, 1, 2, 3))
    _, shift = tcp.build_cell_shifts(cell_dim, L)
    pv = _params()
    frc = tcp.cell_pair_plane_plain(
        torch.from_numpy(cell_pos), cell_dim,
        torch.as_tensor(shift, dtype=torch.float32), torch.from_numpy(pv),
        cell_tag=torch.from_numpy(cell_tag)).numpy()
    p4 = (nz, ny, nx, C)
    gp = planes(cell_pos)
    return dict(gp=gp, gv=planes(vel), gf=planes(frc),
                gw=(1.0 / mass).reshape(p4), gm=mass.reshape(p4), gr=gp.copy(),
                gt=cell_tag.reshape(p4), shift=shift, pv=pv, N=N, L=L)


MEGA_CASES = [(m, k) for m in ('nve', 'nvt', 'langevin') for k in (2, 4)]


def _mega_args(d, cell_dim, k, method, skin, seed):
    rng = np.random.RandomState(seed + 7)
    gn = (rng.uniform(-1, 1, (k, 3) + d['gt'].shape) * 3.0
          * (d['gt'] >= 0)).astype(np.float32)
    kt = np.full((k,), 1.1, np.float32)
    kw = dict(k=k, method=method, recip='div', ndof=3.0 * d['N'],
              tau_inv2=4.0, gamma=0.7,
              gn=gn if method == 'langevin' else None)
    return gn, kt, kw


def _jax_mega(d, cell_dim, C, kt, skin, kw):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    J = jnp.asarray
    out = jp.cell_megastep_planes(
        J(d['gp']), J(d['gv']), J(d['gf']), J(d['gw']), J(d['gm']),
        J(d['gr']), cell_dim, J(d['shift'], jnp.float32), J(d['pv']), 0.004,
        J(kt), 0.05, 0.0, skin, C=C, pnames=('lj1', 'lj2', 'rcut'),
        interpret=True,
        gn=None if kw['gn'] is None else J(kw['gn']),
        **{k: v for k, v in kw.items() if k != 'gn'})
    return [np.asarray(o) for o in out]


def _torch_mega(d, cell_dim, C, kt, skin, kw, device='cpu', plain=False):
    def T(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=device)
    fn = tcp.cell_megastep_planes_plain if plain else tcp.cell_megastep_planes
    kw = dict(kw)
    if plain:
        del kw['recip']             # the plain version divides exactly
    if kw['gn'] is not None:
        kw['gn'] = T(kw['gn'])
    gr, gt, sh = T(d['gr']), T(d['gt'], torch.int32), T(d['shift'])
    if not plain and device != 'cpu':
        kw['cand'] = tcp.mega_candidates(
            gr, gt, cell_dim, sh, tcp.candidate_pads(skin, d['L']),
            float(d['pv'][0]), C=C)
    out = fn(T(d['gp']), T(d['gv']), T(d['gf']), T(d['gw']), T(d['gm']),
             gr, cell_dim, sh, T(d['pv']), 0.004, T(kt), 0.05, 0.0, T(skin),
             C=C, gt=gt, **kw)
    return [o.cpu().numpy() for o in out]


@pytest.mark.parametrize('method,k', MEGA_CASES)
def test_plain_megastep_matches_jax(method, k):
    cell_dim, C = (3, 3, 3), 16
    d = _mega_inputs(cell_dim, C, 4)
    skin = np.full(3, 0.6, np.float32)
    _, kt, kw = _mega_args(d, cell_dim, k, method, skin, 4)
    j = _jax_mega(d, cell_dim, C, kt, skin, kw)
    t = _torch_mega(d, cell_dim, C, kt, skin, kw)
    valid = np.broadcast_to(d['gt'] >= 0, d['gp'].shape)
    np.testing.assert_allclose(t[0][valid], j[0][valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-4, atol=1e-4)
    for i in (3, 4, 6, 7):          # xi, eta, ke2, mdmax
        np.testing.assert_allclose(t[i], j[i], rtol=1e-4, atol=1e-6)
    assert bool(t[5]) == bool(j[5]) is False


def test_plain_megastep_danger_matches_jax():
    """A skin far below the window's drift trips the danger flag on both
    sides, with the same drift ratio."""
    cell_dim, C = (4, 3, 5), 16
    d = _mega_inputs(cell_dim, C, 9)
    skin = np.array([0.02, 0.03, 0.025], np.float32)
    _, kt, kw = _mega_args(d, cell_dim, 2, 'nvt', skin, 9)
    j = _jax_mega(d, cell_dim, C, kt, skin, kw)
    t = _torch_mega(d, cell_dim, C, kt, skin, kw)
    assert bool(j[5]) and bool(t[5])
    np.testing.assert_allclose(t[7], j[7], rtol=1e-4)


@pytest.mark.parametrize('other_name', ['zbl', 'slj', 'ewald'])
def test_wrappers_reject_other_evaluators_and_oversized_cells(other_name):
    """The kernels evaluate the ten stencil evaluators only: the System,
    where the configuration is decided, declines any other pair
    evaluator (those of the JAX package that need diameters or charges)
    before a wrapper is reached.  The wrappers decline a cell capacity
    above MAX_C and a reciprocal mode other than 'div'/'approx'."""
    import types
    import hoomd_tpu_torch as th
    th.context.initialize('--mode=cpu --notice-level=0')
    try:
        th.init.read_snapshot(th.data.make_snapshot(8, th.data.boxdim(L=8.0)))
        other = type(other_name, (th.md.pair.lj,), {
            '_evaluator': types.SimpleNamespace(__name__=other_name)})
        other(r_cut=2.5, nlist=th.md.nlist.cell())
        th.md.integrate.mode_standard(dt=0.005)
        th.md.integrate.nve(group=th.group.all())
        with pytest.raises(NotImplementedError,
                           match=f"evaluator '{other_name}' not "
                                 f"stencil-eligible"):
            th.run(1, quiet=True)
    finally:
        th.context.current = None
    with pytest.raises(ValueError, match='recip'):
        tcp.cell_pair_plane(torch.zeros((1, 4, 3)), (1, 1, 1),
                            torch.zeros((1, 27, 3)), torch.ones(5), C=4,
                            cell_tag=torch.zeros((1, 4), dtype=torch.int32),
                            recip='newton')
    big = tcp.MAX_C + 1
    with pytest.raises(NotImplementedError, match='capacity'):
        tcp.cell_pair_planar(torch.zeros((1, big, 3)), (1, 1, 1),
                             torch.zeros((1, 27, 3)), torch.ones(5), C=big,
                             cell_tag=torch.zeros((1, big),
                                                  dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('cell_dim,seed', GRIDS)
def test_cuda_pair_kernels_match_plain(cuda, cell_dim, seed):
    C = 16
    cell_pos, cell_tag, L, _ = _cells(cell_dim, 2.1, C, 1.25, seed)
    _, shift = tcp.build_cell_shifts(cell_dim, L)
    args = (torch.as_tensor(cell_pos, device=cuda), cell_dim,
            torch.as_tensor(shift, dtype=torch.float32, device=cuda),
            torch.as_tensor(_params(), device=cuda))
    tag = torch.as_tensor(cell_tag, device=cuda)
    n0 = tcp.cell_pair_planar.launches
    got = tcp.cell_pair_planar(*args, C=C, cell_tag=tag)
    want = tcp.cell_pair_planar_plain(*args, cell_tag=tag)
    assert tcp.cell_pair_planar.launches == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    for recip in ('div', 'approx'):
        got = tcp.cell_pair_plane(*args, C=C, cell_tag=tag, recip=recip)
        torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('method,k', MEGA_CASES)
def test_cuda_megastep_matches_plain(cuda, method, k):
    cell_dim, C = (4, 3, 5), 16
    d = _mega_inputs(cell_dim, C, 2)
    skin = np.full(3, 0.6, np.float32)
    _, kt, kw = _mega_args(d, cell_dim, k, method, skin, 2)
    got = _torch_mega(d, cell_dim, C, kt, skin, kw, device=cuda)
    want = _torch_mega(d, cell_dim, C, kt, skin, kw, device=cuda, plain=True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 2, 3, 4, 6, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5)
    assert bool(got[5]) == bool(want[5])
