"""hoomd_tpu_torch fused HPMC sweeps against the JAX package.

The plain torch versions of fused_poly_sweep and fused_sphere_sweep
(hoomd_tpu_torch/hpmc/sweep.py) are held against the JAX package's
Pallas functions in interpret mode, on identical planes, class orders
and uniforms made with numpy from a seed, and the cube job is held
sweep by sweep: the port's System runs with the JAX package's draws
handed to its draw function, and the JAX side is hoomd_tpu's
bin_particles + fused_poly_sweep + scatter called directly, as
hoomd_tpu/hpmc/integrate.py:947-1014 calls them.

Every JAX poly-sweep call in this file has ONE static shape: the plan of
the 6^3 cube lattice at phi = 0.4 (cell_dim (4, 4, 4), C = 11, the same
box and hull tables), so the interpret-mode kernel compiles once.

Tolerances: accept/try counts exactly; positions to 1e-5 and quaternions
to 1e-6 absolute.  The two sides round the same operations in the same
order; what differs is the last ulp of the transcendental functions
(log, sin, cos, exp, rsqrt) between XLA's CPU kernels and torch's.

The cases marked ``gpu`` hold each CUDA kernel against its plain version
on the card and skip where torch sees no CUDA device; the polyhedron
sweep also on the fills of POLY_FILLS (two rounds per call, a ragged
grid, class orders that repeat a class within a round, a 32^3 grid),
and the sphere sweep on those of SPHERE_FILLS (the ragged two-radius
mixture in two rounds, class orders with repeats, a 32^3 grid; in each
the fullest cell filled to C), with equal counts, one launch counted
per call and equal bits from two calls.  The
file imports
jax only inside the JAX-side helpers, so they also run where jax is not
installed:

    python -m pytest tests/test_torch_hpmc_sweep.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.box import Box
from hoomd_tpu_torch.hpmc import integrate as tint
from hoomd_tpu_torch.hpmc import sweep as tsw

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PHI = 0.4
N_SIDE = 6
A = (1.0 / PHI) ** (1.0 / 3.0)
CUBE = 0.5 * np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                       for sz in (-1, 1)])
SEED, D, ROT = 11, 0.15, 0.2
POS_TOL, QUAT_TOL = 1e-5, 1e-6
# [d, a, move_ratio]: mostly translations, mostly rotations, and moves
# so large that most trials are vetoed
MP_CASES = {'translate': (D, ROT, 0.9), 'rotate': (D, 0.6, 0.1),
            'veto': (0.6, 1.0, 0.5)}


def _cube_job(hoomd, snap=None, n=N_SIDE):
    """The config-5 job script at n^3 cubes, for either package."""
    if snap is None:
        hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=A), n=n)
    else:
        hoomd.init.read_snapshot(snap)
    mc = hoomd.hpmc.integrate.convex_polyhedron(seed=SEED, d=D, a=ROT)
    mc.shape_param.set('A', vertices=CUBE)
    return hoomd.context.current.system, mc


@pytest.fixture(scope='module')
def cube():
    """The port's plan and hull tables for the 6^3 cube job."""
    th.context.initialize('--mode=cpu --notice-level=0')
    system, mc = _cube_job(th)
    system._ensure_ready()
    p = system._program
    out = {'cell_dim': p['cell_dim'], 'C': p['C'], 'box_L': p['box_L'],
           'tables': mc._fused_poly_tables(system)}
    th.context.current = None
    assert out['cell_dim'] == (4, 4, 4) and out['C'] == 11
    return out


def _cube_planes(cube, seed, device='cpu'):
    """Jittered, randomly rotated cube lattice binned into the plan's
    planes, with class orders and uniforms from numpy."""
    rng = np.random.RandomState(seed)
    g = (np.arange(N_SIDE) + 0.5) * A - N_SIDE * A / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    pos = pos + rng.uniform(-0.05, 0.05, pos.shape)
    axis = rng.normal(size=pos.shape)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = 0.5 * rng.uniform(-0.2, 0.2, len(pos))[:, None]
    quat = np.concatenate([np.cos(half), np.sin(half) * axis], 1)
    L = cube['box_L']
    box = Box.create(*L, device=device)
    pos_t, quat_t = interop.planes_from_numpy([pos, quat], device)
    _, live, planes, ovf = tint.cell_planes(pos_t, box, cube['cell_dim'],
                                            cube['C'], quat_t)
    assert not bool(ovf)
    nx, ny, nz = cube['cell_dim']
    perms = torch.as_tensor(rng.permutation(8), dtype=torch.int32)
    randu = torch.as_tensor(rng.uniform(size=(8, 12, nz, ny, nx)),
                            dtype=torch.float32, device=device)
    return planes, live, perms, randu


def _jax_poly(planes, live, perms, randu, mp, cube):
    """hoomd_tpu's fused_poly_sweep in interpret mode, always called with
    the same argument kinds so its compile is shared by every caller."""
    import jax.numpy as jnp
    from hoomd_tpu.hpmc.pallas_sweep import fused_poly_sweep
    out = fused_poly_sweep(
        *[jnp.asarray(np.asarray(p), jnp.float32) for p in planes],
        jnp.asarray(np.asarray(live), jnp.float32),
        jnp.asarray(np.asarray(perms), jnp.int32), np.int32(0),
        jnp.asarray(np.asarray(randu), jnp.float32),
        jnp.asarray(np.asarray(mp), jnp.float32),
        cell_dim=cube['cell_dim'], C=cube['C'], R=1, box_L=cube['box_L'],
        tables=cube['tables'], interpret=True)
    return [np.asarray(o) for o in out]


def _assert_poly_match(got, want):
    assert np.array_equal(np.asarray(got[7]), want[7]), (got[7], want[7])
    for k in range(7):
        tol = POS_TOL if k < 3 else QUAT_TOL
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=0,
                                   atol=tol, err_msg=f'plane {k}')


@pytest.mark.parametrize('seed', [1, 2])
@pytest.mark.parametrize('case', list(MP_CASES))
def test_plain_poly_sweep_matches_jax(cube, case, seed):
    planes, live, perms, randu = _cube_planes(cube, seed)
    mp = np.asarray(MP_CASES[case], np.float32)
    want = _jax_poly(planes, live, perms, randu, mp, cube)
    got = tsw.fused_poly_sweep(*planes, live, perms, randu, mp,
                               cell_dim=cube['cell_dim'], C=cube['C'], R=1,
                               box_L=cube['box_L'], tables=cube['tables'])
    _assert_poly_match(got, want)
    t_acc, t_try, r_acc, r_try = (int(c) for c in want[7])
    assert t_try + r_try == 64            # one trial per cell
    if case == 'translate':
        assert t_try > r_try
    elif case == 'rotate':
        assert r_try > t_try
    else:
        assert t_acc < t_try and r_acc < r_try


def test_hull_tables_match_jax(cube):
    import hoomd_tpu as jh
    jsys, jmc = _cube_job(jh)
    assert interop.poly_tables_from_numpy(
        jmc._fused_poly_tables(jsys)) == cube['tables']


def _sphere_planes(cell_dim, width, n, diam, d, seed, device='cpu'):
    """n spheres of types 0/1 (diameters diam[t], move sizes d[t]) in a
    box of cell_dim cells of ``width``, binned into planes with per-slot
    radius and move size: an sc lattice of spacing 1.05 when n is a cube,
    else placed at random without overlap."""
    rng = np.random.RandomState(seed)
    L = np.asarray(cell_dim, float) * width
    tid = np.arange(n) % 2
    side = round(n ** (1.0 / 3.0))
    if side ** 3 == n:
        g = (np.arange(side) + 0.5) * 1.05 - side * 1.05 / 2
        placed = list(np.stack(np.meshgrid(g, g, g, indexing='ij'),
                               -1).reshape(-1, 3))
    else:
        placed = []
    while len(placed) < n:
        x = rng.uniform(-L / 2, L / 2)
        t = tid[len(placed)]
        ok = True
        for p, tp in zip(placed, tid):
            dr = x - p
            dr -= L * np.round(dr / L)
            if np.dot(dr, dr) < (0.5 * (diam[t] + diam[tp])) ** 2:
                ok = False
                break
        if ok:
            placed.append(x)
    pos = np.asarray(placed)
    nc = int(np.prod(cell_dim))
    C = int(np.bincount(_cell_ids(pos, L, cell_dim), minlength=nc).max()) + 2
    box = Box.create(*L, device=device)
    (pos_t,) = interop.planes_from_numpy([pos], device)
    idx, live, planes, ovf = tint.cell_planes(pos_t, box, cell_dim, C)
    assert not bool(ovf)
    nx, ny, nz = cell_dim
    t_pad = torch.as_tensor(np.append(tid, 0), device=device)[idx]
    rad = (torch.as_tensor(0.5 * np.asarray(diam), dtype=torch.float32,
                           device=device)[t_pad].reshape(live.shape) * live)
    dmv = (torch.as_tensor(np.asarray(d), dtype=torch.float32,
                           device=device)[t_pad].reshape(live.shape) * live)
    perms = torch.as_tensor(rng.permutation(8), dtype=torch.int32)
    randu = torch.as_tensor(rng.uniform(size=(8, 6, nz, ny, nx)),
                            dtype=torch.float32, device=device)
    box_L = tuple(float(v) for v in box.L.cpu().numpy())
    return planes + [rad, dmv, live], perms, randu, C, box_L


def _cell_ids(pos, L, cell_dim):
    f = (pos / L + 0.5) % 1.0
    c3 = np.minimum((f * np.asarray(cell_dim)).astype(int),
                    np.asarray(cell_dim) - 1)
    return c3[:, 0] + cell_dim[0] * (c3[:, 1] + cell_dim[1] * c3[:, 2])


# (cell_dim, cell width, N, diameters, move sizes): one type on the
# sphere job's plan, and a ragged grid of a two-type mixture with large
# moves, so the per-slot radius and move size matter and vetoes fire
SPHERE_CASES = {
    'one_type': ((4, 4, 4), 1.575, 216, (1.0, 1.0), (0.12, 0.12)),
    'mixture': ((4, 6, 8), 1.45, 300, (1.0, 0.6), (0.3, 0.5)),
}


@pytest.mark.parametrize('case', list(SPHERE_CASES))
def test_plain_sphere_sweep_matches_jax(case):
    import jax.numpy as jnp
    from hoomd_tpu.hpmc.pallas_sweep import fused_sphere_sweep
    cell_dim, width, n, diam, d = SPHERE_CASES[case]
    planes, perms, randu, C, box_L = _sphere_planes(cell_dim, width, n, diam,
                                                    d, 3)
    want = fused_sphere_sweep(
        *[jnp.asarray(p.numpy()) for p in planes],
        jnp.asarray(perms.numpy()), np.int32(0), jnp.asarray(randu.numpy()),
        cell_dim=cell_dim, C=C, R=1, box_L=box_L, interpret=True)
    got = tsw.fused_sphere_sweep(*planes, perms, randu, cell_dim=cell_dim,
                                 C=C, R=1, box_L=box_L)
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    for k in range(3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=POS_TOL)
    n_try, n_acc = int(want[4]), int(want[3])
    assert n_try <= int(np.prod(cell_dim))          # at most one per cell
    assert 0 < n_acc < n_try


def _jax_draws(seed, timestep, kcall, R, nrand, cell_dim, salt):
    """The JAX package's draws of one kernel call
    (hoomd_tpu/hpmc/integrate.py:952 and :971-979)."""
    import jax
    import jax.numpy as jnp
    from hoomd_tpu.rng import step_key
    key = step_key(jnp.asarray(seed, jnp.uint32),
                   jnp.asarray(timestep, jnp.int32), salt=salt)
    ks = jax.random.split(jax.random.fold_in(key, kcall), R + 1)
    perms = jnp.concatenate([jax.random.permutation(ks[r], 8)
                             for r in range(R)]).astype(jnp.int32)
    nx, ny, nz = cell_dim
    randu = jax.random.uniform(ks[-1], (R * 8, nrand, nz, ny, nx),
                               jnp.float32)
    return perms, randu


def hand_jax_draws(monkeypatch):
    """Make the port's sweeps draw the JAX package's randoms."""
    def draws(seed, timestep, kcall, R, nrand, cell_dim, device, salt):
        perms, randu = _jax_draws(seed, timestep, kcall, R, nrand, cell_dim,
                                  salt)
        return (torch.as_tensor(np.array(perms)),
                torch.as_tensor(np.array(randu), device=device))
    monkeypatch.setattr(tint, 'draw_randoms', draws)


def test_cube_job_matches_jax_sweep_by_sweep(cube, monkeypatch):
    import hoomd_tpu as jh
    import jax.numpy as jnp
    from hoomd_tpu.ops import cells as jcells
    jsys, _ = _cube_job(jh)
    snap = jsys.take_snapshot()
    th.context.initialize('--mode=cpu --notice-level=0')
    tsys, tmc = _cube_job(th, interop.snapshot_from_numpy(snap))
    hand_jax_draws(monkeypatch)

    cd, C = cube['cell_dim'], cube['C']
    nx, ny, nz = cd
    shp = (nz, ny, nx * C)
    pos, quat = jsys.state.pos, jsys.state.orientation
    N = pos.shape[0]
    mp = np.asarray([D, ROT, 0.5], np.float32)
    acc4 = np.zeros(4, np.int64)
    for step in range(4):
        for kcall in range(tmc.nselect):
            _, cell_list, ovf = jcells.bin_particles(pos, jsys.state.box, cd,
                                                     C)
            assert not bool(ovf)
            pc = jnp.concatenate([pos, jnp.zeros((1, 3))])[cell_list]
            qc = jnp.concatenate([quat, jnp.asarray([[1.0, 0, 0, 0]])]
                                 )[cell_list]
            planes = ([pc[..., k].reshape(shp) for k in range(3)]
                      + [qc[..., k].reshape(shp) for k in range(4)])
            live = (cell_list < N).astype(jnp.float32).reshape(shp)
            perms, randu = _jax_draws(SEED, step, kcall, 1, 12, cd,
                                      tint.SALT_POLY)
            out = _jax_poly(planes, live, perms, randu, mp, cube)
            acc4 += out[7]
            dst = jnp.where(cell_list.reshape(-1) < N,
                            cell_list.reshape(-1), N)
            pos = pos.at[dst].set(np.stack([out[k].reshape(-1)
                                            for k in range(3)], -1),
                                  mode='drop')
            quat = quat.at[dst].set(np.stack([out[3 + k].reshape(-1)
                                              for k in range(4)], -1),
                                    mode='drop')
        tsys.run(1, quiet=True)
        assert tsys.timestep == step + 1
        ts = tsys.take_snapshot()
        np.testing.assert_allclose(ts.particles.position, np.asarray(pos),
                                   rtol=0, atol=POS_TOL,
                                   err_msg=f'sweep {step}')
        np.testing.assert_allclose(ts.particles.orientation,
                                   np.asarray(quat), rtol=0, atol=QUAT_TOL,
                                   err_msg=f'sweep {step}')
        c = tmc.get_counters()
        assert [c['translate_accept'],
                c['translate_accept'] + c['translate_reject'],
                c['rotate_accept'],
                c['rotate_accept'] + c['rotate_reject']] == acc4.tolist()
    assert acc4[0] > 0 and acc4[2] > 0 and acc4[0] < acc4[1]
    assert tmc.count_overlaps() == 0
    th.context.current = None


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


def _assert_kernel_matches_plain(got, want, nplanes):
    for g, w in zip(got[nplanes:], want[nplanes:]):
        assert torch.equal(g.cpu(), w.cpu())
    for k in range(nplanes):
        tol = POS_TOL if k < 3 else QUAT_TOL
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize('case', list(MP_CASES))
def test_cuda_poly_sweep_matches_plain(cuda, cube, case):
    planes, live, perms, randu = _cube_planes(cube, 5, cuda)
    kw = dict(cell_dim=cube['cell_dim'], C=cube['C'], R=1,
              box_L=cube['box_L'], tables=cube['tables'])
    mp = MP_CASES[case]
    n0 = tsw.fused_poly_sweep.launches
    got = tsw.fused_poly_sweep(*planes, live, perms, randu, mp, **kw)
    assert tsw.fused_poly_sweep.launches == n0 + 1
    want = tsw.fused_poly_sweep_plain(*planes, live, perms, randu, mp, **kw)
    _assert_kernel_matches_plain(got, want, 7)


@pytest.mark.gpu
@pytest.mark.parametrize('case', list(SPHERE_CASES))
def test_cuda_sphere_sweep_matches_plain(cuda, case):
    cell_dim, width, n, diam, d = SPHERE_CASES[case]
    planes, perms, randu, C, box_L = _sphere_planes(cell_dim, width, n, diam,
                                                    d, 3, cuda)
    kw = dict(cell_dim=cell_dim, C=C, R=1, box_L=box_L)
    n0 = tsw.fused_sphere_sweep.launches
    got = tsw.fused_sphere_sweep(*planes, perms, randu, **kw)
    assert tsw.fused_sphere_sweep.launches == n0 + 1
    want = tsw.fused_sphere_sweep_plain(*planes, perms, randu, **kw)
    _assert_kernel_matches_plain(got, want, 3)


def _poly_fill(cell_dim, width, spacing, keep, C, seed, R, repeats, device):
    """Cubes on an sc lattice of ``spacing`` in a box of cell_dim cells of
    ``width``, each site kept with probability ``keep`` (a ragged fill),
    jittered by 0.05 and rotated by up to 0.1 about a random axis, binned
    into the planes of capacity C; class orders of R rounds (each a
    permutation of the 8 classes, or with ``repeats`` drawn with
    replacement, so a class may come twice in a round) and uniforms from
    numpy.  Returns (planes, live, perms, randu, box_L)."""
    rng = np.random.RandomState(seed)
    L = np.asarray(cell_dim, float) * width
    nl = np.floor(L / spacing).astype(int)
    g = [(np.arange(m) + 0.5) * (L[i] / m) - L[i] / 2 for i, m in enumerate(nl)]
    pos = np.stack(np.meshgrid(*g, indexing='ij'), -1).reshape(-1, 3)
    pos = pos[rng.uniform(size=len(pos)) < keep]
    pos = pos + rng.uniform(-0.05, 0.05, pos.shape)
    axis = rng.normal(size=pos.shape)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = 0.5 * rng.uniform(-0.2, 0.2, len(pos))[:, None]
    quat = np.concatenate([np.cos(half), np.sin(half) * axis], 1)
    box = Box.create(*L, device=device)
    pos_t, quat_t = interop.planes_from_numpy([pos, quat], device)
    _, live, planes, ovf = tint.cell_planes(pos_t, box, cell_dim, C, quat_t)
    assert not bool(ovf)
    nx, ny, nz = cell_dim
    perms = np.concatenate([rng.randint(0, 8, 8) if repeats
                            else rng.permutation(8) for _ in range(R)])
    randu = torch.as_tensor(rng.uniform(size=(8 * R, 12, nz, ny, nx)),
                            dtype=torch.float32, device=device)
    box_L = tuple(float(v) for v in box.L.cpu().numpy())
    return (planes, live, torch.as_tensor(perms, dtype=torch.int32), randu,
            box_L)


# (cell_dim, cell width, lattice spacing, share of sites kept, C, R, class
# orders with repeats): two rounds per call; a ragged grid; two rounds
# whose class orders repeat classes; a 32^3 grid, whose 4096 active cells
# per sub-sweep outnumber the kernel's co-resident blocks
POLY_FILLS = {
    'R2': ((4, 4, 4), 2.2, 1.45, 1.0, 12, 2, False),
    'ragged': ((4, 6, 8), 2.1, 1.4, 0.6, 12, 1, False),
    'repeats': ((4, 4, 4), 2.2, 1.45, 0.8, 12, 2, True),
    'grid32': ((32, 32, 32), 2.1, 1.4, 0.8, 12, 1, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize('case', list(MP_CASES))
@pytest.mark.parametrize('fill', list(POLY_FILLS))
def test_cuda_poly_sweep_fills_match_plain(cuda, cube, fill, case):
    """The one-launch polyhedron sweep on the fills of POLY_FILLS: equal
    counts, planes within POS_TOL / QUAT_TOL of the plain version, one
    launch counted per call, and equal bits from two calls."""
    cell_dim, width, spacing, keep, C, R, repeats = POLY_FILLS[fill]
    planes, live, perms, randu, box_L = _poly_fill(
        cell_dim, width, spacing, keep, C, 7, R, repeats, cuda)
    kw = dict(cell_dim=cell_dim, C=C, R=R, box_L=box_L,
              tables=cube['tables'])
    mp = MP_CASES[case]
    n0 = tsw.fused_poly_sweep.launches
    got = tsw.fused_poly_sweep(*planes, live, perms, randu, mp, **kw)
    assert tsw.fused_poly_sweep.launches == n0 + 1
    again = tsw.fused_poly_sweep(*planes, live, perms, randu, mp, **kw)
    want = tsw.fused_poly_sweep_plain(*planes, live, perms, randu, mp, **kw)
    _assert_kernel_matches_plain(got, want, 7)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    tries, accepts = int(want[7][1] + want[7][3]), int(want[7][0] + want[7][2])
    assert 0 < accepts <= tries


def _sphere_fill(cell_dim, width, spacing, keep, R, repeats, diam, d, seed,
                 device):
    """Spheres of types 0/1 (diameters diam[t], move sizes d[t]) on an sc
    lattice of ``spacing`` in a box of cell_dim cells of ``width``, each
    site kept with probability ``keep``, jittered by 0.01, binned into
    planes whose capacity C is the fullest cell's count (so that cell is
    filled to C); class orders of R rounds (permutations, or with
    ``repeats`` drawn with replacement) and uniforms from numpy.
    Returns (planes + [rad, dmv, live], perms, randu, C, box_L)."""
    rng = np.random.RandomState(seed)
    L = np.asarray(cell_dim, float) * width
    nl = np.floor(L / spacing).astype(int)
    g = [(np.arange(m) + 0.5) * (L[i] / m) - L[i] / 2 for i, m in enumerate(nl)]
    pos = np.stack(np.meshgrid(*g, indexing='ij'), -1).reshape(-1, 3)
    pos = pos[rng.uniform(size=len(pos)) < keep]
    pos = pos + rng.uniform(-0.01, 0.01, pos.shape)
    tid = np.arange(len(pos)) % 2
    nc = int(np.prod(cell_dim))
    C = int(np.bincount(_cell_ids(pos, L, cell_dim), minlength=nc).max())
    box = Box.create(*L, device=device)
    (pos_t,) = interop.planes_from_numpy([pos], device)
    idx, live, planes, ovf = tint.cell_planes(pos_t, box, cell_dim, C)
    assert not bool(ovf)
    assert int(live.reshape(nc, C).sum(1).max()) == C
    t_pad = torch.as_tensor(np.append(tid, 0), device=device)[idx]
    rad = (torch.as_tensor(0.5 * np.asarray(diam), dtype=torch.float32,
                           device=device)[t_pad].reshape(live.shape) * live)
    dmv = (torch.as_tensor(np.asarray(d), dtype=torch.float32,
                           device=device)[t_pad].reshape(live.shape) * live)
    nx, ny, nz = cell_dim
    perms = np.concatenate([rng.randint(0, 8, 8) if repeats
                            else rng.permutation(8) for _ in range(R)])
    randu = torch.as_tensor(rng.uniform(size=(8 * R, 6, nz, ny, nx)),
                            dtype=torch.float32, device=device)
    box_L = tuple(float(v) for v in box.L.cpu().numpy())
    return (planes + [rad, dmv, live], torch.as_tensor(perms, dtype=torch.int32),
            randu, C, box_L)


# (cell_dim, cell width, lattice spacing, share of sites kept, R, class
# orders with repeats, diameters, move sizes): the ragged two-radius
# mixture with large moves, two rounds per call; two rounds whose class
# orders repeat classes; a 32^3 grid, whose 4096 active cells per
# sub-sweep outnumber the kernel's blocks
SPHERE_FILLS = {
    'ragged': ((4, 6, 8), 1.45, 1.05, 0.6, 2, False, (1.0, 0.6), (0.3, 0.5)),
    'repeats': ((4, 4, 4), 1.6, 1.05, 0.8, 2, True, (1.0, 1.0),
                (0.12, 0.12)),
    'grid32': ((32, 32, 32), 1.45, 1.05, 0.8, 1, False, (1.0, 1.0),
               (0.12, 0.12)),
}


@pytest.mark.gpu
@pytest.mark.parametrize('fill', list(SPHERE_FILLS))
def test_cuda_sphere_sweep_fills_match_plain(cuda, fill):
    """The one-launch sphere sweep on the fills of SPHERE_FILLS: equal
    counts, planes within POS_TOL of the plain version, one launch
    counted per call, and equal bits from two calls."""
    cell_dim, width, spacing, keep, R, repeats, diam, d = SPHERE_FILLS[fill]
    planes, perms, randu, C, box_L = _sphere_fill(
        cell_dim, width, spacing, keep, R, repeats, diam, d, 9, cuda)
    kw = dict(cell_dim=cell_dim, C=C, R=R, box_L=box_L)
    n0 = tsw.fused_sphere_sweep.launches
    got = tsw.fused_sphere_sweep(*planes, perms, randu, **kw)
    assert tsw.fused_sphere_sweep.launches == n0 + 1
    again = tsw.fused_sphere_sweep(*planes, perms, randu, **kw)
    want = tsw.fused_sphere_sweep_plain(*planes, perms, randu, **kw)
    _assert_kernel_matches_plain(got, want, 3)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert 0 < int(want[3]) < int(want[4])
