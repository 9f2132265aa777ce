"""The fused single step (HOOMD_TPU_FUSED=on) against the JAX package.

cell_step_plane_planes_plain (hoomd_tpu_torch/ops/cell_pair.py) is held
against the JAX package's cell_step_plane_planes in interpret mode on
identical numpy inputs made from a seed: grids of 3x3x3 and 4x3x5 cells
(an axis of 3 cells in each), C = 16 with padding slots, NVE (s = 1)
and NVT (s < 1), for lj and yukawa.  Tolerances: positions to 1e-6 (the
drift is one product and sum per component on both sides, |x| < 6 here,
an f32 ulp ~5e-7); forces and velocities to rtol 1e-4 / atol 1e-4, as
the megastep's in tests/test_torch_cell_pair.py (the two sides sum ~27 C
candidates in different orders); ke2 and md2 to rtol 1e-5.

Then the fused path end to end: a Nose-Hoover NVT job and an NVE
continuation of 343 LJ particles through hoomd_tpu (HOOMD_TPU_FAST=
interpret, impl 'plane', HOOMD_TPU_MEGA=off, HOOMD_TPU_FUSED=on) and
hoomd_tpu_torch on --mode=cpu: per-tag positions and velocities to
1e-4, xi and eta to rel 1e-4, equal rebuild counts, every step through
cell_step_plane_planes and none through the megastep or one_step's
force.  A Langevin job under HOOMD_TPU_FUSED=on stays on one_step, as in
the JAX package.

The cases marked ``gpu`` hold the kernel against its plain version on
the card (python -m pytest tests/test_torch_step_plane.py -m gpu
--noconftest); they skip where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.ops import cell_pair as tcp
from hoomd_tpu_torch.ops import pair_eval as tpe

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PAD = 1.0e9
RCUT = 2.0
DT = 0.004
GRIDS = [((3, 3, 3), 0), ((4, 3, 5), 1)]
# lj (eps = sigma = 1) and yukawa (the JAX package's fast-engine test
# coefficients), both shifted at RCUT
EVALS = {'lj': dict(epsilon=1.0, sigma=1.0),
         'yukawa': dict(epsilon=1.5, kappa=1.0)}


def _params(eval_name, rcut=RCUT):
    """[rc2, e_shift, *pnames] of eval_name's coefficients, float32."""
    ev = tpe.ALL_EVALUATORS[eval_name]
    raw = {k: np.float32(v) for k, v in EVALS[eval_name].items()}
    raw.update({k: np.float32(v) for k, v in ev.defaults.items()
                if k not in raw})
    tab = {k: torch.tensor(np.float32(v)) for k, v in ev.derive(raw).items()}
    tab['rcut'] = torch.tensor(np.float32(rcut))
    _, es = ev.energy_force(tab['rcut'] ** 2, tab)
    pn = tpe.kernel_pnames(eval_name)
    return np.array([rcut * rcut, float(es)] + [float(tab[k]) for k in pn],
                    np.float32), pn


def _inputs(cell_dim, C, seed):
    """Plane-layout state of a jittered lattice with padding slots: a
    force from the plain stencil, Maxwell velocities, masses 0.8-1.2,
    and a reference position up to 0.05 away from each slot's."""
    rng = np.random.RandomState(seed)
    cdim = np.asarray(cell_dim)
    L = cdim * 2.1
    n = np.floor(L / 1.25).astype(int)
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in n], indexing='ij'),
                    -1).reshape(-1, 3)
    pos = (grid + 0.5) * (L / n) - L / 2 + rng.uniform(-0.12, 0.12,
                                                       grid.shape)
    c3 = np.minimum(((pos / L + 0.5) % 1.0 * cdim).astype(int), cdim - 1)
    cid = c3[:, 0] + cdim[0] * (c3[:, 1] + cdim[1] * c3[:, 2])
    nc = int(np.prod(cdim))
    cell_pos = np.full((nc, C, 3), PAD, np.float32)
    cell_tag = np.full((nc, C), -1, np.int32)
    fill = np.zeros(nc, int)
    for t, c in enumerate(cid):
        cell_pos[c, fill[c]] = pos[t]
        cell_tag[c, fill[c]] = t
        fill[c] += 1
    assert (fill < C).all(), "want padding slots in every cell"
    valid = cell_tag >= 0
    vel = np.where(valid[..., None], rng.normal(0, 1.0, cell_pos.shape),
                   0.0).astype(np.float32)
    mass = np.where(valid, rng.uniform(0.8, 1.2, valid.shape),
                    1.0).astype(np.float32)
    ref = np.where(valid[..., None], cell_pos + rng.uniform(
        -0.05, 0.05, cell_pos.shape), cell_pos).astype(np.float32)
    _, shift = tcp.build_cell_shifts(cell_dim, L)
    nx, ny, nz = cell_dim
    p4 = (nz, ny, nx, C)

    def planes(a):
        return np.ascontiguousarray(
            a.reshape(nz, ny, nx, C, 3).transpose(4, 0, 1, 2, 3))
    return dict(pos=cell_pos, tag=cell_tag, vel=vel, w=(1.0 / mass),
                ref=ref, shift=shift.astype(np.float32), planes=planes,
                p4=p4)


def _step_args(d, eval_name, C, cell_dim, device='cpu'):
    pv, pn = _params(eval_name)
    frc = tcp.cell_pair_plane_plain(
        torch.from_numpy(d['pos']), cell_dim, torch.from_numpy(d['shift']),
        torch.from_numpy(pv), cell_tag=torch.from_numpy(d['tag']),
        eval_name=eval_name, pnames=pn).numpy()
    P = d['planes']
    arrays = dict(gp=P(d['pos']), gv=P(d['vel']), gf=P(frc),
                  gw=d['w'].reshape(d['p4']).astype(np.float32),
                  gr=P(d['ref']), shift=d['shift'], pv=pv,
                  gt=d['tag'].reshape(d['p4']))
    return arrays, pn


def _torch_step(a, cell_dim, C, s, eval_name, pn, device='cpu',
                plain=True, recip='div'):
    def T(x, dt=torch.float32):
        return torch.as_tensor(x, dtype=dt, device=device)
    args = (T(a['gp']), T(a['gv']), T(a['gf']), T(a['gw']), T(a['gr']),
            cell_dim, T(a['shift']), T(a['pv']), DT,
            T(np.float32(s)))
    kw = dict(C=C, gt=T(a['gt'], torch.int32), eval_name=eval_name,
              pnames=pn)
    if plain:
        out = tcp.cell_step_plane_planes_plain(*args, **kw)
    else:
        out = tcp.cell_step_plane_planes(*args, recip=recip, **kw)
    return [o.cpu().numpy() for o in out]


@pytest.mark.parametrize('eval_name', sorted(EVALS))
@pytest.mark.parametrize('method', ['nve', 'nvt'])
@pytest.mark.parametrize('cell_dim,seed', GRIDS)
def test_plain_step_plane_matches_jax(cell_dim, seed, method, eval_name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    C = 16
    d = _inputs(cell_dim, C, seed)
    a, pn = _step_args(d, eval_name, C, cell_dim)
    s = 1.0 if method == 'nve' else float(np.exp(-0.5 * DT * 0.3))
    J = jnp.asarray
    j = jp.cell_step_plane_planes(
        J(a['gp']), J(a['gv']), J(a['gf']), J(a['gw']), J(a['gr']),
        cell_dim, J(a['shift']), J(a['pv']), DT, jnp.float32(s), C=C,
        eval_name=eval_name, pnames=pn,
        recip='approx' if method == 'nvt' else 'div', interpret=True)
    j = [np.asarray(o) for o in j]
    t = _torch_step(a, cell_dim, C, s, eval_name, pn)
    valid = np.broadcast_to(a['gt'] >= 0, a['gp'].shape)
    np.testing.assert_allclose(t[0][valid], j[0][valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t[2][valid], j[2][valid], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t[3], j[3], rtol=1e-5)
    np.testing.assert_allclose(t[4], j[4], rtol=1e-5)
    # padding slots stay where they are, with nothing on them
    assert not t[1][~valid].any() and not t[2][~valid].any()
    assert (t[0][~valid] == PAD).all()


def test_step_plane_wrapper_checks_its_evaluator():
    C = 16
    d = _inputs((3, 3, 3), C, 2)
    a, pn = _step_args(d, 'lj', C, (3, 3, 3))
    with pytest.raises(ValueError, match='pnames'):
        _torch_step(a, (3, 3, 3), C, 1.0, 'lj', ('lj2', 'lj1', 'rcut'),
                    plain=False)
    with pytest.raises(NotImplementedError, match="'zbl'"):
        _torch_step(a, (3, 3, 3), C, 1.0, 'zbl', pn, plain=False)
    # on the CPU the wrapper runs the plain version
    got = _torch_step(a, (3, 3, 3), C, 1.0, 'lj', pn, plain=False)
    want = _torch_step(a, (3, 3, 3), C, 1.0, 'lj', pn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the fused path end to end, through the job-script API of both packages

N_SIDE = 7


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _start_snapshot():
    import hoomd_tpu as jh
    jh.context.initialize('--notice-level=0')
    jh.init.create_lattice(unitcell=jh.lattice.sc(a=1.3), n=N_SIDE)
    snap = jh.context.current.system.take_snapshot()
    rng = np.random.RandomState(21)
    n = snap.particles.N
    snap.particles.position[:] += rng.uniform(-0.1, 0.1, (n, 3))
    v = rng.normal(0, 1.0, (n, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    jh.context.current = None
    return snap


def _job(hoomd, snap, method, steps):
    md = hoomd.md
    hoomd.init.read_snapshot(snap)
    system = hoomd.context.current.system
    lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.004)
    if method == 'nvt':
        md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.5)
    elif method == 'nve':
        md.integrate.nve(group=hoomd.group.all())
    else:
        md.integrate.langevin(group=hoomd.group.all(), kT=1.0, seed=3)
    hoomd.run(steps, quiet=True)
    return system


def _spies(monkeypatch):
    """Count the engine's calls of each force wrapper (on the CPU the
    wrappers run their plain versions and launch nothing)."""
    import hoomd_tpu_torch.ops.fast_lj as tfl
    calls = {}
    for name in ('cell_step_plane_planes', 'megastep_window',
                 'cell_pair_plane'):
        real = getattr(tfl, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(tfl, name, spy)
    return calls


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'plane')
    monkeypatch.setenv('HOOMD_TPU_MEGA', 'off')
    monkeypatch.setenv('HOOMD_TPU_FUSED', 'on')
    return monkeypatch


@pytest.mark.parametrize('method', ['nvt', 'nve'])
def test_fused_job_matches_jax(torch_ctx, fused_env, method):
    import hoomd_tpu as jh
    from hoomd_tpu.ops import pallas_pair as jp
    snap = _start_snapshot()
    steps = 30
    # the JAX engine traces its fused step (it imports the function when
    # it builds the step): count the traces to show it took the path
    jtraced = []
    real = jp.cell_step_plane_planes
    fused_env.setattr(jp, 'cell_step_plane_planes',
                      lambda *a, **k: jtraced.append(1) or real(*a, **k))
    jh.context.initialize('--notice-level=0')
    js = _job(jh, snap, method, steps)
    assert jtraced
    calls = _spies(fused_env)
    ts = _job(th, interop.snapshot_from_numpy(snap), method, steps)
    assert ts._program['fast']['fused'] and not ts._program['fast']['mega']
    assert calls.get('cell_step_plane_planes', 0) >= steps
    assert 'megastep_window' not in calls
    assert 'cell_pair_plane' not in calls
    assert js.timestep == ts.timestep == steps
    sj, st = js.take_snapshot(), ts.take_snapshot()
    for name in ('position', 'velocity'):
        np.testing.assert_allclose(getattr(st.particles, name),
                                   getattr(sj.particles, name), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert (int(ts._fast_carry.n_rebuilds)
            == int(js._fast_carry.n_rebuilds) > 0)
    if method == 'nvt':
        for key in ('xi', 'eta'):
            np.testing.assert_allclose(
                float(ts._fast_carry.aux[key]),
                float(np.asarray(js._fast_carry.aux[key])), rtol=1e-4,
                atol=1e-7, err_msg=key)


def test_fused_langevin_stays_on_one_step(torch_ctx, fused_env):
    snap = _start_snapshot()
    calls = _spies(fused_env)
    ts = _job(th, interop.snapshot_from_numpy(snap), 'langevin', 8)
    assert not ts._program['fast']['fused']
    assert calls.get('cell_pair_plane', 0) >= 8
    assert 'cell_step_plane_planes' not in calls


def test_fused_tails_ride_the_megastep_windows(torch_ctx, monkeypatch):
    """With the megastep on, HOOMD_TPU_FUSED=on leaves the windows to it
    and fuses the single steps a run's length leaves over."""
    monkeypatch.setenv('HOOMD_TPU_FUSED', 'on')
    snap = _start_snapshot()
    calls = _spies(monkeypatch)
    ts = _job(th, interop.snapshot_from_numpy(snap), 'nvt', 11)
    fast = ts._program['fast']
    assert fast['fused'] and fast['mega']
    assert calls.get('megastep_window', 0) > 0
    assert 0 < calls.get('cell_step_plane_planes', 0) < 11
    assert 'cell_pair_plane' not in calls


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('eval_name', sorted(EVALS))
@pytest.mark.parametrize('method', ['nve', 'nvt'])
@pytest.mark.parametrize('cell_dim,seed', GRIDS)
def test_cuda_step_plane_matches_plain(cuda, cell_dim, seed, method,
                                       eval_name):
    C = 16
    d = _inputs(cell_dim, C, seed)
    a, pn = _step_args(d, eval_name, C, cell_dim)
    s = 1.0 if method == 'nve' else float(np.exp(-0.5 * DT * 0.3))
    n0 = tcp.cell_step_plane_planes.launches
    got = _torch_step(a, cell_dim, C, s, eval_name, pn, device=cuda,
                      plain=False,
                      recip='approx' if method == 'nvt' else 'div')
    assert tcp.cell_step_plane_planes.launches == n0 + 1
    want = _torch_step(a, cell_dim, C, s, eval_name, pn, device=cuda)
    # the drift rounds each operation as torch's separate ops: equal bits
    np.testing.assert_array_equal(got[0], want[0])
    for i in (1, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
    for i in (3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5)
