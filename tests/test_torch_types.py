"""Mixtures of up to four particle types on the LJ engine, against the
JAX package.

The port runs a mixture where the JAX fast engine does (hoomd_tpu/
system.py:463, 634-635, 709; ops/fast_lj.py:372-467, 692-707): every
step a one_step, its forces from the typed cell_pair_planar (or the typed
half stencil with HOOMD_TPU_FAST_IMPL=planar_n3l), parameters per pair
from (2 + NP, T, T) tables, and the sort rebin.  On identical numpy
inputs made from a seed:

  * the typed plain stencils against the JAX package's functions: the
    typed cell_pair_planar_plain against cell_pair_planar (interpret
    mode, T = 2) and cell_pair_xla (T = 2, 4), forces to 1e-4 max|F| on the
    live slots (the sides sum ~27 C candidates in different orders;
    5e-4 against cell_pair_xla, whose expanded r^2 loses digits at
    |x| ~ 4), the summed PE to 1e-5 of the summed |PE| of the slots and
    the virial's trace to 1e-4 relative; the port's own cell_pair_xla
    against the JAX one to 1e-4 max|F| (their matrix products sum in
    other orders, and the expanded r^2 magnifies that); the typed
    cell_pair_planar_n3l_plain against the JAX half stencil for lj and
    mie to 1e-4 max|F|; the half
    stencil against the full stencil for all ten evaluators, T = 1 and
    2, to 1e-5 max|F| (torch only);
  * a Kob-Andersen 80:20 job of 512 particles (rho = 1.2, r_cut =
    2.5 sigma_ab, shift) through both packages' job scripts, NVE, NVT
    and Langevin, compared every 4 steps for 20 steps through rebuilds:
    positions to 1e-5, velocities to 2e-4 (the JAX engine's CPU path is
    the XLA formulation above), PE to 1e-5 per particle and pressure to
    1e-5 relative; and
    the same mixture with HOOMD_TPU_FAST_IMPL=planar_n3l on both sides
    (JAX in interpret mode) at rho = 0.9, where the JAX planner keeps
    the half stencil (3 C <= 128), positions and velocities every 3
    steps for 12 steps;
  * Langevin friction per type: at kT = 0 (no noise) with unequal
    gammas the port's positions and velocities follow the JAX general
    engine (HOOMD_TPU_FAST=off); the JAX fast engine takes type 0's gamma
    for every particle (hoomd_tpu/system.py:1139-1141), so it is held to
    the port only with equal gammas (the Langevin case above);
  * the gates: 5 types, and pallas, pallas3d, row with 2 types, raise
    NotImplementedError by name; a 2-type system at N = 4096 builds on
    the sort, with no megastep and no fused step; wrappers refuse a
    table whose shape does not match ntypes;
  * types survive rebuilds: after sort rebuilds, a capacity-overflow
    replan and danger retries, every live slot's type is its tag's;
  * interop.pair_tables_from_numpy on the JAX package's _fast_dyn()
    table of a KA system equals the port's own (the table of the JAX
    system that the job cases above ran, where this worker ran one).

The cases marked ``gpu`` hold the typed planar kernel (T = 2, 4) and the
half-stencil kernel (T = 1, 2) against their plain versions for every
evaluator on the card (python -m pytest tests/test_torch_types.py -m gpu
--noconftest); they skip where torch sees no CUDA device.
"""

import functools

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.ops import cell_pair as tcp
from hoomd_tpu_torch.ops import pair_eval as tpe
from test_torch_evaluators import COEFFS
from test_torch_force_impls import N3L, _fill

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

TYPES = ('A', 'B', 'C', 'D')
# Kob-Andersen 80:20 (Phys. Rev. E 51, 4626): (epsilon, sigma), r_cut =
# 2.5 sigma
KA = {('A', 'A'): (1.0, 1.0), ('A', 'B'): (1.5, 0.8), ('B', 'B'): (0.5, 0.88)}
EVALS = list(tpe.FAST_EVALS)
# the fill of the stencil cases: tests/test_torch_force_impls.py's half
# stencil lattice, (3, 3, 3) cells of C = 48, r_cut 2.5
FILL = N3L[0]


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _typed_table(eval_name, ntypes, rc=2.5):
    """The (2 + NP, T, T) shift-mode table [rc2, e_shift, *pnames] of
    eval_name: test_torch_evaluators.py's coefficients scaled per pair
    by 1 + 0.05 (a + b), r_cut by 1 - 0.04 (a + b); float32 numpy."""
    ev = tpe.ALL_EVALUATORS[eval_name]
    a = np.arange(ntypes)
    f = (1.0 + 0.05 * (a[:, None] + a[None, :])).astype(np.float32)
    raw = dict(ev.defaults)
    raw.update(COEFFS[eval_name])
    raw = {k: np.float32(v) * f for k, v in raw.items()}
    tabs = {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in ev.derive(raw).items()}
    rcut = torch.as_tensor(rc * (1.0 - 0.04 * (a[:, None] + a[None, :])),
                           dtype=torch.float32)
    tabs['rcut'] = rcut
    rc2 = rcut * rcut
    _, e_shift = ev.energy_force(rc2, tabs)
    pn = tpe.kernel_pnames(eval_name)
    return torch.stack([rc2, e_shift] + [tabs[k] for k in pn]).numpy(), pn


def _typed_fill(ntypes, seed, case=FILL):
    """_fill's lattice with a type per live slot (0 on padding)."""
    _, n, a, cd, C, rc, jit = case
    cell_pos, cell_tag, L, shifts, adj = _fill(n, a, cd, C, seed, jit)
    rng = np.random.RandomState(seed + 100)
    typ = np.where(cell_tag >= 0, rng.randint(0, ntypes, cell_tag.shape),
                   0).astype(np.int32)
    return cell_pos, cell_tag, typ, shifts, cd, C, rc


def _torch(*arrays, device='cpu'):
    return [torch.as_tensor(x, device=device) for x in arrays]


def _close(got, want, valid, frac, what):
    scale = np.abs(want[valid]).max()
    err = np.abs(got[valid] - want[valid]).max()
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


def test_params_dict_gathers_per_pair():
    pv = torch.arange(5 * 3 * 3, dtype=torch.float32).reshape(5, 3, 3)
    ti = torch.tensor([[0], [2]])
    tj = torch.tensor([[1, 2, 0]])
    rc2, es, p = tpe.params_dict(pv, ('lj1', 'lj2', 'rcut'), ti, tj)
    assert rc2.shape == (2, 3)
    assert torch.equal(p['lj2'], pv[3][ti, tj])
    assert float(es[1, 0]) == float(pv[1, 2, 1])
    # one type: the scalars of the vector
    rc2, es, p = tpe.params_dict(pv[:, 0, 0], ('lj1', 'lj2', 'rcut'))
    assert float(p['rcut']) == float(pv[4, 0, 0])


@pytest.mark.parametrize('ntypes', [2, 4])
def test_typed_planar_plain_matches_jax(ntypes):
    """T = 2 against the JAX kernel in interpret mode and its XLA
    formulation; T = 4 against the XLA formulation."""
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(ntypes, 7)
    pv, pn = _typed_table('lj', ntypes, rc)
    kw = dict(eval_name='lj', pnames=pn, ntypes=ntypes)
    refs = []
    if ntypes == 2:
        refs.append(tuple(np.asarray(o) for o in jp.cell_pair_planar(
            jnp.asarray(cell_pos), cd, jnp.asarray(shifts), jnp.asarray(pv),
            C=C, interpret=True, cell_typ=jnp.asarray(typ), **kw))
            + (1e-4, 'planar'))
    Fx, pex, virx = (np.asarray(o) for o in jp.cell_pair_xla(
        jnp.asarray(cell_pos), cd, jnp.asarray(shifts), jnp.asarray(pv),
        cell_typ=jnp.asarray(typ), **kw))
    refs.append((Fx, pex, virx, 5e-4, 'xla'))
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv)
    F, pe, vir = (o.numpy() for o in tcp.cell_pair_planar(
        pos, cd, sh, pvt, C=C, cell_tag=tag, cell_typ=ty, **kw))
    valid = cell_tag >= 0
    for Fw, pew, virw, frac, what in refs:
        _close(F, Fw, valid, frac, what)
        assert pe[valid].sum() == pytest.approx(
            pew[valid].sum(), rel=0, abs=1e-5 * np.abs(pew[valid]).sum())
        tr, trw = (v[valid][:, [0, 3, 5]].sum() for v in (vir, virw))
        assert tr == pytest.approx(trw, rel=1e-4)
    assert not F[~valid].any() and not pe[~valid].any()
    # want_pv=False: the forces alone, the same
    F1 = tcp.cell_pair_planar(pos, cd, sh, pvt, C=C, cell_tag=tag,
                              cell_typ=ty, want_pv=False, **kw)
    assert np.array_equal(F1.numpy(), F)
    # the port's XLA formulation: the JAX one's, in torch
    Fpx = tcp.cell_pair_xla(pos, cd, sh, pvt, cell_typ=ty, **kw)[0].numpy()
    _close(Fpx, Fx, valid, 1e-4, 'port xla vs JAX xla')


@pytest.mark.parametrize('eval_name', ['lj', 'mie'])
def test_typed_n3l_plain_matches_jax(eval_name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(2, 8)
    pv, pn = _typed_table(eval_name, 2, rc)
    kw = dict(eval_name=eval_name, pnames=pn, ntypes=2)
    Fj = np.asarray(jp.cell_pair_planar_n3l(
        jnp.asarray(cell_pos), cd, jnp.asarray(shifts), jnp.asarray(pv), C=C,
        interpret=True, cell_typ=jnp.asarray(typ), **kw))
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv)
    F = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag,
                                 cell_typ=ty, **kw).numpy()
    valid = cell_tag >= 0
    _close(F, Fj, valid, 1e-4, f'{eval_name} n3l vs JAX')
    assert not F[~valid].any()


@pytest.mark.parametrize('ntypes', [1, 2])
@pytest.mark.parametrize('eval_name', EVALS)
def test_n3l_plain_matches_full_stencil(eval_name, ntypes):
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(ntypes, 9)
    pv, pn = _typed_table(eval_name, ntypes, rc)
    if ntypes == 1:
        pv = pv[:, 0, 0]
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv)
    kw = dict(eval_name=eval_name, pnames=pn, ntypes=ntypes, cell_typ=ty)
    half = tcp.cell_pair_planar_n3l(pos, cd, sh, pvt, C=C, cell_tag=tag,
                                    **kw).numpy()
    full = tcp.cell_pair_planar(pos, cd, sh, pvt, C=C, cell_tag=tag,
                                want_pv=False, **kw).numpy()
    _close(half, full, cell_tag >= 0, 1e-5, f'{eval_name} T={ntypes}')


def test_wrappers_check_the_table_against_ntypes():
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(2, 10)
    pv, pn = _typed_table('lj', 2, rc)
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv)
    for fn in (tcp.cell_pair_planar, tcp.cell_pair_planar_n3l):
        with pytest.raises(ValueError, match=r'shape \(5, 3, 3\)'):
            fn(pos, cd, sh, pvt, C=C, cell_tag=tag, pnames=pn, ntypes=3,
               cell_typ=ty)
        with pytest.raises(ValueError, match='needs cell_typ'):
            fn(pos, cd, sh, pvt, C=C, cell_tag=tag, pnames=pn, ntypes=2)
        with pytest.raises(ValueError, match='got 20 values'):
            fn(pos, cd, sh, pvt, C=C, cell_tag=tag, pnames=pn)
        with pytest.raises(NotImplementedError, match='5 particle types'):
            fn(pos, cd, sh, torch.zeros(5, 5, 5), C=C, cell_tag=tag,
               pnames=pn, ntypes=5, cell_typ=ty)
    with pytest.raises(ValueError, match='shape'):
        interop.pair_tables_from_numpy(pv, 3)
    with pytest.raises(ValueError, match='shape'):
        interop.pair_tables_from_numpy(pv, 2, eval_name='mie')


# ---------------------------------------------------------------------------
# the job scripts


def _ka_snapshot(n_side, rho, seed, ntypes=2):
    """An n_side^3 sc lattice at density rho, jittered, with Maxwell
    velocities at T = 1; 20% of the particles (a seeded permutation) of
    type B, or types drawn uniformly for ntypes > 2.  A hoomd_tpu
    snapshot (numpy)."""
    import hoomd_tpu as jh
    N = n_side ** 3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / n_side
    snap = jh.data.make_snapshot(N, jh.data.boxdim(L=L),
                                 particle_types=list(TYPES[:ntypes]))
    g = (np.arange(n_side) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    snap.particles.position[:] = pos + rng.uniform(-0.05, 0.05, pos.shape) * a
    if ntypes == 2:
        tid = np.zeros(N, np.int32)
        tid[rng.permutation(N)[:N // 5]] = 1
    else:
        tid = rng.randint(0, ntypes, N).astype(np.int32)
    snap.particles.typeid[:] = tid
    v = rng.normal(0.0, 1.0, (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    return snap


def _ka_script(hoomd, snap, method, gamma=None, kT=1.0, dt=0.002):
    """The Kob-Andersen job script, as a user writes it for either
    package: per-pair epsilon, sigma and r_cut = 2.5 sigma, shift."""
    md = hoomd.md
    hoomd.init.read_snapshot(snap)
    types = list(snap.particles.types)
    lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
    for i, a in enumerate(types):
        for b in types[i:]:
            eps, sig = KA.get((a, b), (1.0 + 0.1 * i, 0.9))
            lj.pair_coeff.set(a, b, epsilon=eps, sigma=sig, r_cut=2.5 * sig)
    lj.set_params(mode='shift')
    md.integrate.mode_standard(dt=dt)
    grp = hoomd.group.all()
    if method == 'nve':
        md.integrate.nve(group=grp)
    elif method == 'nvt':
        md.integrate.nvt(group=grp, kT=kT, tau=0.5)
    else:
        lan = md.integrate.langevin(group=grp, kT=kT, seed=5)
        for t, g in (gamma or {}).items():
            lan.set_gamma(t, g)
    return hoomd.context.current.system


def _trajectory(hoomd, snap, method, reads=5, every=4, thermo=True, **kw):
    """Positions, velocities, PE and pressure (with ``thermo``, else
    None) after every ``every`` steps of the job script, ``reads``
    times."""
    if hoomd is th:
        hoomd.context.initialize('--mode=cpu --notice-level=0')
        snap = interop.snapshot_from_numpy(snap)
    else:
        hoomd.context.initialize('--notice-level=0')
    system = _ka_script(hoomd, snap, method, **kw)
    out = []
    for _ in range(reads):
        system.run(every, quiet=True)
        s = system.take_snapshot()
        q = (system.thermo_quantities() if thermo
             else dict(potential_energy=None, pressure=None))
        out.append((s.particles.position.copy(), s.particles.velocity.copy(),
                    q['potential_energy'], q['pressure']))
    return system, out


def _same_trajectory(a, b, pos_tol=1e-5, vel_tol=2e-4):
    """Positions and velocities to pos_tol and vel_tol; the total PE to
    1e-5 per particle (the sums of ~N^2/2 pair energies of either side
    cancel to a small total) and the pressure to 1e-5 relative."""
    for i, ((pa, va, ea, Pa), (pb, vb, eb, Pb)) in enumerate(zip(a, b)):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=pos_tol,
                                   err_msg=f'positions, read {i}')
        np.testing.assert_allclose(va, vb, rtol=0, atol=vel_tol,
                                   err_msg=f'velocities, read {i}')
        if ea is None:
            continue
        assert ea == pytest.approx(eb, rel=0, abs=1e-5 * len(pa)), \
            f'PE, read {i}'
        assert Pa == pytest.approx(Pb, rel=1e-5, abs=1e-4), f'P, read {i}'


@functools.lru_cache(maxsize=None)
def _ka512():
    return _ka_snapshot(8, 1.2, 3)


# the JAX package's _fast_dyn()['pv'] of the 512-particle KA system, kept
# by the first job case that builds it
_JAX_KA512_PV = {}


@pytest.mark.parametrize('method', ['nve', 'nvt', 'langevin'])
def test_ka_job_matches_jax(torch_ctx, monkeypatch, method):
    """NVE, NVT, and Langevin with equal gammas (2.0 for both types, where
    the JAX fast engine's type-0 friction is every type's) at kT = 1."""
    import hoomd_tpu as jh
    monkeypatch.setenv('HOOMD_TPU_FAST', 'on')
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    kw = dict(gamma={'A': 2.0, 'B': 2.0}) if method == 'langevin' else {}
    js, jt = _trajectory(jh, _ka512(), method, **kw)
    _JAX_KA512_PV.setdefault('pv', np.asarray(js._fast_dyn()['pv']))
    jh.context.current = None
    ts, tt = _trajectory(th, _ka512(), method, **kw)
    assert js._program['fast']['ntypes'] == 2
    fast = ts._program['fast']
    assert (fast['ntypes'], fast['impl'], fast['mega'], fast['rebin_impl']) \
        == (2, 'plane', False, 'sort')
    assert js.timestep == ts.timestep == 20
    assert ts.fast_stats['rebuilds'] >= 1
    assert tcp.cell_pair_planar.launches == 0     # the CPU runs plain
    _same_trajectory(tt, jt)


def test_ka_n3l_job_matches_jax(torch_ctx, monkeypatch):
    """HOOMD_TPU_FAST_IMPL=planar_n3l on both sides; rho = 0.9 keeps the
    JAX planner at C = 40, where its half stencil holds the job."""
    import hoomd_tpu as jh
    import hoomd_tpu.ops.fast_lj as jfl
    import hoomd_tpu_torch.ops.fast_lj as tfl
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'planar_n3l')
    calls = {'jax': 0, 'torch': 0}

    def counted(side, real):
        def fn(*args, **kwargs):
            assert kwargs.get('ntypes') == 2
            calls[side] += 1
            return real(*args, **kwargs)
        return fn
    monkeypatch.setattr(jfl, 'cell_pair_planar_n3l',
                        counted('jax', jfl.cell_pair_planar_n3l))
    monkeypatch.setattr(tfl, 'cell_pair_planar_n3l',
                        counted('torch', tfl.cell_pair_planar_n3l))
    snap = _ka_snapshot(9, 0.9, 4)
    kw = dict(reads=4, every=3, thermo=False)
    js, jt = _trajectory(jh, snap, 'nvt', **kw)
    jh.context.current = None
    ts, tt = _trajectory(th, snap, 'nvt', **kw)
    assert js._program['fast']['C'] == ts._program['fast']['C'] == 40
    # the JAX engine traced the half stencil into its step; the port
    # called it on every step
    assert calls['jax'] >= 1 and calls['torch'] >= 12
    _same_trajectory(tt, jt, vel_tol=1e-4)


def test_langevin_friction_per_type(torch_ctx, monkeypatch):
    """kT = 0: no noise, a deterministic damped run with gamma 0.5 for A
    and 4.0 for B.  The port, on its fast engine, follows the JAX general
    engine.  (The JAX fast engine takes type 0's gamma for every
    particle; with equal gammas the port follows it:
    test_ka_job_matches_jax[langevin].)"""
    import hoomd_tpu as jh
    kw = dict(gamma={'A': 0.5, 'B': 4.0}, kT=0.0, thermo=False)
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    jg, jgen = _trajectory(jh, _ka512(), 'langevin', **kw)
    assert jg._program.get('fast') is None
    jh.context.current = None
    monkeypatch.setenv('HOOMD_TPU_FAST', 'on')
    ts, tt = _trajectory(th, _ka512(), 'langevin', **kw)
    assert ts._program['fast']['ntypes'] == 2
    _same_trajectory(tt, jgen)


# ---------------------------------------------------------------------------
# gates, rebuilds, interop


def _run_one(snap, impl, monkeypatch):
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', impl)
    th.context.initialize('--mode=cpu --notice-level=0')
    system = _ka_script(th, interop.snapshot_from_numpy(snap), 'nvt')
    system._ensure_ready()
    return system


def test_five_types_raise(torch_ctx, monkeypatch):
    snap = _ka_snapshot(6, 1.2, 5, ntypes=4)
    snap.particles.types = list(TYPES) + ['E']
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    th.context.initialize('--mode=cpu --notice-level=0')
    _ka_script(th, interop.snapshot_from_numpy(snap), 'nvt')
    with pytest.raises(NotImplementedError, match='5 particle types'):
        th.run(1, quiet=True)


@pytest.mark.parametrize('impl', ['pallas', 'pallas3d', 'row'])
def test_single_type_impls_refuse_a_mixture(torch_ctx, monkeypatch, impl):
    with pytest.raises(NotImplementedError,
                       match=f'HOOMD_TPU_FAST_IMPL={impl} runs one particle '
                             f'type only \\(2 particle types\\)'):
        _run_one(_ka512(), impl, monkeypatch)


@pytest.mark.parametrize('impl', ['plane', 'planar', 'planar_n3l'])
def test_mixture_gates_at_4096(torch_ctx, monkeypatch, impl):
    """N = 4096 takes xsel for one type; a mixture sorts, with the
    megastep and the fused step off whatever the switches say."""
    monkeypatch.delenv('HOOMD_TPU_REBIN', raising=False)
    monkeypatch.delenv('HOOMD_TPU_MEGA', raising=False)
    monkeypatch.setenv('HOOMD_TPU_FUSED', 'on')
    system = _run_one(_ka_snapshot(16, 1.2, 6), impl, monkeypatch)
    fast = system._program['fast']
    assert (fast['ntypes'], fast['rebin_impl'], fast['mega'], fast['fused'],
            fast['impl']) == (2, 'sort', False, False, impl)
    assert tuple(system._dyn['fast']['pv'].shape) == (5, 2, 2)


def test_types_survive_rebuilds_and_retries(torch_ctx, monkeypatch):
    """A 4-type job through the sort rebuild, a capacity-overflow replan
    (the first plan undersized) and danger retries (an 8-window
    cadence): every live slot keeps its tag's type."""
    import hoomd_tpu_torch.ops.fast_lj as tfl
    from test_torch_slice import _force_retries
    real = tfl.plan_fast_lj
    plans = []

    def plan(*args, **kwargs):
        plans.append(1)
        if len(plans) == 1:
            return (3, 3, 3), 27, 16
        return real(*args, **kwargs)
    monkeypatch.setattr(tfl, 'plan_fast_lj', plan)
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    # a dilute fill (3 cells a side at 343 particles) keeps the CPU run
    # short; the types' bookkeeping does not depend on the density
    snap = _ka_snapshot(7, 0.5, 7, ntypes=4)
    system = _ka_script(th, interop.snapshot_from_numpy(snap), 'langevin',
                        dt=0.005)
    assert system is th.context.current.system
    _force_retries(system)
    th.run(24, quiet=True)
    c = system._fast_carry
    live = c.tag >= 0
    tid = torch.as_tensor(snap.particles.typeid, dtype=c.typ.dtype)
    assert torch.equal(c.typ[live], tid[c.tag[live].long()])
    assert int(live.sum()) == snap.particles.N
    assert len(plans) >= 2 and system._grow.get('fast_plan_conservative')
    assert system.fast_stats['retries'] >= 2
    assert system.fast_stats['rebuilds'] >= 3
    assert np.array_equal(system.take_snapshot().particles.typeid,
                          snap.particles.typeid)


def test_pair_tables_from_numpy_match_the_ports_own(torch_ctx, monkeypatch):
    monkeypatch.setenv('HOOMD_TPU_FAST', 'on')
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    if 'pv' not in _JAX_KA512_PV:
        import hoomd_tpu as jh
        jh.context.initialize('--notice-level=0')
        js = _ka_script(jh, _ka512(), 'nvt')
        js._ensure_ready()
        _JAX_KA512_PV['pv'] = np.asarray(js._fast_dyn()['pv'])
        jh.context.current = None
    pv_j = _JAX_KA512_PV['pv']
    ts = _ka_script(th, interop.snapshot_from_numpy(_ka512()), 'nvt')
    ts._ensure_ready()
    got = interop.pair_tables_from_numpy(pv_j, 2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 2, 2)
    torch.testing.assert_close(got, ts._dyn['fast']['pv'], rtol=2e-6,
                               atol=0.0)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('ntypes', [2, 4])
@pytest.mark.parametrize('eval_name', EVALS)
def test_cuda_typed_planar_matches_plain(cuda, eval_name, ntypes):
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(ntypes, 11)
    pv, pn = _typed_table(eval_name, ntypes, rc)
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv,
                                   device=cuda)
    kw = dict(eval_name=eval_name, pnames=pn, ntypes=ntypes, cell_typ=ty)
    n0 = tcp.cell_pair_planar.typed_launches
    got = tcp.cell_pair_planar(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    F = tcp.cell_pair_planar(pos, cd, sh, pvt, C=C, cell_tag=tag,
                             want_pv=False, **kw)
    assert tcp.cell_pair_planar.typed_launches == n0 + 2
    want = tcp.cell_pair_planar_plain(pos, cd, sh, pvt, cell_tag=tag, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(F, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('ntypes', [1, 2])
@pytest.mark.parametrize('eval_name', EVALS)
def test_cuda_n3l_matches_plain(cuda, eval_name, ntypes):
    cell_pos, cell_tag, typ, shifts, cd, C, rc = _typed_fill(ntypes, 12)
    pv, pn = _typed_table(eval_name, ntypes, rc)
    if ntypes == 1:
        pv = pv[:, 0, 0]
    pos, tag, ty, sh, pvt = _torch(cell_pos, cell_tag, typ, shifts, pv,
                                   device=cuda)
    kw = dict(eval_name=eval_name, pnames=pn, ntypes=ntypes, cell_typ=ty)
    fn = tcp.cell_pair_planar_n3l
    n0 = (fn.launches, fn.typed_launches)
    got = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    again = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    assert (fn.launches, fn.typed_launches) == (
        (n0[0] + 2, n0[1]) if ntypes == 1 else (n0[0], n0[1] + 2))
    want = tcp.cell_pair_planar_n3l_plain(pos, cd, sh, pvt, cell_tag=tag,
                                          **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


if __name__ == '__main__':
    # from the repo root: PYTHONPATH=. python tests/test_torch_types.py
    # ka-trace [n_side] prints T and PE/N every 100 steps of chip_smoke.py's
    # Kob-Andersen job script through the JAX package on the CPU, from the
    # lattice start: the 1000-step melt then 3000 Nose-Hoover steps, and
    # the same with ka_script's second Langevin run between them (what
    # profile_torch_bench.py ka-trace prints for the port on the card)
    import os
    import sys
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import hoomd_tpu as jh
    from profile_torch_bench import ka_trace
    n_side = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    for settle in (False, True):
        ka_trace(settle, n_side, jh, '--notice-level=0')
