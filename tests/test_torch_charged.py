"""The PPPM charged fluid (BASELINE config 4's path) against the JAX package.

A charged job runs where the JAX fast engine runs it (hoomd_tpu/system.py
:406-487, 588, 642-646, 735-744; ops/fast_lj.py:226-267, 372-391,
622-636, 1144-1159): md.charge.pppm with its real-space md.pair.ewald,
fused with an unshifted md.pair.lj into the lj_ewald evaluator, every step
a one_step whose pair force is the charged cell_pair_planar (cell_q, the
slots' charges) plus the PPPM mesh force.  On identical numpy inputs made
from a seed:

  * erfc_approx, ewald and lj_ewald against the JAX evaluators on random
    r^2 in [0.8, 6.25] and charge products of +-1: erfc_approx to 2e-7
    absolute (both the A&S 7.1.26 polynomial in float32), the evaluators'
    force and energy to 2e-6 relative of their largest magnitude (ewald's
    erfc is the float32 library erfc of either side);
  * the plain charged stencil (cell_pair_planar with cell_q) against the
    JAX package's cell_pair_planar(..., cell_q=..., interpret=True) at one
    T = 2 shape, and against its cell_pair_xla with cell_q at T = 1, 2, 4
    for both evaluators, on a jittered 8^3 lattice in (3, 3, 3) cells of
    C = 48 with random charges: forces to 1e-4 max|F| on the live slots
    against the kernel (the sides sum ~1300 candidates in other orders),
    5e-4 against the XLA formulation (its expanded r^2 loses digits at
    |x| ~ 4), the summed PE to 1e-5 of the summed |PE| and the virial's
    trace to 1e-4 relative; the port's own cell_pair_xla to the JAX one's
    at 1e-4 max|F|;
  * md.charge.mesh_compute against the JAX package's on a random neutral
    cloud, in the dense branch (300 charges, a 16^3 mesh) and past the
    2^25 gate (2100 charges, 128 x 128 x 8: the scatter), with want_pv on
    and off: forces to 1e-4 max|F|, per-particle PE to 1e-4 of the
    largest |PE| and the virial to 1e-4 of its largest component (float32
    FFTs of two libraries, and assignment sums in other orders); the
    solver's packed kappa and B-spline moduli equal;
  * the NaCl Madelung energy through the port's job script on the CPU:
    -1.747565 / 2 per ion to rel 2e-3, forces below 5e-2, as
    tests/test_pppm.py holds the JAX package;
  * the 216-ion job of tests/test_charged_fast.py (n = 6, a = 1.6, 16^3
    mesh, NVT at kT = 1) through both packages' job scripts, the JAX side
    on its fast engine (HOOMD_TPU_FAST=on: the XLA formulation on the
    CPU), read every 10 steps for 40 steps: positions to 2e-5, velocities
    to 1e-3, PE to 1e-4 per particle and pressure to 1e-4 relative (the
    pair force sums in another order, erfc_approx against a float32 erfc
    is not in question, and the mesh's FFTs differ by float32 rounding,
    which NVT amplifies); the JAX job is run once, in a module fixture;
  * the charged gates: each refused configuration raises
    NotImplementedError naming the JAX package's reason; a standalone
    ewald pair runs as kind 'ewald'; the config-4 script at 4096 ions
    plans (8, 5, 4), C = 40, the sort rebin, no megastep and no fused
    step; the wrappers take the charged evaluators only with cell_q; the
    solver refuses to build while float32 matmuls may round to TF32;
  * interop.pair_tables_from_numpy and pppm_params_from_numpy on the JAX
    job's arrays equal the port's own.

The file takes about 35 s serial on the CPU.  The cases marked ``gpu``
hold the charged kernel against its plain version on the card for both
evaluators at T = 1, 2, 4, with its launch counters; on the tile kernels'
edge fills (a cell filled to C, an empty cell, a one-particle cell, live
slots among padding, C up to MAX_C) and the Madelung job's plan ((2, 2,
2), C = 88), with equal bits from two calls; and on a pair one float32
step inside r_cut beside one a step outside (python -m pytest
tests/test_torch_charged.py -m gpu --noconftest).  They skip where torch
sees no CUDA device.
"""

import os
import re

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.box import Box as TBox
from hoomd_tpu_torch.md import charge as tch
from hoomd_tpu_torch.ops import cell_pair as tcp
from hoomd_tpu_torch.ops import pair_eval as tpe
from test_torch_force_impls import EDGE, N3L, _cut_pairs, _edge_fill, _fill

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

CHARGED = list(tpe.CHARGED_EVALS)
KAPPA = np.float32(3.2 / 2.5)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _close(got, want, valid, frac, what):
    scale = np.abs(want[valid]).max()
    err = np.abs(got[valid] - want[valid]).max()
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


# ---------------------------------------------------------------------------
# evaluators


def _pair_params(name, n, seed):
    rng = np.random.RandomState(seed)
    r2 = rng.uniform(0.8, 6.25, n).astype(np.float32)
    p = {'kappa': np.full(n, KAPPA, np.float32),
         'qiqj': rng.choice([-1.0, 1.0], n).astype(np.float32)}
    if name == 'lj_ewald':
        p['lj1'] = np.full(n, 4.0, np.float32)
        p['lj2'] = np.full(n, 4.0, np.float32)
    return r2, p


def test_erfc_approx_matches_jax():
    import jax.numpy as jnp
    from hoomd_tpu.ops import pair_eval as jpe
    x = np.random.RandomState(1).uniform(0.0, 4.0, 4000).astype(np.float32)
    got = tpe.erfc_approx(torch.as_tensor(x)).numpy()
    want = np.asarray(jpe.erfc_approx(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize('name', CHARGED)
def test_charged_evaluators_match_jax(name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pair_eval as jpe
    jev, tev = getattr(jpe, name), tpe.ALL_EVALUATORS[name]
    assert tev.coeff_names == jev.coeff_names and tev.needs_charge
    r2, p = _pair_params(name, 4000, 2)
    fj, ej = (np.asarray(o) for o in jev.energy_force(
        jnp.asarray(r2), {k: jnp.asarray(v) for k, v in p.items()}))
    ft, et = (o.numpy() for o in tev.energy_force(
        torch.as_tensor(r2), {k: torch.as_tensor(v) for k, v in p.items()}))
    for got, want, what in ((ft, fj, 'force'), (et, ej, 'energy')):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max(),
                                   err_msg=f'{name} {what}')
    assert tpe.kernel_pnames(name) == (
        ('kappa', 'lj1', 'lj2', 'rcut') if name == 'lj_ewald'
        else ('kappa', 'rcut'))


# ---------------------------------------------------------------------------
# the charged stencil

FILL = N3L[0]


def _charged_fill(ntypes, seed):
    """_fill's lattice with random charges +-1 and (for ntypes > 1) types
    on the live slots, 0 on padding."""
    _, n, a, cd, C, rc, jit = FILL
    cell_pos, cell_tag, L, shifts, _ = _fill(n, a, cd, C, seed, jit)
    rng = np.random.RandomState(seed + 100)
    live = cell_tag >= 0
    q = np.where(live, rng.choice([-1.0, 1.0], cell_tag.shape),
                 0.0).astype(np.float32)
    typ = np.where(live, rng.randint(0, ntypes, cell_tag.shape),
                   0).astype(np.int32)
    return cell_pos, cell_tag, typ, q, shifts, cd, C, rc


def _charged_table(name, ntypes, rc):
    """[rc2, 0, *pnames] of ``name`` (no shift, as a charged job packs
    it), per pair (2 + NP, T, T) for ntypes > 1 with lj1, lj2 scaled by
    1 + 0.1 (a + b); float32 numpy."""
    a = np.arange(ntypes)
    f = (1.0 + 0.1 * (a[:, None] + a[None, :])).astype(np.float32)
    tab = {'kappa': np.full((ntypes, ntypes), KAPPA, np.float32),
           'lj1': (4.0 * f).astype(np.float32),
           'lj2': (4.0 * f).astype(np.float32),
           'rcut': np.full((ntypes, ntypes), rc, np.float32)}
    rc2 = tab['rcut'] * tab['rcut']
    pv = np.stack([rc2, np.zeros_like(rc2)]
                  + [tab[k] for k in tpe.kernel_pnames(name)])
    return (pv[:, 0, 0] if ntypes == 1 else pv).astype(np.float32)


def _jax_charged(fn, cell_pos, cd, shifts, pv, typ, q, **kw):
    import jax.numpy as jnp
    return tuple(np.asarray(o) for o in fn(
        jnp.asarray(cell_pos), cd, jnp.asarray(shifts), jnp.asarray(pv),
        cell_typ=jnp.asarray(typ) if kw['ntypes'] > 1 else None,
        cell_q=jnp.asarray(q), **kw))


def _port_charged(fn, cell_pos, cell_tag, cd, shifts, pv, typ, q, C=None,
                  **kw):
    pos, tag, ty, sh, pvt, qt = (torch.as_tensor(x) for x in
                                 (cell_pos, cell_tag, typ, shifts, pv, q))
    extra = {} if C is None else dict(C=C, cell_tag=tag)
    out = fn(pos, cd, sh, pvt, cell_typ=ty if kw['ntypes'] > 1 else None,
             cell_q=qt, **extra, **kw)
    return tuple(o.numpy() for o in (out if isinstance(out, tuple)
                                     else (out,)))


def _same_pv(got, want, valid, frac, what):
    (F, pe, vir), (Fw, pew, virw) = got, want
    _close(F, Fw, valid, frac, f'{what} F')
    assert pe[valid].sum() == pytest.approx(
        pew[valid].sum(), rel=0, abs=1e-5 * np.abs(pew[valid]).sum()), what
    tr, trw = (v[valid][:, [0, 3, 5]].sum() for v in (vir, virw))
    assert tr == pytest.approx(trw, rel=1e-4), what


def test_plain_charged_planar_matches_jax_kernel():
    """T = 2, lj_ewald, against the JAX kernel in interpret mode."""
    from hoomd_tpu.ops import pallas_pair as jp
    cell_pos, cell_tag, typ, q, shifts, cd, C, rc = _charged_fill(2, 7)
    pv = _charged_table('lj_ewald', 2, rc)
    kw = dict(eval_name='lj_ewald', pnames=tpe.kernel_pnames('lj_ewald'),
              ntypes=2)
    want = _jax_charged(jp.cell_pair_planar, cell_pos, cd, shifts, pv, typ,
                        q, C=C, interpret=True, **kw)
    got = _port_charged(tcp.cell_pair_planar, cell_pos, cell_tag, cd, shifts,
                        pv, typ, q, C=C, **kw)
    valid = cell_tag >= 0
    _same_pv(got, want, valid, 1e-4, 'planar vs JAX kernel')
    assert not got[0][~valid].any() and not got[1][~valid].any()


@pytest.mark.parametrize('ntypes', [1, 2, 4])
@pytest.mark.parametrize('name', CHARGED)
def test_plain_charged_matches_jax_xla(name, ntypes):
    from hoomd_tpu.ops import pallas_pair as jp
    cell_pos, cell_tag, typ, q, shifts, cd, C, rc = _charged_fill(ntypes, 8)
    pv = _charged_table(name, ntypes, rc)
    kw = dict(eval_name=name, pnames=tpe.kernel_pnames(name), ntypes=ntypes)
    want = _jax_charged(jp.cell_pair_xla, cell_pos, cd, shifts, pv, typ, q,
                        **kw)
    got = _port_charged(tcp.cell_pair_planar, cell_pos, cell_tag, cd, shifts,
                        pv, typ, q, C=C, **kw)
    valid = cell_tag >= 0
    _same_pv(got, want, valid, 5e-4, f'{name} T={ntypes} vs JAX xla')
    # the forces alone, the same
    F1 = _port_charged(tcp.cell_pair_planar, cell_pos, cell_tag, cd, shifts,
                       pv, typ, q, C=C, want_pv=False, **kw)
    assert np.array_equal(F1[0], got[0])
    # the port's XLA formulation: the JAX one's, in torch
    Fx = _port_charged(tcp.cell_pair_xla, cell_pos, cell_tag, cd, shifts, pv,
                       typ, q, **kw)[0]
    _close(Fx, want[0], valid, 1e-4, 'port xla vs JAX xla')


def test_wrappers_take_charged_evaluators_only_with_cell_q():
    cell_pos, cell_tag, typ, q, shifts, cd, C, rc = _charged_fill(1, 9)
    pos, tag, sh, qt = (torch.as_tensor(x)
                        for x in (cell_pos, cell_tag, shifts, q))
    pv = torch.as_tensor(_charged_table('ewald', 1, rc))
    pn = tpe.kernel_pnames('ewald')
    with pytest.raises(ValueError, match='pass cell_q'):
        tcp.cell_pair_planar(pos, cd, sh, pv, C=C, cell_tag=tag,
                             eval_name='ewald', pnames=pn)
    with pytest.raises(ValueError, match='pass cell_q'):
        tcp.cell_pair_plane(pos, cd, sh, pv, C=C, cell_tag=tag,
                            eval_name='ewald', pnames=pn)
    lj = torch.tensor([6.25, 0.0, 4.0, 4.0, 2.5])
    with pytest.raises(NotImplementedError, match="not 'lj'"):
        tcp.cell_pair_planar(pos, cd, sh, lj, C=C, cell_tag=tag, cell_q=qt)
    with pytest.raises(ValueError, match='cell_q'):
        tcp.cell_pair_planar(pos, cd, sh, pv, C=C, cell_tag=tag,
                             eval_name='ewald', pnames=pn, cell_q=qt[:-1])


# ---------------------------------------------------------------------------
# the mesh


def _jax_pppm(pos, q, L, mesh):
    """A JAX-package system of charges at pos in a cube of side L with a
    pppm of order 5 on ``mesh``: (system, pppm)."""
    import hoomd_tpu as jh
    jh.context.initialize('--notice-level=0')
    snap = jh.data.make_snapshot(len(q), jh.data.boxdim(L=L))
    snap.particles.position[:] = pos
    snap.particles.charge[:] = q
    jh.init.read_snapshot(snap)
    p = jh.md.charge.pppm(group=jh.group.all(), nlist=jh.md.nlist.cell())
    p.set_params(Nx=mesh[0], Ny=mesh[1], Nz=mesh[2], order=5, rcut=2.5)
    system = jh.context.current.system
    p._make_compute(system)
    return system, p


@pytest.mark.parametrize('case', ['dense', 'scatter'])
def test_mesh_compute_matches_jax(case):
    import jax
    import jax.numpy as jnp
    import hoomd_tpu as jh
    n, L, mesh = {'dense': (300, 9.0, (16, 16, 16)),
                  'scatter': (2100, 12.0, (128, 128, 8))}[case]
    assert (n * mesh[0] * mesh[1] <= tch.DENSE_MAX) == (case == 'dense')
    rng = np.random.RandomState(3)
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    q = rng.choice([-1.0, 1.0], n).astype(np.float32)
    q[-1] = -q[:-1].sum()                            # neutral
    system, p = _jax_pppm(pos, q, L, mesh)
    try:
        jparams = p._pack_params(system)
        box = system.state.box
        tparams = interop.pppm_params_from_numpy(jparams)
        # one compiled call for both forms (op by op, the JAX side
        # compiles every primitive at these shapes)
        both = jax.jit(lambda x, c: [p._mesh_compute(x, c, box, jparams,
                                                     want_pv=pv)
                                     for pv in (True, False)])
        wants = both(jnp.asarray(pos), jnp.asarray(q))
        for want_pv, want in zip((True, False), wants):
            want = tuple(np.asarray(o) for o in want)
            got = tuple(o.numpy() for o in tch.mesh_compute(
                torch.as_tensor(pos), torch.as_tensor(q), TBox.create(L),
                tparams, want_pv=want_pv, mesh=mesh, order=5))
            every = np.ones(n, bool)
            _close(got[0], want[0], every, 1e-4, f'{case} F')
            if want_pv:
                _close(got[1], want[1], every, 1e-4, f'{case} pe')
                _close(got[2], want[2], every, 1e-4, f'{case} virial')
            else:
                assert not got[1].any() and not got[2].any()
    finally:
        jh.context.current = None


def test_pppm_params_match_jax(torch_ctx):
    """The port's packed kappa, B-spline moduli and wave numbers equal the
    JAX package's."""
    import hoomd_tpu as jh
    pos = np.zeros((2, 3), np.float32)
    pos[1, 0] = 1.0
    q = np.array([1.0, -1.0], np.float32)
    system, p = _jax_pppm(pos, q, 8.0, (16, 12, 8))
    jparams = p._pack_params(system)
    jh.context.current = None
    snap = th.data.make_snapshot(2, th.data.boxdim(L=8.0))
    snap.particles.position[:] = pos
    snap.particles.charge[:] = q
    th.init.read_snapshot(snap)
    tp = th.md.charge.pppm(group=th.group.all(), nlist=th.md.nlist.cell())
    tp.set_params(Nx=16, Ny=12, Nz=8, order=5, rcut=2.5)
    got = tp._pack_params(th.context.current.system)
    want = interop.pppm_params_from_numpy(jparams)
    assert float(got['kappa']) == float(want['kappa'])
    for k in ('bmod', 'mvec'):
        for g, w in zip(got[k], want[k]):
            assert torch.equal(g, w), k
    with pytest.raises(ValueError, match='order'):
        tp.set_params(Nx=8, Ny=8, Nz=8, order=8, rcut=2.5)


# ---------------------------------------------------------------------------
# job scripts


def _charged_snapshot(hoomd, n, a=1.6, jitter=0.05, seed=9):
    """The rock-salt start of config 4 (tests/test_charged_fast.py _build):
    n^3 ions of charge +-1 (types A, B) at spacing a, jittered by up to
    ``jitter``, Maxwell velocities at T = 1."""
    L = n * a
    N = n ** 3
    snap = hoomd.data.make_snapshot(N, hoomd.data.boxdim(L=L),
                                    particle_types=['A', 'B'])
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    snap.particles.position[:] = ((ijk + 0.5) * a - L / 2
                                  + rng.uniform(-jitter, jitter, (N, 3)))
    s = np.where(ijk.sum(1) % 2 == 0, 1.0, -1.0)
    snap.particles.charge[:] = s
    snap.particles.typeid[:] = np.where(s > 0, 0, 1)
    v = rng.normal(0, 1.0, (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    return snap


def _charged_script(hoomd, n=6, mesh=16, lj=True, lj_mode='none',
                    lj_nlist=False, lj_rcut=2.5, pair='lj', pppm=True):
    """Config 4's job script (bench_all.py:158-217) at n^3 ions, for
    either package; the keywords make the gates' variants."""
    md = hoomd.md
    hoomd.init.read_snapshot(_charged_snapshot(hoomd, n))
    nl = md.nlist.cell()
    if lj:
        f = getattr(md.pair, pair)(r_cut=lj_rcut, nlist=md.nlist.cell()
                                   if lj_nlist else nl)
        for t1, t2 in [('A', 'A'), ('A', 'B'), ('B', 'B')]:
            f.pair_coeff.set(t1, t2, epsilon=1.0, sigma=1.0)
        f.set_params(mode=lj_mode)
    if pppm:
        p = md.charge.pppm(group=hoomd.group.all(), nlist=nl)
        p.set_params(Nx=mesh, Ny=mesh, Nz=mesh, order=5, rcut=2.5)
    else:
        ew = md.pair.ewald(r_cut=2.5, nlist=nl)
        ew.pair_coeff.set(['A', 'B'], ['A', 'B'], kappa=float(KAPPA))
    md.integrate.mode_standard(dt=0.005)
    md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.5)
    return hoomd.context.current.system


def _reads(system, reads=4, every=10):
    out = []
    for _ in range(reads):
        system.run(every, quiet=True)
        s = system.take_snapshot()
        q = system.thermo_quantities()
        out.append((s.particles.position.copy(),
                    s.particles.velocity.copy(), q['potential_energy'],
                    q['pressure']))
    return out


@pytest.fixture(scope='module')
def jax_job():
    """The 216-ion job through the JAX fast engine, once for the module:
    its reads, its packed 'pv' and its pppm parameters."""
    import hoomd_tpu as jh
    old = os.environ.get('HOOMD_TPU_FAST')
    os.environ['HOOMD_TPU_FAST'] = 'on'
    try:
        jh.context.initialize('--notice-level=0')
        system = _charged_script(jh)
        reads = _reads(system)
        fast = system._program['fast']
        assert fast['eval_name'] == 'lj_ewald'
        pppm = next(f for f in system.forces
                    if type(f).__name__ == 'pppm')
        out = {'reads': reads, 'pv': np.asarray(system._fast_dyn()['pv']),
               'mesh': pppm._pack_params(system),
               'timestep': system.timestep}
    finally:
        jh.context.current = None
        if old is None:
            os.environ.pop('HOOMD_TPU_FAST', None)
        else:
            os.environ['HOOMD_TPU_FAST'] = old
    return out


def test_charged_job_matches_jax(torch_ctx, monkeypatch, jax_job):
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    system = _charged_script(th)
    reads = _reads(system)
    fast = system._program['fast']
    assert (fast['eval_name'], fast['ntypes'], fast['impl'], fast['mega'],
            fast['fused'], fast['rebin_impl']) == ('lj_ewald', 2, 'plane',
                                                   False, False, 'sort')
    assert system.timestep == jax_job['timestep'] == 40
    assert tcp.cell_pair_planar.q_typed_launches == 0   # the CPU runs plain
    N = 216
    for i, ((pa, va, ea, Pa), (pb, vb, eb, Pb)) in enumerate(
            zip(reads, jax_job['reads'])):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=2e-5,
                                   err_msg=f'positions, read {i}')
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-3,
                                   err_msg=f'velocities, read {i}')
        assert ea == pytest.approx(eb, rel=0, abs=1e-4 * N), f'PE, read {i}'
        assert Pa == pytest.approx(Pb, rel=1e-4, abs=1e-4), f'P, read {i}'
    # the JAX job's packed tables, through interop, are the port's own
    pv = interop.pair_tables_from_numpy(jax_job['pv'], 2,
                                        eval_name='lj_ewald')
    torch.testing.assert_close(pv, system._dyn['fast']['pv'], rtol=2e-6,
                               atol=0.0)
    mp = interop.pppm_params_from_numpy(jax_job['mesh'])
    got = system._dyn['fast']['mesh']
    assert float(mp['kappa']) == float(got['kappa'])
    for k in ('bmod', 'mvec'):
        for g, w in zip(got[k], mp[k]):
            assert torch.equal(g, w), k


def test_madelung_nacl(torch_ctx):
    """NaCl rock salt through the port: U/ion = -1.747565 q^2 / (2 a) and
    no force on a perfect lattice (tests/test_pppm.py)."""
    n, a = 4, 1.0
    N = (2 * n) ** 3
    snap = th.data.make_snapshot(N, th.data.boxdim(L=2 * n * a),
                                 particle_types=['A', 'B'])
    ijk = np.stack(np.meshgrid(*[np.arange(2 * n)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    snap.particles.position[:] = ijk * a - n * a + a / 2
    s = (-1.0) ** ijk.sum(1)
    snap.particles.charge[:] = s
    snap.particles.typeid[:] = np.where(s > 0, 0, 1)
    th.init.read_snapshot(snap)
    system = th.context.current.system
    p = th.md.charge.pppm(group=th.group.all(), nlist=th.md.nlist.cell())
    p.set_params(Nx=32, Ny=32, Nz=32, order=5, rcut=3.0)
    th.md.integrate.mode_standard(dt=0.0)
    th.md.integrate.nve(group=th.group.all())
    th.run(1, quiet=True)
    assert system._program['fast']['eval_name'] == 'ewald'
    pe = system.thermo_quantities()['potential_energy']
    assert pe / N == pytest.approx(-1.747565 / 2, rel=2e-3)
    assert np.abs(np.asarray(system.state.net_force)).max() < 5e-2


def test_lj_job_ignores_charges(torch_ctx):
    """Like the JAX package, an uncharged pair force runs on a charged
    snapshot and ignores the charges."""
    out = []
    for charge in (False, True):
        th.context.initialize('--mode=cpu --notice-level=0')
        snap = _charged_snapshot(th, 5)
        if not charge:
            snap.particles.charge[:] = 0.0
        th.init.read_snapshot(snap)
        lj = th.md.pair.lj(r_cut=2.5, nlist=th.md.nlist.cell())
        lj.pair_coeff.set(['A', 'B'], ['A', 'B'], epsilon=1.0, sigma=1.0)
        th.md.integrate.mode_standard(dt=0.005)
        th.md.integrate.nvt(group=th.group.all(), kT=1.0, tau=0.5)
        system = th.context.current.system
        out.append(_reads(system, reads=1))
        assert system._program['fast']['eval_name'] == 'lj'
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# gates


@pytest.mark.parametrize('kw,gate', [
    (dict(lj_mode='shift'), 'pppm + shifted lj pair'),
    (dict(pair='gauss'), 'pppm + non-lj pair (need lj)'),
    (dict(lj_nlist=True), 'pppm pair on a different nlist'),
    (dict(lj_rcut=3.0), 'pppm lj/ewald cutoffs differ'),
    (dict(impl='row'), 'HOOMD_TPU_FAST_IMPL=row runs the lj evaluator only'),
])
def test_charged_gates_raise(torch_ctx, monkeypatch, kw, gate):
    kw = dict(kw)
    impl = kw.pop('impl', None)
    if impl is not None:
        monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', impl)
    _charged_script(th, n=4, mesh=8, **kw)
    with pytest.raises(NotImplementedError, match=re.escape(gate)):
        th.run(1, quiet=True)


def test_pppm_gates_raise(torch_ctx):
    """Two pppm solvers; a pppm whose real-space pair is missing; a third
    pair force beside lj + ewald."""
    system = _charged_script(th, n=4, mesh=8)
    p2 = th.md.charge.pppm(group=th.group.all(), nlist=th.md.nlist.cell())
    with pytest.raises(NotImplementedError, match='multiple pppm instances'):
        th.run(1, quiet=True)
    system.forces.remove(p2)
    p2._ewald_pair = None
    ew = next(f for f in system.forces if f.name == 'pppm_real')
    system.forces.remove(ew)
    system._dirty()
    with pytest.raises(NotImplementedError,
                       match='pppm without its real-space ewald pair'):
        th.run(1, quiet=True)
    system.forces.append(ew)
    g = th.md.pair.gauss(r_cut=2.5, nlist=ew._nlist)
    g.pair_coeff.set(['A', 'B'], ['A', 'B'], epsilon=1.0, sigma=1.0)
    with pytest.raises(NotImplementedError,
                       match='3 pair forces beside pppm'):
        th.run(1, quiet=True)


def test_pppm_refuses_tf32_matmuls(torch_ctx):
    """The mesh's one-hot products must run in full float32: a caller who
    turned TF32 back on after import gets an error when the solver is
    built, and the setting is left as the caller made it."""
    _charged_script(th, n=4, mesh=8)
    torch.set_float32_matmul_precision('high')
    try:
        with pytest.raises(RuntimeError, match='full-float32'):
            th.run(1, quiet=True)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision('highest')
    th.run(1, quiet=True)


def test_standalone_ewald_runs_as_ewald(torch_ctx):
    system = _charged_script(th, n=4, lj=False, pppm=False)
    th.run(2, quiet=True)
    fast = system._program['fast']
    assert fast['eval_name'] == 'ewald' and fast['charged']['mesh'] is None
    assert fast['pnames'] == ('kappa', 'rcut')
    assert tuple(system._dyn['fast']['pv'].shape) == (4, 2, 2)
    assert np.isfinite(system.thermo_quantities()['potential_energy'])


def test_config4_plan(torch_ctx, monkeypatch):
    """Config 4 at 4096 ions: the conservative plan of the lattice start,
    (8, 5, 4) and C = 40, the sort rebin, no megastep and no fused step
    whatever the switches say."""
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    monkeypatch.delenv('HOOMD_TPU_MEGA', raising=False)
    monkeypatch.setenv('HOOMD_TPU_FUSED', 'on')
    system = _charged_script(th, n=16, mesh=32)
    system._ensure_ready()
    fast = system._program['fast']
    assert (fast['cell_dim'], fast['C'], fast['rebin_impl'], fast['mega'],
            fast['fused'], fast['eval_name']) == ((8, 5, 4), 40, 'sort',
                                                  False, False, 'lj_ewald')
    assert tuple(system._dyn['fast']['pv'].shape) == (6, 2, 2)
    assert 4096 * 32 * 32 <= tch.DENSE_MAX


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('ntypes', [1, 2, 4])
@pytest.mark.parametrize('name', CHARGED)
def test_cuda_charged_planar_matches_plain(cuda, name, ntypes):
    cell_pos, cell_tag, typ, q, shifts, cd, C, rc = _charged_fill(ntypes, 11)
    pv = _charged_table(name, ntypes, rc)
    pos, tag, ty, sh, pvt, qt = (torch.as_tensor(x, device=cuda) for x in
                                 (cell_pos, cell_tag, typ, shifts, pv, q))
    kw = dict(eval_name=name, pnames=tpe.kernel_pnames(name), ntypes=ntypes,
              cell_typ=ty if ntypes > 1 else None, cell_q=qt)
    fn = tcp.cell_pair_planar
    n0 = (fn.q_launches, fn.q_typed_launches)
    got = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    F = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, want_pv=False, **kw)
    assert (fn.q_launches, fn.q_typed_launches) == (
        (n0[0] + 2, n0[1]) if ntypes == 1 else (n0[0], n0[1] + 2))
    want = tcp.cell_pair_planar_plain(pos, cd, sh, pvt, cell_tag=tag, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(F, want[0], rtol=1e-4, atol=1e-4)


def _madelung_fill(seed):
    """The Madelung job's plan: 512 ions of charge +-1 on a rock-salt
    lattice of spacing 1 in a box of 8, jittered by up to 0.05, in (2, 2,
    2) cells of C = 88 (64 ions each), with random types; numpy.  Returns
    (cell_pos, cell_tag, typ, q, shifts, cell_dim, C)."""
    rng = np.random.RandomState(seed)
    cd, C, L = (2, 2, 2), 88, 8.0
    ijk = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    pos = ijk - 4.0 + 0.5 + rng.uniform(-0.05, 0.05, ijk.shape)
    c3 = (pos >= 0).astype(int)
    cid = c3[:, 0] + 2 * (c3[:, 1] + 2 * c3[:, 2])
    cell_pos = np.full((8, C, 3), 1.0e9, np.float32)
    cell_tag = np.full((8, C), -1, np.int32)
    q = np.zeros((8, C), np.float32)
    fill = np.zeros(8, int)
    for t, c in enumerate(cid):
        cell_pos[c, fill[c]], cell_tag[c, fill[c]] = pos[t], t
        q[c, fill[c]] = (-1.0) ** ijk[t].sum()
        fill[c] += 1
    typ = np.where(cell_tag >= 0, rng.randint(0, 4, cell_tag.shape), 0)
    _, shifts = tcp.build_cell_shifts(cd, (L, L, L))
    return (cell_pos, cell_tag, typ.astype(np.int32), q,
            shifts.astype(np.float32), cd, C)


def _charged_edge_fill(fill, ntypes, seed):
    """The edge fills of the tile kernels (EDGE: a cell filled to C, an
    empty cell, a one-particle cell, live slots among padding) with
    charges +-1 on the live slots, or the Madelung job's plan; types
    folded into [0, ntypes).  Returns (cell_pos, cell_tag, typ, q,
    shifts, cell_dim, C, r_cut)."""
    if fill == 'madelung':
        cell_pos, cell_tag, typ, q, shifts, cd, C = _madelung_fill(seed)
        return cell_pos, cell_tag, typ % ntypes, q, shifts, cd, C, 3.0
    cd, C = EDGE[fill]
    cell_pos, cell_tag, typ, shifts = _edge_fill(cd, C, seed, ntypes)
    rng = np.random.RandomState(seed + 100)
    q = np.where(cell_tag >= 0, rng.choice([-1.0, 1.0], cell_tag.shape),
                 0.0).astype(np.float32)
    return cell_pos, cell_tag, typ, q, shifts, cd, C, 2.5


@pytest.mark.gpu
@pytest.mark.parametrize('name', CHARGED)
@pytest.mark.parametrize('fill', list(EDGE) + ['madelung'])
def test_cuda_charged_edge_fills_match_plain(cuda, fill, name):
    """The charged kernel on the edge fills and the Madelung plan, with
    one, two and four types: F, PE and virial, and F alone, against the
    plain version at rtol = atol = 1e-4, and equal bits from two calls."""
    for ntypes in (1, 2, 4):
        cell_pos, cell_tag, typ, q, shifts, cd, C, rc = _charged_edge_fill(
            fill, ntypes, 23)
        pv = _charged_table(name, ntypes, rc)
        pos, tag, ty, sh, pvt, qt = (torch.as_tensor(x, device=cuda)
                                     for x in (cell_pos, cell_tag, typ,
                                               shifts, pv, q))
        kw = dict(eval_name=name, pnames=tpe.kernel_pnames(name),
                  ntypes=ntypes, cell_typ=ty if ntypes > 1 else None,
                  cell_q=qt)
        fn = tcp.cell_pair_planar
        got = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
        again = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
        F = fn(pos, cd, sh, pvt, C=C, cell_tag=tag, want_pv=False, **kw)
        want = tcp.cell_pair_planar_plain(pos, cd, sh, pvt, cell_tag=tag,
                                          **kw)
        for g, a, w in zip(got, again, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                       msg=f'{ntypes} types')
            assert torch.equal(g, a), f'{ntypes} types'
        torch.testing.assert_close(F, want[0], rtol=1e-4, atol=1e-4)
        # the fill has pairs in the cut
        assert float(want[0].abs().max()) > 0.1, f'{ntypes} types'


@pytest.mark.gpu
@pytest.mark.parametrize('ntypes', [1, 2])
@pytest.mark.parametrize('name', CHARGED)
def test_cuda_charged_cuts_at_the_rounded_r2(cuda, name, ntypes):
    """A pair one float32 step inside r_cut (r^2 rounded as torch's) pairs,
    the one a step outside does not, in the kernel as in the plain
    version; a mixture's pair (0, 1) at its own cut."""
    pv = _charged_table(name, ntypes, 2.5)
    rc2 = pv[0] if ntypes == 1 else pv[0, 0, 1]
    cell_pos, cell_tag, typ, shifts, cd, C = _cut_pairs(
        rc2, 0, 1 if ntypes > 1 else 0)
    q = np.where(cell_tag >= 0, np.where(cell_tag % 2, -1.0, 1.0),
                 0.0).astype(np.float32)
    pos, tag, ty, sh, pvt, qt = (torch.as_tensor(x, device=cuda) for x in
                                 (cell_pos, cell_tag, typ, shifts, pv, q))
    kw = dict(eval_name=name, pnames=tpe.kernel_pnames(name), ntypes=ntypes,
              cell_typ=ty if ntypes > 1 else None, cell_q=qt)
    got = tcp.cell_pair_planar(pos, cd, sh, pvt, C=C, cell_tag=tag, **kw)
    want = tcp.cell_pair_planar_plain(pos, cd, sh, pvt, cell_tag=tag, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    order = torch.argsort(tag[tag >= 0])     # tags 0, 1 inside; 2, 3 out
    f = got[0][tag >= 0][order]
    assert float(f[0].abs().max()) > 0.0 and not f[2:].any()


if __name__ == '__main__':
    # from the repo root: PYTHONPATH=. python tests/test_torch_charged.py
    # pppm-trace [seed] runs chip_smoke.py's config-4 job script (its
    # velocities from ``seed``, 9 in the config) through the JAX
    # package's fast engine on the CPU (the warmup, the timed window and
    # the NVT window of pppm_job), printing T and PE/N every 100 steps of
    # the window and their means: the reference of pppm_job's PE/N gate;
    # pppm-nve [n_side [mesh]] the script's NVE energy after 300 NVT steps
    import sys
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['HOOMD_TPU_FAST'] = 'on'
    import hoomd_tpu as jh
    from profile_torch_bench import pppm_nve, pppm_trace
    if sys.argv[1:2] == ['pppm-nve']:
        # pppm-nve [n_side [mesh]]: the energy of 500 NVE steps after 300
        # NVT steps from the lattice, as profile_torch_bench.py pppm-nve
        pppm_nve(int(sys.argv[2]) if len(sys.argv) > 2 else 16,
                 int(sys.argv[3]) if len(sys.argv) > 3 else 32, jh,
                 '--notice-level=0')
    else:
        assert sys.argv[1:2] == ['pppm-trace'], sys.argv
        pppm_trace(jh, '--notice-level=0',
                   int(sys.argv[2]) if len(sys.argv) > 2 else 9)
