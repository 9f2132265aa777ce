"""Bonded terms and nlist exclusions (BASELINE config 3's path) against the
JAX package.

Bond and angle forces ride the cell engine as tag-space terms beside the
pair force (hoomd_tpu/system.py:390-398, 501-517, 794-847, 1170-1188;
ops/fast_lj.py:469-571, 639-642, 1161-1164): every step a one_step on the
plane kernel plus the terms, the megastep and the fused step off.  On
identical numpy inputs made from a seed:

  * each term of ops/bonded.py through its driver bonded_force against
    the JAX package's bonded_force with its energy functions (forces by
    jax.grad): FENE and harmonic bonds at r in [0.7, 1.6] (through the
    WCA cut at 2^(1/6) and the FENE clip at r0 sqrt(0.99)), harmonic
    angles at theta = pi exactly, 1e-4 off pi, 0, 1e-4 and in between
    (t0 = pi and 1.9), cosinesq angles, the exclusion correction of
    shifted lj and of unshifted yukawa, and the charged one (lj_ewald
    with a mesh, ewald without); groups straddle the periodic box and
    include padding rows.  Forces, per-particle energies and virials to
    1e-5 of the largest magnitude of each (both float32; the JAX
    derivatives round as autodiff orders them), clipped angles' forces
    exactly 0 on both sides;
  * the exclusion table of md.nlist (default, [] and ['bond', '1-3'])
    against the JAX package's _build_exclusion_table on a branched
    topology with every kind of group, equal;
  * tests/test_fast_bonded.py's 16 chains of 16 beads (WCA, FENE,
    harmonic angles at t0 = pi, default exclusions), shifted so that
    beads cross cells and the rebuilds move them between slots (with
    slot tables left stale the runs part), for 30 steps at dt = 0.002
    under nve, nvt and langevin through both packages' job scripts,
    the JAX side on its fast engine (HOOMD_TPU_FAST=on, the XLA
    formulation on the CPU): positions to 1e-4 (float32 pair and bond
    sums in other orders, over 30 steps of stiff bonds), thermo PE to
    1e-5 relative (about 19 per bead, summed from float32 shares) and
    pressure to 1e-4 relative; rebuilds on the way; the excluded pairs and
    the terms' parameters (through interop) equal to the JAX program's.
    Under nve the run goes in segments of 16 and 14 steps, and the second
    reports danger in both packages, so that each restarts it from the
    first's end carry, slots remapped, at a shorter cadence: one retry
    (NVE, so that the thermostat's rewind on a retry, which the packages
    do differently, does not enter);
  * tests/test_charged_fast_molecular.py's charged polymer (8 chains of 8
    beads of alternating charge, harmonic bonds, bond exclusions, lj and
    PPPM on a 16^3 mesh, NVE) through both packages' fast engines: forces
    after one step to 5e-4 of the largest, PE to 2e-5 relative, and
    positions after 40 steps to 5e-4;
  * the gates: dihedrals, impropers, constraints and special pairs,
    bond.table and angle.table, and HOOMD_TPU_CHAIN=on raise
    NotImplementedError naming what is refused.

The file takes about 60 s serial on the CPU, most of it the JAX side's
compiles and the port's plain stencil.
"""

import os

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.ops import bonded as tb
from hoomd_tpu_torch.ops import pair_eval as tpe

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

BOX_L = np.array([7.0, 8.0, 9.0], np.float32)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


# ---------------------------------------------------------------------------
# the terms


def _wrap(x):
    return ((x + BOX_L / 2) % BOX_L - BOX_L / 2).astype(np.float32)


def _frame(rng, n):
    """n random points and orthonormal pairs (u, w)."""
    base = rng.uniform(-4.0, 4.0, (n, 3))
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(n, 3))
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return base, u, w


def _bond_case(rng, n=64):
    base, u, _ = _frame(rng, n)
    r = np.concatenate([[2 ** (1 / 6), 1.5 * np.sqrt(0.99) - 1e-3,
                         1.5 * np.sqrt(0.99) + 1e-3],
                        np.linspace(0.7, 1.6, n - 3)])
    pos = np.stack([base, base + r[:, None] * u], 1).reshape(-1, 3)
    return _wrap(pos), np.arange(2 * n).reshape(n, 2)


def _angle_case(rng, n=64):
    theta = np.concatenate([[np.pi, np.pi - 1e-4, 0.0, 1e-4],
                            rng.uniform(0.05, np.pi - 0.05, n - 4)])
    base, u, w = _frame(rng, n)
    v = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * w
    pos = np.stack([base + 0.97 * u, base, base + 1.03 * v], 1)
    return _wrap(pos.reshape(-1, 3)), np.arange(3 * n).reshape(n, 3)


def _pad(groups):
    """The group table with two padding rows (an index past the last
    position)."""
    n = groups.max() + 1
    pad = np.full((2, groups.shape[1]), n)
    pad[1, 0] = 0
    return np.concatenate([groups, pad])


def _jax_cfg_term(evaluator, mode, charged=None):
    """The JAX package's exclusion-correction energy function, from its
    _bonded_cfg_for (it reads no system state without bonded forces)."""
    from types import SimpleNamespace as NS
    from hoomd_tpu.system import System
    f = NS(_evaluator=evaluator, mode=mode)
    return System._bonded_cfg_for(None, f, [], np.zeros((1, 2), np.int32),
                                  charged=charged)[0]['energy_fn']


def _term_cases():
    """(name, positions, groups, params, JAX energy fn, port term)."""
    from types import SimpleNamespace as NS
    from hoomd_tpu.ops import bonded as jb
    from hoomd_tpu.ops import pair_eval as jpe
    rng = np.random.RandomState(4)
    bpos, bg = _bond_case(rng)
    apos, ag = _angle_case(rng)
    m, ma = len(bg) + 2, len(ag) + 2

    def full(n, **kw):
        return {k: np.full(n, v, np.float32) for k, v in kw.items()}
    fene = full(m, k=30.0, r0=1.5, sigma=1.0, epsilon=1.0)
    fene['k'][::3] = 20.0
    rc = np.float32(2.5)
    rc2 = rc * rc
    lj = {k: np.full(m, v, np.float32) for k, v in
          tpe.lj.derive({'epsilon': np.float32(1.0), 'sigma': np.float32(1.0),
                         'alpha': np.float32(1.0)}).items()}
    lj.update(rcut2=np.full(m, rc2), rcut=np.full(m, rc))
    _, es = tpe.lj.energy_force(torch.tensor(rc2), {
        k: torch.tensor(v[0]) for k, v in lj.items()})
    lj['e_shift'] = np.full(m, float(es), np.float32)
    yuk = full(m, epsilon=2.0, kappa=1.3, rcut=2.5)
    yuk['rcut2'] = yuk['rcut'] * yuk['rcut']
    yuk['e_shift'] = np.zeros(m, np.float32)
    q = rng.choice([-1.0, 1.0], (m, 2)).astype(np.float32)
    qk = dict(kappa=np.full(m, 1.28, np.float32), qiqj=q[:, 0] * q[:, 1],
              rcut2=np.full(m, rc2))
    lje = dict(qk, lj1=lj['lj1'], lj2=lj['lj2'])
    lj_f = NS(_evaluator=jpe.lj)
    return [
        ('fene', bpos, bg, fene, jb.bond_fene_energy, tb.bond_fene),
        ('bond harmonic', bpos, bg, full(m, k=100.0, r0=1.1),
         jb.bond_harmonic_energy, tb.bond_harmonic),
        ('angle harmonic t0 = pi', apos, ag, full(ma, k=1.5, t0=np.pi),
         jb.angle_harmonic_energy, tb.angle_harmonic),
        ('angle harmonic t0 = 1.9', apos, ag, full(ma, k=2.5, t0=1.9),
         jb.angle_harmonic_energy, tb.angle_harmonic),
        ('angle cosinesq', apos, ag, full(ma, k=3.0, t0=2.1),
         jb.angle_cosinesq_energy, tb.angle_cosinesq),
        ('exclusion lj shift', bpos, bg, lj,
         _jax_cfg_term(jpe.lj, 'shift'), tb.exclusion(tpe.lj, True)),
        ('exclusion yukawa', bpos, bg, yuk,
         _jax_cfg_term(jpe.yukawa, 'none'), tb.exclusion(tpe.yukawa, False)),
        ('charged exclusion lj_ewald + mesh', bpos, bg, lje,
         _jax_cfg_term(None, 'none', {'lj': lj_f, 'mesh': object()}),
         tb.charged_exclusion(tpe.lj, True)),
        ('charged exclusion ewald', bpos, bg, qk,
         _jax_cfg_term(None, 'none', {'lj': None, 'mesh': None}),
         tb.charged_exclusion(None, False)),
    ]


def test_bonded_terms_match_jax():
    import jax.numpy as jnp
    from hoomd_tpu.box import Box as JBox
    from hoomd_tpu.ops import bonded as jb
    jbox = JBox.create(*BOX_L.tolist())
    for name, pos, groups, p, jfn, tterm in _term_cases():
        g = _pad(groups)
        want = [np.asarray(o) for o in jb.bonded_force(
            jnp.asarray(pos), jbox, jnp.asarray(g, jnp.int32),
            {k: jnp.asarray(v) for k, v in p.items()}, jfn)]
        got = [o.numpy() for o in tb.bonded_force(
            torch.as_tensor(pos), torch.as_tensor(BOX_L),
            interop.bonded_groups_from_numpy(g),
            interop.bonded_params_from_numpy(p), tterm)]
        for lab, a, w in zip(('force', 'energy', 'virial'), got, want):
            assert np.isfinite(a).all(), (name, lab)
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f'{name} {lab}')
        F_hot = tb.bonded_force(torch.as_tensor(pos), torch.as_tensor(BOX_L),
                                torch.as_tensor(g),
                                interop.bonded_params_from_numpy(p), tterm,
                                want_pv=False)
        assert torch.equal(F_hot[0], torch.as_tensor(got[0])), name
        assert F_hot[1:] == (None, None)
        if name.startswith('angle harmonic'):
            # theta = pi, pi - 1e-4, 0 and 1e-4 lie outside the cosine's
            # clip: no force on either side
            for out in (got[0], want[0]):
                assert not out[:12].any(), name
        assert np.abs(want[0]).max() > 0.1, name


# ---------------------------------------------------------------------------
# the exclusion table


def _branched_snapshot():
    """A star of three arms with a ring closure, and one group of every
    kind, on a port snapshot."""
    snap = th.data.make_snapshot(
        12, th.data.boxdim(L=10.0), bond_types=['b'], angle_types=['a'],
        dihedral_types=['d'], pair_types=['p'])
    bonds = [[0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [5, 6], [6, 3],
             [2, 7], [8, 9]]
    angles = [[1, 0, 2], [2, 0, 3], [1, 0, 3], [0, 3, 4], [3, 4, 5],
              [0, 2, 7]]
    for name, rows in (('bonds', bonds), ('angles', angles),
                       ('dihedrals', [[1, 0, 3, 4], [7, 2, 0, 3]]),
                       ('constraints', [[10, 11]]), ('pairs', [[9, 11]])):
        d = getattr(snap, name)
        d.resize(len(rows))
        d.group[:] = rows
    snap.particles.position[:] = np.random.RandomState(2).uniform(
        -4, 4, (12, 3))
    return snap


def test_exclusion_table_matches_jax(torch_ctx):
    from types import SimpleNamespace as NS
    from hoomd_tpu.md.nlist import nlist as jnl
    th.init.read_snapshot(_branched_snapshot())
    nl = th.md.nlist.cell()
    assert nl.exclusions == ['bond', 'body', 'constraint']
    snap = th.context.current.system.snapshot_template
    for excl in (None, [], ['bond', '1-3'], ['bond', 'angle', 'pair',
                                              'dihedral']):
        if excl is not None:
            nl.reset_exclusions(excl)
        want = jnl._build_exclusion_table(NS(exclusions=nl.exclusions), snap)
        got = nl._build_exclusion_table(snap)
        if want is None:
            assert got is None, excl
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), excl
    assert nl.exclusions == ['bond', 'angle', 'pair', 'dihedral']


# ---------------------------------------------------------------------------
# short KG trajectories through both packages


def _kg_script(hoomd, method):
    """tests/test_fast_bonded.py's system (_build_kg: 16 chains of 16 beads
    0.97 apart along z, WCA pair, FENE bonds, harmonic angles at t0 = pi,
    the default exclusions) for either package, with ``method`` at kT =
    1 and dt = 0.002, shifted by 0.45 along z: two beads of each chain
    then sit within 0.05 of a face of the engine's cells ((5, 4, 3)), so
    that beads cross cells and the rebuilds move beads between slots.
    Returns the System."""
    md = hoomd.md
    n_chains, chain_len = 16, 16
    N = n_chains * chain_len
    side = int(np.ceil(np.sqrt(n_chains)))
    box_L = max(side * 1.6, chain_len * 0.97 + 2.0)
    snap = hoomd.data.make_snapshot(
        N, hoomd.data.boxdim(L=box_L), particle_types=['A'],
        bond_types=['polymer'], angle_types=['backbone'])
    bonds, angles = [], []
    for c in range(n_chains):
        cx = (c % side) * 1.6 - box_L / 2 + 0.8
        cy = (c // side) * 1.6 - box_L / 2 + 0.8
        for m in range(chain_len):
            idx = c * chain_len + m
            snap.particles.position[idx] = [
                cx, cy, (m - (chain_len - 1) / 2) * 0.97 + 0.45]
            if m > 0:
                bonds.append([idx - 1, idx])
            if m > 1:
                angles.append([idx - 2, idx - 1, idx])
    v = np.random.RandomState(9).normal(0, 0.6, (N, 3))
    snap.particles.velocity[:] = v - v.mean(axis=0)
    snap.bonds.resize(len(bonds))
    snap.bonds.group[:] = bonds
    snap.angles.resize(len(angles))
    snap.angles.group[:] = angles
    hoomd.init.read_snapshot(snap)
    nl = md.nlist.cell()
    wca = md.pair.lj(r_cut=2 ** (1 / 6), nlist=nl)
    wca.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    wca.set_params(mode='shift')
    fene = md.bond.fene()
    fene.bond_coeff.set('polymer', k=30.0, r0=1.5, sigma=1.0, epsilon=1.0)
    ang = md.angle.harmonic()
    ang.angle_coeff.set('backbone', k=1.5, t0=np.pi)
    md.integrate.mode_standard(dt=0.002)
    if method == 'nve':
        md.integrate.nve(group=hoomd.group.all())
    elif method == 'nvt':
        md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.5)
    else:
        md.integrate.langevin(group=hoomd.group.all(), kT=1.0, seed=5)
    return hoomd.context.current.system


def _force_danger(system, at, true):
    """Make the ``at``-th segment the host runs report danger: its carry's
    sticky flag set (``true`` makes it), as a drift past the skin would.
    The host (either package's _run_fast_chunk, the same protocol) then
    restarts the segment from its start carry and plans a smaller window;
    the rebuilt program's segments report as they run."""
    fast = system._program['fast']
    run, calls = fast['run_chunk'], [0]

    def wrapped(carry, dyn, seg, m):
        out = run(carry, dyn, seg, m)
        calls[0] += 1
        return out.replace(danger=true(out.danger)) if calls[0] == at \
            else out
    fast['run_chunk'] = wrapped


def _kg_reads(system, method, true):
    """30 steps: under nve in segments of 16 and 14 steps with a danger
    retry of the second (NVE, so that the thermostat's rewind on a retry,
    which the packages do differently, does not enter), else in one.
    Returns positions, PE and pressure at the end."""
    if method == 'nve':
        system._ensure_ready()
        system._fast_seg_cap = 16
        _force_danger(system, 2, true)
    system.run(30, quiet=True)
    q = system.thermo_quantities()
    s = system.take_snapshot()
    return (s.particles.position.copy(), q['potential_energy'],
            q['pressure'])


def _jax_kg(method):
    """The KG system through the JAX fast engine: its reads, its excluded
    pairs and its terms' parameters."""
    import hoomd_tpu as jh
    import jax.numpy as jnp
    old = os.environ.get('HOOMD_TPU_FAST')
    os.environ['HOOMD_TPU_FAST'] = 'on'
    try:
        jh.context.initialize('--notice-level=0')
        system = _kg_script(jh, method)
        reads = _kg_reads(system, method, jnp.ones_like)
        fast = system._program['fast']
        assert fast['bonded_forces'] and not fast.get('chain')
        bonded = [{k: np.asarray(v) for k, v in p.items()}
                  for p in system._fast_dyn()['bonded']]
        return reads, fast['excl_pairs'], bonded
    finally:
        jh.context.current = None
        if old is None:
            os.environ.pop('HOOMD_TPU_FAST', None)
        else:
            os.environ['HOOMD_TPU_FAST'] = old


@pytest.mark.parametrize('method', ['nve', 'nvt', 'langevin'])
def test_kg_job_matches_jax(torch_ctx, monkeypatch, method):
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    want, excl, bonded = _jax_kg(method)
    system = _kg_script(th, method)
    got = _kg_reads(system, method, torch.ones_like)
    fast = system._program['fast']
    assert (fast['impl'], fast['mega'], fast['fused'], fast['rebin_impl']) \
        == ('plane', False, False, 'sort')
    st = system.fast_stats
    assert st['rebuilds'] > 0, st
    assert st['retries'] == (1 if method == 'nve' else 0), st
    assert np.array_equal(fast['excl_pairs'], excl)
    mine = system._dyn['fast']['bonded']
    assert len(mine) == len(bonded) == 3
    for p, w in zip(mine, bonded):
        assert sorted(p) == sorted(w)
        for k, v in interop.bonded_params_from_numpy(w).items():
            torch.testing.assert_close(p[k], v, rtol=2e-7, atol=0.0)
    (pa, ea, Pa), (pb, eb, Pb) = got, want
    assert ea > 256.0     # the bonds' FENE energy
    d = pa - pb
    d -= np.round(d / 17.52) * 17.52        # the box's edge
    assert np.abs(d).max() <= 1e-4, np.abs(d).max()
    assert ea == pytest.approx(eb, rel=1e-5)
    assert Pa == pytest.approx(Pb, rel=1e-4, abs=1e-4)


# ---------------------------------------------------------------------------
# the charged polymer


def _polymer_script(hoomd):
    """tests/test_charged_fast_molecular.py's _build_polymer for either
    package: 8 chains of 8 beads of alternating charge (types A, B) along
    z, harmonic bonds (k = 100, r0 = 1), the default exclusions, pair.lj
    (r_cut 2.5) and md.charge.pppm (16^3, order 5) on one cell list, NVE
    at dt = 0.002."""
    md = hoomd.md
    n_chain, blen, b0, L = 8, 8, 1.0, 9.0
    N = n_chain * blen
    snap = hoomd.data.make_snapshot(N, hoomd.data.boxdim(L=L),
                                    particle_types=['A', 'B'],
                                    bond_types=['backbone'])
    rng = np.random.RandomState(4)
    bonds = []
    for c in range(n_chain):
        cx, cy = (c % 3 - 1) * 3.0, (c // 3 - 1) * 3.0
        z0 = rng.uniform(0, b0)
        for m in range(blen):
            idx = c * blen + m
            snap.particles.position[idx] = [cx, cy, (z0 + m * b0) % L - L / 2]
            s = 1.0 if m % 2 == 0 else -1.0
            snap.particles.charge[idx] = s
            snap.particles.typeid[idx] = 0 if s > 0 else 1
            if m > 0:
                bonds.append([idx - 1, idx])
    snap.particles.position[:] += rng.uniform(-0.04, 0.04, (N, 3))
    v = rng.normal(0, 0.5, (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    snap.bonds.resize(len(bonds))
    snap.bonds.group[:] = bonds
    hoomd.init.read_snapshot(snap)
    nl = md.nlist.cell()
    lj = md.pair.lj(r_cut=2.5, nlist=nl)
    for t1, t2 in [('A', 'A'), ('A', 'B'), ('B', 'B')]:
        lj.pair_coeff.set(t1, t2, epsilon=1.0, sigma=1.0)
    bond = md.bond.harmonic()
    bond.bond_coeff.set('backbone', k=100.0, r0=b0)
    p = md.charge.pppm(group=hoomd.group.all(), nlist=nl)
    p.set_params(Nx=16, Ny=16, Nz=16, order=5, rcut=2.5)
    md.integrate.mode_standard(dt=0.002)
    md.integrate.nve(group=hoomd.group.all())
    return hoomd.context.current.system


def _polymer_reads(system):
    system.run(1, quiet=True)
    st = system.take_snapshot()
    F = system.state.net_force
    F = np.asarray(F.cpu().numpy() if hasattr(F, 'cpu') else F)
    rtag = np.asarray(system.state.rtag.cpu().numpy()
                      if hasattr(system.state.rtag, 'cpu')
                      else system.state.rtag)
    pe = system.thermo_quantities()['potential_energy']
    system.run(39, quiet=True)
    return F[rtag], pe, st.particles.position.copy(), \
        system.take_snapshot().particles.position.copy()


def test_charged_polymer_matches_jax(torch_ctx, monkeypatch):
    import hoomd_tpu as jh
    monkeypatch.delenv('HOOMD_TPU_FAST_IMPL', raising=False)
    monkeypatch.setenv('HOOMD_TPU_FAST', 'on')
    jh.context.initialize('--notice-level=0')
    try:
        js = _polymer_script(jh)
        want = _polymer_reads(js)
        jfast = js._program['fast']
        assert jfast['eval_name'] == 'lj_ewald' and jfast['bonded_forces']
        jexcl = jfast['excl_pairs']
    finally:
        jh.context.current = None
    system = _polymer_script(th)
    got = _polymer_reads(system)
    fast = system._program['fast']
    assert (fast['eval_name'], fast['ntypes'], fast['mega'],
            fast['fused']) == ('lj_ewald', 2, False, False)
    assert np.array_equal(fast['excl_pairs'], jexcl)
    F, Fw = got[0], want[0]
    np.testing.assert_allclose(F, Fw, rtol=0, atol=5e-4 * np.abs(Fw).max())
    assert got[1] == pytest.approx(want[1], rel=2e-5)
    for a, b in zip(got[2:], want[2:]):
        d = a - b
        d -= np.round(d / 9.0) * 9.0
        assert np.abs(d).max() <= 5e-4


# ---------------------------------------------------------------------------
# the gates


def _gate_snapshot(kind):
    snap = th.data.make_snapshot(
        8, th.data.boxdim(L=12.0), bond_types=['b'], angle_types=['a'],
        dihedral_types=['d'], improper_types=['i'], pair_types=['p'])
    snap.particles.position[:] = np.random.RandomState(1).uniform(
        -5, 5, (8, 3))
    snap.bonds.resize(1)
    snap.bonds.group[:] = [[0, 1]]
    if kind is not None:
        d = getattr(snap, kind)
        d.resize(1)
        d.group[:] = [[0, 1, 2, 3]] if d.arity == 4 else [[2, 3]]
    return snap


def _gate_script(kind):
    th.context.initialize('--mode=cpu --notice-level=0')
    th.init.read_snapshot(_gate_snapshot(kind))
    nl = th.md.nlist.cell()
    lj = th.md.pair.lj(r_cut=2.5, nlist=nl)
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    b = th.md.bond.harmonic()
    b.bond_coeff.set('b', k=10.0, r0=1.0)
    th.md.integrate.mode_standard(dt=0.002)
    th.md.integrate.nve(group=th.group.all())


def test_bonded_gates_raise(torch_ctx, monkeypatch):
    for kind in ('dihedrals', 'impropers', 'constraints', 'pairs'):
        _gate_script(kind)
        with pytest.raises(NotImplementedError,
                           match=rf'bonded topology \({kind}\)'):
            th.run(1, quiet=True)
    for mod in (th.md.bond, th.md.angle):
        with pytest.raises(NotImplementedError, match=r'\.table .*table '
                                                      r'bonded potential'):
            mod.table(width=10)
    _gate_script(None)
    monkeypatch.setenv('HOOMD_TPU_CHAIN', 'on')
    with pytest.raises(NotImplementedError, match='HOOMD_TPU_CHAIN=on'):
        th.run(1, quiet=True)
    monkeypatch.delenv('HOOMD_TPU_CHAIN')
    th.run(2, quiet=True)
    fast = th.context.current.system._program['fast']
    assert fast['excl_pairs'].tolist() == [[0, 1]]


if __name__ == '__main__':
    # from the repo root: PYTHONPATH=. python tests/test_torch_bonded.py
    # kg-trace [seed ...] runs chip_smoke.py's Kremer-Grest PE/N job
    # (config 3's script at KG_SEED_CHAINS chains, its start drawn from
    # ``seed``, 3 in the config) through the JAX package's fast engine on
    # the CPU, printing T and PE/N every 100 steps of the window and their
    # means: the reference of the kg_job's PE/N gate (KG_PE_JAX)
    import sys
    import time
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['HOOMD_TPU_FAST'] = 'on'
    import hoomd_tpu as jh
    from chip_smoke import (KG_SEED_CHAINS, KG_SEED_EQ, kg_script, kg_warmup,
                            kg_window)
    assert sys.argv[1:2] == ['kg-trace'], sys.argv
    for seed in map(int, sys.argv[2:] or ['3']):
        jh.context.initialize('--notice-level=0')
        system, mode = kg_script(jh, KG_SEED_CHAINS, seed)
        t0 = time.perf_counter()
        kg_warmup(system, mode, KG_SEED_EQ)
        what = f'kg-trace hoomd_tpu seed {seed}'
        print(f"{what}: warmup {time.perf_counter() - t0:.1f} s", flush=True)
        temps, pes = kg_window(system)
        for i, (t, pe) in enumerate(zip(temps, pes)):
            print(f"{what}: window {100 * (i + 1)} T {t:.5f} PE/N {pe:.5f}",
                  flush=True)
        print(f"{what}: mean T {float(np.mean(temps))!r} "
              f"mean PE/N {float(np.mean(pes))!r}", flush=True)
