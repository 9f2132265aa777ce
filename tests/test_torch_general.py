"""hoomd_tpu_torch's general engine against the JAX package's.

* rng: the threefry streams.  Uniforms equal bit for bit (integer hash,
  the same mantissa trick); normals within 4 ulps (erfinv in XLA's
  polynomial form: log1p and sqrt round as each library's own).
* ops/neighbor.py: the same rows in the same order, the same counts and
  overflow flags, on a mixture with per-pair ranges and bond exclusions
  in a tilted box, a 2D box and a fill that overflows both capacities;
  the same skin test.
* ops/pair_force.py: the ten stencil evaluators and ewald, each in the
  modes none, shift and xplor (one pair's r_on past its r_cut: the
  fallback), on one list: forces, energies and virials within 2e-6
  relative plus 4e-6 of the largest sum of the terms' magnitudes over a
  particle's list (float32 round-off of sums whose terms cancel; the
  K-axis sums may add in another order).
* trajectories through both packages' job-script API, the port under
  HOOMD_TPU_FAST=off, the JAX package on its default CPU engine (the
  general one), compared by tag every few steps: NVE on a 3-type mixture
  whose first list is sized to overflow mid-run (the port's chunk reruns
  from its start, with grown capacity), Langevin on a sub-group beside
  NVE on the rest (the same noise bits), and NVT on Kremer-Grest chains
  (FENE bonds, harmonic angles, bond exclusions).
* the run loop's schedule: analyzers with a fixed period and phase and
  with a variable period fire at the same steps in both packages.
"""

import functools

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop, rng as trng
from hoomd_tpu_torch.box import Box as TBox
from hoomd_tpu_torch.ops import cells as tcells
from hoomd_tpu_torch.ops import neighbor as tnb
from hoomd_tpu_torch.ops import pair_eval as tpe
from hoomd_tpu_torch.ops.pair_force import pair_force_nlist as t_pair_force

from test_torch_bonded import _kg_script
from test_torch_evaluators import COEFFS

torch.set_num_threads(1)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def test_threefry_streams_match_jax():
    import jax
    import jax.numpy as jnp
    from hoomd_tpu import rng as jrng
    tag = np.random.RandomState(0).permutation(777).astype(np.int32)
    for seed, ts, salt in ((0, 0, 0), (42, 1234, 4097), (2 ** 31 - 1, 10 ** 6,
                                                          5)):
        kj = jrng.step_key(seed, ts, salt=salt)
        kt = trng.step_key(seed, ts, salt=salt)
        assert tuple(int(x) for x in jax.random.key_data(kj)) == kt
        uj = np.asarray(jrng.uniform_by_tag(kj, jnp.asarray(tag), (3,),
                                            jnp.float32))
        ut = trng.uniform_by_tag(kt, torch.as_tensor(tag), (3,)).numpy()
        assert np.array_equal(uj.view(np.int32), ut.view(np.int32))
        uj = np.asarray(jax.random.uniform(kj, (7, 5), jnp.float32, 0.5, 2.0))
        ut = trng.uniform(kt, (7, 5), torch.float32, 0.5, 2.0).numpy()
        assert np.array_equal(uj.view(np.int32), ut.view(np.int32))
        nj = np.asarray(jrng.normal_by_tag(kj, jnp.asarray(tag), (3,),
                                           jnp.float32))
        nt = trng.normal_by_tag(kt, torch.as_tensor(tag), (3,)).numpy()
        ulps = np.abs(nj.view(np.int32).astype(np.int64)
                      - nt.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4, ulps.max()


# ---------------------------------------------------------------------------
# neighbour lists and the pair force on one fill


def _fill(n_side, L, dims=3, tilt=(0.0, 0.0, 0.0), ntypes=2, seed=1,
          jitter=0.15):
    rng = np.random.RandomState(seed)
    g = (np.arange(n_side) + 0.5) / n_side - 0.5
    nz = n_side if dims == 3 else 1
    gz = g if dims == 3 else np.zeros(1)
    f = np.stack(np.meshgrid(g, g, gz, indexing='ij'), -1).reshape(-1, 3)
    N = n_side * n_side * nz
    Lz = L if dims == 3 else 1.0
    f = f + rng.uniform(-jitter, jitter, f.shape) / n_side
    if dims == 2:
        f[:, 2] = 0.0
    xy, xz, yz = tilt
    pos = np.stack([f[:, 0] * L + f[:, 1] * xy * L + f[:, 2] * xz * Lz,
                    f[:, 1] * L + f[:, 2] * yz * Lz, f[:, 2] * Lz], -1)
    return dict(pos=pos.astype(np.float32),
                typeid=(np.arange(N) % ntypes).astype(np.int32),
                tag=rng.permutation(N).astype(np.int32),
                diameter=np.ones(N, np.float32),
                charge=rng.choice([-1.0, 1.0], N).astype(np.float32),
                box=(L, L, Lz, xy, xz, yz, dims))


def _boxes(box):
    from hoomd_tpu.box import Box as JBox
    L0, L1, L2, xy, xz, yz, dims = box
    return (JBox.create(L0, L1, L2, xy, xz, yz, dimensions=dims),
            TBox.create(L0, L1, L2, xy, xz, yz, dimensions=dims))


def _chain_exclusions(N, chain=5):
    """Each tag's bonded neighbours along chains of ``chain`` tags."""
    table = np.full((N, 2), N, np.int32)
    for t in range(N):
        nb = [u for u in (t - 1, t + 1) if 0 <= u < N and u // chain
              == t // chain]
        table[t, :len(nb)] = nb
    return table


def _build_both(d, rcut, r_buff, max_neigh, cell_cap, excl=None, reach=1,
                row_block=4096):
    """The same build through both packages: (jax out, torch out, jax box,
    torch box, cell grid)."""
    import jax
    import jax.numpy as jnp
    from hoomd_tpu.ops import cells as jcells
    from hoomd_tpu.ops.neighbor import build_neighbor_list as j_build
    jbox, tbox = _boxes(d['box'])
    rmax = (rcut + r_buff).astype(np.float32)
    dims = d['box'][6]
    cell_dim = jcells.choose_cell_dim(np.asarray(d['box'][:3]),
                                      float(rmax.max()) / reach, dims)
    rch = (reach, reach, reach if dims == 3 else 0)
    adj = jcells.build_cell_adj(cell_dim, rch)
    assert np.array_equal(adj, tcells.build_cell_adj(cell_dim, rch))
    # compiled whole: one compile per case instead of one per operation
    j = jax.jit(functools.partial(
        j_build, cell_dim=cell_dim, cell_cap=cell_cap, max_neigh=max_neigh,
        row_block=row_block))(
            jnp.asarray(d['pos']), jnp.asarray(d['typeid']),
            jnp.asarray(d['tag']), jnp.asarray(d['diameter']), jbox,
            cell_adj=jnp.asarray(adj), rmax_table=jnp.asarray(rmax),
            excl_tags=None if excl is None else jnp.asarray(excl))
    T = torch.as_tensor
    t = tnb.build_neighbor_list(
        T(d['pos']), T(d['typeid']), T(d['tag']), T(d['diameter']), tbox,
        cell_dim, cell_cap, T(adj, dtype=torch.long), T(rmax), max_neigh,
        excl_tags=None if excl is None else T(excl, dtype=torch.long),
        row_block=row_block)
    return j, t, jbox, tbox, cell_dim


def _same_lists(j, t, what):
    assert np.array_equal(np.asarray(j[0]), t[0].numpy()), what
    assert np.array_equal(np.asarray(j[1]), t[1].numpy()), what
    assert (bool(j[2]), bool(j[3])) == (bool(t[2]), bool(t[3])), what


RCUT2 = np.array([[2.0, 2.2], [2.2, 1.8]])


def test_neighbor_lists_match_jax():
    """Rows, order, counts and flags: a 2-type mixture with per-pair
    ranges and chain exclusions in a tilted box (and its stencil of reach
    2), a 2D box, and a fill overflowing both capacities; then the skin
    test, fresh and after a displacement across half the skin."""
    import jax.numpy as jnp
    from hoomd_tpu.ops import neighbor as jnb
    d = _fill(8, 11.0, tilt=(0.2, -0.1, 0.05))
    excl = _chain_exclusions(len(d['pos']))
    for reach, row_block in ((1, 4096), (2, 200)):
        j, t, jbox, tbox, _ = _build_both(d, RCUT2, 0.4, 96, 24, excl,
                                          reach=reach, row_block=row_block)
        _same_lists(j, t, f'tilted mixture, reach {reach}')
        assert not bool(t[2]) and not bool(t[3])
        assert int(t[1].max()) > 20
    d2 = _fill(14, 16.0, dims=2)
    j, t, *_ = _build_both(d2, RCUT2, 0.4, 48, 16)
    _same_lists(j, t, '2D box')
    assert not bool(t[2])
    j, t, *_ = _build_both(d, RCUT2, 0.4, 12, 3, excl)
    _same_lists(j, t, 'overflowing capacities')
    assert bool(t[2]) and bool(t[3])
    # the skin test in the tilted box
    N = len(d['pos'])
    jfresh = jnb.fresh_neighbor_list(N, 96, jnp.float32)
    tfresh = tnb.fresh_neighbor_list(N, 96, torch.float32, 'cpu')
    assert bool(jnb.needs_rebuild(jnp.asarray(d['pos']), jbox, jfresh, 0.4,
                                  2.6))
    assert bool(tnb.needs_rebuild(torch.as_tensor(d['pos']), tbox, tfresh,
                                  0.4, 2.6))
    for shift in (0.19, 0.21):
        moved = d['pos'].copy()
        moved[5] += np.float32(shift)
        jl = jfresh.replace(ref_pos=jnp.asarray(d['pos']), ref_box_L=jbox.L,
                            ref_box_tilt=jbox.tilt)
        tl = tfresh.replace(ref_pos=torch.as_tensor(d['pos']),
                            ref_box_L=tbox.L, ref_box_tilt=tbox.tilt)
        want = bool(jnb.needs_rebuild(jnp.asarray(moved), jbox, jl, 0.4))
        got = bool(tnb.needs_rebuild(torch.as_tensor(moved), tbox, tl, 0.4))
        assert got == want == (shift * np.sqrt(3) > 0.2), shift


def _term_scales(d, nbr, tbox, name, der, mode):
    """The largest sum over a particle's list of |f_ij| |r_ij|, |e_ij| and
    |f_ij| r_ij^2: the magnitudes whose float32 round-off the force, PE
    and virial sums carry."""
    T = torch.as_tensor
    pos = T(d['pos'])
    N = len(pos)
    nb = T(nbr, dtype=torch.long)
    valid = nb < N
    j = nb.clamp(max=N - 1)
    dr = tbox.min_image(pos[:, None] - pos[j])
    r2 = (dr * dr).sum(-1)
    t = T(d['typeid']).long()
    ti, tj = t[:, None], t[j]
    p = {k: T(v)[ti, tj] for k, v in der.items()}
    p['rcut'] = T(RCUT2, dtype=torch.float32)[ti, tj]
    p['qiqj'] = T(d['charge'])[:, None] * T(d['charge'])[j]
    valid &= r2 < p['rcut'] ** 2
    f, e = tpe.ALL_EVALUATORS[name].energy_force(torch.where(valid, r2, 1.0),
                                                 p)
    f = torch.where(valid, f.abs(), 0.0)
    e = torch.where(valid, e.abs(), 0.0)
    if mode != 'none':
        # the shift and the smoothing factor are bounded by the energy at
        # r_cut and its slope: take the energy's term scale for both
        e = e + torch.where(valid, f * r2, 0.0)
    return (float((f * r2.sqrt()).sum(1).max()), float(e.sum(1).max()),
            float((f * r2).sum(1).max()))


def test_pair_force_nlist_matches_jax():
    """Every evaluator the general engine runs, in the three modes, on one
    2-type list with per-pair r_cut and r_on."""
    import jax.numpy as jnp
    from hoomd_tpu.ops import pair_eval as jpe
    from hoomd_tpu.ops.pair_force import pair_force_nlist as j_pair_force
    d = _fill(7, 9.8, tilt=(0.1, 0.0, 0.0), jitter=0.1)
    j, t, jbox, tbox, _ = _build_both(d, RCUT2, 0.3, 96, 24)
    nbr = np.array(j[0])
    # r_on: inside r_cut for AA and BB, past it for AB (plain shifting)
    ron = np.array([[1.6, 2.5], [2.5, 1.5]], np.float32)
    coeffs = dict(COEFFS, ewald=dict(kappa=1.1))
    cases = 0
    for name in tpe.GENERAL_EVALS:
        raw = {}
        for k in tpe.ALL_EVALUATORS[name].coeff_names:
            v = coeffs[name].get(k, tpe.ALL_EVALUATORS[name].defaults.get(k))
            raw[k] = np.full((2, 2), v, np.float32)
        if 'epsilon' in raw:
            raw['epsilon'][0, 1] = raw['epsilon'][1, 0] = 1.3
        der = {k: np.asarray(v, np.float32)
               for k, v in tpe.ALL_EVALUATORS[name].derive(raw).items()}
        for mode in ('none', 'shift', 'xplor'):
            jo = j_pair_force(
                jnp.asarray(d['pos']), jnp.asarray(d['typeid']),
                jnp.asarray(d['charge']), jnp.asarray(d['diameter']),
                jnp.asarray(nbr), jbox, jpe.ALL_EVALUATORS[name],
                {k: jnp.asarray(v) for k, v in der.items()},
                jnp.asarray(RCUT2, jnp.float32), jnp.asarray(ron), mode)
            T = torch.as_tensor
            to = t_pair_force(
                T(d['pos']), T(d['typeid']), T(d['charge']),
                T(d['diameter']), T(nbr, dtype=torch.long), tbox,
                tpe.ALL_EVALUATORS[name], {k: T(v) for k, v in der.items()},
                T(RCUT2, dtype=torch.float32), T(ron), mode)
            scales = _term_scales(d, nbr, tbox, name, der, mode)
            for a, b, what, scale in zip(jo, to, ('force', 'pe', 'virial'),
                                         scales):
                a, b = np.asarray(a), b.numpy()
                assert np.abs(a).max() > 0, (name, mode, what)
                np.testing.assert_allclose(
                    b, a, rtol=2e-6, atol=4e-6 * scale,
                    err_msg=f'{name} {mode} {what}')
            cases += 1
    assert cases == 33


# ---------------------------------------------------------------------------
# trajectories through the job-script API


def _lattice_snapshot(h, n_side, a, types, seed, v_sigma=1.0):
    N = n_side ** 3
    snap = h.data.make_snapshot(N, h.data.boxdim(L=n_side * a),
                                particle_types=list(types))
    g = (np.arange(n_side) + 0.5) * a - n_side * a / 2
    rng = np.random.RandomState(seed)
    snap.particles.position[:] = np.stack(
        np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3) \
        + rng.uniform(-0.05, 0.05, (N, 3))
    snap.particles.typeid[:] = np.arange(N) % len(types)
    v = rng.normal(0, v_sigma, (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    return snap


def _mixture_script(h, snap):
    h.init.read_snapshot(snap)
    nl = h.md.nlist.cell(r_buff=0.4)
    lj = h.md.pair.lj(r_cut=2.5, nlist=nl)
    types = ['A', 'B', 'C']
    lj.pair_coeff.set(types, types, epsilon=1.0, sigma=1.0)
    lj.pair_coeff.set('A', 'B', epsilon=1.5, sigma=0.8, r_cut=2.0)
    lj.pair_coeff.set('C', 'C', epsilon=0.5, sigma=0.9, r_cut=2.2)
    lj.set_params(mode='shift')
    h.md.integrate.mode_standard(dt=0.004)
    h.md.integrate.nve(group=h.group.all())
    return h.context.current.system


def _subgroup_script(h, snap):
    h.init.read_snapshot(snap)
    lj = h.md.pair.lj(r_cut=2.5, nlist=h.md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    h.md.integrate.mode_standard(dt=0.005)
    N = snap.particles.N
    lan = h.md.integrate.langevin(group=h.group.tags(0, N // 2 - 1),
                                  kT=1.5, seed=11)
    lan.set_gamma('A', 2.0)
    h.md.integrate.nve(group=h.group.tags(N // 2, N - 1))
    return h.context.current.system


def _undersize_first_list(monkeypatch, system):
    """Size the port's first neighbour list to the start's largest count,
    so that the melt overflows it mid-run; the grown list is the
    engine's own."""
    nl = system.nlists[0]
    build, calls = type(nl)._build_config, [0]

    def first_small(self, sys_, grow=None):
        cfg = build(self, sys_, grow)
        calls[0] += 1
        if calls[0] == 1:
            st = sys_.state
            dr = st.box.min_image(st.pos[:, None] - st.pos[None])
            t = st.typeid.long()
            rm = cfg.rmax_table[t[:, None], t[None]]
            n = ((dr * dr).sum(-1) <= rm * rm).sum(1) - 1
            cfg.max_neigh = int(n.max())
        return cfg
    monkeypatch.setattr(type(nl), '_build_config', first_small)
    return calls


def _compare(js, ts, what, pos_tol, vel_tol):
    a = js.take_snapshot().particles
    b = ts.take_snapshot().particles
    np.testing.assert_allclose(b.position, a.position, rtol=0, atol=pos_tol,
                               err_msg=what)
    np.testing.assert_allclose(b.velocity, a.velocity, rtol=0, atol=vel_tol,
                               err_msg=what)
    assert np.array_equal(b.image, a.image), what
    qa, qb = js.thermo_quantities(), ts.thermo_quantities()
    for k in ('potential_energy', 'kinetic_energy', 'pressure'):
        assert abs(qb[k] - qa[k]) <= 1e-5 * max(1.0, abs(qa[k])), (what, k)


@pytest.mark.parametrize('case', ['nve_mixture_overflow', 'langevin_subgroup',
                                  'nvt_kg_bonds'])
def test_general_trajectories_match_jax(torch_ctx, monkeypatch, case):
    """Position within 2e-5 and velocity within 2e-4 of the JAX package's
    by tag after each chunk (float32 round-off grown over the steps), the
    same images, PE, KE and pressure within 1e-5 relative."""
    import hoomd_tpu as jh
    monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    if case == 'nvt_kg_bonds':
        js = _kg_script(jh, 'nvt')
        th.context.initialize('--mode=cpu --notice-level=0')
        ts = _kg_script(th, 'nvt')
        chunks = (10, 10, 10)
    else:
        snap = _lattice_snapshot(jh, 6, 1.09, 'ABC' if 'mixture' in case
                                 else 'A', seed=3, v_sigma=1.3)
        script = (_mixture_script if 'mixture' in case else _subgroup_script)
        js = script(jh, snap)
        ts = script(th, interop.snapshot_from_numpy(snap))
        chunks = (8, 8, 8) if 'mixture' in case else (1, 1, 10, 12)
    calls = (_undersize_first_list(monkeypatch, ts)
             if 'overflow' in case else None)
    for i, n in enumerate(chunks):
        js.run(n, quiet=True)
        ts.run(n, quiet=True)
        assert ts._program['fast'] is None
        _compare(js, ts, f'{case} after chunk {i}', 2e-5, 2e-4)
    if calls is not None:
        # the list overflowed during the first chunk, grew and reran it
        assert calls[0] >= 2
        assert ts._grow[ts.nlists[0]]['max_neigh'] > 0
    if case == 'langevin_subgroup':
        N = js.state.N
        for tags in (np.arange(N // 2), np.arange(N // 2, N)):
            qa = jh.compute.thermo(jh.group.tag_list('g', tags))
            qb = th.compute.thermo(th.group.tag_list('g', tags))
            assert abs(qb.temperature - qa.temperature) <= 1e-5 * \
                qa.temperature
            assert abs(qb.potential_energy - qa.potential_energy) <= \
                1e-5 * abs(qa.potential_energy)
    if case == 'nvt_kg_bonds':
        xa = js._method_aux_by_obj[js.methods[0]]
        xb = ts._method_aux_by_obj[ts.methods[0]]
        for k in ('xi', 'eta'):
            assert abs(float(xb[k]) - float(xa[k])) <= 1e-5, k
        assert int(ts._nl_data[0].n_rebuilds) > 0


def test_analyzers_fire_on_the_same_steps(torch_ctx, monkeypatch):
    """Fixed period with a phase, a variable period, an updater and the
    run's own callback: both packages' run loops fire them at the same
    steps, over runs that start anywhere in the schedule."""
    import importlib
    import hoomd_tpu as jh
    monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    fired = {}
    for h in (jh, th):
        if h is th:
            th.context.initialize('--mode=cpu --notice-level=0')
        snap = _lattice_snapshot(jh, 3, 1.5, 'A', seed=2)
        if h is th:
            snap = interop.snapshot_from_numpy(snap)
        _subgroup_script(h, snap)
        log = fired.setdefault(h.__name__, [])
        h.analyze.callback(lambda ts: log.append(('fixed', ts)), period=7,
                           phase=3)
        h.analyze.callback(lambda ts: log.append(('var', ts)),
                           period=lambda n: n * n + 1)
        updater = importlib.import_module(h.__name__ + '.operation').Updater

        class Tick(updater):
            def update(self, system, ts, log=log):
                log.append(('update', ts))
        h.context.current.system.register_updater(Tick(period=11, phase=2))
        for n in (5, 13, 1, 30):
            h.run(n, quiet=True, callback_period=4,
                  callback=lambda ts: log.append(('run', ts)))
        assert h.get_step() == 49
    assert fired['hoomd_tpu_torch'] == fired['hoomd_tpu']
    assert ('var', 17) in fired['hoomd_tpu']
    assert ('update', 13) in fired['hoomd_tpu']
