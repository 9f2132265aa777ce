"""hoomd_tpu_torch HPMC around the sweep kernels, against the JAX package.

Binning slot for slot, the fused plan (cell_dim, C) against hoomd_tpu's
_build_program, the separating-axis count_overlaps against hoomd_tpu's,
the quaternion helpers, the orientation round trip through snapshots,
the gates, the cell-overflow retry, and the sphere job script sweep by
sweep against the JAX System on its fused path (HOOMD_TPU_HPMC_FUSED=on,
interpret mode) with the JAX package's draws handed to the port.

Tolerances: binning, plans, overlap counts and accept/try counters
exactly; positions to 1e-5 absolute (the two sides differ in the last
ulp of log/sin/cos/exp/rsqrt); quaternion algebra to 1e-6.
"""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.hpmc import integrate as tint
from hoomd_tpu_torch.ops import cells as tcells
from hoomd_tpu_torch.ops import quat as tq

from test_torch_hpmc_sweep import CUBE, _cube_job, hand_jax_draws

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

POS_TOL = 1e-5


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv('HOOMD_TPU_HPMC_FUSED', 'on')


# ---------------------------------------------------------------------------
# binning


@pytest.mark.parametrize('cell_dim,cap,n,seed', [
    ((4, 5, 6), 16, 300, 0),       # room to spare
    ((4, 4, 4), 6, 400, 1),        # overflows: the dropped entries agree
    ((10, 10, 10), 13, 4096, 2),   # config 5's grid
])
def test_bin_particles_matches_jax(cell_dim, cap, n, seed):
    import jax
    from hoomd_tpu.box import Box as JBox
    from hoomd_tpu.ops import cells as jcells
    rng = np.random.RandomState(seed)
    L = np.asarray(cell_dim) * 1.7
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    # a quarter of them exactly on cell faces
    pos[::4] = ((np.floor(pos[::4] / 1.7) * 1.7)).astype(np.float32)
    jcid, jcl, jovf = jax.jit(jcells.bin_particles, static_argnums=(2, 3))(
        pos, JBox.create(*L), cell_dim, cap)
    tcid, tcl, tovf = tcells.bin_particles(torch.as_tensor(pos),
                                           th.box.Box.create(*L), cell_dim,
                                           cap)
    assert np.array_equal(tcid.numpy(), np.asarray(jcid))
    assert np.array_equal(tcl.numpy(), np.asarray(jcl))
    assert bool(tovf) == bool(jovf)
    if cap != 13:
        assert bool(jovf) == (cap == 6)


# ---------------------------------------------------------------------------
# the fused plan


def _jax_fused_plan(jsys, jmc, monkeypatch):
    """cell_dim and C of hoomd_tpu's fused path: trace one sweep of its
    program with the sweep kernels replaced by recorders."""
    import jax.numpy as jnp
    from hoomd_tpu.hpmc import pallas_sweep
    seen = {}

    def poly(*args, cell_dim, C, **kw):
        seen.update(cell_dim=cell_dim, C=C)
        return tuple(args[:7]) + (jnp.zeros((4,), jnp.int32),)

    def sphere(px, py, pz, *args, cell_dim, C, **kw):
        seen.update(cell_dim=cell_dim, C=C)
        z = jnp.zeros((), jnp.int32)
        return px, py, pz, z, z
    monkeypatch.setattr(pallas_sweep, 'fused_poly_sweep', poly)
    monkeypatch.setattr(pallas_sweep, 'fused_sphere_sweep', sphere)
    prog = jmc._build_program(jsys)
    assert prog['fused']
    prog['run_chunk_raw'](jsys.state, prog['init_counters'](),
                          prog['pack_hdyn'](), 1)
    return seen['cell_dim'], seen['C']


PLAN_CASES = {
    'config5_cubes': ('cube', 16, 1.3572088082974532, 0.15),
    'sphere_job': ('sphere', 16, 1.05, 0.12),
    'small_spheres_capped': ('sphere', 12, 3.2, 0.3),
    'cubes_large_d': ('cube', 7, 1.6, 0.4),
}


def _plan_job(hoomd, kind, n, a, d, snap=None):
    if snap is None:
        hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=a), n=n)
    else:
        hoomd.init.read_snapshot(snap)
    if kind == 'cube':
        mc = hoomd.hpmc.integrate.convex_polyhedron(seed=1, d=d, a=0.2)
        mc.shape_param.set('A', vertices=CUBE)
    else:
        mc = hoomd.hpmc.integrate.sphere(seed=1, d=d)
        # small diameters give a grid past 32 cells per axis
        mc.shape_param.set('A', diameter=0.25 if a > 3 else 1.0)
    return hoomd.context.current.system, mc


@pytest.mark.parametrize('case', list(PLAN_CASES))
def test_fused_plan_matches_jax(case, torch_ctx, fused_env, monkeypatch):
    import hoomd_tpu as jh
    jsys, jmc = _plan_job(jh, *PLAN_CASES[case])
    want = _jax_fused_plan(jsys, jmc, monkeypatch)
    tsys, tmc = _plan_job(th, *PLAN_CASES[case],
                          snap=interop.snapshot_from_numpy(
                              jsys.take_snapshot()))
    plan = tmc._plan(tsys)
    assert (plan['cell_dim'], plan['C']) == want
    if case == 'config5_cubes':
        assert want == ((10, 10, 10), 13)
    if case == 'small_spheres_capped':
        assert max(want[0]) == 32


# ---------------------------------------------------------------------------
# count_overlaps


def _cube_config(kind, seed):
    """Cube positions and orientations: a rotated lattice with room to
    spare, a tight lattice with large rotations, or a random dense fill."""
    rng = np.random.RandomState(seed)
    n, L = 5, 7.0
    if kind == 'random':
        pos = rng.uniform(-L / 2, L / 2, (n ** 3, 3))
        ang = rng.uniform(-np.pi, np.pi, n ** 3)
    else:
        a = 1.4 if kind == 'valid' else 1.1
        L = n * a
        g = (np.arange(n) + 0.5) * a - L / 2
        pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
        ang = rng.uniform(-0.3, 0.3, n ** 3) if kind == 'valid' else \
            rng.uniform(-1.5, 1.5, n ** 3)
    axis = rng.normal(size=pos.shape)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    quat = np.concatenate([np.cos(ang / 2)[:, None],
                           np.sin(ang / 2)[:, None] * axis], 1)
    return pos, quat, L


@pytest.mark.parametrize('kind', ['valid', 'tight', 'random'])
def test_cube_count_overlaps_matches_jax(kind, torch_ctx):
    import hoomd_tpu as jh
    pos, quat, L = _cube_config(kind, 4)
    snap = jh.data.make_snapshot(len(pos), jh.data.boxdim(L=L))
    snap.particles.position[:] = pos
    snap.particles.orientation[:] = quat
    jh.init.read_snapshot(snap)
    jmc = jh.hpmc.integrate.convex_polyhedron(seed=1, d=0.1, a=0.1)
    jmc.shape_param.set('A', vertices=CUBE)
    want = jmc.count_overlaps()
    th.init.read_snapshot(interop.snapshot_from_numpy(snap))
    tmc = th.hpmc.integrate.convex_polyhedron(seed=1, d=0.1, a=0.1)
    tmc.shape_param.set('A', vertices=CUBE)
    assert tmc.count_overlaps() == want
    assert (want == 0) == (kind == 'valid')


def test_sphere_count_overlaps_matches_jax(torch_ctx):
    import hoomd_tpu as jh
    rng = np.random.RandomState(5)
    n, L = 200, 7.0
    snap = jh.data.make_snapshot(n, jh.data.boxdim(L=L),
                                 particle_types=['A', 'B'])
    snap.particles.position[:] = rng.uniform(-L / 2, L / 2, (n, 3))
    snap.particles.typeid[:] = np.arange(n) % 2
    jh.init.read_snapshot(snap)
    jmc = jh.hpmc.integrate.sphere(seed=1)
    jmc.shape_param.set('A', diameter=1.0)
    jmc.shape_param.set('B', diameter=0.5)
    th.init.read_snapshot(interop.snapshot_from_numpy(snap))
    tmc = th.hpmc.integrate.sphere(seed=1)
    tmc.shape_param.set('A', diameter=1.0)
    tmc.shape_param.set('B', diameter=0.5)
    want = jmc.count_overlaps()
    assert want > 0 and tmc.count_overlaps() == want
    # disabled pairs do not count
    jmc.overlap_checks.set('A', 'A', False)
    tmc.overlap_checks.set('A', 'A', False)
    want2 = jmc.count_overlaps()
    assert want2 < want and tmc.count_overlaps() == want2


# ---------------------------------------------------------------------------
# quaternions and orientations


def test_quat_helpers_match_jax():
    import jax.numpy as jnp
    from hoomd_tpu.ops import quat as jq
    rng = np.random.RandomState(6)
    a = rng.normal(size=(50, 4)).astype(np.float32)
    b = rng.normal(size=(50, 4)).astype(np.float32)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    ta, tb, tv = (torch.as_tensor(x) for x in (a, b, v))
    ja, jb, jv = (jnp.asarray(x) for x in (a, b, v))
    pairs = [(tq.multiply(ta, tb), jq.multiply(ja, jb)),
             (tq.conjugate(ta), jq.conjugate(ja)),
             (tq.normalize(ta), jq.normalize(ja)),
             (tq.rotate(tq.normalize(ta), tv),
              jq.rotate(jq.normalize(ja), jv))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_orientation_round_trip(torch_ctx):
    rng = np.random.RandomState(7)
    th.init.create_lattice(unitcell=th.lattice.sc(a=1.5), n=3)
    system = th.context.current.system
    snap = system.take_snapshot()
    assert np.array_equal(snap.particles.orientation,
                          np.tile([1.0, 0, 0, 0], (27, 1)))
    q = rng.normal(size=(27, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.orientation[:] = q
    system.restore_snapshot(snap)
    np.testing.assert_allclose(system.state.orientation.numpy(), q,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(system.take_snapshot().particles.orientation,
                               q, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# gates


def _snap(n=64, L=6.0, types=('A',), dims=3, tilt=0.0):
    snap = th.data.make_snapshot(n, th.data.boxdim(L=L, xy=tilt,
                                                   dimensions=dims),
                                 particle_types=list(types))
    g = (np.arange(4) + 0.5) * (L / 4) - L / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    if dims == 2:
        pos[:, 2] = 0.0
    snap.particles.position[:] = pos[:n]
    snap.particles.typeid[:] = np.arange(n) % len(types)
    return snap


def _gate_sphere(**snap_kw):
    th.init.read_snapshot(_snap(**snap_kw))
    mc = th.hpmc.integrate.sphere(seed=1, d=0.1)
    for t in th.context.current.system.particle_types:
        mc.shape_param.set(t, diameter=1.0)
    return mc


def _gate_cubes(verts, types=('A',)):
    th.init.read_snapshot(_snap(types=types))
    mc = th.hpmc.integrate.convex_polyhedron(seed=1, d=0.1, a=0.1)
    for t in types:
        mc.shape_param.set(t, vertices=verts)
    return mc


def _prism(k):
    ang = 2 * np.pi * np.arange(k) / k
    ring = np.stack([0.5 * np.cos(ang), 0.5 * np.sin(ang)], 1)
    return np.concatenate([np.c_[ring, np.full(k, -0.3)],
                           np.c_[ring, np.full(k, 0.3)]])


def _implicit():
    th.init.read_snapshot(_snap())
    mc = th.hpmc.integrate.sphere(seed=1, d=0.1, implicit=True)
    mc.shape_param.set('A', diameter=1.0)
    mc.set_params(nR=0.5, depletant_type='A')
    return mc


def _disabled_pair():
    mc = _gate_sphere(types=('A', 'B'))
    mc.overlap_checks.set('A', 'B', False)
    return mc


def _nselect0():
    mc = _gate_sphere()
    mc.set_params(nselect=0)
    return mc


GATES = {
    '2D box': lambda: _gate_sphere(dims=2),
    'implicit depletants': _implicit,
    'tilted box': lambda: _gate_sphere(tilt=0.2),
    'too small for 2 fused cells': lambda: _gate_sphere(L=2.0, n=8),
    'overlap_checks disables a type pair': _disabled_pair,
    'nselect=0': _nselect0,
    'convex_polyhedron with 2 types': lambda: _gate_cubes(CUBE, ('A', 'B')),
    'hull with V=16 F=5 E=5': lambda: _gate_cubes(_prism(8)),
}


@pytest.mark.parametrize('gate', list(GATES))
def test_gate_raises_by_name(gate, torch_ctx):
    GATES[gate]()
    with pytest.raises(NotImplementedError, match=gate.replace('(', r'\(')):
        th.run(1, quiet=True)


@pytest.mark.parametrize('shape', ['ellipsoid', 'sphere_union', 'sphinx',
                                   'convex_spheropolyhedron', 'polyhedron'])
def test_other_shapes_raise_by_name(shape, torch_ctx):
    th.init.read_snapshot(_snap())
    with pytest.raises(NotImplementedError, match=f'integrate.{shape}'):
        getattr(th.hpmc.integrate, shape)(seed=1)


# ---------------------------------------------------------------------------
# the job script: the cell-overflow retry and sweep-by-sweep parity


def _sphere_job(hoomd, n=6, snap=None):
    if snap is None:
        hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=1.05), n=n)
    else:
        hoomd.init.read_snapshot(snap)
    mc = hoomd.hpmc.integrate.sphere(seed=7, d=0.12)
    mc.shape_param.set('A', diameter=1.0)
    return hoomd.context.current.system, mc


def test_cell_overflow_retry_repeats_the_chunk(torch_ctx, monkeypatch):
    """A first plan with C = 2 overflows (3.4 particles per cell): the
    capacity grows to int(1.5 * 2) + 4 and the chunk reruns from its
    start, with the counters from before it, so the result equals a run
    that never overflowed."""
    clean_sys, clean_mc = _sphere_job(th)
    clean_sys.run(1, quiet=True)
    clean_mc.set_params(nselect=4)    # a rebuild, which zeroes the counters
    clean_sys.run(2, quiet=True)
    want_pos = clean_sys.take_snapshot().particles.position
    want_cnt = clean_mc.get_counters()

    th.context.initialize('--mode=cpu --notice-level=0')
    real = tint.mode_hpmc._plan
    calls = []

    def plan(self, system):
        p = real(self, system)
        calls.append(p['C'])
        if len(calls) == 2:
            p['C'] = 2
        return p
    monkeypatch.setattr(tint.mode_hpmc, '_plan', plan)
    system, mc = _sphere_job(th)
    system.run(1, quiet=True)
    mc.set_params(nselect=4)          # a rebuild: its plan undersizes C
    system.run(2, quiet=True)
    assert system._grow['hpmc_cell_cap'] == 7 and len(calls) == 3
    assert system._program['C'] == 11
    np.testing.assert_array_equal(system.take_snapshot().particles.position,
                                  want_pos)
    assert mc.get_counters() == want_cnt


def test_sphere_job_matches_jax_sweep_by_sweep(torch_ctx, fused_env,
                                               monkeypatch):
    import hoomd_tpu as jh
    jsys, jmc = _sphere_job(jh)
    # the port keeps particles in tag order; the JAX package's default
    # space-filling-curve sorter would reorder them, and the slot order
    # within a cell (hence the mover a draw picks) with them
    jh.context.current.sorter.disable()
    tsys, tmc = _sphere_job(th, snap=interop.snapshot_from_numpy(
        jsys.take_snapshot()))
    hand_jax_draws(monkeypatch)
    for step in range(6):
        jsys.run(1, quiet=True)
        tsys.run(1, quiet=True)
        assert jsys._program['fused']
        assert tsys.timestep == jsys.timestep == step + 1
        np.testing.assert_allclose(
            tsys.take_snapshot().particles.position,
            jsys.take_snapshot().particles.position, rtol=0, atol=POS_TOL,
            err_msg=f'sweep {step}')
        jc, tc = jmc.get_counters(), tmc.get_counters()
        for k in ('translate_accept', 'translate_reject'):
            assert tc[k] == jc[k], (step, k)
    assert 0 < tc['translate_accept'] < tc['translate_reject'] + \
        tc['translate_accept']
    assert tmc.count_overlaps() == 0 == jmc.count_overlaps()


def job_acceptance(hoomd, kind, n=16):
    """Translate and rotate acceptance of a chip_smoke.py job script
    (kind 'cube': BASELINE.json config 5; 'sphere': spheres at a = 1.05,
    sphere(seed=7, d=0.12)) at n^3 particles through ``hoomd`` (either
    package, in a fresh context): 50 settle then 200 measured sweeps.
    hoomd_tpu takes its fused path with HOOMD_TPU_HPMC_FUSED=on
    (interpret mode on the CPU), its gather path with =off."""
    system, mc = (_sphere_job if kind == 'sphere' else _cube_job)(hoomd,
                                                                  n=n)
    system.run(50, quiet=True)
    c0 = mc.get_counters()
    system.run(200, quiet=True)
    c1 = mc.get_counters()
    acc = []
    for m in ('translate', 'rotate'):
        a = c1[f'{m}_accept'] - c0[f'{m}_accept']
        acc.append(a / max(1, a + c1[f'{m}_reject'] - c0[f'{m}_reject']))
    return acc[0], acc[1]


def test_sphere_job_acceptance_reference(fused_env):
    """The translate acceptance chip_smoke.py holds the port's sphere job
    to is the JAX package's own for that script, on its fused path.  (The
    cube job's takes ~13 minutes in interpret mode here: derive it with
    ``PYTHONPATH=. python tests/test_torch_hpmc.py cube``.)"""
    import hoomd_tpu as jh
    from chip_smoke import SPHERE_TRANSLATE_ACC
    t_acc, _ = job_acceptance(jh, 'sphere')
    assert jh.context.current.system._program['fused']
    assert abs(t_acc - SPHERE_TRANSLATE_ACC) < 0.01


if __name__ == '__main__':
    # from the repo root: PYTHONPATH=. python tests/test_torch_hpmc.py
    # {cube|sphere} [n] [on|off|port] prints the acceptances of a
    # chip_smoke.py job script through the JAX package's fused (on) or
    # gather (off) path, or through the port's plain path on the CPU
    import os
    import sys
    args = sys.argv[1:]
    kind = args[0] if args else 'cube'
    n = int(args[1]) if len(args) > 1 else 16
    path = args[2] if len(args) > 2 else 'on'
    if path == 'port':
        th.context.initialize('--mode=cpu --notice-level=0')
        pkg = th
    else:
        os.environ['JAX_PLATFORMS'] = 'cpu'
        os.environ['HOOMD_TPU_HPMC_FUSED'] = path
        import hoomd_tpu as pkg
        pkg.context.initialize('--notice-level=0')
    t, r = job_acceptance(pkg, kind, n)
    print(f"{pkg.__name__} {kind} job n={n} path={path}: translate "
          f"acceptance {t:.4f}, rotate acceptance {r:.4f}")
