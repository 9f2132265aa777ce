"""The slice end to end: one job script through both packages.

A shifted-LJ liquid of 343 particles runs a Langevin melt and then
Nose-Hoover NVT (a dt change in between) through the job-script API of
hoomd_tpu (fast engine in Pallas interpret mode, impl 'plane', as
tests/test_mega_langevin_chain.py runs it) and of hoomd_tpu_torch on
--mode=cpu, from identical inputs.  The first program build of each
package is forced to overflow its cell capacity (a patched planner hands
out a grid that holds too few slots) and its first segment to cross the
Verlet skin (the rebuild cadence starts at 8 windows), so both retry
paths run.  The NVT run length leaves single steps after the k-step
windows, so the per-step path (one_step, cell_pair_plane) runs too.
Per-tag positions and velocities agree to 1e-4,
thermo_quantities to rel 1e-4, and the timesteps are equal."""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

N_SIDE = 7
A = 1.3


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _undersized_planner(module, monkeypatch):
    """First call: a 3x3x3 grid with C = 16, which the 7^3 lattice
    overflows (up to 27 per cell); later calls plan as usual."""
    real = module.plan_fast_lj
    calls = []

    def plan(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return (3, 3, 3), 27, 16
        return real(*args, **kwargs)
    monkeypatch.setattr(module, 'plan_fast_lj', plan)
    return calls


def _start_snapshot(vscale=1.0):
    import hoomd_tpu as jh
    jh.context.initialize('--notice-level=0')
    jh.init.create_lattice(unitcell=jh.lattice.sc(a=A), n=N_SIDE)
    snap = jh.context.current.system.take_snapshot()
    rng = np.random.RandomState(11)
    n = snap.particles.N
    snap.particles.position[:] += rng.uniform(-0.1, 0.1, (n, 3))
    v = rng.normal(0, vscale, (n, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    jh.context.current = None
    return snap


def _job(hoomd, snap, system_hook):
    """The job script, as a user writes it for either package."""
    md = hoomd.md
    hoomd.init.read_snapshot(snap)
    system = hoomd.context.current.system
    nl = md.nlist.cell(r_buff=0.4)
    lj = md.pair.lj(r_cut=2.5, nlist=nl)
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    mode = md.integrate.mode_standard(dt=0.005)
    lan = md.integrate.langevin(group=hoomd.group.all(), kT=1.0, seed=5)
    system_hook(system)
    hoomd.run(24, quiet=True)
    after_melt = dict(system._grow)
    lan.disable()
    mode.set_params(dt=0.0035)
    md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.5)
    hoomd.run(17, quiet=True)
    return system, after_melt


def _force_retries(system):
    # an 8-window (32-step) rebuild cadence: the 24-step melt crosses
    # the skin before its first rebuild, and the backoff retries it
    system._grow['fast_m'] = 8


def test_job_script_matches_jax(torch_ctx, monkeypatch):
    import hoomd_tpu as jh
    import hoomd_tpu.ops.fast_lj as jfl
    import hoomd_tpu_torch.ops.fast_lj as tfl
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'plane')
    snap = _start_snapshot()

    jcalls = _undersized_planner(jfl, monkeypatch)
    jh.context.initialize('--notice-level=0')
    js, jgrow = _job(jh, snap, _force_retries)
    tcalls = _undersized_planner(tfl, monkeypatch)
    ts, tgrow = _job(th, interop.snapshot_from_numpy(snap), _force_retries)

    for s, grow in ((js, jgrow), (ts, tgrow)):
        assert s._program['fast'] is not None
        # both retry paths ran in the melt: the overflow replan and the
        # danger backoff (the dt change resets the cadence afterwards)
        assert grow.get('fast_plan_conservative')
        assert grow.get('fast_m_pinned') and grow['fast_m'] < 8
    assert len(jcalls) >= 2 and len(tcalls) >= 2
    assert js.timestep == ts.timestep == 41

    sj, st = js.take_snapshot(), ts.take_snapshot()
    for name in ('position', 'velocity'):
        np.testing.assert_allclose(getattr(st.particles, name),
                                   getattr(sj.particles, name), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert np.array_equal(st.particles.image, sj.particles.image)
    qj, qt = js.thermo_quantities(), ts.thermo_quantities()
    for key in ('temperature', 'kinetic_energy', 'potential_energy',
                'pressure', 'pressure_xx', 'pressure_yy', 'pressure_zz',
                'ndof', 'volume'):
        assert qt[key] == pytest.approx(qj[key], rel=1e-4, abs=1e-6), key


def test_gpu_mode_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for arg in ('--mode=gpu', '', '--mode auto'):
        with pytest.raises(RuntimeError, match='CUDA'):
            th.context.initialize(arg)
    th.context.current = None

