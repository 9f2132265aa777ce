"""The rebuild's rebin through both packages' job scripts.

(a) Gates: with HOOMD_TPU_REBIN unset, 'off' and 'pallas', at N = 343
    and N = 4096, hoomd_tpu (fast engine, impl 'plane', the configuration
    the port's engine is) and hoomd_tpu_torch pick the same rebin and
    emigrant-buffer width, without running.
(b) Trajectories: tests/test_torch_slice.py's 7^3 job, from a hotter
    start, with the rebin forced to the migration sweep + place ('pallas')
    and to the staged select ('xsel') in both packages'
    build_fast_lj_chunk.  The JAX side runs its Pallas kernels in
    interpret mode.  In the 'pallas' run the emigrant buffers start at
    E = 1, so a rebuild of the melt overflows them and both packages
    retry the segment with E = 16.
    Per-tag positions and velocities agree to 1e-4, images exactly,
    thermo_quantities to rel 1e-4.
(c) The port's xsel ladder with a forced failure: a strike sorts, xsel
    comes back after 8 clean segments, the fourth strike sorts for good,
    a lost particle strikes as a stage overflow does and is counted on
    its own, and a capacity overflow together with a rebin overflow burns
    no strike.
"""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from test_torch_slice import _job, _start_snapshot

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


@pytest.fixture
def jax_plane(monkeypatch):
    """The JAX package's fast engine with its 'plane' kernels, in Pallas
    interpret mode on the CPU."""
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'plane')


def _lattice(hoomd, n, a, seed=3):
    """An n^3 sc lattice, jittered, with small random velocities."""
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=a), n=n)
    system = hoomd.context.current.system
    snap = system.take_snapshot()
    rng = np.random.RandomState(seed)
    N = snap.particles.N
    snap.particles.position[:] += rng.uniform(-0.05, 0.05, (N, 3))
    v = rng.normal(0, 0.5, (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    system.restore_snapshot(snap)
    return system


def _lj_langevin(hoomd):
    md = hoomd.md
    lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.005)
    md.integrate.langevin(group=hoomd.group.all(), kT=1.0, seed=5)


# ---------------------------------------------------------------------------
# (a) the rebin gates


@pytest.mark.parametrize('env', [None, 'off', 'pallas'])
@pytest.mark.parametrize('n_side', [7, 16])
def test_rebin_gate_matches_jax(torch_ctx, jax_plane, monkeypatch, n_side,
                                env):
    import hoomd_tpu as jh
    if env is None:
        monkeypatch.delenv('HOOMD_TPU_REBIN', raising=False)
    else:
        monkeypatch.setenv('HOOMD_TPU_REBIN', env)
    picks = []
    for hoomd in (jh, th):
        if hoomd is jh:
            jh.context.initialize('--notice-level=0')
        else:
            th.context.initialize('--mode=cpu --notice-level=0')
        system = _lattice(hoomd, n_side, 1.3)
        _lj_langevin(hoomd)
        system._ensure_ready()
        fast = system._program['fast']
        picks.append((fast['rebin_impl'], fast['rebin_E']))
    jh.context.current = None
    want = 'sort' if n_side ** 3 < 4096 else {
        None: 'xsel', 'off': 'sort', 'pallas': 'pallas'}[env]
    assert picks[0] == picks[1] == (want, 8)


# ---------------------------------------------------------------------------
# (b) trajectories with the rebin forced


def _force_rebin(module, monkeypatch, impl):
    real = module.build_fast_lj_chunk

    def build(*args, **kwargs):
        kwargs['rebin_impl'] = impl
        return real(*args, **kwargs)
    monkeypatch.setattr(module, 'build_fast_lj_chunk', build)


@pytest.mark.parametrize('impl', ['pallas', 'xsel'])
def test_forced_rebin_job_matches_jax(torch_ctx, jax_plane, monkeypatch,
                                      impl):
    import hoomd_tpu as jh
    import hoomd_tpu.ops.fast_lj as jfl
    import hoomd_tpu_torch.ops.fast_lj as tfl
    snap = _start_snapshot(vscale=2.0)

    def hook(system):
        if impl == 'pallas':
            system._grow['fast_rebin_E'] = 1

    _force_rebin(jfl, monkeypatch, impl)
    jh.context.initialize('--notice-level=0')
    js, _ = _job(jh, snap, hook)
    _force_rebin(tfl, monkeypatch, impl)
    ts, _ = _job(th, interop.snapshot_from_numpy(snap), hook)
    jh.context.current = None

    assert js.timestep == ts.timestep == 41
    assert js._grow.get('fast_rebin_E') == ts._grow.get('fast_rebin_E')
    if impl == 'pallas':
        # the E = 1 buffers overflowed and both widened them to 16
        assert ts._grow['fast_rebin_E'] == 16
        assert ts.fast_stats['rebin_retries'] >= 1
    else:
        assert ts.fast_stats['rebin_retries'] == 0
    assert ts.fast_stats['rebuilds'] > 0
    sj, st = js.take_snapshot(), ts.take_snapshot()
    for name in ('position', 'velocity'):
        np.testing.assert_allclose(getattr(st.particles, name),
                                   getattr(sj.particles, name), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert np.array_equal(st.particles.image, sj.particles.image)
    qj, qt = js.thermo_quantities(), ts.thermo_quantities()
    for key in ('temperature', 'kinetic_energy', 'potential_energy',
                'pressure', 'pressure_xx', 'pressure_yy', 'pressure_zz'):
        assert qt[key] == pytest.approx(qj[key], rel=1e-4, abs=1e-6), key


# ---------------------------------------------------------------------------
# (c) the port's xsel strike ladder


class _XselLadder:
    """A 4096-particle port system on the xsel rebin whose xsel rebuild
    raises one of its failure flags (6: transient-stage overflow, 7: lost
    particle) once per ``strike()``."""

    def __init__(self, monkeypatch, flag=6):
        import hoomd_tpu_torch.ops.fast_lj as tfl
        real = tfl.cell_rebin_xsel
        self.fail = []

        def xsel(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.fail:
                self.fail.pop()
                return (out[:flag] + (torch.ones_like(out[flag]),)
                        + out[flag + 1:])
            return out
        monkeypatch.setattr(tfl, 'cell_rebin_xsel', xsel)
        self.system = _lattice(th, 16, 1.1)
        _lj_langevin(th)

    def segment(self):
        """One 4-step segment (one window, then one rebuild); the rebin
        of the program it leaves."""
        self.system.run(4, quiet=True)
        return self.system._program['fast']['rebin_impl']

    def strike(self):
        self.fail.append(1)
        return self.segment()


def test_xsel_strike_sorts_then_reenables(torch_ctx, monkeypatch):
    lad = _XselLadder(monkeypatch)
    grow = lad.system._grow
    assert lad.segment() == 'xsel'
    assert lad.system.fast_stats['rebuilds'] == 1
    # the failed segment is retried on the sort, the first of the 8
    # clean segments before xsel comes back
    assert lad.strike() == 'sort'
    assert grow['fast_xsel_fails'] == 1 and grow['fast_xsel_retry'] == 7
    assert lad.system.fast_stats['rebin_retries'] == 1
    assert lad.system.fast_stats['rebin_lost'] == 0
    for _ in range(6):
        assert lad.segment() == 'sort'
    assert lad.segment() == 'xsel'
    assert 'fast_rebin_sort' not in grow and 'fast_xsel_retry' not in grow


def test_xsel_fourth_strike_sorts_for_good(torch_ctx, monkeypatch):
    lad = _XselLadder(monkeypatch)
    grow = lad.system._grow
    grow['fast_xsel_fails'] = 3
    assert lad.strike() == 'sort'
    assert grow['fast_xsel_fails'] == 4 and grow['fast_rebin_sort']
    assert 'fast_xsel_retry' not in grow
    for _ in range(2):
        assert lad.segment() == 'sort'


def test_xsel_lost_particle_strikes_and_is_counted(torch_ctx, monkeypatch):
    lad = _XselLadder(monkeypatch, flag=7)
    assert lad.segment() == 'xsel'
    assert lad.strike() == 'sort'
    stats = lad.system.fast_stats
    assert stats['rebin_lost'] == stats['rebin_retries'] == 1
    assert lad.system._grow['fast_xsel_fails'] == 1


def test_capacity_and_rebin_overflow_burn_no_strike(torch_ctx, monkeypatch):
    """A capacity overflow with a rebin overflow: the conservative
    replan runs, and xsel keeps its strike count."""
    lad = _XselLadder(monkeypatch)
    system = lad.system
    system._ensure_ready()
    run_chunk = system._program['fast']['run_chunk']

    def both_flags(carry, *args):
        out = run_chunk(carry, *args)
        return out.replace(overflow=torch.ones_like(out.overflow),
                           rebin_ovf=torch.ones_like(out.rebin_ovf))
    system._program['fast']['run_chunk'] = both_flags
    assert not system._grow.get('fast_plan_conservative')
    assert lad.segment() == 'xsel'
    assert system._grow['fast_plan_conservative']
    assert 'fast_xsel_fails' not in system._grow
    assert system.fast_stats['retries'] == 1
