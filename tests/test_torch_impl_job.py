"""The LJ engine's force paths (HOOMD_TPU_FAST_IMPL) through both
packages' job scripts.

(a) tests/test_torch_slice.py's job script (343 particles, a Langevin
    melt, a dt change, then Nose-Hoover NVT whose run leaves single steps
    after the k-step windows; its first segment crosses the skin, so the
    danger retry runs) through hoomd_tpu (HOOMD_TPU_FAST=interpret: its
    Pallas kernels in interpret mode) and hoomd_tpu_torch on --mode=cpu,
    with HOOMD_TPU_FAST_IMPL = planar_n3l, pallas, pallas3d and row, and
    with plane plus HOOMD_TPU_MEGA=off.  Per-tag positions and velocities
    agree to 1e-4, thermo_quantities to rel 1e-4, the timesteps are
    equal, and the port ran every step on the impl's force wrapper and
    none on the megastep.
(b) Gates, without running: at N = 4096 each impl gets the JAX package's
    rebin, xsel for the planar family and the sort for pallas, pallas3d
    and row, and the port records the impl and whether the megastep runs.
(c) An unknown impl raises ValueError naming the accepted ones.
"""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from test_torch_rebin_job import _lattice, _lj_langevin
from test_torch_slice import _force_retries, _job, _start_snapshot

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

# (HOOMD_TPU_FAST_IMPL, HOOMD_TPU_MEGA, the force wrapper of its steps);
# the jobs of the last two run in tests/test_torch_impl_job_rows.py, so
# that no file runs much over a minute
IMPLS = [('planar_n3l', None, 'cell_pair_planar_n3l'),
         ('pallas', None, 'cell_pair_lj'),
         ('plane', 'off', 'cell_pair_plane'),
         ('pallas3d', None, 'cell_pair_lj_pallas3d'),
         ('row', None, 'cell_pair_lj_row')]
JOBS_HERE = IMPLS[:3]


def _ids(case):
    return case[0] + ('' if case[1] is None else '-mega-' + case[1])


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _set_impl(monkeypatch, impl, mega):
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', impl)
    if mega is None:
        monkeypatch.delenv('HOOMD_TPU_MEGA', raising=False)
    else:
        monkeypatch.setenv('HOOMD_TPU_MEGA', mega)


def _count_calls(module, name, monkeypatch):
    """Count the calls of module.name."""
    real = getattr(module, name)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


def check_impl_job(monkeypatch, impl, mega, wrapper):
    """(a) for one impl: the job through both packages, compared."""
    import hoomd_tpu as jh
    import hoomd_tpu_torch.ops.fast_lj as tfl
    _set_impl(monkeypatch, impl, mega)
    snap = _start_snapshot()
    jh.context.initialize('--notice-level=0')
    js, _ = _job(jh, snap, _force_retries)
    jh.context.current = None

    calls = _count_calls(tfl, wrapper, monkeypatch)

    def no_megastep(*args, **kwargs):
        raise AssertionError(f"impl {impl} ran the megastep")
    monkeypatch.setattr(tfl, 'megastep_window', no_megastep)
    ts, _ = _job(th, interop.snapshot_from_numpy(snap), _force_retries)

    fast = ts._program['fast']
    assert (fast['impl'], fast['mega']) == (impl, False)
    # every step and the danger retry: more calls than the 41 steps
    assert len(calls) > 41
    assert ts.fast_stats['retries'] >= 1
    assert js.timestep == ts.timestep == 41
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


@pytest.mark.parametrize('impl,mega,wrapper', JOBS_HERE,
                         ids=map(_ids, JOBS_HERE))
def test_impl_job_matches_jax(torch_ctx, monkeypatch, impl, mega, wrapper):
    check_impl_job(monkeypatch, impl, mega, wrapper)


@pytest.mark.parametrize('impl,mega,wrapper', IMPLS + [('plane', None, '')],
                         ids=map(_ids, IMPLS + [('plane', None, '')]))
def test_impl_rebin_gate_matches_jax(torch_ctx, monkeypatch, impl, mega,
                                     wrapper):
    import hoomd_tpu as jh
    _set_impl(monkeypatch, impl, mega)
    monkeypatch.delenv('HOOMD_TPU_REBIN', raising=False)
    picks = []
    for hoomd in (jh, th):
        if hoomd is jh:
            jh.context.initialize('--notice-level=0')
        else:
            th.context.initialize('--mode=cpu --notice-level=0')
        system = _lattice(hoomd, 16, 1.1)
        _lj_langevin(hoomd)
        system._ensure_ready()
        picks.append(system._program['fast']['rebin_impl'])
    jh.context.current = None
    want = 'xsel' if impl in ('plane', 'planar_n3l') else 'sort'
    assert picks == [want, want]
    fast = th.context.current.system._program['fast']
    assert fast['impl'] == impl
    assert fast['mega'] == (impl == 'plane' and mega is None)


def test_unknown_impl_raises(torch_ctx, monkeypatch):
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'planar_n31')
    _lattice(th, 4, 1.3)
    _lj_langevin(th)
    with pytest.raises(ValueError, match="'planar_n31' is not one of "
                                         "plane, planar, planar_n3l"):
        th.run(1, quiet=True)
