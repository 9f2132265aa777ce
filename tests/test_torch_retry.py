"""A Nose-Hoover danger retry through both packages.

hoomd_tpu and hoomd_tpu_torch part on one point of the fast engine's
retry protocol: which thermostat state a retried segment restarts from.
This file runs such a retry through both and shows that the two
trajectories differ by that choice alone.  The JAX side runs the fast
engine in Pallas interpret mode, impl 'plane', as
tests/test_torch_slice.py does."""

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from test_torch_slice import _start_snapshot

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _nvt_job(hoomd, snap):
    """A hot start under Nose-Hoover NVT, run for 20 steps."""
    md = hoomd.md
    hoomd.init.read_snapshot(snap)
    lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.004)
    nvt = md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.3)
    system = hoomd.context.current.system
    system.run(20, quiet=True)
    return system, nvt


class _CadenceOnce(dict):
    """A System._grow table whose 'fast_m' reads 16 windows per rebuild
    (a 64-step cadence) once, at its n-th read.  Both packages read it
    once per segment attempt, and write the backed-off value after a
    danger retry."""

    def __init__(self, base, n):
        super().__init__(base)
        self.reads, self.n = 0, n

    def get(self, key, default=None):
        if key == 'fast_m':
            self.reads += 1
            if self.reads == self.n:
                return 16
        return super().get(key, default)


def _retry_in_second_segment(system):
    """The next run's first segment is 12 steps at one window per
    rebuild and runs clean; its second, up to 24 steps at a 64-step
    cadence, crosses the skin and is retried."""
    system._grow = _CadenceOnce(system._grow, 2)
    system._grow['fast_m'] = 1
    system._fast_seg_cap = 12


def test_nvt_danger_retry_differs_from_jax_only_by_the_thermostat_rewind(
        torch_ctx, monkeypatch):
    """A danger retry in NVT, in the second segment of a run, through
    both packages.  hoomd_tpu restarts the retried segment from its start
    carry's particles but with the thermostat xi/eta of its last state
    sync, taken before the run's first segment; hoomd_tpu_torch takes
    xi/eta from the same carry as the particles.  So the port with the
    retry and the JAX run with the retry part by far more than their
    tolerance, and the port with the JAX package's xi/eta put back
    at the retry lands on the JAX run with the retry: the two packages
    differ by that rewind and nothing else.  (That the port's own retry
    lands on its retry-free trajectory is tested in test_torch_core.py.)"""
    import hoomd_tpu as jh
    monkeypatch.setenv('HOOMD_TPU_FAST', 'interpret')
    monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', 'plane')
    snap = _start_snapshot(vscale=1.6)
    tsnap = interop.snapshot_from_numpy(snap)

    jh.context.initialize('--notice-level=0')
    j_retry, jnvt = _nvt_job(jh, snap)
    jaux = {k: np.array(v) for k, v in
            j_retry._method_aux_by_obj[jnvt].items()}
    _retry_in_second_segment(j_retry)
    j_retry.run(36, quiet=True)

    t_retry, _ = _nvt_job(th, tsnap)
    xi20 = float(t_retry._fast_carry.aux['xi'])
    _retry_in_second_segment(t_retry)
    t_retry.run(36, quiet=True)

    # the JAX package's retry by hand: the second segment restarts from
    # the particles at step 32 and the xi/eta synced at step 20
    th.context.initialize('--mode=cpu --notice-level=0')
    t_rewound, tnvt = _nvt_job(th, tsnap)
    t_rewound.run(12, quiet=True)
    t_rewound.state                          # materialize step 32
    xi32 = float(t_rewound._method_aux_by_obj[tnvt]['xi'])
    t_rewound._method_aux_by_obj[tnvt] = {
        k: torch.as_tensor(v) for k, v in jaux.items()}
    t_rewound._fast_carry = None
    t_rewound._grow['fast_m'] = 16
    t_rewound.run(24, quiet=True)

    for s in (j_retry, t_retry, t_rewound):
        assert s._grow.get('fast_m_pinned'), "the retry did not run"
    assert j_retry.timestep == t_retry.timestep == t_rewound.timestep == 56
    # the aux the JAX retry takes is step 20's, and xi moved by step 32
    assert float(jaux['xi']) == pytest.approx(xi20, rel=1e-4)
    assert abs(xi32 - xi20) > 0.1

    def snap_of(s):
        return s.take_snapshot().particles
    g, w = snap_of(t_rewound), snap_of(j_retry)
    np.testing.assert_allclose(g.position, w.position, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.velocity, w.velocity, rtol=0, atol=1e-4)
    assert t_rewound.thermo_quantities()['temperature'] == pytest.approx(
        j_retry.thermo_quantities()['temperature'], rel=1e-4)
    # and the rewind parts the two packages far past that tolerance
    assert np.abs(snap_of(t_retry).velocity - w.velocity).max() > 1e-2
