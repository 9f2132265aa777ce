"""The job script of tests/test_torch_impl_job.py (a) with
HOOMD_TPU_FAST_IMPL = pallas3d and row, through both packages: per-tag
positions and velocities to 1e-4, thermo_quantities to rel 1e-4, equal
timesteps, every step on the impl's force wrapper and none on the
megastep.  A file of its own keeps each file near a minute on the CPU."""

import pytest
import torch

import hoomd_tpu_torch as th
from test_torch_impl_job import IMPLS, JOBS_HERE, _ids, check_impl_job

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

JOBS = [c for c in IMPLS if c not in JOBS_HERE]


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


@pytest.mark.parametrize('impl,mega,wrapper', JOBS, ids=map(_ids, JOBS))
def test_impl_job_matches_jax(torch_ctx, monkeypatch, impl, mega, wrapper):
    check_impl_job(monkeypatch, impl, mega, wrapper)
