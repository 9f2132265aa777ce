"""hoomd_tpu_torch — the PyTorch and CUDA port of hoomd_tpu.

It mirrors hoomd_tpu's module names and job-script API, so a script
written for the JAX package runs with ``import hoomd_tpu_torch as
hoomd``:

    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    hoomd.context.initialize('--mode=gpu')
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=1.0583), n=40)
    nl = md.nlist.cell(r_buff=0.4)
    lj = md.pair.lj(r_cut=2.5, nlist=nl)
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.005)
    md.integrate.nvt(group=hoomd.group.all(), kT=1.2, tau=0.5)
    hoomd.run(1000)

The port so far runs two paths.  MD: a liquid of one to four particle
types with one of ten pair potentials on the cell-major engine (nve,
nvt, langevin), on the JAX package's force paths (HOOMD_TPU_FAST_IMPL;
a mixture on those that take one).  HPMC: hard spheres and one-type
convex polyhedra on the fused checkerboard sweep:

    hoomd.context.initialize('--mode=gpu')
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=1.3572), n=16)
    mc = hpmc.integrate.convex_polyhedron(seed=11, d=0.15, a=0.2)
    mc.shape_param.set('A', vertices=[(sx / 2, sy / 2, sz / 2)
                                      for sx in (-1, 1) for sy in (-1, 1)
                                      for sz in (-1, 1)])
    hoomd.run(250)
    mc.get_counters(), mc.count_overlaps()

Other configurations raise NotImplementedError naming the gate they
failed.  It imports torch, numpy and (for convex hulls) scipy, never jax.
"""

from __future__ import annotations

from . import _config  # noqa: F401  (precision settings at import)
from . import context, data, group, hpmc, init, lattice, md, variant
from .snapshot import Snapshot

__version__ = "0.1.0"

__all__ = ['context', 'data', 'group', 'hpmc', 'init', 'lattice', 'md',
           'variant', 'run', 'get_step', 'Snapshot']


def run(tsteps, quiet=False):
    """Advance the simulation by tsteps."""
    if context.current is None or context.current.system is None:
        raise RuntimeError("initialize the system before run()")
    context.current.system.run(int(tsteps), quiet=quiet)


def get_step():
    return context.current.system.timestep
