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

The port runs the same three paths as the JAX package.  MD: the
cell-major engine takes a liquid of one to four particle types with one
of ten pair potentials (nve, nvt, langevin on all particles), on the JAX
package's force paths (HOOMD_TPU_FAST_IMPL), with bonds and angles
(md.bond.fene / harmonic, md.angle.harmonic / cosinesq) and the cell
list's exclusions beside the pair force, and a charged job with
md.charge.pppm; every other MD configuration falls back to the general
engine (neighbour lists, any number of those forces and types, methods
on sub-groups, tilted or 2D boxes, the xplor shift; HOOMD_TPU_FAST=off
takes it outright).  The run loop fires analyze.log, analyze.callback
and dump.gsd between chunks, and init.read_gsd restarts from a GSD
frame.  HPMC: hard spheres and one-type convex polyhedra on the fused
checkerboard sweep:

    hoomd.context.initialize('--mode=gpu')
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=1.3572), n=16)
    mc = hpmc.integrate.convex_polyhedron(seed=11, d=0.15, a=0.2)
    mc.shape_param.set('A', vertices=[(sx / 2, sy / 2, sz / 2)
                                      for sx in (-1, 1) for sy in (-1, 1)
                                      for sz in (-1, 1)])
    hoomd.run(250)
    mc.get_counters(), mc.count_overlaps()

Other configurations raise NotImplementedError naming the gates they
failed.  It imports torch, numpy and (for convex hulls) scipy, never jax.
"""

from __future__ import annotations

from . import _config  # noqa: F401  (precision settings at import)
from . import (analyze, compute, context, data, dump, group, hpmc, init,
               lattice, md, variant)
from .snapshot import Snapshot

__version__ = "0.1.0"

__all__ = ['analyze', 'compute', 'context', 'data', 'dump', 'group', 'hpmc',
           'init', 'lattice', 'md', 'variant', 'run', 'get_step',
           'Snapshot']


def run(tsteps, quiet=False, callback=None, callback_period=0):
    """Advance the simulation by tsteps; ``callback(step)`` runs every
    callback_period steps, and a negative return ends the run."""
    if context.current is None or context.current.system is None:
        raise RuntimeError("initialize the system before run()")
    context.current.system.run(int(tsteps), callback=callback,
                               callback_period=callback_period, quiet=quiet)


def get_step():
    return context.current.system.timestep
