"""Hard-particle Monte Carlo (counterpart of hoomd_tpu/hpmc/).

The fused checkerboard sweep for hard spheres and one-type convex
polyhedra: ``integrate`` (the integrators), ``data`` (shape-parameter
proxies) and ``sweep`` (the two kernels with their plain versions).
"""

from . import data, integrate, sweep

__all__ = ['integrate', 'data', 'sweep']
