"""Neighbor list configuration (counterpart of hoomd_tpu/md/nlist.py).

The slice runs every pair force on the cell-major engine, whose 27-cell
stencil takes the place of a neighbor list; ``cell`` records the Verlet
skin ``r_buff`` that the engine's cell planner and drift monitor use.
The reference's other arguments are accepted and ignored: the engine's
drift monitor decides when to rebuild.
"""

from __future__ import annotations

from .. import context


class nlist:
    """Base neighbor list; r_buff is the Verlet skin (default 0.4)."""

    def __init__(self, r_buff=0.4, check_period=1, d_max=None,
                 dist_check=True, name=None):
        self.r_buff = float(r_buff)
        self.name = name or f"nlist_{len(_sys().nlists)}"
        _sys().add_nlist(self)

    def set_params(self, r_buff=None, check_period=None, d_max=None,
                   dist_check=None):
        if r_buff is not None:
            self.r_buff = float(r_buff)
        _sys()._dirty()


class cell(nlist):
    """Binned neighbor list (the cell stencil of the fast engine)."""


def _sys():
    if context.current is None or context.current.system is None:
        raise RuntimeError("create the system first: context.initialize() "
                           "then init.*")
    return context.current.system
