"""Neighbor list configuration (counterpart of hoomd_tpu/md/nlist.py).

The slice runs every pair force on the cell-major engine, whose 27-cell
stencil takes the place of a neighbor list; ``cell`` records the Verlet
skin ``r_buff`` that the engine's cell planner and drift monitor use.
The reference's other arguments are accepted and ignored: the engine's
drift monitor decides when to rebuild.

Exclusions follow the JAX package (hoomd_tpu/md/nlist.py:69-70, 93-94,
136-165): by default 'bond', 'body' and 'constraint'; the stencil sums
every pair, so the engine subtracts each excluded pair's term again as a
tag-space pair (System._bonded_cfg_for), from the per-tag table of
_build_exclusion_table.
"""

from __future__ import annotations

import numpy as np

from .. import context


class nlist:
    """Base neighbor list; r_buff is the Verlet skin (default 0.4)."""

    def __init__(self, r_buff=0.4, check_period=1, d_max=None,
                 dist_check=True, name=None):
        self.r_buff = float(r_buff)
        self.name = name or f"nlist_{len(_sys().nlists)}"
        # reference default exclusions (md/nlist.py): bond, body, constraint
        self.exclusions = ['bond', 'body', 'constraint']
        _sys().add_nlist(self)

    def set_params(self, r_buff=None, check_period=None, d_max=None,
                   dist_check=None):
        if r_buff is not None:
            self.r_buff = float(r_buff)
        _sys()._dirty()

    def reset_exclusions(self, exclusions=None):
        self.exclusions = list(exclusions) if exclusions else []
        _sys()._dirty()

    def _build_exclusion_table(self, snap):
        """(N, E) int32 table of each tag's excluded tags, sorted, padded
        with N, from the snapshot's topology and self.exclusions; None
        when no pair is excluded."""
        N = snap.particles.N
        excl = [set() for _ in range(N)]

        def add_pairs(pairs):
            for a, b in np.asarray(pairs):
                excl[a].add(b)
                excl[b].add(a)

        if 'bond' in self.exclusions and snap.bonds.N:
            add_pairs(snap.bonds.group)
        if 'constraint' in self.exclusions and snap.constraints.N:
            add_pairs(snap.constraints.group)
        if 'pair' in self.exclusions and snap.pairs.N:
            add_pairs(snap.pairs.group)
        if ('angle' in self.exclusions or '1-3' in self.exclusions) \
                and snap.angles.N:
            add_pairs(np.asarray(snap.angles.group)[:, [0, 2]])
        if ('dihedral' in self.exclusions or '1-4' in self.exclusions) \
                and snap.dihedrals.N:
            add_pairs(np.asarray(snap.dihedrals.group)[:, [0, 3]])
        emax = max((len(s) for s in excl), default=0)
        if emax == 0:
            return None
        table = np.full((N, emax), N, dtype=np.int32)
        for t, s in enumerate(excl):
            table[t, :len(s)] = sorted(s)
        return table


class cell(nlist):
    """Binned neighbor list (the cell stencil of the fast engine)."""


def _sys():
    if context.current is None or context.current.system is None:
        raise RuntimeError("create the system first: context.initialize() "
                           "then init.*")
    return context.current.system
