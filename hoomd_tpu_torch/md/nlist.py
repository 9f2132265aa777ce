"""Neighbor list configuration (counterpart of hoomd_tpu/md/nlist.py).

On the cell-major engine the 27-cell stencil takes the place of a
neighbor list: ``cell`` records the Verlet skin ``r_buff`` that the
engine's cell planner and drift monitor use.  On the general engine each
list is a padded (N, max_neigh) table built by ops/neighbor.py from the
static configuration ``_build_config`` makes: the merged r_cut matrix of
the subscribed forces plus r_buff, the cell grid, the capacities
(estimated from the mean density, grown by the overflow retry) and the
exclusion table.  The three variants differ in the cell width they aim
for: ``cell`` the largest range (a 27-cell stencil), ``stencil`` its
cell_width or the shortest active range and ``tree`` the shortest
active range, each with a stencil reach that covers the largest.
``check_period``, ``d_max`` and ``dist_check`` are accepted: the skin
test runs every step.

Exclusions follow the JAX package (hoomd_tpu/md/nlist.py:69-70, 93-94,
136-165): by default 'bond', 'body' and 'constraint'; the stencil sums
every pair, so the engine subtracts each excluded pair's term again as a
tag-space pair (System._bonded_cfg_for), from the per-tag table of
_build_exclusion_table.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context
from ..ops import cells


class _NlistConfig:
    """The static configuration of one list for one program."""

    def __init__(self, cell_dim, cell_cap, max_neigh, cell_adj, rmax_table,
                 excl_tags, exclude_body, diameter_shift, r_buff, r_max):
        self.cell_dim = cell_dim
        self.cell_cap = cell_cap
        self.max_neigh = max_neigh
        self.cell_adj = cell_adj            # (ncells, n_adj) long tensor
        self.rmax_table = rmax_table        # (T, T) r_cut + r_buff
        self.excl_tags = excl_tags          # (Ntags, E) long tensor or None
        self.exclude_body = exclude_body
        self.diameter_shift = diameter_shift
        self.r_buff = r_buff
        self.r_max = r_max


class nlist:
    """Base neighbor list; r_buff is the Verlet skin (default 0.4)."""

    def __init__(self, r_buff=0.4, check_period=1, d_max=None,
                 dist_check=True, name=None):
        self.r_buff = float(r_buff)
        self.check_period = int(check_period)
        self.d_max = d_max
        self.dist_check = dist_check
        self.name = name or f"nlist_{len(_sys().nlists)}"
        self.subscribers = []
        # reference default exclusions (md/nlist.py): bond, body, constraint
        self.exclusions = ['bond', 'body', 'constraint']
        self.diameter_shift = False
        self._cfg = None
        _sys().add_nlist(self)

    def subscribe(self, force):
        if force not in self.subscribers:
            self.subscribers.append(force)
        _sys()._dirty()

    def set_params(self, r_buff=None, check_period=None, d_max=None,
                   dist_check=None):
        if r_buff is not None:
            self.r_buff = float(r_buff)
        if check_period is not None:
            self.check_period = int(check_period)
        if d_max is not None:
            self.d_max = d_max
        if dist_check is not None:
            self.dist_check = dist_check
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

    def _cell_width_target(self, rmax, r_span):
        """The cell width the grid aims for: here the largest range (a
        27-cell stencil); the subclasses narrow it."""
        return r_span

    def _max_rcut_matrix(self, types):
        rmat = np.zeros((len(types), len(types)))
        for f in self.subscribers:
            if f.enabled:
                rmat = np.maximum(rmat, f._rcut_matrix(types))
        return rmat

    def _build_config(self, system, grow=None):
        """The general engine's configuration of this list
        (hoomd_tpu/md/nlist.py:167-226); ``grow`` holds the capacity
        floors the overflow retry raised."""
        types = system.particle_types
        snap = system.snapshot_template
        dev = system.device
        rmat = self._max_rcut_matrix(types)
        if self.diameter_shift:
            dmax = self.d_max or float(np.max(snap.particles.diameter,
                                              initial=1.0))
            rmat = rmat + (dmax - 1.0)
        rmax = rmat + np.where(rmat > 0, self.r_buff, 0.0)
        r_span = float(np.max(rmax))
        if r_span <= 0:
            r_span = 1.0
        box = system.state.box
        L = box.L.cpu().numpy().astype(np.float64)
        width = self._cell_width_target(rmax, r_span)
        cell_dim = cells.choose_cell_dim(L, width, box.dimensions)
        # the stencil must cover r_span on cells at least `width` wide
        actual_w = L[:3] / np.maximum(np.asarray(cell_dim), 1)
        reach = tuple(int(np.ceil(r_span / w - 1e-9)) for w in actual_w)
        if box.dimensions == 2:
            reach = (reach[0], reach[1], 0)
        N = system.state.N
        ncells = int(np.prod(cell_dim))
        # capacities from the mean density with headroom; the overflow
        # flags grow them
        cell_cap = max(4, int(np.ceil(N / ncells * 2.0)) + 4)
        density = N / float(np.prod(L[:box.dimensions]))
        vol = (4.0 / 3.0 * np.pi * r_span ** 3 if box.dimensions == 3
               else np.pi * r_span ** 2)
        max_neigh = max(8, int(np.ceil(density * vol * 1.4)) + 8)
        if grow is not None:
            cell_cap = max(cell_cap, grow.get('cell_cap', 0))
            max_neigh = max(max_neigh, grow.get('max_neigh', 0))
        excl = self._build_exclusion_table(snap)
        self._cfg = _NlistConfig(
            cell_dim=cell_dim, cell_cap=cell_cap, max_neigh=max_neigh,
            cell_adj=torch.as_tensor(cells.build_cell_adj(cell_dim, reach),
                                     dtype=torch.long, device=dev),
            rmax_table=torch.as_tensor(rmax, dtype=torch.float32,
                                       device=dev),
            excl_tags=(None if excl is None else
                       torch.as_tensor(excl, dtype=torch.long, device=dev)),
            exclude_body='body' in self.exclusions,
            diameter_shift=self.diameter_shift, r_buff=self.r_buff,
            r_max=r_span)
        return self._cfg


class cell(nlist):
    """Binned neighbor list: cells as wide as the largest range."""


class stencil(nlist):
    """Stenciled neighbor list for size-asymmetric systems: cells of
    ``cell_width`` (default the shortest active range) searched over a
    stencil wide enough for the largest."""

    def __init__(self, r_buff=0.4, check_period=1, d_max=None,
                 dist_check=True, name=None, cell_width=None,
                 deterministic=True):
        super().__init__(r_buff, check_period, d_max, dist_check, name)
        self.cell_width = cell_width

    def set_cell_width(self, cell_width):
        self.cell_width = cell_width
        _sys()._dirty()

    def _cell_width_target(self, rmax, r_span):
        if self.cell_width is not None:
            return float(self.cell_width)
        active = rmax[rmax > 0]
        return float(active.min()) if active.size else r_span


class tree(nlist):
    """Neighbor list for large size disparity: the fine grid of the
    shortest active range with a wide stencil, in place of the
    reference's bounding-volume tree."""

    def _cell_width_target(self, rmax, r_span):
        active = rmax[rmax > 0]
        return float(active.min()) if active.size else r_span


def _sys():
    if context.current is None or context.current.system is None:
        raise RuntimeError("create the system first: context.initialize() "
                           "then init.*")
    return context.current.system
