"""Uniform cell binning (counterpart of hoomd_tpu/ops/cells.py).

Binning is a stable sort on the cell id plus a cummax ranking, as in the
JAX package: within a cell the slots hold particles in index order, as a
live prefix.  The hard-particle sweep depends on that order (the mover
is picked by slot), so it is the same order as the JAX package's, slot
for slot.  Cells are padded to a fixed capacity; an overflow raises a
device flag for the host's grow-and-retry protocol.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import int_dtype


def choose_cell_dim(box_L_np, r_max, dimensions=3):
    """Host-side choice of cell grid dimensions: the widest grid whose cell
    width is still >= r_max (CellList::computeDimensions analog)."""
    dim = np.maximum(1, np.floor(np.asarray(box_L_np) / r_max)).astype(int)
    if dimensions == 2:
        dim[2] = 1
    return tuple(int(d) for d in dim)


def build_cell_adj(cell_dim, reach=(1, 1, 1)):
    """Host-side (ncells, n_adj) int32 adjacency of each cell to its
    (2 reach + 1)^3 stencil, periodic-wrapped, sorted and deduplicated:
    a duplicate (a dimension with fewer cells than the stencil spans)
    becomes the sentinel id ncells, an all-padding row of the cell list.
    reach > 1 on an axis searches a wider neighbourhood of narrower cells
    (the nlist stencil and tree variants)."""
    nx, ny, nz = cell_dim
    rx, ry, rz = reach
    ncells = nx * ny * nz
    ids = np.arange(ncells)
    ix, iy, iz = ids % nx, (ids // nx) % ny, ids // (nx * ny)
    adj = np.empty((ncells, (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1)),
                   np.int32)
    c = 0
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                adj[:, c] = ((ix + dx) % nx
                             + nx * ((iy + dy) % ny + ny * ((iz + dz) % nz)))
                c += 1
    adj.sort(axis=1)
    dup = np.zeros_like(adj, dtype=bool)
    dup[:, 1:] = adj[:, 1:] == adj[:, :-1]
    adj[dup] = ncells
    return adj


def cell_index(pos, box, cell_dim):
    """Flat cell id x + nx*(y + ny*z) per particle."""
    nx, ny, nz = cell_dim
    f = box.make_fraction(pos)
    # particles are kept wrapped, but guard roundoff at the boundary
    f = f - torch.floor(f)
    # per axis with host scalars: no small host->device copy, which
    # would make the host wait for the stream
    cx, cy, cz = ((f[:, k] * n).to(int_dtype()).clamp(0, n - 1)
                  for k, n in enumerate(cell_dim))
    return cx + nx * (cy + ny * cz)


def bin_particles(pos, box, cell_dim, capacity):
    """(ncells, capacity) table of particle indices, padded with N.

    Returns (cid, cell_list, overflow); overflow is a device bool."""
    idt = int_dtype()
    N = pos.shape[0]
    dev = pos.device
    ncells = int(np.prod(cell_dim))
    cid = cell_index(pos, box, cell_dim)
    scid, order = torch.sort(cid, stable=True)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    bnd = torch.ones(N, dtype=torch.bool, device=dev)
    bnd[1:] = scid[1:] != scid[:-1]
    first = torch.cummax(torch.where(bnd, idx, 0), 0).values
    rank = idx - first
    ok = rank < capacity
    slot = torch.where(ok, scid.long() * capacity + rank, ncells * capacity)
    flat = torch.full((ncells * capacity + 1,), N, dtype=idt, device=dev)
    flat[slot] = order.to(idt)
    cell_list = flat[:-1].reshape(ncells, capacity)
    return cid, cell_list, ~ok.all()
