"""Padded fixed-capacity Verlet neighbour lists (counterpart of
hoomd_tpu/ops/neighbor.py), the general engine's pair search.

Full (symmetric) per-particle lists of shape (N, max_neigh), padded with
the sentinel N.  A build bins the particles (ops/cells.py), gathers each
row's candidates from its cell's stencil, masks them by the per-type-pair
range r_cut + r_buff, self, padding, body and the per-tag exclusion
table, and compacts the kept ones in stencil order with a row cumsum and
a scatter: the same rows, in the same order, as the JAX package's build.
Kept candidates past max_neigh and every masked one go to a trash column
that is sliced off.  Capacity overflows (neighbours, cell occupancy) set
sticky flags for the host's grow-and-retry protocol.

The rebuild test (the Verlet skin, box-strain aware) is a device
reduction; where the JAX package selects between the old and the new
list with lax.cond inside its compiled step, the host here reads the
test once per step and builds only when it holds.  (Building every step
and selecting on the device, as a traced cond would, keeps the step free
of that read but cost 3.5-3.8x as much per step on the card at the bench
job's size; PERF.md has the measurement.)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .._config import PAD_COORD
from ..box import Box
from .cells import bin_particles


@dataclass
class NeighborListData:
    """Device-side neighbour list state, carried through the step loop."""
    idx: torch.Tensor           # (N, max_neigh) int64, sentinel N
    n_neigh: torch.Tensor       # (N,) int64
    ref_pos: torch.Tensor       # (N, 3) positions at the last build
    ref_box_L: torch.Tensor     # (3,) box lengths at the last build
    ref_box_tilt: torch.Tensor  # (3,) box tilts at the last build
    overflow: torch.Tensor      # () bool: neighbour capacity exceeded
    cell_overflow: torch.Tensor  # () bool: cell capacity exceeded
    n_rebuilds: torch.Tensor    # () int64

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def build_neighbor_list(pos, typeid, tag, diameter, box, cell_dim, cell_cap,
                        cell_adj, rmax_table, max_neigh, excl_tags=None,
                        diameter_shift=False, body=None, exclude_body=False,
                        row_block=4096):
    """One full build: bin, stencil gather, range mask, compaction.

    cell_adj (ncells, n_adj) long device tensor (cells.build_cell_adj);
    rmax_table (T, T) r_cut + r_buff per type pair; excl_tags (Ntags, E)
    long table of excluded tags per tag, padded with Ntags, or None.
    Rows are built in blocks of row_block, bounding the (rows,
    n_adj * cell_cap) candidate tensors.  Returns (idx, n_neigh,
    nbr_overflow, cell_overflow)."""
    N = pos.shape[0]
    dev = pos.device
    cid, cell_list, cell_overflow = bin_particles(pos, box, cell_dim,
                                                  cell_cap)
    cid = cid.long()
    cl_pad = torch.cat([cell_list.long(),
                        torch.full((1, cell_cap), N, dtype=torch.long,
                                   device=dev)])
    pos_pad = torch.cat([pos, torch.full((1, 3), PAD_COORD, dtype=pos.dtype,
                                         device=dev)])
    t_pad = torch.cat([typeid.long(), torch.zeros(1, dtype=torch.long,
                                                  device=dev)])
    if diameter_shift:
        d_pad = torch.cat([diameter, diameter.new_ones(1)])
    use_body = exclude_body and body is not None
    if use_body:
        b_pad = torch.cat([body.long(), torch.full((1,), -1, dtype=torch.long,
                                                   device=dev)])
    use_excl = excl_tags is not None and excl_tags.shape[1] > 0
    if use_excl:
        ntags = excl_tags.shape[0]
        tag_pad = torch.cat([tag.long(), torch.full((1,), ntags,
                                                    dtype=torch.long,
                                                    device=dev)])
        # the sentinel row's table row: excludes nothing
        excl_pad = torch.cat([excl_tags, torch.full(
            (1, excl_tags.shape[1]), ntags, dtype=torch.long, device=dev)])

    B = min(row_block, N)
    idx_out, nn_out = [], []
    for start in range(0, N, B):
        rows = torch.arange(start, start + B, dtype=torch.long, device=dev)
        i = rows.clamp(max=N)
        pos_i = pos_pad[i]
        cand = cl_pad[cell_adj[cid[rows.clamp(max=N - 1)]]].reshape(B, -1)
        dr = box.min_image(pos_i[:, None, :] - pos_pad[cand])
        r2 = (dr * dr).sum(-1)
        rmax = rmax_table[t_pad[i][:, None], t_pad[cand]]
        if diameter_shift:
            rmax = rmax + 0.5 * (d_pad[i][:, None] + d_pad[cand]) - 1.0
        keep = r2 <= rmax * rmax
        keep &= cand != i[:, None]
        keep &= (cand < N) & (rows < N)[:, None]
        if use_body:
            bi = b_pad[i][:, None]
            keep &= ~((bi == b_pad[cand]) & (bi != -1))
        if use_excl:
            my_excl = excl_pad[tag_pad[i]]
            keep &= ~(tag_pad[cand][:, :, None]
                      == my_excl[:, None, :]).any(-1)
        rank = torch.cumsum(keep, 1) - 1
        slot = torch.where(keep, rank.clamp(max=max_neigh), max_neigh)
        nbr = torch.full((B, max_neigh + 1), N, dtype=torch.long, device=dev)
        nbr.scatter_(1, slot, torch.where(keep, cand, N))
        idx_out.append(nbr[:, :max_neigh])
        nn_out.append(keep.sum(1))
    idx = torch.cat(idx_out)[:N]
    n_neigh = torch.cat(nn_out)[:N]
    return idx, n_neigh, (n_neigh > max_neigh).any(), cell_overflow


def needs_rebuild(pos, box, nl, r_buff, r_max=None):
    """The Verlet-skin displacement test, box-deformation aware: the
    reference positions are remapped affinely into the current box, and
    the skin budget is charged for the strain's change of a pair at
    r_max.  A device bool."""
    ref_box = Box(L=nl.ref_box_L, tilt=nl.ref_box_tilt,
                  periodic=box.periodic, dimensions=box.dimensions)
    ref_remap = box.from_fraction(ref_box.make_fraction(nl.ref_pos))
    dr = box.min_image(pos - ref_remap)
    max_d = torch.sqrt((dr * dr).sum(-1).max())
    strain = (box.L / nl.ref_box_L - 1.0).abs().max()
    strain = strain + (box.tilt - nl.ref_box_tilt).abs().max()
    budget = 0.5 * r_buff
    if r_max is not None:
        budget = budget - r_max * strain
    return max_d > budget


def update_neighbor_list(pos, typeid, tag, diameter, box, nl, *, r_buff,
                         r_max, cell_dim, cell_cap, cell_adj, rmax_table,
                         max_neigh, excl_tags=None, diameter_shift=False,
                         body=None, exclude_body=False):
    """Rebuild when the skin test says so (one host read)."""

    def rebuild():
        idx, nn, ovf, covf = build_neighbor_list(
            pos, typeid, tag, diameter, box, cell_dim, cell_cap, cell_adj,
            rmax_table, max_neigh, excl_tags=excl_tags,
            diameter_shift=diameter_shift, body=body,
            exclude_body=exclude_body)
        return NeighborListData(
            idx=idx, n_neigh=nn, ref_pos=pos, ref_box_L=box.L,
            ref_box_tilt=box.tilt, overflow=nl.overflow | ovf,
            cell_overflow=nl.cell_overflow | covf,
            n_rebuilds=nl.n_rebuilds + 1)

    return rebuild() if bool(needs_rebuild(pos, box, nl, r_buff, r_max)) \
        else nl


def fresh_neighbor_list(N, max_neigh, dtype, device):
    """An empty list that the first test always rebuilds: ref_box_L = -1
    makes the strain term exceed any skin budget (a padding position
    alone is unsafe: min_image may wrap it near any particle)."""
    return NeighborListData(
        idx=torch.full((N, max_neigh), N, dtype=torch.long, device=device),
        n_neigh=torch.zeros((N,), dtype=torch.long, device=device),
        ref_pos=torch.full((N, 3), PAD_COORD, dtype=dtype, device=device),
        ref_box_L=torch.full((3,), -1.0, dtype=dtype, device=device),
        ref_box_tilt=torch.zeros((3,), dtype=dtype, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        cell_overflow=torch.zeros((), dtype=torch.bool, device=device),
        n_rebuilds=torch.zeros((), dtype=torch.long, device=device))
