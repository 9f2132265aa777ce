"""Cell re-binning by migration: counterpart of hoomd_tpu/ops/pallas_rebin.py.

Between neighbour rebuilds no particle moves more than one cell along any
axis (the engine's danger protocol bounds drift to half the Verlet skin),
so a rebuild can move particles between neighbouring cells instead of
sorting every slot.  The state travels as 14 float32 columns
(pos xyz, vel xyz, force xyz, image xyz, tag, mass) in plane layout
(14, nz, ny, nx, C); the int columns ride by VALUE, exact below 2^24
(the engine's gate keeps N < 2^23).

Two families, each the JAX package's function slot for slot:

  cell_rebin_plane(variant=...)   plane-local migration, three variants:
      'select'  cell_rebin_select   (pallas_rebin.py _kernel_rebin_select)
                z, x, then y: each cell selects its new occupants from a
                3C-wide window of its own and both neighbours' slots
      'grid'    cell_rebin_sweep    (_kernel_rebin_sweep): x pass, y pass
                (compact <= E emigrants per face, clear, place), then the
                z emigrants into emz;
                cell_rebin_place    (_kernel_rebin_place): place the z
                immigrants of every plane
      other     cell_rebin_serial   (_kernel_rebin): the same function as
                'grid', as one program
  cell_rebin_xsel / cell_rebin_xsel_planes   the JAX package's plain-XLA
      staged select (wrap once, then per axis the global bin floor
      ((x + L/2) / L * n) == own index), which runs outside any Pallas
      kernel and so is plain torch here.

Slot order is deterministic and equal to the JAX package's: emigrants in
slot order, immigrants ordered [from index-1 (E), from index+1 (E)],
immigrant rank r placed in the free slot of rank r, and a window's
candidates ordered [index-1, own, index+1].  The JAX code forms ranks by
triangular-ones matmuls and moves values by one-hot products; here ranks
are exclusive running counts and values move by index, which gives the
same slots and the same bits (one-hot sums add exact zeros).

On a CUDA tensor each of the four migration wrappers launches its
hand-written kernel (csrc/cell_rebin.cu) or raises; on a CPU tensor it
runs the plain version.  Each counts its launches in ``<wrapper>.launches``.
Overflow (more than E emigrants through one face, more immigrants than
free slots, more than C claimants of a cell) raises a sticky flag: the
rebuild is unusable and the host retries on the sort rebuild.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import PAD_COORD
from .cell_pair import _kernel_lib, _stream

# column indices
PX, PY, PZ, VX, VY, VZ, FX, FY, FZ, IX, IY, IZ, TG, MS = range(14)
NCOL = 14

_FILLS = np.zeros((NCOL,), np.float32)
_FILLS[PX] = _FILLS[PY] = _FILLS[PZ] = PAD_COORD
_FILLS[TG] = -1.0
_FILLS[MS] = 1.0

# largest capacities the kernels take: 3C window candidates and 2E
# immigrants, one thread each, in a block of at most 1024 threads
MAX_C = 341
MAX_E = 512


def _fill(ref, ndim):
    """(NCOL, 1, ...) fill column of ndim dims, on ref's device."""
    return torch.as_tensor(_FILLS, device=ref.device).reshape(
        (NCOL,) + (1,) * (ndim - 1))


def rebin_params(box_L, cell_dim):
    """float32 [Lx, Ly, Lz, wx, wy, wz], w = L / n rounded in float32 as
    the JAX package's ``par`` (pallas_rebin.py:700)."""
    if torch.is_tensor(box_L):
        box_L = box_L.detach().cpu().numpy()
    L = np.asarray(box_L, np.float32).reshape(3)
    return np.concatenate([L, L / np.asarray(cell_dim, np.float32)])


def _scalars(par, ref):
    t = torch.as_tensor(np.asarray(par, np.float32), device=ref.device)
    return t[:3], t[3:6]


def _rank(mask):
    """Exclusive running count of set entries along the last axis."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, -1) - m


def _axis_index(shape, dim, ref):
    """float32 index along ``dim``, shaped to broadcast against ``shape``."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], device=ref.device,
                        dtype=torch.float32).reshape(view)


def _origin(io, w, L):
    """Lower face of a cell: i * w - L / 2, each operation rounded."""
    return io * w - 0.5 * L


def _compact(cols, mask, E):
    """Pull masked slots of (NCOL, ..., C) rows into (NCOL, ..., E)
    buffers in slot order.  Returns (em, em_valid (..., E), ovf); entries
    past the count are zero, slots ranked past E are dropped and flagged."""
    rank = _rank(mask)
    cnt = mask.sum(-1)
    idx = torch.where(mask & (rank < E), rank, E)
    em = cols.new_zeros(cols.shape[:-1] + (E + 1,))
    em.scatter_(-1, idx.expand_as(cols), cols)
    valid = torch.arange(E, device=cols.device) < cnt[..., None]
    return em[..., :E], valid, (cnt > E).any()


def _place(cols, free, imm, imm_valid):
    """Insert immigrants into free slots: immigrant of rank r lands in the
    free slot of rank r.  cols (NCOL, ..., C); free (..., C) bool; imm
    (NCOL, ..., K); imm_valid (..., K) bool.  Returns (cols', ovf)."""
    C = free.shape[-1]
    frank = _rank(free)
    nfree = free.sum(-1, keepdim=True)
    irank = _rank(imm_valid)
    slots = torch.arange(C, device=cols.device).expand_as(free)
    slot_of = torch.full(free.shape[:-1] + (C + 1,), C, dtype=torch.int64,
                         device=cols.device)
    slot_of.scatter_(-1, torch.where(free, frank, C), slots)
    land = imm_valid & (irank < nfree)
    dest = torch.where(land, torch.gather(slot_of, -1, irank.clamp(max=C)),
                       C)
    out = torch.cat([cols, cols[..., :1]], -1)
    out.scatter_(-1, dest.expand_as(imm), imm)
    ovf = (imm_valid.sum(-1, keepdim=True) > nfree).any()
    return out[..., :C], ovf


def _clear(cols, stay):
    """Reset non-staying slots to the canonical padding fill."""
    return torch.where(stay[None], cols, _fill(cols, cols.dim()))


def _shift_at(cols, dim, at, pos_col, img_col, L, sgn):
    """Periodic shift of the rows at index ``at`` along ``dim``: pos
    + sgn L, image - sgn."""
    hit = _axis_index(cols.shape[1:], dim - 1, cols) == float(at)
    out = cols.clone()
    out[pos_col] = torch.where(hit, cols[pos_col] + sgn * L, cols[pos_col])
    out[img_col] = torch.where(hit, cols[img_col] - sgn, cols[img_col])
    return out


def _migrants(cols, axis, io, L, w):
    """valid, +face and -face masks of one axis."""
    local = cols[PX + axis] - _origin(io, w, L)
    valid = cols[TG] >= 0.0
    return valid, valid & (local >= w), valid & (local < 0.0)


def _rebin_axis(cols, axis, L, w, E):
    """One axis pass of the sweep over (NCOL, nz, ny, nx, C): compact the
    emigrants of each face, clear their slots, and place what the two
    neighbours sent.  Returns (cols', ovf)."""
    dim = 3 - axis                                 # x: 3, y: 2, z: 1
    n = cols.shape[dim]
    io = _axis_index(cols.shape[1:], dim - 1, cols)
    valid, migp, migm = _migrants(cols, axis, io, L, w)
    em_p, vp, o1 = _compact(cols, migp, E)
    em_m, vm, o2 = _compact(cols, migm, E)
    stay = valid & ~(migp | migm)
    cols = _clear(cols, stay)
    em_p = _shift_at(torch.roll(em_p, 1, dim), dim, 0, PX + axis, IX + axis,
                     L, -1.0)
    em_m = _shift_at(torch.roll(em_m, -1, dim), dim, n - 1, PX + axis,
                     IX + axis, L, 1.0)
    vp = torch.roll(vp, 1, dim - 1)
    vm = torch.roll(vm, -1, dim - 1)
    cols, o3 = _place(cols, ~stay, torch.cat([em_p, em_m], -1),
                      torch.cat([vp, vm], -1))
    return cols, o1 | o2 | o3


def _pack_emz(em, valid):
    """(NCOL, nz, ny, nx, E) emigrants -> (nz, ny, nx, NCOL*E), column c
    in lanes [c*E, (c+1)*E), invalid entries tagged -1."""
    em = em.clone()
    em[TG] = torch.where(valid, em[TG], -1.0)
    nz, ny, nx, E = em.shape[1:]
    return em.permute(1, 2, 3, 0, 4).reshape(nz, ny, nx, NCOL * E)


def _unpack_emz(pk, E):
    nz, ny, nx, _ = pk.shape
    return pk.reshape(nz, ny, nx, NCOL, E).permute(3, 0, 1, 2, 4)


# ---------------------------------------------------------------------------
# plain torch versions of the four kernels


def cell_rebin_select_plain(cols, cell_dim, par, *, C):
    """Plain torch version of cell_rebin_select: (cols', ovf)."""
    Lv, wv = _scalars(par, cols)
    out, ovf = cols, torch.zeros((), dtype=torch.bool, device=cols.device)
    for axis in (2, 0, 1):                         # z, then x, then y
        dim = 3 - axis
        n = out.shape[dim]
        L, w = Lv[axis], wv[axis]
        lo = _shift_at(torch.roll(out, 1, dim), dim, 0, PX + axis,
                       IX + axis, L, -1.0)
        hi = _shift_at(torch.roll(out, -1, dim), dim, n - 1, PX + axis,
                       IX + axis, L, 1.0)
        cand = torch.cat([lo, out, hi], -1)        # (NCOL, ..., 3C)
        io = _axis_index(cand.shape[1:], dim - 1, cand)
        local = cand[PX + axis] - _origin(io, w, L)
        sf = (cand[TG] >= 0.0) & (local >= 0.0) & (local < w)
        rank = _rank(sf)
        sel = cand.new_zeros(cand.shape[:-1] + (C + 1,))
        sel.scatter_(-1, torch.where(sf & (rank < C), rank,
                                     C).expand_as(cand), cand)
        got = torch.arange(C, device=cols.device) < sf.sum(-1, keepdim=True)
        out = torch.where(got[None], sel[..., :C], _fill(cols, cols.dim()))
        ovf = ovf | (sf & (rank >= C)).any()
    return out, ovf


def _sweep(cols, Lv, wv, E):
    """x pass, y pass, then the z emigrants: (swept, emz, ovf)."""
    cols, o1 = _rebin_axis(cols, 0, Lv[0], wv[0], E)
    cols, o2 = _rebin_axis(cols, 1, Lv[1], wv[1], E)
    io = _axis_index(cols.shape[1:], 0, cols)
    valid, migp, migm = _migrants(cols, 2, io, Lv[2], wv[2])
    em_p, vp, o3 = _compact(cols, migp, E)
    em_m, vm, o4 = _compact(cols, migm, E)
    swept = _clear(cols, valid & ~(migp | migm))
    emz = torch.stack([_pack_emz(em_p, vp), _pack_emz(em_m, vm)])
    return swept, emz, o1 | o2 | o3 | o4


def _z_place(swept, emz, Lv, E):
    """Plane iz takes the +z emigrants of plane iz-1 and the -z emigrants
    of plane iz+1, shifted by -+Lz across the seam: (cols', ovf)."""
    nz = swept.shape[1]
    em_p = _shift_at(torch.roll(_unpack_emz(emz[0], E), 1, 1), 1, 0, PZ, IZ,
                     Lv[2], -1.0)
    em_m = _shift_at(torch.roll(_unpack_emz(emz[1], E), -1, 1), 1, nz - 1,
                     PZ, IZ, Lv[2], 1.0)
    imm = torch.cat([em_p, em_m], -1)
    return _place(swept, swept[TG] < 0.0, imm, imm[TG] >= 0.0)


def cell_rebin_sweep_plain(cols, cell_dim, par, *, C, E):
    """Plain torch version of cell_rebin_sweep: (swept, emz, ovf)."""
    Lv, wv = _scalars(par, cols)
    return _sweep(cols, Lv, wv, E)


def cell_rebin_place_plain(swept, emz, cell_dim, par, *, C, E):
    """Plain torch version of cell_rebin_place: (cols', ovf)."""
    Lv, _ = _scalars(par, swept)
    return _z_place(swept, emz, Lv, E)


def cell_rebin_serial_plain(cols, cell_dim, par, *, C, E):
    """Plain torch version of cell_rebin_serial: (cols', ovf)."""
    Lv, wv = _scalars(par, cols)
    swept, emz, o1 = _sweep(cols, Lv, wv, E)
    out, o2 = _z_place(swept, emz, Lv, E)
    return out, o1 | o2


# ---------------------------------------------------------------------------
# wrappers: kernel on a CUDA tensor, plain version on a CPU tensor


def _check(C, E, **tensors):
    """Raise unless every named tensor has its expected shape and the
    capacities fit one block of the kernels."""
    if not 1 <= C <= MAX_C:
        raise NotImplementedError(f"cell capacity C={C} outside the rebin "
                                  f"kernels' 1..{MAX_C}")
    if E is not None and not 1 <= E <= MAX_E:
        raise NotImplementedError(f"emigrant buffer E={E} outside the rebin "
                                  f"kernels' 1..{MAX_E}")
    for name, (t, want) in tensors.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: expected shape {tuple(want)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")


def _shapes(cell_dim, C, E=None):
    nx, ny, nz = cell_dim
    cols = (NCOL, nz, ny, nx, C)
    emz = (2, nz, ny, nx, NCOL * E) if E is not None else None
    return cols, emz


def _on_cpu(t):
    if t.device.type not in ('cuda', 'cpu'):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == 'cpu'


def _launch(name, t, *args):
    """Call the C entry point ``name`` on t's stream; raise on its error."""
    lib = _kernel_lib()
    err = getattr(lib.lib, name)(*args, _stream(t))
    lib.check(err, name)


def _geom(cell_dim, par, C, E=None):
    nx, ny, nz = cell_dim
    return [float(x) for x in np.asarray(par, np.float32)] + [
        nx, ny, nz, C] + ([E] if E is not None else [])


def cell_rebin_select(cols, cell_dim, par, *, C):
    """'select' migration (z, then x, then y window selects) of the
    (NCOL, nz, ny, nx, C) columns; par from rebin_params.  Returns
    (cols', ovf) with ovf a 0-d bool tensor."""
    shp, _ = _shapes(cell_dim, C)
    _check(C, None, cols=(cols, shp))
    if _on_cpu(cols):
        return cell_rebin_select_plain(cols, cell_dim, par, C=C)
    src = cols.contiguous()
    tmp = torch.empty((2,) + shp, dtype=torch.float32, device=src.device)
    out = torch.empty_like(src)
    flag = torch.zeros(1, dtype=torch.int32, device=src.device)
    _launch('hoomd_rebin_select', src, src.data_ptr(), tmp.data_ptr(),
            out.data_ptr(), flag.data_ptr(), *_geom(cell_dim, par, C))
    cell_rebin_select.launches += 1
    return out, flag[0] != 0


def cell_rebin_sweep(cols, cell_dim, par, *, C, E):
    """The 'grid' sweep: x pass, y pass and the z emigrants.  Returns
    (swept, emz (2, nz, ny, nx, NCOL*E), ovf)."""
    shp, eshp = _shapes(cell_dim, C, E)
    _check(C, E, cols=(cols, shp))
    if _on_cpu(cols):
        return cell_rebin_sweep_plain(cols, cell_dim, par, C=C, E=E)
    src = cols.contiguous()
    swept = torch.empty_like(src)
    emz = torch.empty(eshp, dtype=torch.float32, device=src.device)
    emxy = torch.empty((2,) + eshp, dtype=torch.float32, device=src.device)
    flag = torch.zeros(1, dtype=torch.int32, device=src.device)
    _launch('hoomd_rebin_sweep', src, src.data_ptr(), swept.data_ptr(),
            emxy[0].data_ptr(), emxy[1].data_ptr(), emz.data_ptr(),
            flag.data_ptr(), *_geom(cell_dim, par, C, E))
    cell_rebin_sweep.launches += 1
    return swept, emz, flag[0] != 0


def cell_rebin_place(swept, emz, cell_dim, par, *, C, E):
    """The 'grid' z place: every plane takes the z emigrants of its two
    neighbour planes.  Returns (cols', ovf)."""
    shp, eshp = _shapes(cell_dim, C, E)
    _check(C, E, swept=(swept, shp), emz=(emz, eshp))
    if _on_cpu(swept):
        return cell_rebin_place_plain(swept, emz, cell_dim, par, C=C, E=E)
    if emz.device != swept.device:
        raise ValueError("swept and emz must lie on the same device")
    src = swept.contiguous()
    em = emz.contiguous()
    out = torch.empty_like(src)
    flag = torch.zeros(1, dtype=torch.int32, device=src.device)
    _launch('hoomd_rebin_place', src, src.data_ptr(), em.data_ptr(),
            out.data_ptr(), flag.data_ptr(), *_geom(cell_dim, par, C, E))
    cell_rebin_place.launches += 1
    return out, flag[0] != 0


def cell_rebin_serial(cols, cell_dim, par, *, C, E):
    """The sweep and the z place as one program.  Returns (cols', ovf)."""
    shp, eshp = _shapes(cell_dim, C, E)
    _check(C, E, cols=(cols, shp))
    if _on_cpu(cols):
        return cell_rebin_serial_plain(cols, cell_dim, par, C=C, E=E)
    src = cols.contiguous()
    out = torch.empty_like(src)
    em = torch.empty((3,) + eshp, dtype=torch.float32, device=src.device)
    flag = torch.zeros(1, dtype=torch.int32, device=src.device)
    _launch('hoomd_rebin_serial', src, src.data_ptr(), out.data_ptr(),
            em[0].data_ptr(), em[1].data_ptr(), em[2].data_ptr(),
            flag.data_ptr(), *_geom(cell_dim, par, C, E))
    cell_rebin_serial.launches += 1
    return out, flag[0] != 0


KERNEL_WRAPPERS = (cell_rebin_select, cell_rebin_sweep, cell_rebin_place,
                   cell_rebin_serial)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# the op


def to_cols(pos, vel, frc, img, tag, mass, cell_dim, C):
    """Cell-major (nc, C, ...) state -> (NCOL, nz, ny, nx, C) float32."""
    nx, ny, nz = cell_dim
    f32 = torch.float32

    def p3(a):
        return a.to(f32).reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2, 3)

    def p1(a):
        return a.to(f32).reshape(1, nz, ny, nx, C)
    return torch.cat([p3(pos), p3(vel), p3(frc), p3(img), p1(tag),
                      p1(mass)]).contiguous()


def from_cols(out, C, int_dtype):
    """(NCOL, nz, ny, nx, C) -> (pos, vel, frc, img, tag, mass) cell-major."""
    nc = out[0].numel() // C

    def u3(i0):
        return out[i0:i0 + 3].permute(1, 2, 3, 4, 0).reshape(nc, C, 3)
    return (u3(PX), u3(VX), u3(FX), u3(IX).to(int_dtype),
            out[TG].reshape(nc, C).to(int_dtype), out[MS].reshape(nc, C))


def cell_rebin_plane(pos, vel, frc, img, tag, mass, cell_dim, box_L, *, C,
                     E=8, variant='grid'):
    """Re-bin cell-major state by plane-local migration.

    pos/vel/frc (nc, C, 3) float32, img (nc, C, 3) int, tag (nc, C) int
    (-1 = padding), mass (nc, C); box_L (3,).  Returns the same tuple
    re-binned plus a 0-d bool overflow flag.  variant 'select', 'grid'
    (sweep, then place) or anything else (the serial program), as in the
    JAX package.  Precondition: no particle has moved more than one cell
    along any axis since the last rebin."""
    cols = to_cols(pos, vel, frc, img, tag, mass, cell_dim, C)
    par = rebin_params(box_L, cell_dim)
    if variant == 'select':
        out, ovf = cell_rebin_select(cols, cell_dim, par, C=C)
    elif variant == 'grid':
        swept, emz, o1 = cell_rebin_sweep(cols, cell_dim, par, C=C, E=E)
        out, o2 = cell_rebin_place(swept, emz, cell_dim, par, C=C, E=E)
        ovf = o1 | o2
    else:
        out, ovf = cell_rebin_serial(cols, cell_dim, par, C=C, E=E)
    return from_cols(out, C, tag.dtype) + (ovf,)


# ---------------------------------------------------------------------------
# xsel: the JAX package's plain-XLA staged select, in plain torch


def _xsel_stages(cols, cell_dim, L, half, C, n_live0):
    """The three staged axis selects of cell_rebin_xsel and
    cell_rebin_xsel_planes.  cols (nz, ny, nx, C, NCOL) channel matrix.
    Each axis: every cell claims, in window order [index-1, own,
    index+1], the candidates whose global bin floor((x + L/2) / L * n)
    is its own index.  The x and y stages carry C + 8 slots (a cell's
    occupancy is transient until all three axes are resolved), the z
    stage C.  Returns (cols', cap_ovf, lost)."""
    nx, ny, nz = cell_dim
    fill = torch.as_tensor(_FILLS, device=cols.device)
    cap_ovf = torch.zeros((), dtype=torch.bool, device=cols.device)
    Cmid = C + 8
    for arr_axis, n_ax, p_ch, out_cap in ((2, nx, 0, Cmid), (1, ny, 1, Cmid),
                                          (0, nz, 2, C)):
        win = torch.cat([torch.roll(cols, 1, arr_axis), cols,
                         torch.roll(cols, -1, arr_axis)], dim=3)
        io = _axis_index(win.shape[:4], arr_axis, win)
        tband = torch.clamp(torch.floor((win[..., p_ch] + half[p_ch])
                                        / L[p_ch] * n_ax), 0, n_ax - 1)
        claim = (win[..., TG] >= 0.0) & (tband == io)
        rank = _rank(claim)
        nclaim = claim.sum(-1, keepdim=True)
        cap_ovf = cap_ovf | (nclaim.max() > out_cap)
        idx = torch.where(claim & (rank < out_cap), rank, out_cap)
        out = win.new_zeros(win.shape[:3] + (out_cap + 1, NCOL))
        out.scatter_(3, idx[..., None].expand_as(win), win)
        got = torch.arange(out_cap, device=cols.device) < nclaim
        cols = torch.where(got[..., None], out[..., :out_cap, :], fill)
    lost = (cols[..., TG] >= 0.0).sum() != n_live0
    return cols, cap_ovf, lost


def cell_rebin_xsel_planes(gp, gv, gf, gim, gtag, gmass, cell_dim, box_L, *,
                           C):
    """Plane-layout xsel rebin: gp/gv/gf (3, nz, ny, nx, C) float32,
    gim the same shape int, gtag/gmass (nz, ny, nx, C).  Positions are
    wrapped once up front (images adjusted).  Returns (gp', gv', gf', gim',
    gtag', gmass', cap_ovf, lost): either flag makes this rebuild
    unusable."""
    itp = gtag.dtype
    L = torch.as_tensor(np.asarray(rebin_params(box_L, cell_dim)[:3]),
                        device=gp.device)
    half = 0.5 * L
    Lb = L.reshape(3, 1, 1, 1, 1)
    shift = torch.floor((gp + half.reshape(3, 1, 1, 1, 1)) / Lb)
    gp_w = gp - shift * Lb
    gim_w = (gim + shift.to(itp)).to(torch.float32)
    cols = torch.stack([gp_w[0], gp_w[1], gp_w[2], gv[0], gv[1], gv[2],
                        gf[0], gf[1], gf[2], gim_w[0], gim_w[1], gim_w[2],
                        gtag.to(torch.float32), gmass], dim=-1)
    cols, cap_ovf, lost = _xsel_stages(cols, cell_dim, L, half, C,
                                       (gtag >= 0).sum())
    ch = cols.permute(4, 0, 1, 2, 3)
    return (ch[0:3], ch[3:6], ch[6:9], ch[9:12].to(itp), ch[TG].to(itp),
            ch[MS], cap_ovf, lost)


def cell_rebin_xsel(pos, vel, frc, img, tag, mass, cell_dim, box_L, *, C):
    """Cell-major xsel rebin: (nc, C, ...) in and out, otherwise as
    cell_rebin_xsel_planes.  Returns (pos', vel', frc', img', tag',
    mass', cap_ovf, lost)."""
    nx, ny, nz = cell_dim

    def planes(a):
        return a.reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2, 3)
    p4 = (nz, ny, nx, C)
    gp, gv, gf, gim, gtag, gmass, cap_ovf, lost = cell_rebin_xsel_planes(
        planes(pos), planes(vel), planes(frc), planes(img), tag.reshape(p4),
        mass.reshape(p4), cell_dim, box_L, C=C)
    nc = nx * ny * nz

    def cells(a):
        return a.permute(1, 2, 3, 4, 0).reshape(nc, C, 3)
    return (cells(gp), cells(gv), cells(gf), cells(gim),
            gtag.reshape(nc, C), gmass.reshape(nc, C), cap_ovf, lost)
