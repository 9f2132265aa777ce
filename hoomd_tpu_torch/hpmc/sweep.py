"""Fused checkerboard sweeps: counterpart of hoomd_tpu/hpmc/pallas_sweep.py.

Two wrappers, each beside the plain torch version of the same function:

  fused_sphere_sweep  (pallas_sweep.py fused_sphere_sweep)  hard spheres
  fused_poly_sweep    (pallas_sweep.py fused_poly_sweep)    one-type convex
                                                            polyhedra, SAT

One call runs R rounds x 8 parity sub-sweeps on cell planes of shape
(nz, ny, nx*C): the C slots of cell (z, y, x) occupy lanes [x*C, (x+1)*C)
of row (z, y), live slots form a prefix, and ``live`` is 1/0.  In each
sub-sweep every cell of the parity class ``perms[s]`` picks one mover,
proposes a trial move from its own uniforms ``randu[s, :, z, y, x]``, and
commits it unless the trial overlaps a live slot of its 27-cell window.
The arithmetic is the JAX kernel's, operation for operation (Box-Muller
direction, u^(1/3) radius, rsqrt with one Newton step for polyhedra,
commit as old + (new - old)), so the port agrees with the JAX package to
float32 round-off on the same ``perms`` and ``randu``.

``perms`` lies on the host: the host needs each sub-sweep's class to
pick the cells it launches.  ``randu`` lies with the planes.

On a CUDA tensor a wrapper launches its hand-written kernel
(csrc/hpmc_sweep.cu) or raises; on a CPU tensor it runs the plain
version.  Nothing falls back from one to the other.  Each sweep is one
cooperative launch per call, a block per active cell, which writes new
planes and counts: the wrapper clones nothing, zero-fills nothing, and
reads strided position planes (cell_planes's views) in place.  Each
wrapper counts its calls in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

F32 = np.float32
EPS = float(F32(1e-7))          # SAT separation tolerance of the JAX kernel
TINY = float(F32(1e-12))
TWO_PI = float(F32(2.0 * np.pi))
THIRD = float(F32(1.0 / 3.0))
CENTER = 13                     # (0, 0, 0) in the (dz, dy, dx) window order
MAX_V, MAX_F, MAX_E = 8, 8, 6   # the kernel's table bounds (the JAX gate)
POLY_PROP = 25                  # floats of the poly kernel's proposal per cell


@functools.lru_cache(maxsize=64)
def class_windows(cell_dim, c):
    """Cell ids of parity class c (z, y, x order) and their 27-cell
    windows, (dz, dy, dx) order with dx fastest: host numpy."""
    nx, ny, nz = cell_dim
    pz, py, px = c // 4, (c // 2) % 2, c % 2
    z, y, x = np.meshgrid(np.arange(pz, nz, 2), np.arange(py, ny, 2),
                          np.arange(px, nx, 2), indexing='ij')
    z, y, x = z.reshape(-1), y.reshape(-1), x.reshape(-1)
    act = (z * ny + y) * nx + x
    win = np.empty((len(act), 27), np.int64)
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                win[:, k] = ((((z + dz) % nz) * ny + (y + dy) % ny) * nx
                             + (x + dx) % nx)
                k += 1
    return act, win


def _host_list(a):
    return [int(v) for v in torch.as_tensor(a).reshape(-1).tolist()]


def _f32s(mp):
    return [float(F32(v)) for v in torch.as_tensor(mp).reshape(-1).tolist()]


def _wrap(x, L):
    """x - L floor(x / L + 0.5), with a true divide (L a device tensor)."""
    return x - L * torch.floor(x / L + 0.5)


def _min_image(d, L):
    return d - L * torch.round(d / L)


def _rsqrt_exact(x):
    r = torch.rsqrt(x)
    return r * (1.5 - 0.5 * x * r * r)


def _quat_to_R(w, x, y, z):
    """Rows of R(q), term for term as the JAX kernel writes them."""
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def _gaussians(u1, u2, u3, u4):
    """Box-Muller: two gaussians from (u1, u2) and one from (u3, u4)."""
    r1 = torch.sqrt(-2.0 * torch.log(u1 + TINY))
    g1 = r1 * torch.cos(TWO_PI * u2)
    g2 = r1 * torch.sin(TWO_PI * u2)
    g3 = torch.sqrt(-2.0 * torch.log(u3 + TINY)) * torch.cos(TWO_PI * u4)
    return g1, g2, g3


def _pick(live_act, u_sel):
    """Mover slot per active cell and whether the cell holds any."""
    cnt = live_act.sum(-1)
    ci = cnt.to(torch.int32)
    pick = torch.minimum((u_sel * cnt).to(torch.int32),
                         torch.clamp(ci - 1, min=0)).long()
    return pick, cnt > 0.5


def _gather_slot(p, act, pick):
    """p (..., ncells, C) -> (..., M): slot pick[m] of cell act[m]."""
    rows = p[..., act, :]
    idx = pick.expand(rows.shape[:-1]).unsqueeze(-1)
    return rows.gather(-1, idx).squeeze(-1)


def _prep(planes, live, randu, cell_dim, C, R, nrand):
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    P = torch.stack([p.reshape(nc, C) for p in planes])
    lv = live.reshape(nc, C)
    U = randu.reshape(8 * R, nrand, nc)
    return P, lv, U


def _commit(P, act, pick, raw, new, sel):
    """Slot pick of each active cell <- raw + sel (new - raw)."""
    P[:, act, pick] = raw + sel * (new - raw)


# ---------------------------------------------------------------------------
# plain torch versions


def _count_work(stats, has, cand, **per_pair):
    """Add one sub-sweep's trials and candidate pairs (live window slots
    other than the mover) to ``stats``, and each per-pair count summed
    over those pairs."""
    cand = cand & has[:, None, None]
    stats['trials'] = stats.get('trials', 0) + int(has.sum())
    stats['pairs'] = stats.get('pairs', 0) + int(cand.sum())
    for k, v in per_pair.items():
        stats[k] = stats.get(k, 0) + int(v[cand].sum())


def fused_sphere_sweep_plain(px, py, pz, rad, dmv, live, perms, randu, *,
                             cell_dim, C, R, box_L, stats=None):
    """Plain torch version of fused_sphere_sweep, on any device.  With a
    ``stats`` dict it also counts the work the data needs (trials,
    candidate pairs), for the kernel's bound."""
    dev = px.device
    P, lv, U = _prep((px, py, pz), live, randu, cell_dim, C, R, 6)
    rd, dm = rad.reshape(-1, C), dmv.reshape(-1, C)
    L = torch.tensor(box_L, dtype=torch.float32, device=dev)
    Lv = [L[k] for k in range(3)]
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    n_try = torch.zeros((), dtype=torch.int32, device=dev)
    for s, c in enumerate(_host_list(perms)[:8 * R]):
        act_np, win_np = class_windows(tuple(cell_dim), c)
        act = torch.as_tensor(act_np, device=dev)
        win = torch.as_tensor(win_np, device=dev)
        u = U[s][:, act]                                    # (6, M)
        pick, has = _pick(lv[act], u[0])
        pl = _gather_slot(lv, act, pick)
        raw = _gather_slot(P, act, pick)                    # (3, M)
        mov = raw * pl
        mr = _gather_slot(rd, act, pick) * pl
        md = _gather_slot(dm, act, pick) * pl
        g1, g2, g3 = _gaussians(u[1], u[2], u[3], u[4])
        gn = torch.rsqrt(g1 * g1 + g2 * g2 + g3 * g3 + TINY)
        rball = torch.exp(torch.log(u[5] + TINY) * THIRD)
        step = md * rball * gn
        new = torch.stack([_wrap(mov[k] + g * step, Lv[k])
                           for k, g in enumerate((g1, g2, g3))])
        W = P[:, win]                                       # (3, M, 27, C)
        rr = None
        for k in range(3):
            d = _min_image(new[k][:, None, None] - W[k], Lv[k])
            rr = d * d if rr is None else rr + d * d
        thr = mr[:, None, None] + rd[win]
        cand = lv[win] > 0.5
        cand[torch.arange(len(act_np), device=dev), CENTER, pick] &= ~(pl > 0.5)
        hit = (rr < thr * thr) & cand
        if stats is not None:
            _count_work(stats, has, cand)
        acc = has & ~hit.flatten(1).any(1)
        _commit(P, act, pick, raw, new, pl * acc)
        n_acc = n_acc + acc.sum(dtype=torch.int32)
        n_try = n_try + has.sum(dtype=torch.int32)
    shp = px.shape
    return (P[0].reshape(shp), P[1].reshape(shp), P[2].reshape(shp), n_acc,
            n_try)


@functools.lru_cache(maxsize=8)
def poly_tables_np(tables):
    """(V, F, E) nested tuples -> float32 arrays and the static A-frame
    face supports lo/hi, as the JAX kernel derives them."""
    V = np.asarray(tables[0], np.float32)
    Fn = np.asarray(tables[1], np.float32)
    Ed = np.asarray(tables[2], np.float32)
    projA = Fn @ V.T
    return V, Fn, Ed, projA.min(axis=1), projA.max(axis=1)


def _supports(c0, c1, c2, V):
    """min/max over the vertex table (last dim) of (c0 v0 + c1 v1) + c2 v2."""
    p = (c0.unsqueeze(-1) * V[:, 0] + c1.unsqueeze(-1) * V[:, 1]
         + c2.unsqueeze(-1) * V[:, 2])
    return p.amin(-1), p.amax(-1)


def poly_overlap_plain(dgx, dgy, dgz, RA, qa, qb, tables_t, axes=False):
    """SAT overlap of A (trial mover, rows RA of R(q_A), quaternion qa)
    with B (window slots, quaternion planes qb) at B - A = dg; shapes
    broadcast.  Face axes of A and B, then edge x edge axes, each with
    the 1e-7 tolerance, term for term as the JAX kernel.  With ``axes``
    it also returns how many axes, in that order, each pair needs: up to
    and including the first that separates it, all of them when none
    does."""
    V, Fn, Ed, loF, hiF = tables_t
    drx = RA[0][0] * dgx + RA[1][0] * dgy + RA[2][0] * dgz
    dry = RA[0][1] * dgx + RA[1][1] * dgy + RA[2][1] * dgz
    drz = RA[0][2] * dgx + RA[1][2] * dgy + RA[2][2] * dgz
    qw, qx, qy, qz = qa
    ww, wqx, wqy, wqz = qb
    sw = qw * ww + qx * wqx + qy * wqy + qz * wqz
    sx = qw * wqx - qx * ww - qy * wqz + qz * wqy
    sy = qw * wqy + qx * wqz - qy * ww - qz * wqx
    sz = qw * wqz - qx * wqy + qy * wqx - qz * ww
    S = _quat_to_R(sw, sx, sy, sz)
    S = [[e.unsqueeze(-1) for e in row] for row in S]
    dr = [d.unsqueeze(-1) for d in (drx, dry, drz)]

    def Sv(v):
        return tuple(S[i][0] * v[:, 0] + S[i][1] * v[:, 1] + S[i][2] * v[:, 2]
                     for i in range(3))

    def STc(c0, c1, c2):
        return tuple(S[0][j] * c0 + S[1][j] * c1 + S[2][j] * c2
                     for j in range(3))

    def dot_dr(c0, c1, c2):
        return dr[0] * c0 + dr[1] * c1 + dr[2] * c2

    def separated(loA, hiA, t, loB, hiB):
        return (loA > t + hiB + EPS) | (t + loB > hiA + EPS)

    # A's face normals (static in A's frame)
    t = dot_dr(Fn[:, 0], Fn[:, 1], Fn[:, 2])
    loB, hiB = _supports(*STc(Fn[:, 0], Fn[:, 1], Fn[:, 2]), V)
    seps = [separated(loF, hiF, t, loB, hiB)]
    # B's face normals, mapped into A's frame
    cA = Sv(Fn)
    t = dot_dr(*cA)
    loA, hiA = _supports(*cA, V)
    seps.append(separated(loA, hiA, t, loF, hiF))
    # edge x edge axes: (i_e, j_e) flattened with j_e fastest
    b = [x.unsqueeze(-2) for x in Sv(Ed)]                # (..., 1, NE)
    e = [Ed[:, k].unsqueeze(-1) for k in range(3)]       # (NE, 1)
    cx = e[1] * b[2] - e[2] * b[1]
    cy = e[2] * b[0] - e[0] * b[2]
    cz = e[0] * b[1] - e[1] * b[0]
    cx, cy, cz = (a.flatten(-2) for a in (cx, cy, cz))
    t = dot_dr(cx, cy, cz)
    loA, hiA = _supports(cx, cy, cz, V)
    loB, hiB = _supports(*STc(cx, cy, cz), V)
    seps.append(separated(loA, hiA, t, loB, hiB))
    sep = torch.cat(seps, -1)
    hit = ~sep.any(-1)
    if not axes:
        return hit
    return hit, torch.where(hit, sep.shape[-1], sep.int().argmax(-1) + 1)


def _tables_tensors(tables, dev):
    return tuple(torch.as_tensor(a, device=dev) for a in poly_tables_np(tables))


def fused_poly_sweep_plain(px, py, pz, qw, qx, qy, qz, live, perms, randu,
                           mp, *, cell_dim, C, R, box_L, tables, stats=None):
    """Plain torch version of fused_poly_sweep, on any device.  Returns
    (px', py', pz', qw', qx', qy', qz', counts) with counts int32
    [translate accepts, translate tries, rotate accepts, rotate tries].
    With a ``stats`` dict it also counts the work the data needs:
    trials, candidate pairs, and the face and edge axes each pair needs
    up to its first separating one."""
    dev = px.device
    d_mv, a_mv, m_ratio = _f32s(mp)
    P, lv, U = _prep((px, py, pz, qw, qx, qy, qz), live, randu, cell_dim, C,
                     R, 12)
    tab = _tables_tensors(tables, dev)
    L = torch.tensor(box_L, dtype=torch.float32, device=dev)
    Lv = [L[k] for k in range(3)]
    cnt = torch.zeros((4,), dtype=torch.int32, device=dev)
    for s, c in enumerate(_host_list(perms)[:8 * R]):
        act_np, win_np = class_windows(tuple(cell_dim), c)
        act = torch.as_tensor(act_np, device=dev)
        win = torch.as_tensor(win_np, device=dev)
        (u_sel, u_mr, u1, u2, u3, u4, u_r, a1, a2, a3, a4,
         u_ang) = U[s][:, act]
        pick, has = _pick(lv[act], u_sel)
        pl = _gather_slot(lv, act, pick)
        raw = _gather_slot(P, act, pick)                    # (7, M)
        mx, my, mz, mqw, mqx, mqy, mqz = raw * pl
        g1, g2, g3 = _gaussians(u1, u2, u3, u4)
        gn = _rsqrt_exact(g1 * g1 + g2 * g2 + g3 * g3 + TINY)
        rball = torch.exp(torch.log(u_r + TINY) * THIRD)
        h1, h2, h3 = _gaussians(a1, a2, a3, a4)
        hn = _rsqrt_exact(h1 * h1 + h2 * h2 + h3 * h3 + TINY)
        half = 0.5 * (2.0 * u_ang - 1.0) * a_mv
        dqw = torch.cos(half)
        s_h = torch.sin(half) * hn
        dqx, dqy, dqz = s_h * h1, s_h * h2, s_h * h3
        rot = u_mr > m_ratio
        step = d_mv * rball * gn * (1.0 - rot.float())
        nxp = _wrap(mx + g1 * step, Lv[0])
        nyp = _wrap(my + g2 * step, Lv[1])
        nzp = _wrap(mz + g3 * step, Lv[2])
        rw = dqw * mqw - dqx * mqx - dqy * mqy - dqz * mqz
        rx = dqw * mqx + dqx * mqw + dqy * mqz - dqz * mqy
        ry = dqw * mqy - dqx * mqz + dqy * mqw + dqz * mqx
        rz = dqw * mqz + dqx * mqy - dqy * mqx + dqz * mqw
        rn = _rsqrt_exact(rw * rw + rx * rx + ry * ry + rz * rz + TINY)
        nq = [torch.where(rot, r * rn, m) for r, m in
              ((rw, mqw), (rx, mqx), (ry, mqy), (rz, mqz))]
        new = torch.stack([nxp, nyp, nzp] + nq)             # (7, M)
        nb = [a[:, None, None] for a in new]
        RA = _quat_to_R(*nb[3:])
        W = P[:, win]                                       # (7, M, 27, C)
        dg = [_min_image(W[k] - nb[k], Lv[k]) for k in range(3)]
        hit, nax = poly_overlap_plain(*dg, RA, nb[3:], list(W[3:]), tab,
                                      axes=True)
        cand = lv[win] > 0.5
        cand[torch.arange(len(act_np), device=dev), CENTER, pick] &= ~(pl > 0.5)
        hit = hit & cand
        if stats is not None:
            nf2 = 2 * len(tab[1])
            _count_work(stats, has, cand, face_axes=nax.clamp(max=nf2),
                        edge_axes=(nax - nf2).clamp(min=0))
        acc = has & ~hit.flatten(1).any(1)
        _commit(P, act, pick, raw, new, pl * acc)
        cnt = cnt + torch.stack([(acc & ~rot).sum(), (has & ~rot).sum(),
                                 (acc & rot).sum(),
                                 (has & rot).sum()]).to(torch.int32)
    shp = px.shape
    return tuple(P[k].reshape(shp) for k in range(7)) + (cnt,)


# ---------------------------------------------------------------------------
# wrappers


_LIB = []


def _kernel_lib():
    """The kernel library, built and loaded at the first launch."""
    if not _LIB:
        from ..ops._build import load
        _LIB.append(load())
    return _LIB[0]


def _check(planes, live, perms, randu, cell_dim, C, R, nrand):
    nx, ny, nz = cell_dim
    want = (nz, ny, nx * C)
    for k, p in enumerate(list(planes) + [live]):
        if tuple(p.shape) != want:
            raise ValueError(f"plane {k}: expected shape {want}, got "
                             f"{tuple(p.shape)}")
    if tuple(randu.shape) != (8 * R, nrand, nz, ny, nx):
        raise ValueError(f"randu: expected shape {(8 * R, nrand, nz, ny, nx)}"
                         f", got {tuple(randu.shape)}")
    if torch.as_tensor(perms).numel() < 8 * R:
        raise ValueError(f"perms: need {8 * R} class indices")
    if any(n % 2 for n in cell_dim):
        raise ValueError(f"cell_dim {cell_dim}: the checkerboard needs even "
                         "cell counts on every axis")


def _device_args(planes, live, randu):
    ts = list(planes) + [live, randu]
    if any(t.device.type != 'cuda' for t in ts):
        raise ValueError("kernel inputs must all lie on the CUDA device")
    return [t.contiguous().float() for t in ts]


def _flat_stride(t):
    """The stride s at which flattened element i of t lies (i * s from its
    first element), or None where no single stride does."""
    want = s = t.stride(-1)
    for n, st in zip(reversed(t.shape), reversed(t.stride())):
        if n != 1 and st != want:
            return None
        want *= n
    return s if s > 0 else None


def _strided_planes(planes):
    """The planes as the polyhedron kernel reads them, with their strides
    (a host int32 array): a float32 view on the card whose elements lie
    one stride apart as it is (the planes of hpmc/integrate.py
    cell_planes read every third or fourth float of their gather), any
    other as a contiguous float32 copy."""
    if any(p.device.type != 'cuda' for p in planes):
        raise ValueError("kernel inputs must all lie on the CUDA device")
    out, strides = [], []
    for p in planes:
        s = _flat_stride(p) if p.dtype == torch.float32 else None
        if s is None:
            p, s = p.contiguous().float(), 1
        out.append(p)
        strides.append(s)
    return out, np.asarray(strides, np.int32)


def _perms_host(perms, R):
    p = torch.as_tensor(perms).reshape(-1)[:8 * R]
    if p.device.type != 'cpu':
        raise ValueError("perms must lie on the host")
    return p.to(torch.int32).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_sphere_sweep(px, py, pz, rad, dmv, live, perms, randu, *,
                       cell_dim, C, R, box_L):
    """R rounds x 8 parity sub-sweeps of hard-sphere translation trials.
    px/py/pz/rad/dmv/live: (nz, ny, nx*C) planes; perms (8R,) class
    order on the host; randu (8R, 6, nz, ny, nx) uniforms.  Returns
    (px', py', pz', n_accept, n_try)."""
    planes = (px, py, pz, rad, dmv)
    _check(planes, live, perms, randu, cell_dim, C, R, 6)
    if px.device.type == 'cpu':
        return fused_sphere_sweep_plain(px, py, pz, rad, dmv, live, perms,
                                        randu, cell_dim=cell_dim, C=C, R=R,
                                        box_L=box_L)
    lib = _kernel_lib()
    ins, strides = _strided_planes((px, py, pz))
    r, d, lv, u = _device_args((rad, dmv), live, randu)
    nx, ny, nz = cell_dim
    nslots = nx * ny * nz * C
    buf = torch.empty(3 * nslots, dtype=torch.float32, device=lv.device)
    cnt = torch.empty((2,), dtype=torch.int32, device=lv.device)
    pm = _perms_host(perms, R)
    Lx, Ly, Lz = (float(F32(v)) for v in box_L)
    err = lib.lib.hoomd_hpmc_sphere_sweep(
        *[a.data_ptr() for a in ins], strides.ctypes.data_as(ctypes.c_void_p),
        r.data_ptr(), d.data_ptr(), lv.data_ptr(), u.data_ptr(),
        pm.data_ptr(), 8 * R, buf.data_ptr(), cnt.data_ptr(),
        nx, ny, nz, C, Lx, Ly, Lz, _stream(lv))
    lib.check(err, 'fused_sphere_sweep')
    fused_sphere_sweep.launches += 1
    return buf.view((3,) + tuple(px.shape)).unbind(0) + (cnt[0], cnt[1])


fused_sphere_sweep.launches = 0


@functools.lru_cache(maxsize=8)
def _poly_table_buffer(tables):
    """[nv, nf, ne] and the float tables the kernel takes: V (8x3), F
    (8x3), E (6x3), lo (8), hi (8), zero-padded, as one float32 array."""
    V, Fn, Ed, lo, hi = poly_tables_np(tables)
    if len(V) > MAX_V or len(Fn) > MAX_F or len(Ed) > MAX_E:
        raise NotImplementedError(
            f"shape tables V={len(V)} F={len(Fn)} E={len(Ed)} exceed the "
            f"kernel's {MAX_V}/{MAX_F}/{MAX_E}")
    buf = np.zeros(3 * MAX_V + 3 * MAX_F + 3 * MAX_E + 2 * MAX_F, np.float32)
    o = 0
    for a, n in ((V, 3 * MAX_V), (Fn, 3 * MAX_F), (Ed, 3 * MAX_E),
                 (lo, MAX_F), (hi, MAX_F)):
        flat = a.reshape(-1)
        buf[o:o + flat.size] = flat
        o += n
    return (len(V), len(Fn), len(Ed)), buf


def fused_poly_sweep(px, py, pz, qw, qx, qy, qz, live, perms, randu, mp, *,
                     cell_dim, C, R, box_L, tables):
    """R rounds x 8 parity sub-sweeps of one-type convex polyhedron
    trials: translate or rotate (u > move_ratio rotates), SAT narrow
    phase in the mover's frame.  qw..qz: orientation planes; mp (3,)
    [d, a, move_ratio] on the host; tables (V, F, E) nested tuples.
    Returns (px', py', pz', qw', qx', qy', qz', counts(4,))."""
    planes = (px, py, pz, qw, qx, qy, qz)
    _check(planes, live, perms, randu, cell_dim, C, R, 12)
    if px.device.type == 'cpu':
        return fused_poly_sweep_plain(px, py, pz, qw, qx, qy, qz, live, perms,
                                      randu, mp, cell_dim=cell_dim, C=C, R=R,
                                      box_L=box_L, tables=tables)
    lib = _kernel_lib()
    (nv, nf, ne), tab = _poly_table_buffer(tables)
    ins, strides = _strided_planes(planes)
    lv, u = _device_args((), live, randu)
    nx, ny, nz = cell_dim
    nslots = nx * ny * nz * C
    # the 7 new planes, then the kernel's scratch (a proposal per cell)
    buf = torch.empty(7 * nslots + POLY_PROP * nx * ny * nz,
                      dtype=torch.float32, device=lv.device)
    cnt = torch.empty((4,), dtype=torch.int32, device=lv.device)
    pm = _perms_host(perms, R)
    d_mv, a_mv, m_ratio = _f32s(mp)
    Lx, Ly, Lz = (float(F32(v)) for v in box_L)
    err = lib.lib.hoomd_hpmc_poly_sweep(
        *[a.data_ptr() for a in ins], strides.ctypes.data_as(ctypes.c_void_p),
        lv.data_ptr(), u.data_ptr(),
        pm.data_ptr(), 8 * R, buf.data_ptr(), cnt.data_ptr(),
        tab.ctypes.data_as(ctypes.c_void_p), nv, nf, ne, d_mv, a_mv, m_ratio,
        nx, ny, nz, C, Lx, Ly, Lz, _stream(lv))
    lib.check(err, 'fused_poly_sweep')
    fused_poly_sweep.launches += 1
    return buf[:7 * nslots].view((7,) + tuple(px.shape)).unbind(0) + (cnt,)


fused_poly_sweep.launches = 0

KERNEL_WRAPPERS = (fused_sphere_sweep, fused_poly_sweep)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
