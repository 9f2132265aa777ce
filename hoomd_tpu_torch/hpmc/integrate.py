"""Hard-particle Monte Carlo integrators (counterpart of
hoomd_tpu/hpmc/integrate.py).

The port runs the JAX package's fused checkerboard sweep
(hpmc/sweep.py): hard spheres and one-type convex polyhedra.  A sweep is
``nselect`` kernel calls of R = 1 round each; one call bins the
particles on its own grid of cell width >= diam + 2 R d_max, gathers
(nz, ny, nx*C) planes, draws its randoms, runs 8 parity sub-sweeps of
one trial per active cell, and scatters the planes back to particle
order.  Counters stay on the device and are read only when asked.  A
configuration outside the fused sweep raises NotImplementedError naming
the gate it failed; the JAX package's gather path is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context
from ..ops import cells as cells_ops
from ..ops import quat as Q
from . import data
from . import sweep as sweep_ops

R_ROUNDS = 1              # rounds per kernel call (and per re-bin)
MAX_GRID = 32             # cells per axis, as the JAX planner caps them
SALT_SPHERE, SALT_POLY = 31, 37
_MASK64 = (1 << 64) - 1


def _stream_key(*parts):
    """A 63-bit generator seed from integers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


def draw_randoms(seed, timestep, kcall, R, nrand, cell_dim, device, salt):
    """The randoms of one kernel call, keyed by (seed, salt, timestep,
    call): ``perms`` (8R,) int32 class orders from a CPU generator, so
    the host knows each sub-sweep's class without a sync, and ``randu``
    (8R, nrand, nz, ny, nx) uniforms in [0, 1) from a generator on
    ``device``.  The layout is the JAX package's, so a test can hand the
    sweep that package's draws in place of these."""
    nx, ny, nz = cell_dim
    key = _stream_key(seed, salt, timestep, kcall)
    g = torch.Generator().manual_seed(key)
    perms = torch.cat([torch.randperm(8, generator=g)
                       for _ in range(R)]).to(torch.int32)
    gd = torch.Generator(device=device).manual_seed(key)
    randu = torch.rand((8 * R, nrand, nz, ny, nx), generator=gd,
                       device=device)
    return perms, randu


class interaction_matrix:
    """Per-type-pair overlap-check enables (``mc.overlap_checks``).
    Pairs default to enabled.  The fused sweep tests every pair, so it
    gates out a matrix that disables any; count_overlaps honours it."""

    def __init__(self, mc):
        self._mc = mc
        self._enables = {}

    @staticmethod
    def _key(a, b):
        return (a, b) if a <= b else (b, a)

    def set(self, a, b, enable):
        self._enables[self._key(a, b)] = bool(enable)
        self._mc._dirty()

    def get(self, a, b):
        return self._enables.get(self._key(a, b), True)

    def matrix(self, types):
        """(T, T) boolean numpy matrix in the given type order."""
        m = np.ones((len(types), len(types)), bool)
        for i, a in enumerate(types):
            for j, b in enumerate(types):
                m[i, j] = self.get(a, b)
        return m


def cell_planes(pos, box, cell_dim, C, quat=None):
    """Bin particles on the fused grid and gather their (nz, ny, nx*C)
    planes, as hoomd_tpu/hpmc/integrate.py:956-970 does: slots hold
    particles in index order as a live prefix, padding slots hold zeros
    (and the identity quaternion).  Returns (idx, live, planes,
    overflow): idx (ncells*C,) the particle of each slot (N for
    padding), planes [x, y, z] or, with ``quat``, [x, y, z, qw, qx, qy,
    qz]."""
    N = pos.shape[0]
    nx, ny, nz = cell_dim
    shp = (nz, ny, nx * C)
    _, cell_list, ovf = cells_ops.bin_particles(pos, box, cell_dim, C)
    idx = cell_list.reshape(-1).long()
    live = (idx < N).to(pos.dtype).reshape(shp)
    pc = torch.cat([pos, pos.new_zeros((1, 3))])[idx]
    planes = [pc[:, k].reshape(shp) for k in range(3)]
    if quat is not None:
        q_pad = quat.new_zeros((1, 4))
        q_pad[:, 0] = 1.0                   # identity, made on the device
        qc = torch.cat([quat, q_pad])[idx]
        planes += [qc[:, k].reshape(shp) for k in range(4)]
    return idx, live, planes, ovf


def _scatter_rows(a, idx, rows, N):
    """a with a[idx[k]] = rows[k] wherever idx[k] < N (padding slots hold
    N and land on a dropped extra row)."""
    ext = torch.cat([a, a.new_zeros((1, a.shape[1]))])
    ext[idx] = rows
    return ext[:N]


class mode_hpmc:
    """Base HPMC integrator (reference IntegratorHPMC)."""

    def __init__(self, seed, d=0.1, a=0.1, move_ratio=0.5, nselect=4,
                 implicit=False):
        self.seed = int(seed)
        self.move_ratio = float(move_ratio)
        self.nselect = int(nselect)
        self.implicit = bool(implicit)
        self.nR = 0.0
        self.depletant_type = None
        self.ntrial = 1
        self._default_d = float(d)
        self._default_a = float(a)
        self.d_by_type = {}
        self.a_by_type = {}
        self.shape_param = data.param_dict(self)
        self.overlap_checks = interaction_matrix(self)
        context.current.system.set_hpmc_integrator(self)

    def _dirty(self):
        context.current.system._dirty()

    def set_params(self, d=None, a=None, move_ratio=None, nselect=None,
                   nR=None, depletant_type=None, ntrial=None):
        """Move sizes and ratio, nselect, and the implicit-depletant
        parameters (accepted as the JAX package does; a program with
        depletants is gated out when it is built)."""
        if nR is not None:
            if not self.implicit:
                raise RuntimeError("hpmc: nR requires an integrator "
                                   "constructed with implicit=True")
            if (self.nR > 0) != (float(nR) > 0):
                self._dirty()
            self.nR = float(nR)
        if depletant_type is not None:
            if not self.implicit:
                raise RuntimeError(
                    "hpmc: depletant_type requires implicit=True")
            if self.depletant_type != str(depletant_type):
                self._dirty()
            self.depletant_type = str(depletant_type)
        if ntrial is not None:
            self.ntrial = int(ntrial)
        return self._set_move_params(d=d, a=a, move_ratio=move_ratio,
                                     nselect=nselect)

    def get_nR(self):
        return self.nR

    def get_depletant_type(self):
        return self.depletant_type

    def get_ntrial(self):
        return self.ntrial

    def _set_move_params(self, d=None, a=None, move_ratio=None,
                         nselect=None):
        if d is not None:
            if isinstance(d, dict):
                self.d_by_type.update(d)
            else:
                self._default_d = float(d)
        if a is not None:
            if isinstance(a, dict):
                self.a_by_type.update(a)
            else:
                self._default_a = float(a)
        if move_ratio is not None:
            self.move_ratio = float(move_ratio)
        if nselect is not None:
            self.nselect = int(nselect)
            self._dirty()               # the calls per sweep
            return
        # move sizes are read at every run; only a d grown past the
        # stencil width the grid was built for needs a new grid
        built = getattr(self, '_built_d', None)
        if built is None:
            self._dirty()
            return
        if d is not None and any(self.get_d(t) > built.get(t, 0.0)
                                 for t in built):
            self._dirty()

    def get_d(self, type_name=None):
        return self.d_by_type.get(type_name, self._default_d)

    def get_a(self, type_name=None):
        return self.a_by_type.get(type_name, self._default_a)

    def get_counters(self):
        """Move counters (one device read)."""
        c = context.current.system._hpmc_counters
        if c is None:
            return {}
        m = torch.cat([c['moves'], c['cell_overflow'].to(torch.int32)[None]]
                      ).cpu().tolist()
        return {'translate_accept': m[0], 'translate_reject': m[1] - m[0],
                'rotate_accept': m[2], 'rotate_reject': m[3] - m[2],
                'cell_overflow': m[4]}

    def get_translate_acceptance(self):
        c = self.get_counters()
        n = c.get('translate_accept', 0) + c.get('translate_reject', 0)
        return c['translate_accept'] / n if n else 0.0

    def get_rotate_acceptance(self):
        c = self.get_counters()
        n = c.get('rotate_accept', 0) + c.get('rotate_reject', 0)
        return c['rotate_accept'] / n if n else 0.0

    # -- subclass interface -------------------------------------------------
    def _interaction_diameter(self, system):
        """Max center-to-center distance at which two shapes can overlap."""
        raise NotImplementedError

    def _overlap_pairs(self, system, dr, ti, tj, qi, qj):
        """bool (P,): do the shapes of pairs at dr = x_i - x_j overlap."""
        raise NotImplementedError

    def _fused_radii(self, system):
        """Per-type radii for the sphere sweep; None when not spheres."""
        return None

    def _fused_poly_tables(self, system):
        """(V, F, E) hull tables for the polyhedron sweep; raises
        NotImplementedError naming the gate when the shape is outside
        it, None when not a polyhedron."""
        return None

    # -- validity -------------------------------------------------------------
    def count_overlaps(self, system=None):
        """Number of overlapping pairs in the current configuration
        (reference IntegratorHPMCMono::countOverlaps).  All pairs in
        blocks of rows, pre-filtered by the interaction diameter (an
        exact bound), then the shape's own overlap test in plain torch:
        independent of the sweep kernels."""
        system = system or context.current.system
        st = system.state
        N = st.N
        dev = st.pos.device
        types = system.particle_types
        enabled = torch.as_tensor(self.overlap_checks.matrix(types),
                                  device=dev)
        reach = float(self._interaction_diameter(system))
        reach2 = (reach * (1.0 + 1e-6)) ** 2
        tid = st.typeid.long()
        q = st.orientation
        cols = torch.arange(N, device=dev)
        B = 256
        total = 0
        for r0 in range(0, N, B):
            rows = cols[r0:r0 + B]
            dr = st.box.min_image(st.pos[rows][:, None, :]
                                  - st.pos[None, :, :])
            near = ((dr * dr).sum(-1) <= reach2) & (rows[:, None]
                                                    < cols[None, :])
            li, j = torch.nonzero(near, as_tuple=True)
            if li.numel() == 0:
                continue
            i = rows[li]
            hit = self._overlap_pairs(system, dr[li, j], tid[i], tid[j],
                                      q[i], q[j])
            total += int((hit & enabled[tid[i], tid[j]]).sum())
        return total

    # -- program construction (called by System) -----------------------------
    def _decline(self, why):
        raise NotImplementedError(
            f"hoomd_tpu_torch runs HPMC on the fused checkerboard sweep "
            f"only, and this configuration is outside it: {why}")

    def _plan(self, system):
        """The fused grid, as hoomd_tpu/hpmc/integrate.py:921-939 plans
        it: cell width w_f = diam + 2 R d_max, at most 32 cells per axis,
        an even count on each, and C = max(4, ceil(2 N / ncells) + 4,
        the grown capacity)."""
        st = system.state
        L = st.box.L.cpu().numpy()
        d_max = float(np.max([self.get_d(t) for t in system.particle_types]))
        diam = self._interaction_diameter(system)
        w_f = diam + 2.0 * d_max * R_ROUNDS
        cd = [min(c, MAX_GRID) for c in cells_ops.choose_cell_dim(L, w_f, 3)]
        cd = [max(2, 2 * (c // 2)) for c in cd]
        if not all(L[ax] / cd[ax] >= w_f - 1e-9 for ax in range(3)):
            self._decline(f"box {tuple(float(v) for v in L)} too small for "
                          f"2 fused cells of width {w_f:.4f} per axis")
        ncells = int(np.prod(cd))
        C = max(4, int(np.ceil(st.N / ncells * 2.0)) + 4,
                system._grow.get('hpmc_cell_cap', 0))
        return {'cell_dim': tuple(cd), 'C': C, 'w_f': w_f}

    def _gates(self, system):
        st = system.state
        if st.box.dimensions != 3:
            self._decline('2D box')
        if self.implicit and self.nR > 0 and self.depletant_type is not None:
            self._decline('implicit depletants')
        if float(st.box.tilt.abs().max()) > 1e-12:
            self._decline('tilted box (the sweep is orthorhombic)')
        if not self.overlap_checks.matrix(system.particle_types).all():
            self._decline('overlap_checks disables a type pair')
        if self.nselect < 1:
            self._decline(f'nselect={self.nselect}')

    def _build_program(self, system):
        self._gates(system)
        radii = self._fused_radii(system)
        tables = self._fused_poly_tables(system) if radii is None else None
        if radii is None and tables is None:
            self._decline(f'shape {type(self).__name__}')
        plan = self._plan(system)
        types = list(system.particle_types)
        self._built_d = {t: self.get_d(t) for t in types}
        st = system.state
        N = st.N
        dev = st.pos.device
        cell_dim, C = plan['cell_dim'], plan['C']
        nx, ny, nz = cell_dim
        shp = (nz, ny, nx * C)
        box_L = tuple(float(v) for v in st.box.L.cpu().numpy())
        n_kernels = -(-self.nselect // R_ROUNDS)
        kw = dict(cell_dim=cell_dim, C=C, R=R_ROUNDS, box_L=box_L)
        mc = self

        if tables is not None:
            def pack():
                t = types[0]
                return tuple(float(np.float32(v)) for v in
                             (mc.get_d(t), mc.get_a(t), mc.move_ratio))

            def sweep(state, moves, mp):
                pos, quat = state.pos, state.orientation
                ovf = torch.zeros((), dtype=torch.bool, device=dev)
                for kcall in range(n_kernels):
                    idx, live, planes, o = cell_planes(pos, state.box,
                                                       cell_dim, C, quat)
                    ovf = ovf | o
                    perms, randu = draw_randoms(
                        mc.seed, state.timestep, kcall, R_ROUNDS, 12,
                        cell_dim, dev, SALT_POLY)
                    out = sweep_ops.fused_poly_sweep(
                        *planes, live, perms, randu, mp,
                        tables=tables, **kw)
                    moves = moves + out[7]
                    pos = _scatter_rows(pos, idx, torch.stack(
                        [out[k].reshape(-1) for k in range(3)], -1), N)
                    quat = _scatter_rows(quat, idx, torch.stack(
                        [out[3 + k].reshape(-1) for k in range(4)], -1), N)
                return (state.replace(pos=pos, orientation=quat,
                                      timestep=state.timestep + 1),
                        moves, ovf)
        else:
            radii_t = torch.as_tensor(np.asarray(radii, np.float32),
                                      device=dev)

            def pack():
                return torch.as_tensor(
                    np.asarray([mc.get_d(t) for t in types], np.float32),
                    device=dev)

            def sweep(state, moves, d_t):
                pos = state.pos
                t_pad = torch.cat([state.typeid.long(),
                                   state.typeid.new_zeros(1).long()])
                ovf = torch.zeros((), dtype=torch.bool, device=dev)
                zero2 = torch.zeros((2,), dtype=torch.int32, device=dev)
                for kcall in range(n_kernels):
                    idx, live, planes, o = cell_planes(pos, state.box,
                                                       cell_dim, C)
                    ovf = ovf | o
                    if len(types) == 1:
                        rad = radii_t[0] * live
                        dmv = d_t[0] * live
                    else:
                        tc = t_pad[idx].reshape(shp)
                        rad = radii_t[tc] * live
                        dmv = d_t[tc] * live
                    perms, randu = draw_randoms(
                        mc.seed, state.timestep, kcall, R_ROUNDS, 6,
                        cell_dim, dev, SALT_SPHERE)
                    npx, npy, npz, na, nt = sweep_ops.fused_sphere_sweep(
                        *planes, rad, dmv, live, perms, randu, **kw)
                    moves = moves + torch.cat([torch.stack([na, nt]).to(
                        torch.int32), zero2])
                    pos = _scatter_rows(pos, idx, torch.stack(
                        [npx.reshape(-1), npy.reshape(-1),
                         npz.reshape(-1)], -1), N)
                return (state.replace(pos=pos, timestep=state.timestep + 1),
                        moves, ovf)

        def init_counters():
            return {'moves': torch.zeros((4,), dtype=torch.int32,
                                         device=dev),
                    'cell_overflow': torch.zeros((), dtype=torch.bool,
                                                 device=dev)}

        return {'sweep': sweep, 'pack': pack, 'init_counters': init_counters,
                'cell_dim': cell_dim, 'C': C, 'R': R_ROUNDS,
                'n_kernels': n_kernels, 'box_L': box_L,
                'shape': 'sphere' if tables is None else 'convex_polyhedron'}


class sphere(mode_hpmc):
    """Hard spheres (reference hpmc/integrate.py sphere, ShapeSphere.h).
    shape_param.set('A', diameter=1.0)."""

    def __init__(self, seed, d=0.1, nselect=4, implicit=False,
                 move_ratio=0.5):
        mode_hpmc.__init__(self, seed, d=d, nselect=nselect,
                           move_ratio=move_ratio, implicit=implicit)

    def _diameters(self, system):
        return np.array([float(self.shape_param[t].get('diameter', 1.0))
                         for t in system.particle_types])

    def _interaction_diameter(self, system):
        return float(self._diameters(system).max())

    def _fused_radii(self, system):
        return 0.5 * self._diameters(system)

    def _overlap_pairs(self, system, dr, ti, tj, qi, qj):
        d_t = torch.as_tensor(self._diameters(system), dtype=dr.dtype,
                              device=dr.device)
        rsum = 0.5 * (d_t[ti] + d_t[tj])
        return (dr * dr).sum(-1) < rsum * rsum


def _hull_data(verts):
    """Host-side convex hull features: the hull's vertices, unique face
    normals and edge directions (deduplicated up to sign), as
    hoomd_tpu/hpmc/integrate.py:1188 derives them."""
    from scipy.spatial import ConvexHull
    v = np.asarray(verts, dtype=float)
    hull = ConvexHull(v)
    normals = hull.equations[:, :3]
    normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)

    def dedupe(rows):
        out = []
        for r in rows:
            if not any(np.allclose(r, o, atol=1e-9)
                       or np.allclose(r, -o, atol=1e-9) for o in out):
                out.append(r)
        return np.array(out)
    normals = dedupe(normals)
    # true hull edges only: an edge shared by two coplanar triangles of
    # Qhull's triangulation is a face diagonal, not an edge
    edge_owners = {}
    for si, simplex in enumerate(hull.simplices):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            e = tuple(sorted((simplex[a], simplex[b])))
            edge_owners.setdefault(e, []).append(si)
    raw = hull.equations[:, :3]
    raw = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    edges = [e for e, owners in edge_owners.items()
             if not (len(owners) == 2
                     and np.allclose(raw[owners[0]], raw[owners[1]],
                                     atol=1e-7))]
    evecs = np.array([v[b] - v[a] for a, b in edges])
    evecs = evecs / np.linalg.norm(evecs, axis=1, keepdims=True)
    return v[hull.vertices], normals, dedupe(evecs)


class convex_polyhedron(mode_hpmc):
    """Hard convex polyhedra (reference hpmc.integrate.convex_polyhedron,
    ShapeConvexPolyhedron.h) with separating-axis overlap tests.
    shape_param.set('A', vertices=[(x,y,z), ...])."""

    def __init__(self, seed, d=0.1, a=0.1, move_ratio=0.5, nselect=4,
                 implicit=False, max_verts=None):
        mode_hpmc.__init__(self, seed, d=d, a=a, move_ratio=move_ratio,
                           nselect=nselect, implicit=implicit)

    def _vertices(self, system, t):
        verts = self.shape_param[t].get('vertices')
        if verts is None:
            raise RuntimeError(f"convex_polyhedron: no vertices set for "
                               f"type {t!r}")
        return verts

    def _shape_tables(self, system):
        """Per-type (V, F, E) float32 tables, each padded with repeats of
        its first row so supports stay exact."""
        hulls = [_hull_data(self._vertices(system, t))
                 for t in system.particle_types]
        out = []
        for k in range(3):
            n = max(len(h[k]) for h in hulls)
            tab = np.zeros((len(hulls), n, 3))
            for i, h in enumerate(hulls):
                tab[i, :len(h[k])] = h[k]
                tab[i, len(h[k]):] = h[k][0]
            out.append(tab.astype(np.float32))
        return out

    def _interaction_diameter(self, system):
        r = max(float(np.linalg.norm(np.asarray(self._vertices(system, t)),
                                     axis=1).max())
                for t in system.particle_types)
        return 2.0 * r

    def _fused_poly_tables(self, system):
        types = system.particle_types
        if len(types) != 1:
            self._decline(f'convex_polyhedron with {len(types)} types '
                          f'(the fused sweep takes 1)')
        v, f, e = _hull_data(self._vertices(system, types[0]))
        if (len(v) > sweep_ops.MAX_V or len(f) > sweep_ops.MAX_F
                or len(e) > sweep_ops.MAX_E):
            self._decline(f'hull with V={len(v)} F={len(f)} E={len(e)} '
                          f'(the fused sweep takes V <= {sweep_ops.MAX_V}, '
                          f'F <= {sweep_ops.MAX_F}, E <= {sweep_ops.MAX_E})')
        return (tuple(map(tuple, v.tolist())), tuple(map(tuple, f.tolist())),
                tuple(map(tuple, e.tolist())))

    def _overlap_pairs(self, system, dr, ti, tj, qi, qj):
        """Separating-axis test over the face normals of both shapes and
        the edge cross products, A at dr and B at the origin, with the
        1e-7 tolerance of hoomd_tpu/hpmc/integrate.py:1332-1382."""
        V, Fn, E = (torch.as_tensor(a, device=dr.device)
                    for a in self._shape_tables(system))
        qa, qb = qi[:, None, :], qj[:, None, :]
        vi, vj = Q.rotate(qa, V[ti]), Q.rotate(qb, V[tj])      # (P, NV, 3)
        ei, ej = Q.rotate(qa, E[ti]), Q.rotate(qb, E[tj])      # (P, NE, 3)
        cross = torch.linalg.cross(
            *torch.broadcast_tensors(ei[:, :, None, :], ej[:, None, :, :]),
            dim=-1).flatten(1, 2)
        axes = torch.cat([Q.rotate(qa, Fn[ti]), Q.rotate(qb, Fn[tj]),
                          cross], 1)                           # (P, NA, 3)
        pa = (axes[:, :, None, :] * vi[:, None, :, :]).sum(-1)
        pb = (axes[:, :, None, :] * vj[:, None, :, :]).sum(-1)
        da = (axes * dr[:, None, :]).sum(-1)
        a_lo, a_hi = pa.amin(-1) + da, pa.amax(-1) + da
        b_lo, b_hi = pb.amin(-1), pb.amax(-1)
        sep = (a_lo > b_hi + 1e-7) | (b_lo > a_hi + 1e-7)
        return ~sep.any(-1)


def _not_ported(name):
    class shape(mode_hpmc):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"hpmc.integrate.{name}: hoomd_tpu_torch ports the fused "
                f"sweep for sphere and convex_polyhedron only")
    shape.__name__ = shape.__qualname__ = name
    return shape


ellipsoid = _not_ported('ellipsoid')
sphere_union = _not_ported('sphere_union')
sphinx = _not_ported('sphinx')
convex_polygon = _not_ported('convex_polygon')
simple_polygon = _not_ported('simple_polygon')
convex_spheropolyhedron = _not_ported('convex_spheropolyhedron')
convex_spheropolygon = _not_ported('convex_spheropolygon')
convex_polyhedron_union = _not_ported('convex_polyhedron_union')
polyhedron = _not_ported('polyhedron')
faceted_sphere = _not_ported('faceted_sphere')
