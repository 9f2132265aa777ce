"""Long-range electrostatics: PPPM (counterpart of hoomd_tpu/md/charge.py).

The smooth-PME formulation of the JAX package: cardinal B-spline charge
assignment of order 1..7, the k-space solve with torch.fft on complex64
(the Green's function with the B-spline deconvolution, 3 inverse FFTs
for the ik-differentiated field), interpolation back to the particles,
and per-particle energy q_i phi(r_i)/2 plus the self and neutralizing
background terms.  The real-space part is md.pair.ewald, which set_params
attaches on the solver's neighbour list (named 'pppm_real'), as in the
reference.

The mesh is plain torch on the card as in the JAX package, which computes
it in XLA outside any Pallas kernel.  Assignment and interpolation take
one of the JAX package's two formulations (hoomd_tpu/md/charge.py:250):
with N Nx Ny <= 2^25 the dense one: per-axis (N, K) weight matrices from
one-hot products and the charge density and the fields as matrix
products; else the scatter (index_add_) and the gather.  The dense
products must run in full float32: B-spline weights rounded to a few
mantissa bits heated the JAX package's charged fluid into divergence on
its TPU (charge.py:275-283), and TF32 on the card keeps 10 bits.
hoomd_tpu_torch._config turns TF32 off at import
(torch.backends.cuda.matmul.allow_tf32 = False,
torch.set_float32_matmul_precision('highest')); the solver's
construction raises if a caller has turned it back on, rather than
change the process's settings behind its back.  The dense side also sums
in a fixed order, while index_add_ on the card adds with atomics, whose
order varies from run to run.

Not ported: the neighbour-list exclusion correction (the k-space erf
part of bonded pairs), which needs bonded topology that the port still
refuses.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import context
from ..operation import Force

# the dense formulation's gate, N Nx Ny <= 2^25 (hoomd_tpu/md/charge.py:250)
DENSE_MAX = 1 << 25


def _bspline_weights(u, order):
    """Cardinal B-spline M_p weights of positions u (any shape) in grid
    units: (mesh points (..., p) int64, weights (..., p)), mesh point m =
    floor(u) - k with weight M_p(u - m), k = 0..p-1."""
    base = torch.floor(u).to(torch.int64)
    m = base[..., None] - torch.arange(order, device=u.device)
    x = u[..., None] - m.to(u.dtype)
    return m, _eval_mn(x, order)


def _eval_mn(x, n):
    """M_n(x) by the recursion M_n(x) = [x M_{n-1}(x) + (n - x)
    M_{n-1}(x - 1)] / (n - 1), M_1 = 1 on [0, 1), level by level: the
    arguments x - j come from successive subtractions of 1, as the
    recursion forms them, so every value rounds as the JAX package's
    unrolled recursion rounds it, in n (n + 1) / 2 evaluations instead
    of 2^n - 1."""
    xs = [x]
    for _ in range(n - 1):
        xs.append(xs[-1] - 1)
    X = torch.stack(xs, dim=-1)                        # (..., n): x - j
    M = ((X >= 0) & (X < 1)).to(x.dtype)               # M_1(x - j)
    for k in range(2, n + 1):
        w = n - k + 1
        Xk = X[..., :w]
        M = (Xk * M[..., :w] + (k - Xk) * M[..., 1:w + 1]) / (k - 1)
    return M[..., 0]


def _bspline_moduli(mesh_n, order):
    """|b(m)|^-2 deconvolution factors of one axis (host numpy, float64):
    b(m) = exp(2 pi i (p-1) m / K) / sum_{k=0}^{p-2} M_p(k+1)
    exp(2 pi i m k / K), zeros (even order at Nyquist) filled from their
    neighbours."""
    k = np.arange(1, order)

    def Mp(x, n):
        if n == 1:
            return np.where((x >= 0) & (x < 1), 1.0, 0.0)
        return (x * Mp(x, n - 1) + (n - x) * Mp(x - 1, n - 1)) / (n - 1)
    mvals = Mp(k.astype(float), order)
    m = np.arange(mesh_n)
    phase = np.exp(2j * np.pi * np.outer(m, k) / mesh_n)
    mod2 = np.abs(phase @ mvals) ** 2
    small = mod2 < 1e-7
    if small.any():
        mod2[small] = 0.5 * (np.roll(mod2, 1)[small]
                             + np.roll(mod2, -1)[small])
    return 1.0 / mod2


def mesh_compute(pos, q, box, params, want_pv=True, *, mesh, order):
    """The k-space part on any (M, 3) / (M,) layout: padding rows ride
    along with q = 0 and receive zero force and energy.  ``params`` is
    pppm._pack_params's {'kappa', 'bmod', 'mvec'}.  Returns (F (M, 3),
    pe (M,), virial (M, 6)); without want_pv the potential's inverse FFT
    and interpolation are skipped and pe, virial are zero."""
    Nx, Ny, Nz = mesh
    rdt = pos.dtype
    dev = pos.device
    N = pos.shape[0]
    L = box.L
    V = box.volume()
    kappa = params['kappa']
    mx, my, mz = params['mvec']
    bx, by, bz = params['bmod']
    dense = N * Nx * Ny <= DENSE_MAX

    # -- charge assignment -------------------------------------------------
    f = box.make_fraction(pos)
    g = f - torch.floor(f)
    u = torch.stack([g[:, 0] * Nx, g[:, 1] * Ny, g[:, 2] * Nz], dim=-1)
    pm, w = _bspline_weights(u, order)                   # (N, 3, p) each
    pmx = torch.remainder(pm[:, 0], Nx)
    pmy = torch.remainder(pm[:, 1], Ny)
    pmz = torch.remainder(pm[:, 2], Nz)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    if dense:
        def dense_w(pm, w, n):
            # the one-hot product sum_p onehot(pm)[n, p, k] w[n, p]; the
            # p mesh points of a row are distinct, so it is exact
            oh = (pm[..., None] == torch.arange(n, device=dev)).to(rdt)
            return torch.bmm(w[:, None, :], oh)[:, 0]
        Wx = dense_w(pmx, wx, Nx)
        Wy = dense_w(pmy, wy, Ny)
        Wz = dense_w(pmz, wz, Nz)
        TW = (Wx[:, :, None] * Wy[:, None, :]).reshape(N, Nx * Ny)
        rho = ((TW * q[:, None]).T @ Wz).reshape(Nx, Ny, Nz)
    else:
        w3 = (wx[:, :, None, None] * wy[:, None, :, None]
              * wz[:, None, None, :])
        idx = ((pmx[:, :, None, None] * Ny + pmy[:, None, :, None]) * Nz
               + pmz[:, None, None, :])
        flat_idx = idx.reshape(N, -1)
        flat_w = w3.reshape(N, -1)
        rho = torch.zeros((Nx * Ny * Nz,), dtype=rdt, device=dev)
        rho.index_add_(0, flat_idx.reshape(-1),
                       (q[:, None] * flat_w).reshape(-1))
        rho = rho.reshape(Nx, Ny, Nz)

    # -- k-space solve -------------------------------------------------------
    rho_k = torch.fft.fftn(rho)
    kx = (2.0 * math.pi / L[0]) * mx
    ky = (2.0 * math.pi / L[1]) * my
    kz = (2.0 * math.pi / L[2]) * mz
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    decon = bx[:, None, None] * by[None, :, None] * bz[None, None, :]
    pos_k = k2 > 0
    green = torch.where(
        pos_k,
        (4.0 * math.pi / torch.where(pos_k, k2, 1.0))
        * torch.exp(-k2 / (4.0 * kappa ** 2)) * decon / V, 0.0)
    phi_k = green * rho_k
    scale = Nx * Ny * Nz

    def interp(field):
        """Mesh field -> per-particle values (the transpose of the
        assignment)."""
        if dense:
            P1 = field.reshape(Nx * Ny, Nz) @ Wz.T              # (XY, N)
            return (TW * P1.T).sum(1)
        return (field.reshape(-1)[flat_idx] * flat_w).sum(1)

    if want_pv:
        phi = torch.fft.ifftn(phi_k).real * scale
        pe = 0.5 * q * interp(phi)
    # E = -grad(phi): E_hat = -i k phi_hat; F = q E
    E = [interp(torch.fft.ifftn(-1j * kk * phi_k).real * scale)
         for kk in (kx[:, None, None], ky[None, :, None], kz[None, None, :])]
    force = q[:, None] * torch.stack(E, dim=-1)
    if not want_pv:
        return (force, torch.zeros((N,), dtype=rdt, device=dev),
                torch.zeros((N, 6), dtype=rdt, device=dev))

    # -- self energy and neutralizing background -----------------------------
    pe = pe - kappa / math.sqrt(math.pi) * q * q
    pe = pe - math.pi / (2.0 * kappa ** 2 * V) * q * q.sum()

    # -- k-space virial (global, shared by q_i^2) ----------------------------
    pref = green * rho_k.abs() ** 2 / 2.0
    kfac = torch.where(pos_k, 2.0 * (1.0 / torch.where(pos_k, k2, 1.0)
                                     + 1.0 / (4.0 * kappa ** 2)), 0.0)
    kxx, kyy, kzz = kx[:, None, None], ky[None, :, None], kz[None, None, :]
    vir_global = torch.stack([
        (pref * (delta - kfac * a * b)).sum()
        for a, b, delta in ((kxx, kxx, 1.0), (kxx, kyy, 0.0),
                            (kxx, kzz, 0.0), (kyy, kyy, 1.0),
                            (kyy, kzz, 0.0), (kzz, kzz, 1.0))])
    qsum2 = (q * q).sum()
    share = torch.where(qsum2 > 0, q * q / qsum2, 0.0)
    virial = share[:, None] * vir_global[None, :]
    return force, pe, virial


class pppm(Force):
    """PPPM Coulomb solver (reference md/charge.py pppm)."""

    def __init__(self, group, nlist):
        Force.__init__(self, None)
        self.group = group
        self._pair_nlist = nlist
        self._params_set = False
        self._ewald_pair = None
        context.current.system.add_force(self)

    def set_params(self, Nx, Ny, Nz, order, rcut, kappa=None, alpha=0.0):
        """Mesh, assignment order (1..7) and the real-space cutoff; kappa
        defaults to 3.2 / rcut (erfc(kappa rc)/rc ~ 1e-5, the JAX
        package's choice).  Attaches the real-space pair.ewald."""
        if order < 1 or order > 7:
            raise ValueError("pppm order must be in 1..7")
        self.mesh = (int(Nx), int(Ny), int(Nz))
        self.order = int(order)
        self.rcut = float(rcut)
        self.kappa = float(kappa) if kappa else 3.2 / self.rcut
        self._params_set = True
        from . import pair as md_pair
        sys_ = context.current.system
        if self._ewald_pair is None:
            self._ewald_pair = md_pair.ewald(r_cut=self.rcut,
                                             nlist=self._pair_nlist,
                                             name='pppm_real')
        types = sys_.particle_types
        self._ewald_pair.pair_coeff.set(types, types, kappa=self.kappa)
        sys_._dirty()

    def disable(self):
        Force.disable(self)
        if self._ewald_pair:
            self._ewald_pair.disable()

    def enable(self):
        Force.enable(self)
        if self._ewald_pair:
            self._ewald_pair.enable()

    def _rcut_matrix(self, types):
        return np.zeros((len(types), len(types)))

    def _pack_params(self, system):
        """{'kappa': (), 'bmod': three (K,), 'mvec': three (K,)} float32
        tensors on the system's device: kappa, each axis' B-spline
        deconvolution factors and its signed wave numbers in FFT order."""
        if not self._params_set:
            raise RuntimeError("pppm: call set_params(Nx, Ny, Nz, order, "
                               "rcut) before run()")

        def T(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=system.device)
        return {'kappa': T(self.kappa),
                'bmod': tuple(T(_bspline_moduli(n, self.order))
                              for n in self.mesh),
                'mvec': tuple(T(np.fft.fftfreq(n) * n) for n in self.mesh)}

    def _make_compute(self, system):
        """The mesh hook the engine calls: mesh_compute bound to this
        solver's mesh and order.  Raises if float32 matrix products may
        round to TF32 (see the module docstring)."""
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != 'highest'):
            raise RuntimeError(
                "pppm needs full-float32 matrix products: TF32 was turned "
                "on after hoomd_tpu_torch was imported (set torch.backends"
                ".cuda.matmul.allow_tf32 = False and torch.set_float32_"
                "matmul_precision('highest'))")
        self._mesh_compute = functools.partial(mesh_compute, mesh=self.mesh,
                                               order=self.order)
        return self._mesh_compute
