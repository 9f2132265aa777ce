// 27-cell LJ stencil shared by the cell kernels (cell_pair.cu,
// cell_pair_impls.cu).
//
// It computes what the TPU kernels of hoomd_tpu/ops/pallas_pair.py
// compute (_kernel_plane, _kernel_planar, the force pass of
// _kernel_megastep): for every particle of a home cell, the LJ force
// (and, when asked, the half-pair energy and virial) against every
// particle of the 27 surrounding cells, each neighbour cell carrying the
// periodic image shift of build_cell_shifts.  It does not copy their
// plane windows or lane rolls.
//
// Layout: one thread block per home cell, thread i owns slot i.  The
// block stages the 27 neighbour cells (coordinates plus shift, and a
// validity byte) into shared memory — 27*C*13 bytes, 14 KB at C = 40 —
// and every thread walks the 27*C candidates in the same order, so each
// shared-memory read is a broadcast.
//
// Rules kept from the JAX kernels, and made explicit:
//   * validity comes from tag >= 0, never from coordinate magnitude, so
//     padding slots (PAD_COORD) never pair;
//   * the self pair (centre cell, same slot) is excluded by index;
//   * dr = xi - (xj + shift) directly, never the expanded
//     |xi|^2 + |xj|^2 - 2 xi.xj form, which loses digits at |x| ~ 20;
//   * r^2 is clamped to 1e-3 before the evaluator, and the energy skips
//     r^2 <= 1e-6, as _kernel_planar does.
#pragma once

#include <cuda_runtime.h>

namespace hoomd_torch {

// Per-slot 3-vectors with explicit strides: component a of slot s lives
// at p[s * ss + a * cs].  (nc, C, 3) arrays have ss = 3, cs = 1; plane
// arrays (3, nz, ny, nx, C) have ss = 1, cs = nc * C.
struct Vec3 {
    float* p;
    long long ss, cs;
    __device__ __forceinline__ float& at(long long s, int a) const {
        return p[s * ss + a * cs];
    }
};

struct Geom {
    int nx, ny, nz, C;
};

// Shared-memory bytes one block of the stencil needs.
__host__ __device__ inline size_t stencil_smem_bytes(int C) {
    return (size_t)27 * C * (3 * sizeof(float) + 1);
}

// Stage the 27 neighbour cells of `cell`, in build_cell_shifts order
// ((dz, dy, dx) with dx fastest), into sx/sy/sz/sv.
__device__ inline void stage_stencil(const Vec3 pos, const int* __restrict__ tag,
                                     const float* __restrict__ shifts, const Geom g,
                                     const int cell, float* sx, float* sy, float* sz,
                                     unsigned char* sv) {
    const int ix = cell % g.nx;
    const int iy = (cell / g.nx) % g.ny;
    const int iz = cell / (g.nx * g.ny);
    const int n = 27 * g.C;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / g.C;
        const int s = t - k * g.C;
        const int jx = (ix + k % 3 - 1 + g.nx) % g.nx;
        const int jy = (iy + (k / 3) % 3 - 1 + g.ny) % g.ny;
        const int jz = (iz + k / 9 - 1 + g.nz) % g.nz;
        const long long slot = (long long)(jx + g.nx * (jy + g.ny * jz)) * g.C + s;
        const float* sh = shifts + ((long long)cell * 27 + k) * 3;
        sx[t] = pos.at(slot, 0) + sh[0];
        sy[t] = pos.at(slot, 1) + sh[1];
        sz[t] = pos.at(slot, 2) + sh[2];
        sv[t] = tag[slot] >= 0;
    }
}

// LJ parameters of the single-type stencil.
struct LJ {
    float rc2, lj1, lj2, e_shift;
};

// One candidate at (dx, dy, dz) = x_i - x_j from slot i: adds the force
// (3) and, with PV, the full-pair energy (1) and virial (6, order xx, xy,
// xz, yy, yz, zz) to acc.  Nothing is added outside r_cut.  APPROX picks
// the fast reciprocal that the JAX package uses under a thermostat.
template <bool APPROX, bool PV>
__device__ __forceinline__ void lj_pair(const float dx, const float dy, const float dz,
                                        const LJ lj, float* acc) {
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 < lj.rc2)) return;
    const float r2s = fmaxf(r2, 1e-3f);
    const float r2i = APPROX ? __fdividef(1.0f, r2s) : 1.0f / r2s;
    const float r6i = r2i * r2i * r2i;
    const float fdivr = r2i * r6i * (12.0f * lj.lj1 * r6i - 6.0f * lj.lj2);
    acc[0] += fdivr * dx;
    acc[1] += fdivr * dy;
    acc[2] += fdivr * dz;
    if (PV) {
        if (r2 > 1e-6f) acc[3] += r6i * (lj.lj1 * r6i - lj.lj2) - lj.e_shift;
        acc[4] += fdivr * dx * dx;
        acc[5] += fdivr * dx * dy;
        acc[6] += fdivr * dx * dz;
        acc[7] += fdivr * dy * dy;
        acc[8] += fdivr * dy * dz;
        acc[9] += fdivr * dz * dz;
    }
}

// Sum over the n staged candidates for the slot at (xi, yi, zi), skipping
// the invalid ones and the candidate `self` (-1: none); acc as lj_pair's,
// energy and virial for the caller to halve.
template <bool APPROX, bool PV>
__device__ inline void stencil_sum(const float xi, const float yi, const float zi,
                                   const int self, const int n, const float* sx,
                                   const float* sy, const float* sz,
                                   const unsigned char* sv, const LJ lj, float* acc) {
    for (int t = 0; t < n; ++t) {
        if (!sv[t] || t == self) continue;
        lj_pair<APPROX, PV>(xi - sx[t], yi - sy[t], zi - sz[t], lj, acc);
    }
}

}  // namespace hoomd_torch
