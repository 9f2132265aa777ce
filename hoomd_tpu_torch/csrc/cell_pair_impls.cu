// Hand-written Hopper kernels of the LJ engine's other force paths, chosen
// by HOOMD_TPU_FAST_IMPL (hoomd_tpu_torch/ops/cell_pair.py binds them
// through ctypes):
//
// hoomd_cell_pair_lj      replaces hoomd_tpu/ops/pallas_pair.py:_kernel
//                         ('pallas'): a cell against the 27 cells its row of
//                         the adjacency table lists; forces, half-pair
//                         energy and virial.
// hoomd_cell_pair_lj3d    replaces pallas_pair.py:_kernel3d ('pallas3d'): a
//                         cell against its 27 modular-indexed neighbours, one
//                         neighbour at a time; forces.
// hoomd_cell_pair_lj_row  replaces pallas_pair.py:_kernel_row ('row'): a tile
//                         of an x-row of cells against its 9 (dz, dy) stencil
//                         rows, each row staged once and reused for
//                         dx = -1, 0, +1; forces.
// hoomd_cell_pair_n3l     replaces pallas_pair.py:_kernel_planar_n3l
//                         ('planar_n3l'): the half stencil, each pair once and
//                         its -F put on the other particle; forces.  Like the
//                         TPU kernel it takes any of the ten evaluators, and
//                         a mixture of up to kMaxTypes types (its typed
//                         branch, pallas_pair.py:944-990) through the
//                         per-pair table lookup of cell_stencil.cuh.
//
// All four take the rules of cell_stencil.cuh: validity from tag >= 0, the
// self pair excluded by index, dr = xi - (xj + shift) directly (the TPU's
// 'pallas' kernel forms r^2 as |xi|^2 + |xj|^2 - 2 xi.xj for its matrix
// unit, which loses digits at |x| ~ 20), the exact divide.  The first three
// are LJ only and single-type, as their TPU kernels are.
//
// What bounds them on this card: as for cell_pair.cu, the pair loop.  At
// the 64k bench plan (2352 cells, C = 40) the full stencil visits 102M
// candidate pairs of ~20 flops against a few MB of state, so the fp32
// issue rate bounds them; the half stencil visits half the pairs.  What
// each design does:
//   * lj: one block per cell stages the 27 listed cells (27*C*13 bytes of
//     shared memory, 14 KB at C = 40), a thread per slot.
//   * lj3d: one block per cell stages one neighbour at a time into a
//     double buffer (2*C*13 bytes, 1 KB at C = 40), one barrier per
//     neighbour: less shared memory per block than lj, more barriers.
//   * lj_row: one block per tile of TX cells of an x-row (TX*C threads:
//     at MAX_C one row does not fit a block) stages each (dz, dy) row's
//     TX + 2 cells once, image shifts applied, and every thread reads it
//     for its dx = -1, 0, +1 neighbours: 9 stagings of (TX+2)*C slots
//     instead of 27 of C per cell.
//   * n3l: one block per cell walks the 14 entries of the half stencil
//     (own cell with i < j, then (0,0,+1), the (0,+1) row, the (+1,-1),
//     (+1,0), (+1,+1) rows).  The lanes of a warp take the candidates of a
//     32-slot tile in rotated order, so in one step no two lanes touch the
//     same j, and each warp sums -F per j into its own shared row without
//     atomics; the warps' rows are added in warp order.  The own cell's
//     j side goes to this block's own slots; the j side of each other
//     entry e goes to the neighbour's slots in partial plane e - 1 of a
//     (13, M, 3) buffer (each (neighbour, e) has one source cell, so no
//     two blocks write one entry), and a second launch adds the 13 planes
//     to the forces in plane order.  The sums are deterministic: the same
//     inputs give the same bits, run after run.  A mixture's variant
//     stages each candidate's type in its validity byte and the table in
//     shared memory, and each thread keeps the row of its own type in
//     registers; the single-type variants read [rc2, e_shift, *pnames]
//     as before.
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace hoomd_torch {

__device__ __forceinline__ int wrap(const int i, const int n) { return (i + n) % n; }

// ---------------------------------------------------------------------------
// lj: the adjacency-listed stencil.  lj = [lj1, lj2, rc2, e_shift].

__global__ void lj_adj_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                              const int* __restrict__ adj, const float* __restrict__ shifts,
                              const float* __restrict__ ljp, const int C,
                              float* __restrict__ frc, float* __restrict__ pe,
                              float* __restrict__ vir) {
    extern __shared__ float smem[];
    __shared__ int self_k;
    const int n = 27 * C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    const long long cell = blockIdx.x;
    const int* row = adj + cell * 27;
    const float* shc = shifts + cell * 27 * 3;
    if (threadIdx.x == 0) {
        // the entry that lists this cell itself under no image shift
        int s = -1;
        for (int k = 0; k < 27 && s < 0; ++k)
            if (row[k] == cell && shc[3 * k] == 0.0f && shc[3 * k + 1] == 0.0f &&
                shc[3 * k + 2] == 0.0f)
                s = k;
        self_k = s;
    }
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / C;
        if (row[k] < 0 || row[k] >= (int)gridDim.x) {
            // an id outside the grid lists nothing: never read past it
            sx[t] = sy[t] = sz[t] = 0.0f;
            sv[t] = 0;
            continue;
        }
        const long long slot = (long long)row[k] * C + (t - k * C);
        sx[t] = pos[slot * 3 + 0] + shc[3 * k + 0];
        sy[t] = pos[slot * 3 + 1] + shc[3 * k + 1];
        sz[t] = pos[slot * 3 + 2] + shc[3 * k + 2];
        sv[t] = tag[slot] >= 0;
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= C) return;
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const long long slot = cell * C + i;
    if (tag[slot] >= 0)
        stencil_sum<EV_LJ, false, true>(pos[slot * 3], pos[slot * 3 + 1], pos[slot * 3 + 2],
                                 self_k >= 0 ? self_k * C + i : -1, n, sx, sy, sz, sv, lj,
                                 acc);
    for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
    pe[slot] = 0.5f * acc[3];
    for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
}

// ---------------------------------------------------------------------------
// lj3d: one neighbour at a time, double-buffered.

__global__ void lj_3d_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                             const float* __restrict__ shifts, const float* __restrict__ ljp,
                             const Geom g, float* __restrict__ frc) {
    extern __shared__ float smem[];
    const int C = g.C;
    unsigned char* sv0 = reinterpret_cast<unsigned char*>(smem + 6 * C);
    const int cell = blockIdx.x;
    const int ix = cell % g.nx, iy = (cell / g.nx) % g.ny, iz = cell / (g.nx * g.ny);
    const float* shc = shifts + (long long)cell * 27 * 3;
    auto stage = [&](const int k, const int b) {
        const int jc = wrap(ix + k % 3 - 1, g.nx) +
                       g.nx * (wrap(iy + (k / 3) % 3 - 1, g.ny) + g.ny * wrap(iz + k / 9 - 1, g.nz));
        float* s = smem + b * 3 * C;
        for (int t = threadIdx.x; t < C; t += blockDim.x) {
            const long long slot = (long long)jc * C + t;
            s[t] = pos[slot * 3 + 0] + shc[3 * k + 0];
            s[C + t] = pos[slot * 3 + 1] + shc[3 * k + 1];
            s[2 * C + t] = pos[slot * 3 + 2] + shc[3 * k + 2];
            sv0[b * C + t] = tag[slot] >= 0;
        }
    };
    const int i = threadIdx.x;
    const long long slot = (long long)cell * C + i;
    const bool vi = i < C && tag[slot] >= 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (vi) {
        xi = pos[slot * 3];
        yi = pos[slot * 3 + 1];
        zi = pos[slot * 3 + 2];
    }
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[3] = {0.f, 0.f, 0.f};
    stage(0, 0);
    __syncthreads();
    for (int k = 0; k < 27; ++k) {
        // the next neighbour goes to the other buffer, which every thread
        // left at the previous barrier
        if (k + 1 < 27) stage(k + 1, (k + 1) & 1);
        const int b = k & 1;
        if (vi)
            stencil_sum<EV_LJ, false, false>(xi, yi, zi, k == 13 ? i : -1, C, smem + b * 3 * C,
                                      smem + b * 3 * C + C, smem + b * 3 * C + 2 * C,
                                      sv0 + b * C, lj, acc);
        __syncthreads();
    }
    if (i < C)
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
}

// ---------------------------------------------------------------------------
// lj_row: grid (tiles of TX cells, ny, nz).

__global__ void lj_row_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                              const float* __restrict__ shifts, const float* __restrict__ ljp,
                              const Geom g, const int TX, float* __restrict__ frc) {
    extern __shared__ float smem[];
    const int C = g.C;
    const int W = (TX + 2) * C;
    float* sx = smem;
    float* sy = sx + W;
    float* sz = sy + W;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + W);
    const int x0 = blockIdx.x * TX, iy = blockIdx.y, iz = blockIdx.z;
    const int tx = min(TX, g.nx - x0);          // cells of this tile
    const int t = threadIdx.x;
    const int lc = t / C, i = t - lc * C;
    const long long slot = ((long long)(x0 + lc) + g.nx * (iy + (long long)g.ny * iz)) * C + i;
    const bool vi = lc < tx && tag[slot] >= 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (vi) {
        xi = pos[slot * 3];
        yi = pos[slot * 3 + 1];
        zi = pos[slot * 3 + 2];
    }
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < 9; ++r) {
        const int jy = wrap(iy + r % 3 - 1, g.ny), jz = wrap(iz + r / 3 - 1, g.nz);
        __syncthreads();                        // the last row's reads are done
        // staged entry u_local holds cell x0 - 1 + u_local of the row under
        // the image shift of the (home, dx) that reaches it
        for (int s = t; s < (tx + 2) * C; s += blockDim.x) {
            const int ul = s / C, js = s - ul * C;
            const int u = x0 - 1 + ul;          // in [-1, nx]
            const int hx = min(max(u, 0), g.nx - 1);
            const int k = r * 3 + (u - hx) + 1;
            const float* sh =
                shifts + (((long long)hx + g.nx * (iy + (long long)g.ny * iz)) * 27 + k) * 3;
            const long long js_slot =
                ((long long)wrap(u, g.nx) + g.nx * (jy + (long long)g.ny * jz)) * C + js;
            sx[s] = pos[js_slot * 3 + 0] + sh[0];
            sy[s] = pos[js_slot * 3 + 1] + sh[1];
            sz[s] = pos[js_slot * 3 + 2] + sh[2];
            sv[s] = tag[js_slot] >= 0;
        }
        __syncthreads();
        if (!vi) continue;
        for (int d = 0; d < 3; ++d) {           // dx = d - 1: staged cell lc + d
            const int base = (lc + d) * C;
            stencil_sum<EV_LJ, false, false>(xi, yi, zi, (r == 4 && d == 1) ? i : -1, C, sx + base,
                                      sy + base, sz + base, sv + base, lj, acc);
        }
    }
    if (lc < tx)
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
}

// ---------------------------------------------------------------------------
// n3l: the half stencil.  par = [rc2, e_shift, *pnames] of one type, or the
// (2 + np, T, T) table of a mixture (TYPED).

// Entry e of the half stencil: the own cell, (0,0,+1), the (dz, dy) = (0,+1)
// row, then the (+1,-1), (+1,0) and (+1,+1) rows, dx = -1, 0, +1 in each.
__device__ __forceinline__ void n3l_offset(const int e, int& dz, int& dy, int& dx) {
    if (e < 2) {
        dz = 0;
        dy = 0;
        dx = e;
    } else if (e < 5) {
        dz = 0;
        dy = 1;
        dx = e - 3;
    } else {
        dz = 1;
        dy = (e - 5) / 3 - 1;
        dx = (e - 5) % 3 - 1;
    }
}

constexpr int kN3lEntries = 14;

// Shared memory of one block: a staged cell, the warps' j-side rows, the
// table of a mixture (ntab floats, 0 for one type) and the validity bytes.
static inline size_t n3l_smem_bytes(const int C, const int threads, const int ntab) {
    return (size_t)3 * C * sizeof(float) + (size_t)(threads / 32) * 3 * C * sizeof(float) +
           (size_t)ntab * sizeof(float) + C;
}

template <int EV, bool TYPED>
__global__ void n3l_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                           const int* __restrict__ typ, const float* __restrict__ shifts,
                           const float* __restrict__ par, const int np, const int T,
                           const Geom g, float* __restrict__ frc, float* __restrict__ part) {
    extern __shared__ float smem[];
    const int C = g.C;
    const int nw = blockDim.x >> 5;
    const int ntab = TYPED ? (2 + np) * T * T : 0;
    float* sx = smem;
    float* sy = sx + C;
    float* sz = sy + C;
    float* accj = sz + C;                       // [warp][axis][C]
    float* tab = accj + nw * 3 * C;
    unsigned char* sv = reinterpret_cast<unsigned char*>(tab + ntab);
    const int cell = blockIdx.x;
    const int ix = cell % g.nx, iy = (cell / g.nx) % g.ny, iz = cell / (g.nx * g.ny);
    const long long M = (long long)g.nx * g.ny * g.nz * C;
    const float* shc = shifts + (long long)cell * 27 * 3;
    const int i = threadIdx.x, lane = i & 31, w = i >> 5;
    const long long slot = (long long)cell * C + i;
    const bool vi = i < C && tag[slot] >= 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (vi) {
        xi = pos[slot * 3];
        yi = pos[slot * 3 + 1];
        zi = pos[slot * 3 + 2];
    }
    PairPar P;
    TypedRow R;
    if constexpr (TYPED) {
        stage_table(par, ntab, tab);
        __syncthreads();
        R = load_typed_row(tab, np, T, vi ? min(max(typ[slot], 0), T - 1) : 0);
    } else {
        P = load_pair_par(par, np);
    }
    float acc[3] = {0.f, 0.f, 0.f};
    for (int e = 0; e < kN3lEntries; ++e) {
        int dz, dy, dx;
        n3l_offset(e, dz, dy, dx);
        const int k = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1);
        const int jc = wrap(ix + dx, g.nx) + g.nx * (wrap(iy + dy, g.ny) + g.ny * wrap(iz + dz, g.nz));
        for (int t = threadIdx.x; t < C; t += blockDim.x) {
            const long long js = (long long)jc * C + t;
            sx[t] = pos[js * 3 + 0] + shc[3 * k + 0];
            sy[t] = pos[js * 3 + 1] + shc[3 * k + 1];
            sz[t] = pos[js * 3 + 2] + shc[3 * k + 2];
            if constexpr (TYPED)
                sv[t] = type_byte(tag[js], typ[js], T);
            else
                sv[t] = tag[js] >= 0;
        }
        for (int t = threadIdx.x; t < nw * 3 * C; t += blockDim.x) accj[t] = 0.0f;
        __syncthreads();
        float* aj = accj + w * 3 * C;
        for (int jt = 0; jt < C; jt += 32) {
            for (int s = 0; s < 32; ++s) {
                // lane l takes slot jt + (l + s) mod 32: distinct in a step
                const int j = jt + ((lane + s) & 31);
                if (vi && j < C && sv[j] && (e != 0 || j > i)) {
                    float f[3] = {0.f, 0.f, 0.f};
                    if constexpr (TYPED)
                        typed_pair_acc<EV, false>(xi - sx[j], yi - sy[j], zi - sz[j], R,
                                                  sv[j] - 1, f);
                    else
                        pair_acc<EV, false, false>(xi - sx[j], yi - sy[j], zi - sz[j], P, f);
                    for (int a = 0; a < 3; ++a) {
                        acc[a] += f[a];
                        aj[a * C + j] -= f[a];
                    }
                }
                __syncwarp();
            }
        }
        __syncthreads();
        if (i < C) {
            float gj[3] = {0.f, 0.f, 0.f};
            for (int ww = 0; ww < nw; ++ww)
                for (int a = 0; a < 3; ++a) gj[a] += accj[(ww * 3 + a) * C + i];
            if (e == 0) {
                for (int a = 0; a < 3; ++a) acc[a] += gj[a];
            } else {
                float* dst = part + ((e - 1) * M + (long long)jc * C + i) * 3;
                for (int a = 0; a < 3; ++a) dst[a] = gj[a];
            }
        }
        __syncthreads();                        // before accj is zeroed again
    }
    if (i < C)
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
}

// frc += the 13 partial planes, in plane order.
__global__ void n3l_fold_kernel(float* __restrict__ frc, const float* __restrict__ part,
                                const long long n3) {
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n3) return;
    float f = frc[q];
    for (int o = 0; o < kN3lEntries - 1; ++o) f += part[o * n3 + q];
    frc[q] = f;
}

template <int EV, bool TYPED>
static cudaError_t launch_n3l(const float* pos, const int* tag, const int* typ,
                              const float* shifts, const float* par, const int np, const int T,
                              float* frc, float* part, const Geom g, cudaStream_t st) {
    const int threads = threads_for(g.C);
    const size_t smem = n3l_smem_bytes(g.C, threads, TYPED ? (2 + np) * T * T : 0);
    cudaError_t e = set_smem(n3l_kernel<EV, TYPED>, smem);
    if (e != cudaSuccess) return e;
    n3l_kernel<EV, TYPED><<<g.nx * g.ny * g.nz, threads, smem, st>>>(pos, tag, typ, shifts, par,
                                                                     np, T, g, frc, part);
    return cudaGetLastError();
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// pos (nc, C, 3), tag (nc, C), adj (nc, 27), shifts (nc, 27, 3),
// ljp [lj1, lj2, rc2, e_shift]; frc (nc, C, 3), pe (nc, C), vir (nc, C, 6).
int hoomd_cell_pair_lj(const float* pos, const int* tag, const int* adj, const float* shifts,
                       const float* ljp, float* frc, float* pe, float* vir, int nc, int C,
                       void* stream) {
    const size_t smem = stencil_smem_bytes(C);
    cudaError_t e = set_smem(lj_adj_kernel, smem);
    if (e != cudaSuccess) return e;
    lj_adj_kernel<<<nc, threads_for(C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, adj, shifts, ljp, C, frc, pe, vir);
    return cudaGetLastError();
}

// pos (nz, ny, nx, C, 3) cell-major, tag, shifts (nc, 27, 3), ljp as above;
// frc (nc, C, 3).
int hoomd_cell_pair_lj3d(const float* pos, const int* tag, const float* shifts,
                         const float* ljp, float* frc, int nx, int ny, int nz, int C,
                         void* stream) {
    const size_t smem = (size_t)2 * C * (3 * sizeof(float) + 1);
    cudaError_t e = set_smem(lj_3d_kernel, smem);
    if (e != cudaSuccess) return e;
    lj_3d_kernel<<<nx * ny * nz, threads_for(C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, shifts, ljp, Geom{nx, ny, nz, C}, frc);
    return cudaGetLastError();
}

// As hoomd_cell_pair_lj3d, in tiles of tx cells of an x-row (tx * C <= 1024).
int hoomd_cell_pair_lj_row(const float* pos, const int* tag, const float* shifts,
                           const float* ljp, float* frc, int nx, int ny, int nz, int C, int tx,
                           void* stream) {
    const size_t smem = (size_t)(tx + 2) * C * (3 * sizeof(float) + 1);
    cudaError_t e = set_smem(lj_row_kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((nx + tx - 1) / tx, ny, nz);
    lj_row_kernel<<<grid, threads_for(tx * C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, shifts, ljp, Geom{nx, ny, nz, C}, tx, frc);
    return cudaGetLastError();
}

// pos, tag, shifts as above, typ (nc, C) (a mixture only, else null), par
// [rc2, e_shift, *pnames] of evaluator ev, or with ntypes > 1 the
// (2 + np, ntypes, ntypes) table; frc (nc, C, 3); part a (13, nc * C, 3)
// scratch buffer.  Two launches.
int hoomd_cell_pair_n3l(const float* pos, const int* tag, const int* typ, const float* shifts,
                        const float* par, int np, int ntypes, float* frc, float* part, int nx,
                        int ny, int nz, int C, int ev, void* stream) {
    if (ntypes < 1 || ntypes > kMaxTypes || np < 0 || np > kMaxPnames)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    cudaError_t e = dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return ntypes > 1
                   ? launch_n3l<EV, true>(pos, tag, typ, shifts, par, np, ntypes, frc, part, g, st)
                   : launch_n3l<EV, false>(pos, tag, typ, shifts, par, np, 1, frc, part, g, st);
    });
    if (e != cudaSuccess) return e;
    const long long n3 = (long long)nx * ny * nz * C * 3;
    n3l_fold_kernel<<<(unsigned)((n3 + 255) / 256), 256, 0, st>>>(frc, part, n3);
    return cudaGetLastError();
}

}  // extern "C"
