// Hand-written Hopper kernels of the cell-major LJ engine
// (hoomd_tpu_torch/ops/cell_pair.py binds them through ctypes).
//
// hoomd_cell_pair_plane   replaces hoomd_tpu/ops/pallas_pair.py:_kernel_plane
//                         (forces only, full 27-cell stencil).
// hoomd_cell_pair_planar  replaces hoomd_tpu/ops/pallas_pair.py:_kernel_planar
//                         (forces, half-pair energy and virial), single type.
// hoomd_megastep          replaces hoomd_tpu/ops/pallas_pair.py:_kernel_megastep
//                         (k fused velocity-Verlet steps: NVE, Nose-Hoover, Langevin).
//
// Each is instantiated for the ten pair evaluators of cell_stencil.cuh
// (the JAX engine's FAST_EVALS), picked by the evaluator id the host
// passes; its parameters are the vector [rc2, e_shift, *pnames].
//
// What bounds them on this card: the stencil is arithmetic on shared
// memory.  At the 64k LJ bench shape (2352 cells, C = 40) a full step visits
// 2352 * 40 * 1080 = 102M candidate pairs, about 20 flops each, against
// 18 MB of state traffic, so the pair loop is FP32-issue bound, not
// memory bound; the evaluators other than lj add a sqrtf and an expf or
// powf per pair inside r_cut.  The design keeps it simple and right: one block per
// cell, shared-memory broadcast of the staged candidates, no atomics (a
// pair is evaluated from both sides, like the TPU's full stencil), so
// the sums are deterministic.  Unused lanes (C rounded up to a warp)
// and the full rather than half stencil are the known costs, left to
// later work.
//
// The TPU megastep holds the whole state in VMEM with no grid.  Here a
// window of k steps is ONE cooperative launch (hoomd_megastep): its
// blocks stay resident, walk the cells, and meet at a grid-wide barrier
// after each step's drift and after its forces; every block then merges
// the same partials in the same order (the drift monitor's top-two, the
// Nose-Hoover kinetic energy), so xi, eta and the drift ratio stay in
// registers with no finishing launch, and the same inputs give the same
// bits.  The pair loop of a slot visits only its candidate set
// (hoomd_mega_candidates, built once per rebuild): the staged entries
// that can come inside r_cut while the drift guard holds, about 140 of
// the 1080 at the bench shape, listed per slot in the staged order, so
// a window that stays under the guard sums the same terms in the same
// order as a walk of all 1080.  A block works on a run of up to 4 cells
// along x and stages the union of their stencils once.  Once the guard
// trips, the rest of the window walks every staged slot.  Each C entry
// point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "cell_stencil.cuh"

namespace cg = cooperative_groups;

namespace hoomd_torch {

// ---------------------------------------------------------------------------
// cell_pair_plane / cell_pair_planar

template <int EV, bool APPROX, bool PV>
__global__ void cell_pair_kernel(const Vec3 pos, const int* __restrict__ tag,
                                 const float* __restrict__ shifts,
                                 const float* __restrict__ par, const int np, const Geom g,
                                 Vec3 frc, float* __restrict__ pe, float* __restrict__ vir) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    const int cell = blockIdx.x;
    stage_stencil(pos, tag, shifts, g, cell, sx, sy, sz, sv);
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= g.C) return;
    const PairPar P = load_pair_par(par, np);
    float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int ic = 13 * g.C + i;
    if (sv[ic])
        stencil_sum<EV, APPROX, PV>(sx[ic], sy[ic], sz[ic], ic, n, sx, sy, sz, sv, P, acc);
    const long long slot = (long long)cell * g.C + i;
    frc.at(slot, 0) = acc[0];
    frc.at(slot, 1) = acc[1];
    frc.at(slot, 2) = acc[2];
    if (PV) {
        pe[slot] = 0.5f * acc[3];
        for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
    }
}

template <int EV, bool APPROX, bool PV>
static cudaError_t launch_cell_pair(const float* pos, long long pss, long long pcs,
                                    const int* tag, const float* shifts, const float* par,
                                    int np, float* frc, long long fss, long long fcs,
                                    float* pe, float* vir, const Geom g, cudaStream_t st) {
    const size_t smem = stencil_smem_bytes(g.C);
    cudaError_t e = set_smem(cell_pair_kernel<EV, APPROX, PV>, smem);
    if (e != cudaSuccess) return e;
    cell_pair_kernel<EV, APPROX, PV><<<g.nx * g.ny * g.nz, threads_for(g.C), smem, st>>>(
        Vec3{const_cast<float*>(pos), pss, pcs}, tag, shifts, par, np, g, Vec3{frc, fss, fcs},
        pe, vir);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The megastep: one cooperative launch per window of k steps.
//
// mp = [dt, tinv2, it_x, it_y, it_z, gamma, ndof, rc2, e_shift, *pnames];
// sc = [xi, eta, ke2, mdmax], read at the start and written at the end.
// mdmax starts from sc[3], so windows chained on one sc carry the
// window-to-window maximum.
constexpr int MP_DT = 0, MP_TINV2 = 1, MP_IT = 2, MP_GAMMA = 5, MP_NDOF = 6, MP_PV = 7;
// the partial sums are kept per 256-slot chunk (drift, the window's first
// kinetic energy) and per cell (the Nose-Hoover kinetic energy), as the
// parent's per-step launches kept them, and summed in that order
constexpr int kChunk = 256;
// the most threads a block takes: C <= MAX_C = 512 on one cell
constexpr int kMegaMaxThreads = 512;

// Top-two reduction of one axis' squared drift: the largest value, how
// many slots hold it, and the largest value below it.  Merging two
// partials is exact and independent of the order, so any grouping gives
// exactly what one_step's max / tie / masked max give.
struct Top2 {
    float m1;
    int cnt;
    float m2;
};

__device__ inline Top2 top2_merge(const Top2 a, const Top2 b) {
    if (a.m1 > b.m1) return Top2{a.m1, a.cnt, fmaxf(a.m2, b.m1)};
    if (b.m1 > a.m1) return Top2{b.m1, b.cnt, fmaxf(b.m2, a.m1)};
    return Top2{a.m1, a.cnt + b.cnt, fmaxf(a.m2, b.m2)};
}

__device__ inline Top2 top2_shfl(const Top2 t, const int o) {
    return Top2{__shfl_down_sync(0xffffffffu, t.m1, o), __shfl_down_sync(0xffffffffu, t.cnt, o),
                __shfl_down_sync(0xffffffffu, t.m2, o)};
}

// t[3] of every thread -> the block's merge, returned to every thread.
// sh holds 3 * 32 records.
__device__ inline void top2_block(Top2* t, Top2* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    for (int a = 0; a < 3; ++a) {
        for (int o = 16; o > 0; o >>= 1) {
            const Top2 u = top2_shfl(t[a], o);
            if (lane + o < 32) t[a] = top2_merge(t[a], u);
        }
        if (lane == 0) sh[a * 32 + wid] = t[a];
    }
    __syncthreads();
    for (int a = 0; a < 3; ++a) {
        Top2 r = sh[a * 32];
        for (int w = 1; w < nw; ++w) r = top2_merge(r, sh[a * 32 + w]);
        t[a] = r;
    }
    __syncthreads();
}

__device__ inline float nh_xi_half(const float* mp, const float xi, const float ke2,
                                   const float kT) {
    // xi + dt/2 (KE2 / (ndof kT) - 1) / tau^2, the megastep's order
    return xi + 0.5f * mp[MP_DT] * (ke2 / (mp[MP_NDOF] * kT) - 1.0f) * mp[MP_TINV2];
}

// The sum of 256 values as one 256-thread block_sum adds them: per warp
// of 32, then the 8 warp sums.  Called by one whole warp; lane 0 holds it.
__device__ inline float sum256_as_block(const float* vals) {
    const int lane = threadIdx.x & 31;
    float r = 0.0f;
    for (int w = 0; w < kChunk / 32; ++w) {
        const float x = __shfl_sync(0xffffffffu, warp_sum(vals[32 * w + lane]), 0);
        if (lane == w) r = x;
    }
    return warp_sum(r);
}

// KE2 from n partials, added as one 256-thread block adds them: thread t
// sums partials t, t + 256, ... in order, then block_sum.  Every block
// computes the same bits; vals is 256 floats of shared memory.
__device__ inline float ke_total(const float* __restrict__ part, const int n, float* vals) {
    for (int vt = threadIdx.x; vt < kChunk; vt += blockDim.x) {
        float k = 0.0f;
        for (int b = vt; b < n; b += kChunk) k += part[b];
        vals[vt] = k;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        const float tot = sum256_as_block(vals);
        if (threadIdx.x == 0) vals[kChunk] = tot;
    }
    __syncthreads();
    const float tot = vals[kChunk];
    __syncthreads();
    return tot;
}

struct MegaArgs {
    float* p;                // (3, M) planes, updated in place
    float* v;
    float* f;
    const float* w;          // 1/m (M)
    const float* m;          // m (M)
    const float* r;          // (3, M) reference positions of the candidate set
    const int* tag;          // (M)
    const float* shifts;     // (nc, 27, 3)
    const float* mp;
    int np;
    float* sc;
    const float* kt;         // (k)
    const float* noise;      // (k, 3, M), langevin only
    const unsigned short* list;  // (M, cap) the candidates' union indices
    const int* count;        // (M) candidates per slot
    int cap;
    Top2* dpart;             // (nb, 3)
    float* kpart;            // max(nb, nc)
    Geom g;
    long long M;
    int nb;                  // 256-slot chunks
    int k;
    int R;                   // cells of a run along x (the last of a row may be shorter)
    int nrun;                // runs per row, ceil(nx / R)
};

// A block's work item in the force phase is a run of R cells along x, one
// thread per slot (R C threads).  It stages the union of their stencils,
// 3 x 3 x (R + 2) cells, which is 9 (R + 2) / (27 R) of the 27 cells per
// cell a block of one cell stages: half at R = 4.
static inline int mega_run(const int nx, const int C) {
    return std::max(1, std::min(std::min(4, nx), kMegaMaxThreads / C));
}

// Shared memory of one block, in floats: the staged union (x, y, z and a
// validity byte per slot; in the drift phase the reductions' scratch),
// the per-slot kinetic energies of a run, and the union cells' slot
// bases and shifts.
struct MegaSmem {
    int kev, ubase, ush, total;
};

__host__ __device__ inline MegaSmem mega_smem(const int C, const int R) {
    const int nu = 9 * (R + 2);
    const int stage_bytes = nu * C * (3 * (int)sizeof(float) + 1);
    const int red_bytes = (kChunk + 1) * (int)sizeof(float) + 3 * 32 * (int)sizeof(Top2);
    MegaSmem m;
    m.kev = ((stage_bytes > red_bytes ? stage_bytes : red_bytes) + 3) / 4;
    m.ubase = m.kev + R * C;
    m.ush = m.ubase + nu;
    m.total = m.ush + 3 * nu;
    return m;
}

// Union index of stencil entry k of the run's cell r: union cells are
// (dz, dy, ux) with ux = r + dx + 1 in 0 .. R' + 1.
__device__ __forceinline__ int union_base(const int k, const int r, const int uw, const int C) {
    return (((k / 9) * 3 + (k / 3) % 3) * uw + r + k % 3) * C;
}

// The candidates of a slot from its list of union indices (ascending, so
// in stencil order), read eight at a time: the walk of a slot whose
// candidates fit its row of the list.
template <int EV, bool APPROX>
__device__ __forceinline__ void listed_sum(const float xi, const float yi, const float zi,
                                           const unsigned short* __restrict__ row, const int n,
                                           const float* sx, const float* sy, const float* sz,
                                           const PairPar& P, float* acc) {
    const uint4* row8 = reinterpret_cast<const uint4*>(row);
    for (int n0 = 0; n0 < n; n0 += 8) {
        const uint4 q = __ldg(row8 + (n0 >> 3));
        const unsigned h[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            if (n0 + u >= n) break;
            const int e = (h[u >> 1] >> (16 * (u & 1))) & 0xffff;
            pair_acc<EV, APPROX, false>(xi - sx[e], yi - sy[e], zi - sz[e], P, acc);
        }
    }
}

// Every staged slot of the stencil of the run's cell r, in stencil order,
// but the invalid ones and the slot itself (the parent kernel's walk): the
// walk past the drift guard and of a slot whose list overflowed.  Pairs
// that are not candidates lie outside r_cut and add nothing, so both walks
// give the same bits.
template <int EV, bool APPROX>
__device__ __forceinline__ void full_sum(const float xi, const float yi, const float zi,
                                         const int self, const int r, const int uw, const int C,
                                         const float* sx, const float* sy, const float* sz,
                                         const unsigned char* sv, const PairPar& P, float* acc) {
    for (int k = 0; k < 27; ++k) {
        const int ub = union_base(k, r, uw, C);
        for (int s = 0; s < C; ++s) {
            const int e = ub + s;
            if (!sv[e] || e == self) continue;
            pair_acc<EV, APPROX, false>(xi - sx[e], yi - sy[e], zi - sz[e], P, acc);
        }
    }
}

// k steps.  Per step: the drift of every slot (block partials of the
// per-axis top-two drift per 256-slot chunk); a grid-wide barrier; every
// block merges the partials to the same drift ratio and Nose-Hoover
// half step; the forces of each run of cells at the drifted positions,
// from each slot's candidate list (or, once the drift guard has tripped
// or where the list overflowed, from every staged slot, as the parent
// kernel did), and the kick; a
// grid-wide barrier; with NVT every block sums the per-cell kinetic
// energies.  METHOD 0 = NVE, 1 = Nose-Hoover, 2 = Langevin (precomputed
// noise planes, drag -gamma v).  The arithmetic of each slot is the
// parent kernels' (the per-step launches this replaces), operation for
// operation, and so are the orders of the sums.
template <int EV, bool APPROX, int METHOD>
__global__ void __launch_bounds__(kMegaMaxThreads) mega_window(const MegaArgs a) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float smem[];
    const Geom g = a.g;
    const int C = g.C;
    const long long M = a.M;
    const int nc = g.nx * g.ny * g.nz;
    const float* mp = a.mp;
    const float dt = mp[MP_DT], hdt = 0.5f * dt;
    const MegaSmem lay = mega_smem(C, a.R);
    // the reductions' scratch, in the staging area when it is idle
    float* vals = smem;                                             // kChunk + 1
    Top2* tsh = reinterpret_cast<Top2*>(smem + kChunk + 1);         // 3 * 32
    float* kev = smem + lay.kev;
    int* ubase = reinterpret_cast<int*>(smem + lay.ubase);
    float* ush = smem + lay.ush;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    float xi = a.sc[0], eta = a.sc[1], md2 = a.sc[3];

    // the window's first kinetic energy, per 256-slot chunk
    for (int ch = blockIdx.x; ch < a.nb; ch += gridDim.x) {
        for (int t = threadIdx.x; t < kChunk; t += blockDim.x) {
            const long long j = (long long)ch * kChunk + t;
            float k = 0.0f;
            if (j < M)
                k = (a.v[j] * a.v[j] + a.v[M + j] * a.v[M + j] + a.v[2 * M + j] * a.v[2 * M + j]) *
                    a.m[j];
            vals[t] = k;
        }
        __syncthreads();
        if (threadIdx.x < 32) {
            const float k = sum256_as_block(vals);
            if (threadIdx.x == 0) a.kpart[ch] = k;
        }
        __syncthreads();
    }
    grid.sync();
    float ke2 = ke_total(a.kpart, a.nb, vals);

    const PairPar P = load_pair_par(mp + MP_PV, a.np);
    const int nitems = a.nrun * g.ny * g.nz;
    const int r = threadIdx.x / C, i = threadIdx.x - r * C;   // this thread's slot
    for (int si = 0; si < a.k; ++si) {
        // ---- drift: v' = s v + dt/2 f/m ; x += dt v'
        float s = 1.0f;
        if (METHOD == 1) s = expf(-hdt * nh_xi_half(mp, xi, ke2, a.kt[si]));
        for (int ch = blockIdx.x; ch < a.nb; ch += gridDim.x) {
            Top2 t[3] = {{-1.f, 0, -1.f}, {-1.f, 0, -1.f}, {-1.f, 0, -1.f}};
            for (int tt = threadIdx.x; tt < kChunk; tt += blockDim.x) {
                const long long j = (long long)ch * kChunk + tt;
                if (j >= M) continue;
                const float wj = a.w[j];
                for (int ax = 0; ax < 3; ++ax) {
                    const long long q = ax * M + j;
                    const float vh = s * a.v[q] + hdt * a.f[q] * wj;
                    const float pn = a.p[q] + dt * vh;
                    a.v[q] = vh;
                    a.p[q] = pn;
                    const float d = pn - a.r[q];
                    t[ax] = top2_merge(t[ax], Top2{d * d, 1, -1.f});
                }
            }
            top2_block(t, tsh);
            if (threadIdx.x == 0)
                for (int ax = 0; ax < 3; ++ax) a.dpart[ch * 3 + ax] = t[ax];
        }
        grid.sync();
        // ---- the drift ratio ((d1 + d2) / skin_a)^2 and the first half
        // of the Nose-Hoover update, the same in every block
        {
            Top2 t[3] = {{-1.f, 0, -1.f}, {-1.f, 0, -1.f}, {-1.f, 0, -1.f}};
            for (int b = threadIdx.x; b < a.nb; b += blockDim.x)
                for (int ax = 0; ax < 3; ++ax) t[ax] = top2_merge(t[ax], a.dpart[b * 3 + ax]);
            top2_block(t, tsh);
            for (int ax = 0; ax < 3; ++ax) {
                const float m1 = t[ax].m1;
                const float m2 = (t[ax].cnt > 1) ? m1 : fmaxf(t[ax].m2, 0.0f);
                const float it = mp[MP_IT + ax];
                const float sd = 0.5f * (sqrtf(m1 * it) + sqrtf(m2 * it));
                md2 = fmaxf(md2, sd * sd);
            }
            if (METHOD == 1) {
                const float xi1 = nh_xi_half(mp, xi, ke2, a.kt[si]);
                eta = eta + mp[MP_DT] * xi1;
                xi = xi1;
            }
        }
        // past the guard the candidate set may miss a pair: walk every slot
        const bool tripped = md2 > 1.0f;
        // ---- forces at the drifted positions, then the kick, run by run
        const float sk = (METHOD == 1) ? expf(-hdt * xi) : 1.0f;
        for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
            const int row = item / a.nrun;
            const int ix0 = (item - row * a.nrun) * a.R;
            const int rlen = min(a.R, g.nx - ix0);
            const int uw = rlen + 2, nu = 9 * uw;
            const int cell0 = ix0 + g.nx * row;
            // each union cell's first slot and shift, read from the shift
            // table of a cell of the run that has it in its stencil
            for (int u = threadIdx.x; u < nu; u += blockDim.x) {
                const int ux = u % uw, uyz = u / uw;
                const int rh = min(max(ux - 1, 0), rlen - 1);
                const int k = uyz * 3 + (ux - rh);
                ubase[u] = (int)stencil_slot(g, cell0 + rh, k, 0);
                for (int ax = 0; ax < 3; ++ax)
                    ush[3 * u + ax] = a.shifts[((long long)(cell0 + rh) * 27 + k) * 3 + ax];
            }
            __syncthreads();
            const int n = nu * C;
            float* sx = smem;
            float* sy = sx + n;
            float* sz = sy + n;
            unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
            for (int e = threadIdx.x; e < n; e += blockDim.x) {
                const int u = e / C;
                const long long slot = ubase[u] + (e - u * C);
                sx[e] = a.p[slot] + ush[3 * u];
                sy[e] = a.p[M + slot] + ush[3 * u + 1];
                sz[e] = a.p[2 * M + slot] + ush[3 * u + 2];
                sv[e] = a.tag[slot] >= 0;
            }
            __syncthreads();
            const bool mine = r < rlen;
            const long long j = (long long)(cell0 + r) * C + i;
            float ke = 0.0f;
            if (mine) {
                float acc[3] = {0.f, 0.f, 0.f};
                const int ic = union_base(13, r, uw, C) + i;
                if (sv[ic]) {
                    const int n = a.count[j];
                    if (tripped || n > a.cap)
                        full_sum<EV, APPROX>(sx[ic], sy[ic], sz[ic], ic, r, uw, C, sx, sy, sz, sv,
                                             P, acc);
                    else
                        listed_sum<EV, APPROX>(sx[ic], sy[ic], sz[ic], a.list + j * a.cap, n,
                                               sx, sy, sz, P, acc);
                }
                const float wj = a.w[j];
                for (int ax = 0; ax < 3; ++ax) {
                    const long long q = ax * M + j;
                    float F = acc[ax];
                    float vn;
                    if (METHOD == 2) {
                        F = F + a.noise[(long long)si * 3 * M + q] - mp[MP_GAMMA] * a.v[q];
                        vn = a.v[q] + hdt * F * wj;
                    } else {
                        vn = a.v[q] + hdt * F * wj;
                        if (METHOD == 1) vn = vn * sk;
                    }
                    a.f[q] = F;
                    a.v[q] = vn;
                    ke += vn * vn;
                }
                ke *= a.m[j];
            }
            if (METHOD == 1) {
                // each cell's kinetic energy as the parent's block_sum
                // over threads_for(C) threads adds it: per warp of 32
                // slots, then the warp sums
                if (mine) kev[r * C + i] = ke;
                __syncthreads();
                const int nwp = (C + 31) >> 5;   // the warps of threads_for(C)
                for (int rc = warp; rc < rlen; rc += nwarps) {
                    float y = 0.0f;
                    for (int w = 0; w < nwp; ++w) {
                        const int ii = 32 * w + lane;
                        const float x = __shfl_sync(
                            0xffffffffu, warp_sum(ii < C ? kev[rc * C + ii] : 0.0f), 0);
                        if (lane == w) y = x;
                    }
                    y = warp_sum(y);
                    if (lane == 0) a.kpart[cell0 + rc] = y;
                }
            }
            __syncthreads();
        }
        grid.sync();
        if (METHOD == 1) {
            ke2 = ke_total(a.kpart, nc, vals);
            xi = nh_xi_half(mp, xi, ke2, a.kt[si]);
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.sc[0] = xi;
        a.sc[1] = eta;
        a.sc[2] = ke2;
        a.sc[3] = md2;
    }
}

template <int EV, bool APPROX, int METHOD>
static cudaError_t launch_window(MegaArgs a, cudaStream_t st) {
    auto kern = mega_window<EV, APPROX, METHOD>;
    const int threads = threads_for(a.R * a.g.C);
    const size_t smem = (size_t)mega_smem(a.g.C, a.R).total * sizeof(float);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    // as much of the SM's L1 as shared memory as it takes
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
        cudaSuccess)
        return e;
    const int want = std::max(a.nrun * a.g.ny * a.g.nz, a.nb);
    const int blocks = std::max(1, std::min(per_sm * sms, want));
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks), dim3(threads), args, smem,
                                    st);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <int METHOD>
static cudaError_t window(int ev, int approx, const MegaArgs& a, cudaStream_t st) {
    if (approx && ev == EV_LJ) return launch_window<EV_LJ, true, METHOD>(a, st);
    return dispatch_eval(
        ev, [&](auto t) { return launch_window<decltype(t)::value, false, METHOD>(a, st); });
}

// ---------------------------------------------------------------------------
// The megastep's candidate set: for slot i of a cell and entry t of its
// staged stencil (27 C entries, build_cell_shifts order), bit t of i is
// set when both slots are live, t is not i itself, and the pair can come
// inside r_cut while the drift guard holds.  The guard allows
// |d_ia| + |d_ja| <= skin_a on each axis, so the pair's distance is at
// least sum_a max(|dr_a| - skin_a, 0)^2 with dr from the reference
// positions; s_a is skin_a plus the caller's rounding margin.  One warp
// builds one 32-bit word of a slot's bits with a ballot, into shared
// memory for 16 slots at a time; a warp per slot then writes the set
// bits, in ascending order, as the slot's list.
constexpr int kCandSlots = 16;

__global__ void mega_candidates_kernel(const float* __restrict__ r, const int* __restrict__ tag,
                                       const float* __restrict__ shifts, const Geom g,
                                       const float s0, const float s1, const float s2,
                                       const float rc2, const int W, const int R, const int cap,
                                       unsigned short* __restrict__ list,
                                       int* __restrict__ count) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    unsigned* wbuf = reinterpret_cast<unsigned*>(smem + (stencil_smem_bytes(g.C) + 3) / 4);
    const long long M = (long long)g.nx * g.ny * g.nz * g.C;
    const int cell = blockIdx.x;
    // the cell's place in the megastep's runs along x
    const int ix = cell % g.nx, rr = ix % R;
    const int uw = min(R, g.nx - (ix - rr)) + 2;
    stage_stencil(Vec3{const_cast<float*>(r), 1, M}, tag, shifts, g, cell, sx, sy, sz, sv);
    __syncthreads();
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i0 = 0; i0 < g.C; i0 += kCandSlots) {
        const int ns = min(kCandSlots, g.C - i0);
        for (int ii = 0; ii < ns; ++ii) {
            const int ic = 13 * g.C + i0 + ii;
            if (!sv[ic]) {                     // a padding slot has none
                for (int wd = threadIdx.x; wd < W; wd += blockDim.x) wbuf[ii * W + wd] = 0u;
                continue;
            }
            const float xi = sx[ic], yi = sy[ic], zi = sz[ic];
            for (int wd = threadIdx.x >> 5; wd < W; wd += nw) {
                const int t = 32 * wd + lane;
                bool keep = false;
                if (t < n && sv[t] && t != ic) {
                    const float mx = fmaxf(fabsf(xi - sx[t]) - s0, 0.0f);
                    const float my = fmaxf(fabsf(yi - sy[t]) - s1, 0.0f);
                    const float mz = fmaxf(fabsf(zi - sz[t]) - s2, 0.0f);
                    const float lb = __fadd_rn(
                        __fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)), __fmul_rn(mz, mz));
                    keep = lb < rc2;
                }
                const unsigned word = __ballot_sync(0xffffffffu, keep);
                if (lane == 0) wbuf[ii * W + wd] = word;
            }
        }
        __syncthreads();
        // each slot's list: the union index, in the megastep's run
        // layout, of each set bit in ascending order, as many as fit
        for (int ii = threadIdx.x >> 5; ii < ns; ii += nw) {
            const long long j = (long long)cell * g.C + i0 + ii;
            int base = 0;
            for (int wd = 0; wd < W; ++wd) {
                const unsigned word = wbuf[ii * W + wd];
                if ((word >> lane) & 1u) {
                    const int pos = base + __popc(word & ((1u << lane) - 1u));
                    if (pos < cap) {
                        const int t = 32 * wd + lane, k = t / g.C;
                        list[j * cap + pos] =
                            (unsigned short)(union_base(k, rr, uw, g.C) + t - k * g.C);
                    }
                }
                base += __popc(word);
            }
            if (lane == 0) count[j] = base;
        }
        __syncthreads();
    }
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

int hoomd_cell_pair_plane(const float* pos, long long pss, long long pcs, const int* tag,
                          const float* shifts, const float* par, int np, float* frc,
                          long long fss, long long fcs, int nx, int ny, int nz, int C, int ev,
                          int approx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    if (approx && ev == EV_LJ)
        return launch_cell_pair<EV_LJ, true, false>(pos, pss, pcs, tag, shifts, par, np, frc,
                                                   fss, fcs, nullptr, nullptr, g, st);
    return dispatch_eval(ev, [&](auto t) {
        return launch_cell_pair<decltype(t)::value, false, false>(
            pos, pss, pcs, tag, shifts, par, np, frc, fss, fcs, nullptr, nullptr, g, st);
    });
}

int hoomd_cell_pair_planar(const float* pos, long long pss, long long pcs, const int* tag,
                           const float* shifts, const float* par, int np, float* frc,
                           float* pe, float* vir, int nx, int ny, int nz, int C, int ev,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    return dispatch_eval(ev, [&](auto t) {
        return launch_cell_pair<decltype(t)::value, false, true>(
            pos, pss, pcs, tag, shifts, par, np, frc, 3, 1, pe, vir, g, st);
    });
}

// k velocity-Verlet steps on plane-layout state (3, nz, ny, nx, C),
// updated in place, in one cooperative launch.  method: 0 nve, 1 nvt, 2
// langevin.  noise holds k * 3 * M floats (langevin only).  list and
// count are the candidate set of the reference positions r
// (hoomd_mega_candidates): a slot whose count is at most cap walks its
// row of list, any other every staged slot.
// dpart needs 3 * ceil(M / 256) Top2 records (12 bytes each), kpart
// max(nc, ceil(M / 256)) floats; mp carries np evaluator parameters after
// [.., rc2, e_shift]; sc = [xi, eta, ke2, mdmax] is read and written.
int hoomd_megastep(float* p, float* v, float* f, const float* w, const float* m,
                   const float* r, const int* tag, const float* shifts, const float* mp,
                   int np, float* sc, const float* kt, const float* noise, const void* list,
                   const int* count, int cap, void* dpart,
                   float* kpart, int nx, int ny, int nz, int C, int k, int method, int ev,
                   int approx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ev < 0 || ev >= EV_COUNT || method < 0 || method > 2 || k < 1)
        return cudaErrorInvalidValue;
    MegaArgs a;
    a.p = p;
    a.v = v;
    a.f = f;
    a.w = w;
    a.m = m;
    a.r = r;
    a.tag = tag;
    a.shifts = shifts;
    a.mp = mp;
    a.np = np;
    a.sc = sc;
    a.kt = kt;
    a.noise = noise;
    a.list = static_cast<const unsigned short*>(list);
    a.count = count;
    a.cap = cap;
    a.dpart = static_cast<Top2*>(dpart);
    a.kpart = kpart;
    a.g = Geom{nx, ny, nz, C};
    a.M = (long long)nx * ny * nz * C;
    a.nb = (int)((a.M + kChunk - 1) / kChunk);
    a.k = k;
    a.R = mega_run(nx, C);
    a.nrun = (nx + a.R - 1) / a.R;
    if (method == 0) return window<0>(ev, approx, a, st);
    if (method == 1) return window<1>(ev, approx, a, st);
    return window<2>(ev, approx, a, st);
}

// The candidate set of the reference planes r (3, nz, ny, nx, C): in the
// megastep's run layout, each slot's candidates as union indices into
// list (M, cap), cap a
// multiple of 8 (the first min(count, cap) of a row are written), with
// their number in count (M); s0..s2 the per-axis skins with their
// rounding margin, rc2 the squared cutoff.
int hoomd_mega_candidates(const float* r, const int* tag, const float* shifts, float s0,
                          float s1, float s2, float rc2, void* list, int* count,
                          int cap, int nx, int ny, int nz, int C, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    const int W = (27 * C + 31) / 32;
    const size_t smem = (stencil_smem_bytes(C) + 3) / 4 * 4 + (size_t)kCandSlots * W * 4;
    cudaError_t e = set_smem(mega_candidates_kernel, smem);
    if (e != cudaSuccess) return e;
    if (cap % 8 != 0) return cudaErrorInvalidValue;
    mega_candidates_kernel<<<nx * ny * nz, 256, smem, st>>>(
        r, tag, shifts, g, s0, s1, s2, rc2, W, mega_run(nx, C), cap,
        static_cast<unsigned short*>(list), count);
    return cudaGetLastError();
}

const char* hoomd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
