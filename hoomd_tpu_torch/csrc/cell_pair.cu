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
// What bounds them on this card: the pair loop.  At the 64k LJ bench
// shape (2352 cells, C = 40) a particle has ~730 live candidates in its 27
// cells and ~55 of them inside r_cut, ~20 flops per candidate against a
// few MB of state, so the fp32 issue rate, not memory; the evaluators
// other than lj add a sqrtf and an expf or powf per pair inside r_cut.
//
// The plane and planar kernels run on the warp walk of cell_walk.cuh: a
// block per tile of tx <= PAIR_TILE cells of an x-row stages the tile's
// union (9 (dz, dy) rows of tx + 2 cells) once, compacted to the live
// slots, with a box per union cell; a warp per home walks the union cells
// inside its cut, lists the pairs inside it by ballot and evaluates them 32
// at a time with the warp converged, so an evaluator pays its
// transcendentals only inside the cut.  The sums are ordered: lane a folds
// sum a over each batch, oldest pair first, with the first design's
// per-pair operations, so every slot's sums are that design's bits (a block
// per cell and a thread per slot walking all 27 C staged slots, padding
// included, serially, each thread's in-cut branch diverging across its
// warp); the bench job's trajectory rests on those bits.  Padding slots get
// zero outputs, as they did.  No atomics: a pair is evaluated from both
// sides, like the TPU's full stencil.
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

#include "cell_walk.cuh"

// Cells per tile at most (chosen by timing at the bench plan:
// profile_torch_bench.py tiles builds the other widths with -DPAIR_TILE=n)
#ifndef PAIR_TILE
#define PAIR_TILE 2
#endif

namespace cg = cooperative_groups;

namespace hoomd_torch {

// ---------------------------------------------------------------------------
// cell_pair_plane / cell_pair_planar: a tile of tx <= TX cells of an x-row
// (grid: tiles, ny, nz), the union staged once (cell_tile.cuh stage_union,
// each union cell under the shift of the home cells that reach it; on a
// grid 1 or 2 cells wide a cell of a row is two or three union cells),
// compacted, with each union cell's box; the homes are the tile's live
// slots (pack_homes), a warp per home (walk_home, ordered).  A home's own
// coordinates are its staged entry (row (0, 0), union cell lc + 1, its
// rank among its cell's live slots), the first design's x_i, and that
// entry is the self pair.  Lane a of the home's warp writes output a: F
// (3); PV: PE and the virial, halved.  pos and frc are strided (Vec3).

template <int EV, bool APPROX, bool PV>
__global__ void __launch_bounds__(kWalkWarps * 32)
    pair_walk_kernel(const Vec3 pos, const int* __restrict__ tag,
                     const float* __restrict__ shifts, const float* __restrict__ par,
                     const int np, const Geom g, const int TX, const Vec3 frc,
                     float* __restrict__ pe, float* __restrict__ vir) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const WalkSmem S = walk_smem(smem4, TX, C);
    const Tile t = tile_of_block(g, TX);
    const long long cell0 = (long long)t.x0 + g.nx * (t.iy + (long long)g.ny * t.iz);
    for (int q = threadIdx.x; q < t.tx * C; q += blockDim.x) {   // the padding slots' outputs
        const long long slot = cell0 * C + q;
        if (tag[slot] >= 0) continue;
        for (int a = 0; a < 3; ++a) frc.at(slot, a) = 0.0f;
        if (PV) {
            pe[slot] = 0.0f;
            for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.0f;
        }
    }
    pack_homes(tag, g, t, S.hslot, S.hstart);
    const int nh = S.hstart[t.tx];
    if (nh == 0) return;                        // the whole block: no live home
    stage_union(tag, shifts, g, t, 0, 9, S.off,
                [&](const int idx, const int, const int, const long long sl, const float* sh) {
                    S.ent[idx] = make_float4(pos.at(sl, 0) + sh[0], pos.at(sl, 1) + sh[1],
                                             pos.at(sl, 2) + sh[2], 0.0f);
                });
    stage_boxes(9 * t.W, S.ent, S.off, S.box);
    __syncthreads();
    const PairPar P = load_pair_par(par, np);
    float4* L = S.lst + w * kWalkList;
    for (int p = w; p < nh; p += kWalkWarps) {  // warp-uniform
        const long long slot = S.hslot[p];
        const int lc = home_cell(S.hstart, t.tx, p);
        const int self = S.off[4 * t.W + lc + 1] + p - S.hstart[lc];
        const float4 h = S.ent[self];
        float acc;
        walk_home<EV, APPROX, PV, true>(h.x, h.y, h.z, self, S.ent, S.box, S.off, t.W, lc, P,
                                        L, &acc);
        if (lane < 3) frc.at(slot, lane) = acc;
        if (PV && lane == 3) pe[slot] = 0.5f * acc;
        if (PV && lane >= 4 && lane < 10) vir[slot * 6 + lane - 4] = 0.5f * acc;
        __syncwarp();                           // the list is read before the next home
    }
}

template <int EV, bool APPROX, bool PV>
static cudaError_t launch_pair_walk(const float* pos, long long pss, long long pcs,
                                    const int* tag, const float* shifts, const float* par,
                                    int np, float* frc, long long fss, long long fcs,
                                    float* pe, float* vir, const Geom g, cudaStream_t st) {
    const int tx = union_tile(g.nx, g.C, PAIR_TILE);
    const size_t smem = walk_smem_bytes(tx, g.C);
    cudaError_t e = set_smem(pair_walk_kernel<EV, APPROX, PV>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((g.nx + tx - 1) / tx, g.ny, g.nz);
    pair_walk_kernel<EV, APPROX, PV><<<grid, kWalkWarps * 32, smem, st>>>(
        Vec3{const_cast<float*>(pos), pss, pcs}, tag, shifts, par, np, g, tx,
        Vec3{frc, fss, fcs}, pe, vir);
    return cudaGetLastError();
}

// The build and occupancy of the plane (PV false) or planar (PV true)
// kernel of evaluator ev at capacity C on a grid nx cells wide
// (kernel_occupancy's out[5]) and its threads per block (out[5]).
template <bool APPROX, bool PV>
static int pair_walk_occupancy(const int ev, const int nx, const int C, int* out) {
    out[5] = kWalkWarps * 32;
    const size_t smem = walk_smem_bytes(union_tile(nx, C, PAIR_TILE), C);
    if constexpr (APPROX)
        return kernel_occupancy(pair_walk_kernel<EV_LJ, true, PV>, out[5], smem, out);
    else
        return dispatch_eval(ev, [&](auto t) {
            return kernel_occupancy(pair_walk_kernel<decltype(t)::value, false, PV>, out[5],
                                    smem, out);
        });
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
// stencil (27 C entries, build_cell_shifts order), t is a candidate of i
// when both slots are live, t is not i itself, and the pair can come
// inside r_cut while the drift guard holds.  The guard allows
// |d_ia| + |d_ja| <= skin_a on each axis, so the pair's distance is at
// least sum_a max(|dr_a| - skin_a, 0)^2 with dr from the reference
// positions; s_a is skin_a plus the caller's rounding margin.  A slot's
// list holds its candidates' union indices in the megastep's staging of
// its run, ascending, which is the stencil order.
//
// A block takes the megastep's own work item, a run of up to R cells
// along x.  It stages the run's union of 9 (R + 2) cells once, compacted
// to their live slots (cell_tile.cuh compact_cells), each entry with its
// union index and each cell's shift read from the table as the megastep
// reads it, and each staged cell's bounding box.  The run's homes are the
// staged entries of its own cells.  A warp takes a home at a time: it
// skips the home's staged cells whose box fails the candidate test (the
// box's per-axis distance put through the test, rounded as an entry's;
// rounding is monotone, so every entry of such a cell fails it too and
// no list changes; ~45% of the candidates at the bench plan, as row 4's
// skip), and its lanes test the entries of the kept cells in stencil
// order, 32 at a time; a ballot gives each kept entry its place in the
// row, so the list is written in ascending order with contiguous stores.
// No atomics.  The walk is latency-bound, not bound by the test's
// arithmetic (a trivial test took as long): its body is branch-free (every
// lane loads and tests an entry, the out-of-range ones masked), since a
// branch around the load put convergence barriers before every vote, and
// each stencil row's span is found once per home by one lane.  Its first
// design, a block per cell staging the cell's own 27-cell stencil with its
// padding and testing every staged slot against 16 slots at a time, took
// 4.5% of its bound at the bench plan.
//
// Warps per block and blocks per SM, chosen by timing on the card: 12
// warps held to 56 registers (3 blocks per SM) ran faster than 8 (5
// blocks) or 16 (2 blocks).
constexpr int kCandWarps = 12;
constexpr int kCandBlocks = 3;

// Shared memory of one block at capacity C, runs of R cells: the staged
// union, its cells' boxes and shifts, their ids and the offsets.
static inline size_t cand_smem_bytes(const int C, const int R) {
    const int nu = 9 * (R + 2);
    return (size_t)nu * C * sizeof(float4) + (size_t)nu * 9 * sizeof(float) +
           (size_t)(2 * nu + 1) * sizeof(int);
}

// sum_a max(d_a - s_a, 0)^2 of the per-axis distances d_a, every
// operation rounded to nearest, in the plain version's order.
__device__ __forceinline__ float cand_lb(const float dx, const float dy, const float dz,
                                         const float s0, const float s1, const float s2) {
    const float mx = fmaxf(__fsub_rn(dx, s0), 0.0f);
    const float my = fmaxf(__fsub_rn(dy, s1), 0.0f);
    const float mz = fmaxf(__fsub_rn(dz, s2), 0.0f);
    return __fadd_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)), __fmul_rn(mz, mz));
}

__global__ void __launch_bounds__(kCandWarps * 32, kCandBlocks)
    mega_candidates_kernel(const float* __restrict__ r, const int* __restrict__ tag,
                           const float* __restrict__ shifts, const Geom g, const float s0,
                           const float s1, const float s2, const float rc2, const int R,
                           const int nrun, const int cap, unsigned short* __restrict__ list,
                           int* __restrict__ count) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int numax = 9 * (R + 2);
    float4* ent = smem4;                                        // x, y, z, union index
    float* box = reinterpret_cast<float*>(ent + numax * C);     // [cell][lo xyz, hi xyz]
    float* ush = box + numax * 6;
    int* ucell = reinterpret_cast<int*>(ush + numax * 3);
    int* off = ucell + numax;
    const long long M = (long long)g.nx * g.ny * g.nz * C;
    const int row = blockIdx.x / nrun;
    const int ix0 = (blockIdx.x - row * nrun) * R;
    const int rlen = min(R, g.nx - ix0);
    const int uw = rlen + 2, nu = 9 * uw;
    const int cell0 = ix0 + g.nx * row;
    // each union cell's id and shift, read from the shift table of a cell
    // of the run that has it in its stencil (mega_window's rule)
    for (int u = threadIdx.x; u < nu; u += blockDim.x) {
        const int ux = u % uw, uyz = u / uw;
        const int rh = min(max(ux - 1, 0), rlen - 1);
        const int k = uyz * 3 + (ux - rh);
        ucell[u] = (int)(stencil_slot(g, cell0 + rh, k, 0) / C);
        for (int a = 0; a < 3; ++a)
            ush[3 * u + a] = shifts[((long long)(cell0 + rh) * 27 + k) * 3 + a];
    }
    // a padding slot of the run has no candidates
    for (int q = threadIdx.x; q < rlen * C; q += blockDim.x)
        if (tag[(long long)cell0 * C + q] < 0) count[(long long)cell0 * C + q] = 0;
    __syncthreads();
    compact_cells(
        nu, C, tag, [&](const int u) { return (long long)ucell[u]; }, off,
        [&](const int u, const int s, const int idx, const long long sl) {
            ent[idx] = make_float4(r[sl] + ush[3 * u], r[M + sl] + ush[3 * u + 1],
                                   r[2 * M + sl] + ush[3 * u + 2], __int_as_float(u * C + s));
        });
    // each staged cell's box (an empty one lies at infinity)
    for (int u = w; u < nu; u += kCandWarps) {
        float b[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                      -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
        for (int e = off[u] + lane; e < off[u + 1]; e += 32) {
            const float4 q = ent[e];
            b[0] = fminf(b[0], q.x), b[1] = fminf(b[1], q.y), b[2] = fminf(b[2], q.z);
            b[3] = fmaxf(b[3], q.x), b[4] = fmaxf(b[4], q.y), b[5] = fmaxf(b[5], q.z);
        }
        for (int o = 16; o > 0; o >>= 1)
            for (int a = 0; a < 3; ++a) {
                b[a] = fminf(b[a], __shfl_xor_sync(0xffffffffu, b[a], o));
                b[3 + a] = fmaxf(b[3 + a], __shfl_xor_sync(0xffffffffu, b[3 + a], o));
            }
        if (lane < 6) box[u * 6 + lane] = b[lane];
    }
    __syncthreads();
    // the homes: the staged entries of the run's own cells, union cells
    // hu0 .. hu0 + rlen - 1 (the row dz = dy = 0), under the zero shift of
    // stencil entry 13, as the parent staged them
    const int hu0 = 4 * uw + 1;
    const int h0 = off[hu0], nh = off[hu0 + rlen] - h0;
    const unsigned lt = lanemask_lt();
    for (int p = w; p < nh; p += kCandWarps) {      // warp-uniform
        const float4 h = ent[h0 + p];
        const int self = __float_as_int(h.w);
        const int rr = self / C - hu0;              // the home's cell in the run
        const long long j = (long long)(cell0 + rr) * C + (self - (self / C) * C);
        // the home's stencil cells whose box can hold a candidate
        bool near = false;
        if (lane < 27) {
            const float* b = box + (((lane / 9) * 3 + (lane / 3) % 3) * uw + rr + lane % 3) * 6;
            near = cand_lb(fmaxf(fmaxf(__fsub_rn(b[0], h.x), __fsub_rn(h.x, b[3])), 0.0f),
                           fmaxf(fmaxf(__fsub_rn(b[1], h.y), __fsub_rn(h.y, b[4])), 0.0f),
                           fmaxf(fmaxf(__fsub_rn(b[2], h.z), __fsub_rn(h.z, b[5])), 0.0f), s0,
                           s1, s2) < rc2;
        }
        const unsigned keep = __ballot_sync(0xffffffffu, near);
        // stencil row r (dz, dy) = (r / 3, r % 3) holds entries 3 r .. 3 r +
        // 2, union cells r uw + rr .. r uw + rr + 2: one range of the staged
        // entries.  Lane r < 9 finds the span from its row's first to its
        // last kept cell (a skipped cell between them is walked, and its
        // entries fail the test as its box did)
        int rb = 0, re = 0;
        if (lane < 9) {
            const unsigned m = (keep >> (3 * lane)) & 7u;
            if (m) {
                const int ur = lane * uw + rr;
                rb = off[ur + __ffs(m) - 1];
                re = off[ur + 32 - __clz(m)];
            }
        }
        unsigned short* out = list + j * cap;
        int n = 0;                                  // candidates so far (warp-uniform)
        for (int r = 0; r < 9; ++r) {
            const int beg = __shfl_sync(0xffffffffu, rb, r);
            const int end = __shfl_sync(0xffffffffu, re, r);
            // branch-free: every lane loads and tests an entry of the span
            for (int e0 = beg; e0 < end; e0 += 32) {
                const float4 q = ent[min(e0 + lane, end - 1)];
                const int ui = __float_as_int(q.w);
                const float lb = cand_lb(fabsf(__fsub_rn(h.x, q.x)), fabsf(__fsub_rn(h.y, q.y)),
                                         fabsf(__fsub_rn(h.z, q.z)), s0, s1, s2);
                const bool in = (e0 + lane < end) & (ui != self) & (lb < rc2);
                const unsigned b = __ballot_sync(0xffffffffu, in);
                const int at = n + __popc(b & lt);
                if (in & (at < cap)) out[at] = (unsigned short)ui;
                n += __popc(b);
            }
        }
        if (lane == 0) count[j] = n;
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
        return launch_pair_walk<EV_LJ, true, false>(pos, pss, pcs, tag, shifts, par, np, frc,
                                                   fss, fcs, nullptr, nullptr, g, st);
    return dispatch_eval(ev, [&](auto t) {
        return launch_pair_walk<decltype(t)::value, false, false>(
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
        return launch_pair_walk<decltype(t)::value, false, true>(
            pos, pss, pcs, tag, shifts, par, np, frc, 3, 1, pe, vir, g, st);
    });
}

// The build and occupancy of the plane kernel of evaluator ev (approx:
// lj's fast reciprocal) at capacity C on a grid nx cells wide
// (kernel_occupancy's out[5]) and its threads per block (out[5]).
int hoomd_cell_pair_plane_occupancy(int ev, int approx, int nx, int C, int* out) {
    return approx && ev == EV_LJ ? pair_walk_occupancy<true, false>(ev, nx, C, out)
                                 : pair_walk_occupancy<false, false>(ev, nx, C, out);
}

// The same for the planar kernel (exact divide).
int hoomd_cell_pair_planar_occupancy(int ev, int nx, int C, int* out) {
    return pair_walk_occupancy<false, true>(ev, nx, C, out);
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
// list (M, cap), cap a multiple of 8 (the first min(count, cap) of a row
// are written), with their number in count (M); s0..s2 the per-axis
// skins with their rounding margin, rc2 the squared cutoff.
int hoomd_mega_candidates(const float* r, const int* tag, const float* shifts, float s0,
                          float s1, float s2, float rc2, void* list, int* count,
                          int cap, int nx, int ny, int nz, int C, void* stream) {
    if (cap % 8 != 0) return cudaErrorInvalidValue;
    const int R = mega_run(nx, C), nrun = (nx + R - 1) / R;
    const size_t smem = cand_smem_bytes(C, R);
    cudaError_t e = set_smem(mega_candidates_kernel, smem);
    if (e != cudaSuccess) return e;
    mega_candidates_kernel<<<nrun * ny * nz, kCandWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        r, tag, shifts, Geom{nx, ny, nz, C}, s0, s1, s2, rc2, R, nrun, cap,
        static_cast<unsigned short*>(list), count);
    return cudaGetLastError();
}

// The build and occupancy of the candidate build at capacity C on a grid
// nx cells wide (kernel_occupancy's out[5]) and its threads per block
// (out[5]).
int hoomd_mega_candidates_occupancy(int nx, int C, int* out) {
    out[5] = kCandWarps * 32;
    return kernel_occupancy(mega_candidates_kernel, out[5], cand_smem_bytes(C, mega_run(nx, C)),
                            out);
}

const char* hoomd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
