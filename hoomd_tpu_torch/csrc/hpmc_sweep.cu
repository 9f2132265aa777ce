// Hand-written Hopper kernels of the fused hard-particle MC sweep
// (hoomd_tpu_torch/hpmc/sweep.py binds them through ctypes).
//
// hoomd_hpmc_sphere_sweep  replaces hoomd_tpu/hpmc/pallas_sweep.py:fused_sphere_sweep
//                          (hard-sphere translation trials).
// hoomd_hpmc_poly_sweep    replaces hoomd_tpu/hpmc/pallas_sweep.py:fused_poly_sweep
//                          (one-type convex polyhedra: translate or rotate, SAT).
//
// A call runs R rounds x 8 parity sub-sweeps on cell planes (nz, ny, nx*C).
// The TPU kernel keeps the whole grid in VMEM, proposes a trial in EVERY
// cell and masks out 7/8 of them, and forms the 27-cell windows by rolling
// whole planes.  Here a sub-sweep touches only its active cells, in order,
// so each sees the previous one's commits.  The commit is race-free: the
// 27-cell window of an active cell holds no other cell of its class,
// because the cell counts are even and same-class cells lie 2 apart (on
// a 2-cell axis the -1 and +1 offsets name the same cell twice, which a
// veto does not mind).
//
// Numerics: the proposal and the overlap tests round each operation as
// the plain torch version's separate operations do (__fmul_rn and
// friends, which the compiler never contracts into fused multiply-adds),
// and call the same libm functions (logf, sinf, cosf, expf, sqrtf,
// rsqrtf, floorf, rintf), so kernel and plain version take the same
// decisions on the card.
//
// What bounds them on this card: at the config-5 plan (10x10x10 cells,
// C = 13, N = 4096 cubes) a sub-sweep moves 0.4 MB of planes and tests
// 125 trials against ~110 live window slots each, a few SAT axes per
// pair, well under a microsecond of memory or FP32 time; what it costs is
// latency: a trial's proposal (12 uniforms, two Box-Muller pairs, a
// quaternion product) and the SAT of its nearest neighbours are serial
// chains, and the sub-sweeps are ordered.
//
// hoomd_hpmc_sphere_sweep: ONE cooperative launch per call, a block per
// active cell, the proposals of a segment drawn at its start in
// parallel, grid.sync() between the sub-sweeps (see "The sphere sweep"
// below).  Its first design made one launch per
// sub-sweep, and thread 0 alone drew each trial while the block waited.
//
// hoomd_hpmc_poly_sweep: ONE cooperative launch per call (persistent
// blocks, a thread per window slot, grid.sync() between the ordered
// phases), so any grid up to 32^3 cells fits among the co-resident blocks,
// each block looping over its share of a sub-sweep's active cells:
//   * prologue: the input planes are copied into the output planes and
//     the counts zeroed (the wrapper clones nothing);
//   * a cell is active once per segment (a run of sub-sweeps in which no
//     class comes twice: a round, for the class orders the sweep draws),
//     and only its own commit moves its mover, so at a segment's start
//     the block that owns a cell draws its proposal from the state then,
//     which is the state its sub-sweep would see: a thread per (class,
//     cell), all in parallel, with the plain version's arithmetic;
//   * a sub-sweep: a block per active cell; each thread takes a live slot
//     of the window and tests A's face normals (most pairs are separated
//     there); the pairs that pass go to a list in shared memory, and
//     kAxisLanes lanes of a warp take each over B's faces and the edge x
//     edge axes at once, a ballot per step giving "separated";
//     __syncthreads_or gives the veto; thread 0 commits and tallies; what
//     a trial needs before the sub-sweep's barrier (its proposal, its
//     window slot and whether it is live) is read before it;
//   * the tallies go to the counts with integer atomics at the end (exact
//     in any order).
// What bounds it: the ordered sub-sweeps' latency.  profile_torch_bench.py
// sweep-parts builds this file also with POLY_SWEEP_NO_SAT (no overlap
// tests) and with POLY_SWEEP_NO_CELLS as well (no draws, trials or
// commits: the prologue, the barriers and the tallies alone) and times
// the three at config 5's plan.
// A first design of this launch gave each active cell one warp whose
// lanes walked the window 32 slots at a time: at config 5's plan every
// step of that walk waits on device memory with a single warp per SM,
// and the call took 0.20 ms on an H100 (700 W), 3x the 8 launches it
// replaced.
// Every C entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace hoomd_hpmc {

namespace cg = cooperative_groups;

constexpr float kTiny = 1e-12f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kThird = 1.0f / 3.0f;
constexpr float kEps = 1e-7f;
constexpr int kCenter = 13;
constexpr int kMaxV = 8, kMaxF = 8, kMaxE = 6;

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

struct Geom {
    int nx, ny, nz, C;
    float L[3];
};

struct PolyTables {
    int nv, nf, ne;
    float v[kMaxV][3];
    float f[kMaxF][3];
    float e[kMaxE][3];
    float lo[kMaxF];
    float hi[kMaxF];
};

// x - L floor(x / L + 0.5)
__device__ __forceinline__ float wrap_box(float x, float L) {
    return fs(x, fm(L, floorf(fa(__fdiv_rn(x, L), 0.5f))));
}

// d - L rint(d / L)
__device__ __forceinline__ float min_image(float d, float L) {
    return fs(d, fm(L, rintf(__fdiv_rn(d, L))));
}

__device__ __forceinline__ float rsqrt_exact(float x) {
    const float r = rsqrtf(x);
    return fm(r, fs(1.5f, fm(fm(fm(0.5f, x), r), r)));
}

// Box-Muller: two gaussians from (u1, u2), one from (u3, u4).
__device__ __forceinline__ void gaussians(float u1, float u2, float u3, float u4, float& g1,
                                          float& g2, float& g3) {
    const float r1 = sqrtf(fm(-2.0f, logf(fa(u1, kTiny))));
    g1 = fm(r1, cosf(fm(kTwoPi, u2)));
    g2 = fm(r1, sinf(fm(kTwoPi, u2)));
    g3 = fm(sqrtf(fm(-2.0f, logf(fa(u3, kTiny)))), cosf(fm(kTwoPi, u4)));
}

__device__ __forceinline__ float sum3sq(float a, float b, float c) {
    return fa(fa(fm(a, a), fm(b, b)), fm(c, c));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
    return fa(fa(fm(a0, b0), fm(a1, b1)), fm(a2, b2));
}

// Rows of R(q), term for term as the plain version writes them.
__device__ __forceinline__ void quat_to_R(float w, float x, float y, float z, float R[3][3]) {
    R[0][0] = fs(1.f, fm(2.f, fa(fm(y, y), fm(z, z))));
    R[0][1] = fm(2.f, fs(fm(x, y), fm(w, z)));
    R[0][2] = fm(2.f, fa(fm(x, z), fm(w, y)));
    R[1][0] = fm(2.f, fa(fm(x, y), fm(w, z)));
    R[1][1] = fs(1.f, fm(2.f, fa(fm(x, x), fm(z, z))));
    R[1][2] = fm(2.f, fs(fm(y, z), fm(w, x)));
    R[2][0] = fm(2.f, fs(fm(x, z), fm(w, y)));
    R[2][1] = fm(2.f, fa(fm(y, z), fm(w, x)));
    R[2][2] = fs(1.f, fm(2.f, fa(fm(x, x), fm(y, y))));
}

// min/max over the vertex table of c . v
__device__ __forceinline__ void supports(const PolyTables& T, float c0, float c1, float c2,
                                         float& lo, float& hi) {
    lo = hi = dot3(c0, c1, c2, T.v[0][0], T.v[0][1], T.v[0][2]);
#pragma unroll
    for (int k = 1; k < kMaxV; ++k) {
        if (k < T.nv) {
            const float p = dot3(c0, c1, c2, T.v[k][0], T.v[k][1], T.v[k][2]);
            lo = fminf(lo, p);
            hi = fmaxf(hi, p);
        }
    }
}

__device__ __forceinline__ bool separated(float loA, float hiA, float t, float loB, float hiB) {
    return (loA > fa(fa(t, hiB), kEps)) || (fa(t, loB) > fa(hiA, kEps));
}

// The frame of a pair: B - A = dg rotated into A's frame (dr) and the
// rows of R(q_A^-1 q_B) (S), term for term as hoomd_tpu_torch/hpmc/
// sweep.py:poly_overlap_plain forms them.
struct PairFrame {
    float dr[3];
    float S[3][3];
};

__device__ __forceinline__ PairFrame pair_frame(const float RA[3][3], const float qa[4],
                                                float dgx, float dgy, float dgz, float ww,
                                                float wx, float wy, float wz) {
    PairFrame F;
    F.dr[0] = fa(fa(fm(RA[0][0], dgx), fm(RA[1][0], dgy)), fm(RA[2][0], dgz));
    F.dr[1] = fa(fa(fm(RA[0][1], dgx), fm(RA[1][1], dgy)), fm(RA[2][1], dgz));
    F.dr[2] = fa(fa(fm(RA[0][2], dgx), fm(RA[1][2], dgy)), fm(RA[2][2], dgz));
    const float qw = qa[0], qx = qa[1], qy = qa[2], qz = qa[3];
    const float sw = fa(fa(fa(fm(qw, ww), fm(qx, wx)), fm(qy, wy)), fm(qz, wz));
    const float sx = fa(fs(fs(fm(qw, wx), fm(qx, ww)), fm(qy, wz)), fm(qz, wy));
    const float sy = fs(fs(fa(fm(qw, wy), fm(qx, wz)), fm(qy, ww)), fm(qz, wx));
    const float sz = fs(fa(fs(fm(qw, wz), fm(qx, wy)), fm(qy, wx)), fm(qz, ww));
    quat_to_R(sw, sx, sy, sz, F.S);
    return F;
}

// The SAT axes of a pair, in poly_overlap_plain's order: A's face normals
// (static in A's frame), B's face normals mapped into A's frame, then the
// edge x edge axes (i_e, j_e), j_e fastest.  Each tells whether it
// separates the pair, with poly_overlap_plain's arithmetic; the pair
// overlaps when none does, in whatever order they are asked.
__device__ __forceinline__ bool sep_face_a(const PolyTables& T, const PairFrame& F, int i) {
    const float n0 = T.f[i][0], n1 = T.f[i][1], n2 = T.f[i][2];
    const float t = dot3(F.dr[0], F.dr[1], F.dr[2], n0, n1, n2);
    float loB, hiB;
    supports(T, dot3(F.S[0][0], F.S[1][0], F.S[2][0], n0, n1, n2),
             dot3(F.S[0][1], F.S[1][1], F.S[2][1], n0, n1, n2),
             dot3(F.S[0][2], F.S[1][2], F.S[2][2], n0, n1, n2), loB, hiB);
    return separated(T.lo[i], T.hi[i], t, loB, hiB);
}

__device__ __forceinline__ bool sep_face_b(const PolyTables& T, const PairFrame& F, int j) {
    const float c0 = dot3(F.S[0][0], F.S[0][1], F.S[0][2], T.f[j][0], T.f[j][1], T.f[j][2]);
    const float c1 = dot3(F.S[1][0], F.S[1][1], F.S[1][2], T.f[j][0], T.f[j][1], T.f[j][2]);
    const float c2 = dot3(F.S[2][0], F.S[2][1], F.S[2][2], T.f[j][0], T.f[j][1], T.f[j][2]);
    const float t = dot3(F.dr[0], F.dr[1], F.dr[2], c0, c1, c2);
    float lo, hi;
    supports(T, c0, c1, c2, lo, hi);
    return separated(lo, hi, t, T.lo[j], T.hi[j]);
}

__device__ __forceinline__ bool sep_edge(const PolyTables& T, const PairFrame& F, int i, int j) {
    float b[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
        b[r] = dot3(F.S[r][0], F.S[r][1], F.S[r][2], T.e[j][0], T.e[j][1], T.e[j][2]);
    const float e0 = T.e[i][0], e1 = T.e[i][1], e2 = T.e[i][2];
    const float cx = fs(fm(e1, b[2]), fm(e2, b[1]));
    const float cy = fs(fm(e2, b[0]), fm(e0, b[2]));
    const float cz = fs(fm(e0, b[1]), fm(e1, b[0]));
    const float t = dot3(F.dr[0], F.dr[1], F.dr[2], cx, cy, cz);
    float lo, hi, loB, hiB;
    supports(T, cx, cy, cz, lo, hi);
    supports(T, dot3(F.S[0][0], F.S[1][0], F.S[2][0], cx, cy, cz),
             dot3(F.S[0][1], F.S[1][1], F.S[2][1], cx, cy, cz),
             dot3(F.S[0][2], F.S[1][2], F.S[2][2], cx, cy, cz), loB, hiB);
    return separated(lo, hi, t, loB, hiB);
}

// Axis a of B's faces and the edge pairs (a < nf + ne ne).
__device__ __forceinline__ bool sep_rest(const PolyTables& T, const PairFrame& F, int a) {
    if (a < T.nf) return sep_face_b(T, F, a);
    a -= T.nf;
    return sep_edge(T, F, a / T.ne, a % T.ne);
}

// Active cell m of parity class c (x parity in bit 0, z in bit 2), its
// coordinates and its flat id.
__device__ __forceinline__ int class_cell(const Geom& g, const int c, const int m, int& z, int& y,
                                          int& x) {
    const int hx = g.nx / 2, hy = g.ny / 2;
    x = (c & 1) + 2 * (m % hx);
    y = ((c >> 1) & 1) + 2 * ((m / hx) % hy);
    z = (c >> 2) + 2 * (m / (hx * hy));
    return (z * g.ny + y) * g.nx + x;
}

// Flat slot index of window candidate k (offset k / C in (dz, dy, dx)
// order with dx fastest, lane k % C).
__device__ __forceinline__ int window_slot(const Geom& g, int z, int y, int x, int k) {
    const int o = k / g.C, l = k - o * g.C;
    const int dz = o / 9 - 1, dy = (o / 3) % 3 - 1, dx = o % 3 - 1;
    const int zz = (z + dz + g.nz) % g.nz, yy = (y + dy + g.ny) % g.ny,
              xx = (x + dx + g.nx) % g.nx;
    return ((zz * g.ny + yy) * g.nx + xx) * g.C + l;
}

// Mover pick of one cell: slot, whether the cell holds any, live[pick].
// The live count adds the slots in slot order; their loads go out
// kPickLoads at a time.
constexpr int kPickLoads = 16;

__device__ __forceinline__ void pick_mover(const float* __restrict__ live, int cell, int C,
                                           float u_sel, int& pick, bool& has, float& pl) {
    float cnt = 0.f;
    for (int l0 = 0; l0 < C; l0 += kPickLoads) {
        float v[kPickLoads];
#pragma unroll
        for (int u = 0; u < kPickLoads; ++u) v[u] = l0 + u < C ? live[cell * C + l0 + u] : 0.f;
#pragma unroll
        for (int u = 0; u < kPickLoads; ++u)
            if (l0 + u < C) cnt = fa(cnt, v[u]);
    }
    const int ci = (int)cnt;
    pick = min((int)fm(u_sel, cnt), max(ci - 1, 0));
    has = cnt > 0.5f;
    pl = live[cell * C + pick];
}

// ---------------------------------------------------------------------------
// What both sweeps share: a call is ONE cooperative launch (chained past
// kMaxSub sub-sweeps), whose blocks are all co-resident.

constexpr int kMaxSweepThreads = 512;
constexpr int kMaxSub = 1024;            // sub-sweeps of one launch

// The threads of a sweep's block: a thread per window slot (27 C, in
// whole warps), at most kMaxSweepThreads.
static int threads_for(int C) {
    const int n = ((27 * C + 31) / 32) * 32;
    return n < kMaxSweepThreads ? n : kMaxSweepThreads;
}

// Each sub-sweep's class of perms[0 .. n), | 8 where a segment starts (a
// run of sub-sweeps in which no class comes twice, so no cell is active
// twice).
static cudaError_t encode_segments(const int* perms, const int n, unsigned char* code) {
    unsigned seen = 0;
    for (int s = 0; s < n; ++s) {
        const int c = perms[s];
        if (c < 0 || c > 7) return cudaErrorInvalidValue;
        const bool start = s == 0 || ((seen >> c) & 1u);
        if (start) seen = 0;
        seen |= 1u << c;
        code[s] = (unsigned char)(c | (start ? 8 : 0));
    }
    return cudaSuccess;
}

// The blocks of a cooperative launch of `kernel`: as many as the card
// holds at once, at most `want`.
template <typename K>
static cudaError_t coop_blocks(K kernel, const int threads, const size_t smem, const int want,
                               int* blocks) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
        return e;
    if (!coop) return cudaErrorNotSupported;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return e;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
        cudaSuccess)
        return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    *blocks = std::max(1, std::min(per_sm * sms, want));
    return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The sphere sweep.
//
// A block takes an active cell of a sub-sweep; block b of the G blocks
// takes cells m = b, b + G, ... of every class, so it owns the same cells
// in every sub-sweep, and a thread takes a slot of the cell's window.
//   * prologue: each block copies its own cells' slots from the input
//     planes (read in place, strided) into the output planes; block 0
//     zeroes the counts;
//   * at a segment's start each block draws the proposals of its cells of
//     the segment's classes into shared memory, a thread per (class,
//     cell), from the state then, which is the state the cell's
//     sub-sweep will see (only a cell's own commit moves its mover); the
//     first segment of a call draws from the input planes, beside the
//     copy;
//   * a sub-sweep: each thread tests its window slots (the ids, live
//     flags and thresholds (r + r_j)^2 of its first KP slots are found
//     before the sub-sweep's grid barrier, since they read no plane),
//     __syncthreads_or gives the veto, thread 0 commits and tallies;
//     a grid.sync() separates the sub-sweeps;
//   * the tallies go to the counts with integer atomics at the end.
// The kernel keeps no state between calls.  A design that replaced the
// grid barriers by per-cell commit flags kept between calls was 10%
// faster (PERF.md §7) but unsafe across streams and under graph capture.
// A warp per cell, its lanes walking the window 8 slots each, took 3x
// longer: each slot's minimum image costs three exact divides, and the
// lanes' chains were serial.
// sweep-parts builds this file also with SPHERE_SWEEP_NO_TESTS (every
// trial accepted) and with SPHERE_SWEEP_NO_CELLS as well (the prologue,
// the barriers and the tallies alone).

// A cell's drawn trial: new position, the mover's present one, its
// radius and live flag, pick | has << 16.
struct SphereProp {
    float x[3];
    float raw[3];
    float r, pl;
    int meta;
};

struct SphereArgs {
    const float* in[3];
    int in_stride[3];
    float* out;                       // the 3 new planes
    const float* rad;
    const float* dmv;
    const float* live;
    const float* u;                   // uniforms of the launch's first sub-sweep
    int* cnt;
    Geom g;
    int nsub, first, nper;            // nper: cells per block and class
    unsigned char code[kMaxSub];
};

// The proposal of cell `cell` from its uniforms uc[k * ncells] and the
// planes P (element i of plane k at P[k][i * st[k]]), as the plain
// version draws it.
__device__ __forceinline__ void draw_sphere(const SphereArgs& a, const float* const* P,
                                            const int* st, const float* uc, const int cell,
                                            const int ncells, SphereProp& pr) {
    const Geom& g = a.g;
    int pick;
    bool has;
    float pl;
    pick_mover(a.live, cell, g.C, uc[0], pick, has, pl);
    const int slot = cell * g.C + pick;
    float g1, g2, g3;
    gaussians(uc[1 * ncells], uc[2 * ncells], uc[3 * ncells], uc[4 * ncells], g1, g2, g3);
    const float gn = rsqrtf(fa(sum3sq(g1, g2, g3), kTiny));
    const float rball = expf(fm(logf(fa(uc[5 * ncells], kTiny)), kThird));
    const float step = fm(fm(fm(a.dmv[slot], pl), rball), gn);
    const float gv[3] = {g1, g2, g3};
    for (int k = 0; k < 3; ++k) {
        const float raw = P[k][(long long)slot * st[k]];
        pr.raw[k] = raw;
        pr.x[k] = wrap_box(fa(fm(raw, pl), fm(gv[k], step)), g.L[k]);
    }
    pr.r = fm(a.rad[slot], pl);
    pr.pl = pl;
    pr.meta = pick | (has ? 1 << 16 : 0);
}

__global__ void __launch_bounds__(kMaxSweepThreads) sphere_sweep_kernel(const SphereArgs a) {
    constexpr int KP = 2;                       // window slots per thread known before a barrier
    extern __shared__ float4 sphere_shared[];
    const Geom& g = a.g;
    const int ncells = g.nx * g.ny * g.nz, nslots = ncells * g.C, n = 27 * g.C;
    float* const P[3] = {a.out, a.out + nslots, a.out + 2 * nslots};
    const int ones[3] = {1, 1, 1};
    const int tid = threadIdx.x, nt = blockDim.x, G = gridDim.x, b0 = blockIdx.x;
    const int M = (g.nx / 2) * (g.ny / 2) * (g.nz / 2);
    const int nper = a.nper;
    SphereProp* prop = reinterpret_cast<SphereProp*>(sphere_shared);   // [class][i]
    // prologue: the block's own cells' slots
    if (a.first) {
        for (int e = tid; e < 8 * nper * g.C; e += nt) {
            const int l = e % g.C, ci = e / g.C, c = ci & 7, m = b0 + (ci >> 3) * G;
            if (m >= M) continue;
            int z, y, x;
            const int slot = class_cell(g, c, m, z, y, x) * g.C + l;
            for (int k = 0; k < 3; ++k) P[k][slot] = a.in[k][(long long)slot * a.in_stride[k]];
        }
        if (b0 == 0 && tid == 0) a.cnt[0] = a.cnt[1] = 0;
    }
    int tally[2] = {0, 0};                      // the block's accepts and tries (thread 0)
    // what a cell's trial needs before its sub-sweep's barrier: for this
    // thread's window slots k = tid + q nt, the slot and the threshold
    // (r + r_j)^2, -1 where the slot is no candidate (not live, or the
    // mover)
    struct Trial {
        int cell, z, y, x;
        int j[KP];
        float thr2[KP];
    };
    auto prepare = [&](const int c, const int m, const int i) {
        Trial t;
        t.cell = class_cell(g, c, m, t.z, t.y, t.x);
        const SphereProp& p = prop[c * nper + i];
        const int pick = p.meta & 0xffff;
#pragma unroll
        for (int q = 0; q < KP; ++q) {
            const int k = tid + q * nt;
            t.j[q] = 0;
            t.thr2[q] = -1.f;
            if (k < n) {
                const int j = window_slot(g, t.z, t.y, t.x, k);
                t.j[q] = j;
                if (a.live[j] > 0.5f && !(k == kCenter * g.C + pick && p.pl > 0.5f)) {
                    const float thr = fa(p.r, a.rad[j]);
                    t.thr2[q] = fm(thr, thr);
                }
            }
        }
        return t;
    };
    Trial tr;
    for (int s = 0; s < a.nsub; ++s) {
        const int c = a.code[s] & 7;
        if (a.code[s] & 8) {
            if (s > 0) cg::this_grid().sync();  // the last sub-sweep's commits
#ifndef SPHERE_SWEEP_NO_CELLS
            // the block's cells of the segment's classes: thread (r, cls)
            // draws the r-th for class cls
            const bool from_in = a.first && s == 0;
            const float* const* src = from_in ? a.in : P;
            const int* st = from_in ? a.in_stride : ones;
            const int cls = tid & 7;
            int sub = -1;
            for (int j = s; j < a.nsub && (j == s || !(a.code[j] & 8)); ++j)
                if ((a.code[j] & 7) == cls) {
                    sub = j;
                    break;
                }
            for (int i = tid >> 3; sub >= 0 && i < nper; i += nt >> 3) {
                const int m = b0 + i * G;
                if (m >= M) continue;
                int z, y, x;
                const int cell = class_cell(g, cls, m, z, y, x);
                draw_sphere(a, src, st, a.u + (long long)sub * 6 * ncells + cell, cell, ncells,
                            prop[cls * nper + i]);
            }
            __syncthreads();
            if (b0 < M) tr = prepare(c, b0, 0);
#endif
            if (s == 0) cg::this_grid().sync();  // the copied planes
        } else {
            cg::this_grid().sync();             // the last sub-sweep's commits
        }
#ifndef SPHERE_SWEEP_NO_CELLS
        for (int i = 0, m = b0; m < M; ++i, m += G) {
            if (i > 0) tr = prepare(c, m, i);
            const SphereProp& p = prop[c * nper + i];
            const bool has = (p.meta >> 16) & 1;
            int hit = 0;
#ifndef SPHERE_SWEEP_NO_TESTS
            if (has) {
#pragma unroll
                for (int q = 0; q < KP; ++q) {
                    if (!(tr.thr2[q] >= 0.f)) continue;
                    const int j = tr.j[q];
                    const float dx = min_image(fs(p.x[0], __ldcg(P[0] + j)), g.L[0]);
                    const float dy = min_image(fs(p.x[1], __ldcg(P[1] + j)), g.L[1]);
                    const float dz = min_image(fs(p.x[2], __ldcg(P[2] + j)), g.L[2]);
                    hit |= sum3sq(dx, dy, dz) < tr.thr2[q];
                }
                for (int k = tid + KP * nt; k < n; k += nt) {
                    const int j = window_slot(g, tr.z, tr.y, tr.x, k);
                    if (!(a.live[j] > 0.5f) ||
                        (k == kCenter * g.C + (p.meta & 0xffff) && p.pl > 0.5f))
                        continue;
                    const float dx = min_image(fs(p.x[0], __ldcg(P[0] + j)), g.L[0]);
                    const float dy = min_image(fs(p.x[1], __ldcg(P[1] + j)), g.L[1]);
                    const float dz = min_image(fs(p.x[2], __ldcg(P[2] + j)), g.L[2]);
                    const float thr = fa(p.r, a.rad[j]);
                    hit |= sum3sq(dx, dy, dz) < fm(thr, thr);
                }
            }
#endif
            hit = __syncthreads_or(hit);
            if (tid == 0) {
                const bool acc = has && !hit;
                const float sel = fm(p.pl, acc ? 1.f : 0.f);
                const int slot = tr.cell * g.C + (p.meta & 0xffff);
                for (int k = 0; k < 3; ++k)
                    P[k][slot] = fa(p.raw[k], fm(sel, fs(p.x[k], p.raw[k])));
                tally[1] += has;
                tally[0] += acc;
            }
        }
        // the next sub-sweep's first trial, where it needs no new draw
        if (s + 1 < a.nsub && !(a.code[s + 1] & 8) && b0 < M)
            tr = prepare(a.code[s + 1] & 7, b0, 0);
#endif
    }
    if (tid == 0 && (tally[0] | tally[1])) {
        atomicAdd(&a.cnt[0], tally[0]);
        atomicAdd(&a.cnt[1], tally[1]);
    }
}

// The dynamic shared memory of the sphere sweep's block: the proposals.
static size_t sphere_smem(const int nper) { return (size_t)8 * nper * sizeof(SphereProp); }

static cudaError_t launch_sphere(SphereArgs& a, const int* perms, const int nsub,
                                 const float* randu, cudaStream_t st) {
    const Geom& g = a.g;
    const int threads = threads_for(g.C);
    const int M = (g.nx / 2) * (g.ny / 2) * (g.nz / 2);
    const long long ncells = (long long)g.nx * g.ny * g.nz;
    // the co-resident blocks, at the shared memory of the cells each block
    // then takes
    int blocks = M;
    cudaError_t e;
    for (int nper = 0; nper != (M + blocks - 1) / blocks;) {
        nper = (M + blocks - 1) / blocks;
        e = coop_blocks(sphere_sweep_kernel, threads, sphere_smem(nper), M, &blocks);
        if (e != cudaSuccess) return e;
    }
    a.nper = (M + blocks - 1) / blocks;
    int s0 = 0;
    do {
        const int nn = std::min(kMaxSub, nsub - s0);
        if ((e = encode_segments(perms + s0, nn, a.code)) != cudaSuccess) return e;
        a.nsub = nn;
        a.first = s0 == 0;
        a.u = randu + (long long)s0 * 6 * ncells;
        void* args[] = {&a};
        e = cudaLaunchCooperativeKernel((const void*)sphere_sweep_kernel, dim3(blocks),
                                        dim3(threads), args, sphere_smem(a.nper), st);
        if (e != cudaSuccess) return e;
        s0 += nn;
    } while (s0 < nsub);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The polyhedron sweep: one cooperative launch per call (up to kMaxSub
// sub-sweeps), persistent blocks, a block per active cell.

constexpr int kAxisLanes = 8;            // lanes on one pair's remaining axes

// One launch: the input planes, the output (7 planes, then the proposals,
// 25 x ncells floats, as scratch), the uniforms of its first
// sub-sweep, and each sub-sweep's class, | 8 where a segment starts (a run
// of sub-sweeps in which no class comes twice, so no cell is active twice).
struct PolyArgs {
    const float* in[7];
    int in_stride[7];
    float* out;
    const float* live;
    const float* u;
    int* cnt;
    Geom g;
    PolyTables T;
    float d_mv, a_mv, m_ratio;
    int nsub, first;
    unsigned char code[kMaxSub];
};

// The proposal of a cell from its uniforms uc[k * ncells] and the planes P
// (the state at the start of its segment), as the plain version draws it:
// prop[k * ncells] = new x (3), q (4), rows of R(q) (9), live[pick],
// pick | has << 16 | rot << 17, and the mover's present x and q (7).
__device__ void draw_poly(const PolyArgs& a, const float* const* P, const float* uc, int cell,
                          int ncells, float* prop) {
    const Geom& g = a.g;
    float uu[12];
    for (int k = 0; k < 12; ++k) uu[k] = uc[k * ncells];
    int pick;
    bool has;
    float pl;
    pick_mover(a.live, cell, g.C, uu[0], pick, has, pl);
    const int slot = cell * g.C + pick;
    float raw[7], m[7];
    for (int k = 0; k < 7; ++k) {
        raw[k] = P[k][slot];
        m[k] = fm(raw[k], pl);
    }
    // translate: ball-uniform (Box-Muller direction, u^(1/3))
    float g1, g2, g3, h1, h2, h3;
    gaussians(uu[2], uu[3], uu[4], uu[5], g1, g2, g3);
    const float gn = rsqrt_exact(fa(sum3sq(g1, g2, g3), kTiny));
    const float rball = expf(fm(logf(fa(uu[6], kTiny)), kThird));
    // rotate: random axis, uniform angle in [-a, a]
    gaussians(uu[7], uu[8], uu[9], uu[10], h1, h2, h3);
    const float hn = rsqrt_exact(fa(sum3sq(h1, h2, h3), kTiny));
    const float half = fm(fm(0.5f, fs(fm(2.0f, uu[11]), 1.0f)), a.a_mv);
    const float dqw = cosf(half);
    const float s_h = fm(sinf(half), hn);
    const float dqx = fm(s_h, h1), dqy = fm(s_h, h2), dqz = fm(s_h, h3);
    const bool rot = uu[1] > a.m_ratio;
    const float step = fm(fm(fm(a.d_mv, rball), gn), fs(1.0f, rot ? 1.f : 0.f));
    float v[16];
    v[0] = wrap_box(fa(m[0], fm(g1, step)), g.L[0]);
    v[1] = wrap_box(fa(m[1], fm(g2, step)), g.L[1]);
    v[2] = wrap_box(fa(m[2], fm(g3, step)), g.L[2]);
    const float mqw = m[3], mqx = m[4], mqy = m[5], mqz = m[6];
    const float rw = fs(fs(fs(fm(dqw, mqw), fm(dqx, mqx)), fm(dqy, mqy)), fm(dqz, mqz));
    const float rx = fs(fa(fa(fm(dqw, mqx), fm(dqx, mqw)), fm(dqy, mqz)), fm(dqz, mqy));
    const float ry = fa(fa(fs(fm(dqw, mqy), fm(dqx, mqz)), fm(dqy, mqw)), fm(dqz, mqx));
    const float rz = fa(fs(fa(fm(dqw, mqz), fm(dqx, mqy)), fm(dqy, mqx)), fm(dqz, mqw));
    const float rn = rsqrt_exact(fa(fa(fa(fa(fm(rw, rw), fm(rx, rx)), fm(ry, ry)), fm(rz, rz)),
                                    kTiny));
    v[3] = rot ? fm(rw, rn) : mqw;
    v[4] = rot ? fm(rx, rn) : mqx;
    v[5] = rot ? fm(ry, rn) : mqy;
    v[6] = rot ? fm(rz, rn) : mqz;
    float RA[3][3];
    quat_to_R(v[3], v[4], v[5], v[6], RA);
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) v[7 + 3 * r + c] = RA[r][c];
    for (int k = 0; k < 16; ++k) prop[k * ncells] = v[k];
    prop[16 * ncells] = pl;
    prop[17 * ncells] = __int_as_float(pick | (has ? 1 << 16 : 0) | (rot ? 1 << 17 : 0));
    for (int k = 0; k < 7; ++k) prop[(18 + k) * ncells] = raw[k];
}

__global__ void __launch_bounds__(kMaxSweepThreads) poly_sweep_kernel(const PolyArgs a) {
    cg::grid_group grid = cg::this_grid();
    __shared__ PolyTables T;
    __shared__ int nnear;
    extern __shared__ int near_list[];          // 27 C: the pairs past A's faces
    const Geom& g = a.g;
    const int ncells = g.nx * g.ny * g.nz, nslots = ncells * g.C, n = 27 * g.C;
    float* const P[7] = {a.out, a.out + nslots, a.out + 2 * nslots, a.out + 3 * nslots,
                         a.out + 4 * nslots, a.out + 5 * nslots, a.out + 6 * nslots};
    float* const prop = a.out + 7LL * nslots;
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, wid = tid >> 5;
    const int hx = g.nx / 2, hy = g.ny / 2, M = hx * hy * (g.nz / 2);
    {
        const int* src = reinterpret_cast<const int*>(&a.T);
        int* dst = reinterpret_cast<int*>(&T);
        for (int i = tid; i < (int)(sizeof(PolyTables) / sizeof(int)); i += nt) dst[i] = src[i];
    }
    auto cell_of = [&](const int c, const int m, int& z, int& y, int& x) {
        return class_cell(g, c, m, z, y, x);
    };
    if (a.first) {
        const int gt = blockIdx.x * nt + tid, gn = gridDim.x * nt;
        for (int k = 0; k < 7; ++k)
            for (int i = gt; i < nslots; i += gn) P[k][i] = a.in[k][(long long)i * a.in_stride[k]];
        if (gt < 4) a.cnt[gt] = 0;
        grid.sync();                            // the copied planes
    }
    __syncthreads();
    int tally[4] = {0, 0, 0, 0};                // thread 0: the block's accepts and tries
    // what a cell's trial needs before the sub-sweep's barrier: its
    // proposal and, for this thread's window slot k = tid, the slot and
    // whether it is a candidate (live, not the mover)
    struct Trial {
        int cell, z, y, x, pick, j0;
        bool has, rot, cand0;
        float pl;
        float pr[16];
        float raw[7];
    };
    auto prepare = [&](const int c, const int m) {
        Trial t;
        t.cell = cell_of(c, m, t.z, t.y, t.x);
#pragma unroll
        for (int k = 0; k < 16; ++k) t.pr[k] = prop[k * ncells + t.cell];
#pragma unroll
        for (int k = 0; k < 7; ++k) t.raw[k] = prop[(18 + k) * ncells + t.cell];
        t.pl = prop[16 * ncells + t.cell];
        const int meta = __float_as_int(prop[17 * ncells + t.cell]);
        t.pick = meta & 0xffff;
        t.has = (meta >> 16) & 1;
        t.rot = (meta >> 17) & 1;
        t.j0 = tid < n ? window_slot(g, t.z, t.y, t.x, tid) : 0;
        t.cand0 = tid < n && a.live[t.j0] > 0.5f &&
                  !(tid == kCenter * g.C + t.pick && t.pl > 0.5f);
        return t;
    };
    Trial tr;
    for (int s = 0; s < a.nsub; ++s) {
        const int c = a.code[s] & 7;
        if (a.code[s] & 8) {
            if (s > 0) grid.sync();             // the last sub-sweep's commits
            // a segment starts: the block draws the proposals of its cells
            // of the segment's classes, thread (r, cls) for class cls of its
            // r-th cell, from the state now
            const int cls = tid & 7;
            int sub = -1;
            for (int j = s; j < a.nsub && (j == s || !(a.code[j] & 8)); ++j)
                if ((a.code[j] & 7) == cls) {
                    sub = j;
                    break;
                }
#ifndef POLY_SWEEP_NO_CELLS
            for (int m = blockIdx.x + (tid >> 3) * gridDim.x; sub >= 0 && m < M;
                 m += (nt >> 3) * gridDim.x) {
                int z, y, x;
                const int cell = cell_of(cls, m, z, y, x);
                draw_poly(a, P, a.u + (long long)sub * 12 * ncells + cell, cell, ncells,
                          prop + cell);
            }
#endif
            __syncthreads();
            if (blockIdx.x < M) tr = prepare(c, blockIdx.x);
        } else {
            grid.sync();                        // the last sub-sweep's commits
        }
#ifndef POLY_SWEEP_NO_CELLS
        for (int m = blockIdx.x; m < M; m += gridDim.x) {
            if (m != blockIdx.x) tr = prepare(c, m);
            const float qa[4] = {tr.pr[3], tr.pr[4], tr.pr[5], tr.pr[6]};
            float RA[3][3];
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int cc = 0; cc < 3; ++cc) RA[r][cc] = tr.pr[7 + 3 * r + cc];
            auto frame_of = [&](const int j) {
                return pair_frame(RA, qa, min_image(fs(P[0][j], tr.pr[0]), g.L[0]),
                                  min_image(fs(P[1][j], tr.pr[1]), g.L[1]),
                                  min_image(fs(P[2][j], tr.pr[2]), g.L[2]), P[3][j], P[4][j],
                                  P[5][j], P[6][j]);
            };
            if (tid == 0) nnear = 0;
            __syncthreads();
            int hit = 0;
#ifndef POLY_SWEEP_NO_SAT
            if (tr.has) {
                // a thread per live window slot (the mover aside): A's face
                // normals; the pairs none of them separates go to the list
                for (int k = tid; k < n; k += nt) {
                    const int j = k == tid ? tr.j0 : window_slot(g, tr.z, tr.y, tr.x, k);
                    const bool cand = k == tid ? tr.cand0
                                               : a.live[j] > 0.5f &&
                                                     !(k == kCenter * g.C + tr.pick && tr.pl > 0.5f);
                    if (!cand) continue;
                    const PairFrame F = frame_of(j);
                    bool nr = true;
                    for (int i = 0; i < T.nf && nr; ++i) nr = !sep_face_a(T, F, i);
                    if (nr) near_list[atomicAdd(&nnear, 1)] = j;
                }
                __syncthreads();
                // each listed pair: kAxisLanes lanes over B's faces and the
                // edge pairs, a ballot per step; four pairs per warp
                const int nn = nnear, nb = T.nf + T.ne * T.ne;
                const int q = lane / kAxisLanes, gl = lane % kAxisLanes;
                for (int p0 = wid * 4; p0 < nn; p0 += (nt >> 5) * 4) {
                    const bool act = p0 + q < nn;
                    PairFrame F;
                    if (act) F = frame_of(near_list[p0 + q]);
                    bool sep = false;
                    for (int a0 = 0; a0 < nb; a0 += kAxisLanes) {
                        const int ax = a0 + gl;
                        const bool sp = act && !sep && ax < nb && sep_rest(T, F, ax);
                        // every lane votes, separated or not (a ballot
                        // behind sep's short circuit would leave lanes out)
                        const unsigned b = __ballot_sync(0xffffffffu, sp);
                        sep = sep || ((b >> (kAxisLanes * q)) & ((1u << kAxisLanes) - 1)) != 0;
                        if (__all_sync(0xffffffffu, !act || sep)) break;
                    }
                    hit |= act && !sep;
                }
            }
#endif
            hit = __syncthreads_or(hit);
            if (tid == 0) {
                const bool acc = tr.has && !hit;
                const float sel = fm(tr.pl, acc ? 1.f : 0.f);
                const int slot = tr.cell * g.C + tr.pick;
                for (int k = 0; k < 7; ++k)
                    P[k][slot] = fa(tr.raw[k], fm(sel, fs(tr.pr[k], tr.raw[k])));
                if (tr.rot) {
                    tally[3] += tr.has;
                    tally[2] += acc;
                } else {
                    tally[1] += tr.has;
                    tally[0] += acc;
                }
            }
        }
#endif
        // the next sub-sweep's first trial, where it needs no new draw
        if (s + 1 < a.nsub && !(a.code[s + 1] & 8) && blockIdx.x < M)
            tr = prepare(a.code[s + 1] & 7, blockIdx.x);
    }
    if (tid == 0)
        for (int k = 0; k < 4; ++k)
            if (tally[k]) atomicAdd(&a.cnt[k], tally[k]);
}

// The dynamic shared memory of the poly sweep's block at capacity C: the
// list of pairs past A's faces.
static size_t poly_smem(int C) { return (size_t)27 * C * sizeof(int); }

}  // namespace hoomd_hpmc

using namespace hoomd_hpmc;

extern "C" {

// px, py, pz: the input planes, element i of plane k at in_k[i *
// strides[k]] (strides, perms on the host); rad, dmv, live contiguous;
// randu (nsub, 6, nz, ny, nx); out: the 3 new planes of nx ny nz C
// floats; cnt [accepts, tries].
int hoomd_hpmc_sphere_sweep(const float* px, const float* py, const float* pz,
                            const int* strides, const float* rad, const float* dmv,
                            const float* live, const float* randu, const int* perms, int nsub,
                            float* out, int* cnt, int nx, int ny, int nz, int C, float Lx,
                            float Ly, float Lz, cudaStream_t st) {
    if (nsub < 0) return cudaErrorInvalidValue;
    SphereArgs a;
    const float* in[3] = {px, py, pz};
    for (int k = 0; k < 3; ++k) {
        a.in[k] = in[k];
        a.in_stride[k] = strides[k];
    }
    a.out = out;
    a.rad = rad;
    a.dmv = dmv;
    a.live = live;
    a.cnt = cnt;
    a.g = Geom{nx, ny, nz, C, {Lx, Ly, Lz}};
    return launch_sphere(a, perms, nsub, randu, st);
}

// The build and occupancy of the sphere sweep at capacity C (a cell per
// block and class, R = 1): out = [registers per thread, local (spill)
// bytes per thread, static shared bytes, dynamic shared bytes, blocks per
// SM, threads per block].
int hoomd_hpmc_sphere_occupancy(int C, int* out) {
    const size_t smem = sphere_smem(1);
    cudaError_t e = cudaFuncSetAttribute(sphere_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, sphere_sweep_kernel)) != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = (int)smem;
    out[5] = threads_for(C);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], sphere_sweep_kernel, out[5], smem);
}

int hoomd_hpmc_poly_sweep(const float* px, const float* py, const float* pz, const float* qw,
                          const float* qx, const float* qy, const float* qz, const int* strides,
                          const float* live, const float* randu, const int* perms, int nsub,
                          float* out, int* cnt,
                          const float* tab, int nv, int nf, int ne, float d_mv, float a_mv,
                          float m_ratio, int nx, int ny, int nz, int C, float Lx, float Ly,
                          float Lz, cudaStream_t st) {
    // strides, perms and tab lie on the host: element i of input plane k
    // at in_k[i * strides[k]] (the planes may be strided views).  tab: V (8x3), F (8x3), E (6x3), lo
    // (8), hi (8), zero-padded.  out: 7 planes of nx ny nz C floats, then
    // 25 x nx ny nz floats of scratch (a proposal per cell)
    if (nv < 1 || nv > kMaxV || nf < 0 || nf > kMaxF || ne < 0 || ne > kMaxE || nsub < 0)
        return cudaErrorInvalidValue;
    PolyArgs a;
    const float* in[7] = {px, py, pz, qw, qx, qy, qz};
    for (int k = 0; k < 7; ++k) {
        a.in[k] = in[k];
        a.in_stride[k] = strides[k];
    }
    a.out = out;
    a.live = live;
    a.cnt = cnt;
    a.g = Geom{nx, ny, nz, C, {Lx, Ly, Lz}};
    a.T.nv = nv;
    a.T.nf = nf;
    a.T.ne = ne;
    const float* p = tab;
    for (int k = 0; k < kMaxV; ++k)
        for (int r = 0; r < 3; ++r) a.T.v[k][r] = *p++;
    for (int k = 0; k < kMaxF; ++k)
        for (int r = 0; r < 3; ++r) a.T.f[k][r] = *p++;
    for (int k = 0; k < kMaxE; ++k)
        for (int r = 0; r < 3; ++r) a.T.e[k][r] = *p++;
    for (int k = 0; k < kMaxF; ++k) a.T.lo[k] = *p++;
    for (int k = 0; k < kMaxF; ++k) a.T.hi[k] = *p++;
    a.d_mv = d_mv;
    a.a_mv = a_mv;
    a.m_ratio = m_ratio;
    const int threads = threads_for(C);
    const size_t smem = poly_smem(C);
    // a block per active cell where the co-resident blocks hold them all
    const int M = (nx / 2) * (ny / 2) * (nz / 2);
    int blocks = 0;
    cudaError_t e = coop_blocks(poly_sweep_kernel, threads, smem, M, &blocks);
    if (e != cudaSuccess) return e;
    const long long ncells = (long long)nx * ny * nz;
    int s0 = 0;
    do {
        const int n = std::min(kMaxSub, nsub - s0);
        if ((e = encode_segments(perms + s0, n, a.code)) != cudaSuccess) return e;
        a.nsub = n;
        a.first = s0 == 0;
        a.u = randu + (long long)s0 * 12 * ncells;
        void* args[] = {&a};
        e = cudaLaunchCooperativeKernel((const void*)poly_sweep_kernel, dim3(blocks),
                                        dim3(threads), args, smem, st);
        if (e != cudaSuccess) return e;
        s0 += n;
    } while (s0 < nsub);
    return cudaGetLastError();
}

// The build and occupancy of the poly sweep at capacity C: out =
// [registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes, blocks per SM, threads per block].
int hoomd_hpmc_poly_occupancy(int C, int* out) {
    const size_t smem = poly_smem(C);
    cudaError_t e = cudaFuncSetAttribute(poly_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, poly_sweep_kernel)) != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = (int)smem;
    out[5] = threads_for(C);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], poly_sweep_kernel, out[5], smem);
}

}  // extern "C"
