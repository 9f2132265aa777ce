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
// whole planes.  Here each sub-sweep is one launch of only the active
// cells, one block per cell, on one stream, so each sub-sweep sees the
// previous one's commits.  The commit is in place and race-free: the
// 27-cell window of an active cell holds no other cell of its class,
// because the cell counts are even and same-class cells lie 2 apart (on
// a 2-cell axis the -1 and +1 offsets name the same cell twice, which a
// veto does not mind).
//
// Block body: thread 0 draws the proposal from the cell's uniforms and
// puts it in shared memory; every thread tests its share of the 27*C
// window slots, reading them straight from device memory (each slot is
// read once per block, so staging it in shared memory would buy nothing);
// __syncthreads_or gives the veto; thread 0 commits and counts with
// integer atomics (exact in any order).
//
// Numerics: the proposal and the overlap tests round each operation as
// the plain torch version's separate operations do (__fmul_rn and
// friends, which the compiler never contracts into fused multiply-adds),
// and call the same libm functions (logf, sinf, cosf, expf, sqrtf,
// rsqrtf, floorf, rintf), so kernel and plain version take the same
// decisions on the card.
//
// What bounds them on this card: at the config-5 plan (10x10x10 cells,
// C = 13, N = 4096 cubes) a sub-sweep moves 0.4 MB of planes and does
// 125 x 351 candidate tests of at most 15 SAT axes, well under a
// microsecond of memory or FP32 time, so a sub-sweep costs a launch and
// the latency of one block's serial chain (thread 0's proposal, one SAT
// per thread), not bandwidth or arithmetic.  Every C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace hoomd_hpmc {

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

// SAT overlap of A (the trial mover: rows RA of R(q_A), quaternion qa) with
// B (quaternion qb) at B - A = dg: A's face normals, B's face normals, edge
// x edge axes, as hoomd_tpu_torch/hpmc/sweep.py:poly_overlap_plain.
__device__ __forceinline__ bool poly_overlap(const PolyTables& T, const float RA[3][3], const float qa[4],
                             float dgx, float dgy, float dgz, float ww, float wx, float wy,
                             float wz) {
    const float drx = fa(fa(fm(RA[0][0], dgx), fm(RA[1][0], dgy)), fm(RA[2][0], dgz));
    const float dry = fa(fa(fm(RA[0][1], dgx), fm(RA[1][1], dgy)), fm(RA[2][1], dgz));
    const float drz = fa(fa(fm(RA[0][2], dgx), fm(RA[1][2], dgy)), fm(RA[2][2], dgz));
    const float qw = qa[0], qx = qa[1], qy = qa[2], qz = qa[3];
    const float sw = fa(fa(fa(fm(qw, ww), fm(qx, wx)), fm(qy, wy)), fm(qz, wz));
    const float sx = fa(fs(fs(fm(qw, wx), fm(qx, ww)), fm(qy, wz)), fm(qz, wy));
    const float sy = fs(fs(fa(fm(qw, wy), fm(qx, wz)), fm(qy, ww)), fm(qz, wx));
    const float sz = fs(fa(fs(fm(qw, wz), fm(qx, wy)), fm(qy, wx)), fm(qz, ww));
    float S[3][3];
    quat_to_R(sw, sx, sy, sz, S);
    float lo, hi, loB, hiB;
    // A's face normals (static in A's frame)
    for (int i = 0; i < T.nf; ++i) {
        const float n0 = T.f[i][0], n1 = T.f[i][1], n2 = T.f[i][2];
        const float t = dot3(drx, dry, drz, n0, n1, n2);
        supports(T, dot3(S[0][0], S[1][0], S[2][0], n0, n1, n2),
                 dot3(S[0][1], S[1][1], S[2][1], n0, n1, n2),
                 dot3(S[0][2], S[1][2], S[2][2], n0, n1, n2), loB, hiB);
        if (separated(T.lo[i], T.hi[i], t, loB, hiB)) return false;
    }
    // B's face normals, mapped into A's frame
    for (int j = 0; j < T.nf; ++j) {
        const float c0 = dot3(S[0][0], S[0][1], S[0][2], T.f[j][0], T.f[j][1], T.f[j][2]);
        const float c1 = dot3(S[1][0], S[1][1], S[1][2], T.f[j][0], T.f[j][1], T.f[j][2]);
        const float c2 = dot3(S[2][0], S[2][1], S[2][2], T.f[j][0], T.f[j][1], T.f[j][2]);
        const float t = dot3(drx, dry, drz, c0, c1, c2);
        supports(T, c0, c1, c2, lo, hi);
        if (separated(lo, hi, t, T.lo[j], T.hi[j])) return false;
    }
    // edge x edge axes
    float b[kMaxE][3];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
        if (j < T.ne) {
            for (int r = 0; r < 3; ++r)
                b[j][r] = dot3(S[r][0], S[r][1], S[r][2], T.e[j][0], T.e[j][1], T.e[j][2]);
        }
    }
    for (int i = 0; i < T.ne; ++i) {
        const float e0 = T.e[i][0], e1 = T.e[i][1], e2 = T.e[i][2];
#pragma unroll
        for (int j = 0; j < kMaxE; ++j) {
            if (j >= T.ne) break;
            const float cx = fs(fm(e1, b[j][2]), fm(e2, b[j][1]));
            const float cy = fs(fm(e2, b[j][0]), fm(e0, b[j][2]));
            const float cz = fs(fm(e0, b[j][1]), fm(e1, b[j][0]));
            const float t = dot3(drx, dry, drz, cx, cy, cz);
            supports(T, cx, cy, cz, lo, hi);
            supports(T, dot3(S[0][0], S[1][0], S[2][0], cx, cy, cz),
                     dot3(S[0][1], S[1][1], S[2][1], cx, cy, cz),
                     dot3(S[0][2], S[1][2], S[2][2], cx, cy, cz), loB, hiB);
            if (separated(lo, hi, t, loB, hiB)) return false;
        }
    }
    return true;
}

// The active cell of this block for parity (pz, py, px), and its flat id.
__device__ __forceinline__ int active_cell(const Geom& g, int pz, int py, int px, int& z, int& y,
                                           int& x) {
    const int hx = g.nx / 2, hy = g.ny / 2;
    const int b = blockIdx.x;
    x = px + 2 * (b % hx);
    y = py + 2 * ((b / hx) % hy);
    z = pz + 2 * (b / (hx * hy));
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
__device__ __forceinline__ void pick_mover(const float* __restrict__ live, int cell, int C,
                                           float u_sel, int& pick, bool& has, float& pl) {
    float cnt = 0.f;
    for (int l = 0; l < C; ++l) cnt = fa(cnt, live[cell * C + l]);
    const int ci = (int)cnt;
    pick = min((int)fm(u_sel, cnt), max(ci - 1, 0));
    has = cnt > 0.5f;
    pl = live[cell * C + pick];
}

struct SphereTrial {
    float x[3];
    float r;
    float pl;
    int pick;
    int has;
};

__global__ void sphere_subsweep(float* __restrict__ px, float* __restrict__ py,
                                float* __restrict__ pz, const float* __restrict__ rad,
                                const float* __restrict__ dmv, const float* __restrict__ live,
                                const float* __restrict__ u, int cz, int cy, int cx, Geom g,
                                int* __restrict__ cnt) {
    __shared__ SphereTrial tr;
    int z, y, x;
    const int cell = active_cell(g, cz, cy, cx, z, y, x);
    const int ncells = g.nx * g.ny * g.nz;
    float* P[3] = {px, py, pz};
    if (threadIdx.x == 0) {
        const float* uc = u + cell;
        int pick;
        bool has;
        float pl;
        pick_mover(live, cell, g.C, uc[0], pick, has, pl);
        const int slot = cell * g.C + pick;
        float g1, g2, g3;
        gaussians(uc[1 * ncells], uc[2 * ncells], uc[3 * ncells], uc[4 * ncells], g1, g2, g3);
        const float gn = rsqrtf(fa(sum3sq(g1, g2, g3), kTiny));
        const float rball = expf(fm(logf(fa(uc[5 * ncells], kTiny)), kThird));
        const float step = fm(fm(fm(dmv[slot], pl), rball), gn);
        const float gv[3] = {g1, g2, g3};
        for (int k = 0; k < 3; ++k)
            tr.x[k] = wrap_box(fa(fm(P[k][slot], pl), fm(gv[k], step)), g.L[k]);
        tr.r = fm(rad[slot], pl);
        tr.pl = pl;
        tr.pick = pick;
        tr.has = has;
    }
    __syncthreads();
    int hit = 0;
    const int n = 27 * g.C;
    for (int k = threadIdx.x; k < n && !hit; k += blockDim.x) {
        const int j = window_slot(g, z, y, x, k);
        if (!(live[j] > 0.5f)) continue;
        if (k == kCenter * g.C + tr.pick && tr.pl > 0.5f) continue;
        const float dx = min_image(fs(tr.x[0], px[j]), g.L[0]);
        const float dy = min_image(fs(tr.x[1], py[j]), g.L[1]);
        const float dz = min_image(fs(tr.x[2], pz[j]), g.L[2]);
        const float thr = fa(tr.r, rad[j]);
        hit = sum3sq(dx, dy, dz) < fm(thr, thr);
    }
    hit = __syncthreads_or(hit);
    if (threadIdx.x == 0) {
        const bool acc = tr.has && !hit;
        const float sel = fm(tr.pl, acc ? 1.f : 0.f);
        const int slot = cell * g.C + tr.pick;
        for (int k = 0; k < 3; ++k) {
            const float raw = P[k][slot];
            P[k][slot] = fa(raw, fm(sel, fs(tr.x[k], raw)));
        }
        if (tr.has) atomicAdd(&cnt[1], 1);
        if (acc) atomicAdd(&cnt[0], 1);
    }
}

struct PolyTrial {
    float x[3];
    float q[4];
    float RA[3][3];
    float pl;
    int pick;
    int has;
    int rot;
};

__global__ void poly_subsweep(float* __restrict__ px, float* __restrict__ py,
                              float* __restrict__ pz, float* __restrict__ pqw,
                              float* __restrict__ pqx, float* __restrict__ pqy,
                              float* __restrict__ pqz, const float* __restrict__ live,
                              const float* __restrict__ u, int cz, int cy, int cx, Geom g,
                              PolyTables T, float d_mv, float a_mv, float m_ratio,
                              int* __restrict__ cnt) {
    __shared__ PolyTrial tr;
    __shared__ PolyTables sT;   // dynamic table indexing reads shared, not a param copy
    int z, y, x;
    const int cell = active_cell(g, cz, cy, cx, z, y, x);
    const int ncells = g.nx * g.ny * g.nz;
    float* P[7] = {px, py, pz, pqw, pqx, pqy, pqz};
    if (threadIdx.x == 0) {
        sT = T;
        float uu[12];
        for (int k = 0; k < 12; ++k) uu[k] = u[k * ncells + cell];
        int pick;
        bool has;
        float pl;
        pick_mover(live, cell, g.C, uu[0], pick, has, pl);
        const int slot = cell * g.C + pick;
        float m[7];
        for (int k = 0; k < 7; ++k) m[k] = fm(P[k][slot], pl);
        // translate: ball-uniform (Box-Muller direction, u^(1/3))
        float g1, g2, g3, h1, h2, h3;
        gaussians(uu[2], uu[3], uu[4], uu[5], g1, g2, g3);
        const float gn = rsqrt_exact(fa(sum3sq(g1, g2, g3), kTiny));
        const float rball = expf(fm(logf(fa(uu[6], kTiny)), kThird));
        // rotate: random axis, uniform angle in [-a, a]
        gaussians(uu[7], uu[8], uu[9], uu[10], h1, h2, h3);
        const float hn = rsqrt_exact(fa(sum3sq(h1, h2, h3), kTiny));
        const float half = fm(fm(0.5f, fs(fm(2.0f, uu[11]), 1.0f)), a_mv);
        const float dqw = cosf(half);
        const float s_h = fm(sinf(half), hn);
        const float dqx = fm(s_h, h1), dqy = fm(s_h, h2), dqz = fm(s_h, h3);
        const bool rot = uu[1] > m_ratio;
        const float step = fm(fm(fm(d_mv, rball), gn), fs(1.0f, rot ? 1.f : 0.f));
        tr.x[0] = wrap_box(fa(m[0], fm(g1, step)), g.L[0]);
        tr.x[1] = wrap_box(fa(m[1], fm(g2, step)), g.L[1]);
        tr.x[2] = wrap_box(fa(m[2], fm(g3, step)), g.L[2]);
        const float mqw = m[3], mqx = m[4], mqy = m[5], mqz = m[6];
        const float rw = fs(fs(fs(fm(dqw, mqw), fm(dqx, mqx)), fm(dqy, mqy)), fm(dqz, mqz));
        const float rx = fs(fa(fa(fm(dqw, mqx), fm(dqx, mqw)), fm(dqy, mqz)), fm(dqz, mqy));
        const float ry = fa(fa(fs(fm(dqw, mqy), fm(dqx, mqz)), fm(dqy, mqw)), fm(dqz, mqx));
        const float rz = fa(fs(fa(fm(dqw, mqz), fm(dqx, mqy)), fm(dqy, mqx)), fm(dqz, mqw));
        const float rn = rsqrt_exact(fa(fa(fa(fa(fm(rw, rw), fm(rx, rx)), fm(ry, ry)),
                                             fm(rz, rz)),
                                          kTiny));
        tr.q[0] = rot ? fm(rw, rn) : mqw;
        tr.q[1] = rot ? fm(rx, rn) : mqx;
        tr.q[2] = rot ? fm(ry, rn) : mqy;
        tr.q[3] = rot ? fm(rz, rn) : mqz;
        quat_to_R(tr.q[0], tr.q[1], tr.q[2], tr.q[3], tr.RA);
        tr.pl = pl;
        tr.pick = pick;
        tr.has = has;
        tr.rot = rot;
    }
    __syncthreads();
    float RA[3][3], qa[4], xa[3];
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) RA[r][c] = tr.RA[r][c];
    for (int k = 0; k < 4; ++k) qa[k] = tr.q[k];
    for (int k = 0; k < 3; ++k) xa[k] = tr.x[k];
    int hit = 0;
    const int n = 27 * g.C;
    for (int k = threadIdx.x; k < n && !hit; k += blockDim.x) {
        const int j = window_slot(g, z, y, x, k);
        if (!(live[j] > 0.5f)) continue;
        if (k == kCenter * g.C + tr.pick && tr.pl > 0.5f) continue;
        const float dgx = min_image(fs(px[j], xa[0]), g.L[0]);
        const float dgy = min_image(fs(py[j], xa[1]), g.L[1]);
        const float dgz = min_image(fs(pz[j], xa[2]), g.L[2]);
        hit = poly_overlap(sT, RA, qa, dgx, dgy, dgz, pqw[j], pqx[j], pqy[j], pqz[j]);
    }
    hit = __syncthreads_or(hit);
    if (threadIdx.x == 0) {
        const bool acc = tr.has && !hit;
        const float sel = fm(tr.pl, acc ? 1.f : 0.f);
        const int slot = cell * g.C + tr.pick;
        const float nv[7] = {tr.x[0], tr.x[1], tr.x[2], tr.q[0], tr.q[1], tr.q[2], tr.q[3]};
        for (int k = 0; k < 7; ++k) {
            const float raw = P[k][slot];
            P[k][slot] = fa(raw, fm(sel, fs(nv[k], raw)));
        }
        const int base = tr.rot ? 2 : 0;
        if (tr.has) atomicAdd(&cnt[base + 1], 1);
        if (acc) atomicAdd(&cnt[base], 1);
    }
}

static int threads_for(int C) {
    const int n = ((27 * C + 31) / 32) * 32;
    return n < 512 ? n : 512;
}

}  // namespace hoomd_hpmc

using namespace hoomd_hpmc;

extern "C" {

int hoomd_hpmc_sphere_sweep(float* px, float* py, float* pz, const float* rad, const float* dmv,
                            const float* live, const float* randu, const int* perms, int nsub,
                            int* cnt, int nx, int ny, int nz, int C, float Lx, float Ly,
                            float Lz, cudaStream_t st) {
    const Geom g{nx, ny, nz, C, {Lx, Ly, Lz}};
    const long long ncells = (long long)nx * ny * nz;
    const int blocks = (nx / 2) * (ny / 2) * (nz / 2);
    for (int s = 0; s < nsub; ++s) {
        const int c = perms[s];
        sphere_subsweep<<<blocks, threads_for(C), 0, st>>>(
            px, py, pz, rad, dmv, live, randu + (long long)s * 6 * ncells, c / 4, (c / 2) % 2,
            c % 2, g, cnt);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaGetLastError();
}

int hoomd_hpmc_poly_sweep(float* px, float* py, float* pz, float* qw, float* qx, float* qy,
                          float* qz, const float* live, const float* randu, const int* perms,
                          int nsub, int* cnt, const float* tab, int nv, int nf, int ne,
                          float d_mv, float a_mv, float m_ratio, int nx, int ny, int nz, int C,
                          float Lx, float Ly, float Lz, cudaStream_t st) {
    // tab: V (8x3), F (8x3), E (6x3), lo (8), hi (8), zero-padded
    PolyTables T;
    T.nv = nv;
    T.nf = nf;
    T.ne = ne;
    const float* p = tab;
    for (int k = 0; k < kMaxV; ++k)
        for (int r = 0; r < 3; ++r) T.v[k][r] = *p++;
    for (int k = 0; k < kMaxF; ++k)
        for (int r = 0; r < 3; ++r) T.f[k][r] = *p++;
    for (int k = 0; k < kMaxE; ++k)
        for (int r = 0; r < 3; ++r) T.e[k][r] = *p++;
    for (int k = 0; k < kMaxF; ++k) T.lo[k] = *p++;
    for (int k = 0; k < kMaxF; ++k) T.hi[k] = *p++;
    const Geom g{nx, ny, nz, C, {Lx, Ly, Lz}};
    const long long ncells = (long long)nx * ny * nz;
    const int blocks = (nx / 2) * (ny / 2) * (nz / 2);
    for (int s = 0; s < nsub; ++s) {
        const int c = perms[s];
        poly_subsweep<<<blocks, threads_for(C), 0, st>>>(
            px, py, pz, qw, qx, qy, qz, live, randu + (long long)s * 12 * ncells, c / 4,
            (c / 2) % 2, c % 2, g, T, d_mv, a_mv, m_ratio, cnt);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaGetLastError();
}

}  // extern "C"
