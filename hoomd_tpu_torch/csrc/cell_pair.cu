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
// memory.  At the 64k LJ bench shape (2352 cells, C = 40) a step visits
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
// The TPU megastep holds the whole state in VMEM with no grid.  Here the
// k steps need grid-wide order between the drift and the stencil and a
// global KE sum for the Nose-Hoover update, so each step is a drift
// launch (with block partials of the per-axis top-two drift), a
// one-block finishing launch (drift monitor, xi/eta), a force + kick
// launch, and for NVT a one-block KE finish.  xi, eta, KE and the drift
// ratio live in a small device buffer: no host synchronisation inside a
// window.  Each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace hoomd_torch {

constexpr int kRedThreads = 256;

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
// megastep pieces.  mp = [dt, tinv2, it_x, it_y, it_z, gamma, ndof, rc2,
// e_shift, *pnames]; sc = [xi, eta, ke2, mdmax].
constexpr int MP_DT = 0, MP_TINV2 = 1, MP_IT = 2, MP_GAMMA = 5, MP_NDOF = 6, MP_PV = 7;

// Top-two reduction of one axis' squared drift: the largest value, how
// many slots hold it, and the largest value below it.  Merging two
// partials is associative, so block partials and the finishing pass
// give exactly what one_step's max / tie / masked max give.
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

__device__ inline void top2_block(Top2* t, Top2* sh) {
    // t[3] per thread -> block result in sh[0..2] (valid after return)
    for (int a = 0; a < 3; ++a) sh[a * kRedThreads + threadIdx.x] = t[a];
    __syncthreads();
    for (int s = kRedThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s)
            for (int a = 0; a < 3; ++a)
                sh[a * kRedThreads + threadIdx.x] = top2_merge(
                    sh[a * kRedThreads + threadIdx.x], sh[a * kRedThreads + threadIdx.x + s]);
        __syncthreads();
    }
}

__device__ inline float nh_xi_half(const float* mp, const float xi, const float ke2,
                                   const float kT) {
    // xi + dt/2 (KE2 / (ndof kT) - 1) / tau^2, the megastep's order
    return xi + 0.5f * mp[MP_DT] * (ke2 / (mp[MP_NDOF] * kT) - 1.0f) * mp[MP_TINV2];
}

// Drift: v' = s v + dt/2 f/m ; x += dt v' ; per-axis top-two of
// (x - x_ref)^2 into block partials.
__global__ void mega_drift(float* __restrict__ p, float* __restrict__ v,
                           const float* __restrict__ f, const float* __restrict__ w,
                           const float* __restrict__ r, const long long M,
                           const float* __restrict__ mp, const float* __restrict__ sc,
                           const float* __restrict__ kt, const int si, const int nvt,
                           Top2* __restrict__ part) {
    __shared__ Top2 sh[3 * kRedThreads];
    const float dt = mp[MP_DT], hdt = 0.5f * dt;
    float s = 1.0f;
    if (nvt) s = expf(-hdt * nh_xi_half(mp, sc[0], sc[2], kt[si]));
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    Top2 t[3] = {{-1.f, 0, -1.f}, {-1.f, 0, -1.f}, {-1.f, 0, -1.f}};
    if (j < M) {
        const float wj = w[j];
        for (int a = 0; a < 3; ++a) {
            const long long q = a * M + j;
            const float vh = s * v[q] + hdt * f[q] * wj;
            const float pn = p[q] + dt * vh;
            v[q] = vh;
            p[q] = pn;
            const float d = pn - r[q];
            t[a] = Top2{d * d, 1, -1.f};
        }
    }
    top2_block(t, sh);
    if (threadIdx.x == 0)
        for (int a = 0; a < 3; ++a) part[blockIdx.x * 3 + a] = sh[a * kRedThreads];
}

// One block: finish the drift monitor (normalised ratio
// ((d1 + d2) / skin_a)^2, max over axes and over the window so far) and
// advance the Nose-Hoover xi / eta of the first half step.
__global__ void mega_drift_finish(const Top2* __restrict__ part, const int nb,
                                  const float* __restrict__ mp, float* __restrict__ sc,
                                  const float* __restrict__ kt, const int si, const int nvt) {
    __shared__ Top2 sh[3 * kRedThreads];
    Top2 t[3] = {{-1.f, 0, -1.f}, {-1.f, 0, -1.f}, {-1.f, 0, -1.f}};
    for (int b = threadIdx.x; b < nb; b += blockDim.x)
        for (int a = 0; a < 3; ++a) t[a] = top2_merge(t[a], part[b * 3 + a]);
    top2_block(t, sh);
    if (threadIdx.x != 0) return;
    float md2 = sc[3];
    for (int a = 0; a < 3; ++a) {
        const Top2 r = sh[a * kRedThreads];
        const float m1 = r.m1;
        const float m2 = (r.cnt > 1) ? m1 : fmaxf(r.m2, 0.0f);
        const float it = mp[MP_IT + a];
        const float sd = 0.5f * (sqrtf(m1 * it) + sqrtf(m2 * it));
        md2 = fmaxf(md2, sd * sd);
    }
    sc[3] = md2;
    if (nvt) {
        const float xi1 = nh_xi_half(mp, sc[0], sc[2], kt[si]);
        sc[1] = sc[1] + mp[MP_DT] * xi1;
        sc[0] = xi1;
    }
}

// Block partials of sum m v.v over the planes (the kinetic-energy sum).
__global__ void mega_ke_partial(const float* __restrict__ v, const float* __restrict__ m,
                                const long long M, float* __restrict__ part) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float k = 0.0f;
    if (j < M)
        k = (v[j] * v[j] + v[M + j] * v[M + j] + v[2 * M + j] * v[2 * M + j]) * m[j];
    k = block_sum(k);
    if (threadIdx.x == 0) part[blockIdx.x] = k;
}

// One block: KE2 = sum of the partials; with nvt, the second-half xi
// update of step si.
__global__ void mega_ke_finish(const float* __restrict__ part, const int nb,
                               const float* __restrict__ mp, float* __restrict__ sc,
                               const float* __restrict__ kt, const int si, const int nvt) {
    float k = 0.0f;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) k += part[b];
    k = block_sum(k);
    if (threadIdx.x != 0) return;
    sc[2] = k;
    if (nvt) sc[0] = nh_xi_half(mp, sc[0], k, kt[si]);
}

// Forces at the drifted positions, then the kick.  METHOD 0 = NVE,
// 1 = Nose-Hoover (post-scale, KE partial per block), 2 = Langevin
// (precomputed noise planes of this step, drag -gamma v).
template <int EV, bool APPROX, int METHOD>
__global__ void mega_force_kick(const float* __restrict__ p, float* __restrict__ v,
                                float* __restrict__ f, const float* __restrict__ w,
                                const float* __restrict__ m, const int* __restrict__ tag,
                                const float* __restrict__ shifts,
                                const float* __restrict__ mp, const int np,
                                const float* __restrict__ sc,
                                const float* __restrict__ noise, const Geom g,
                                float* __restrict__ kpart) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    const long long M = (long long)g.nx * g.ny * g.nz * g.C;
    const int cell = blockIdx.x;
    stage_stencil(Vec3{const_cast<float*>(p), 1, M}, tag, shifts, g, cell, sx, sy, sz, sv);
    __syncthreads();
    const int i = threadIdx.x;
    float ke = 0.0f;
    if (i < g.C) {
        const PairPar P = load_pair_par(mp + MP_PV, np);
        float acc[3] = {0.f, 0.f, 0.f};
        const int ic = 13 * g.C + i;
        if (sv[ic])
            stencil_sum<EV, APPROX, false>(sx[ic], sy[ic], sz[ic], ic, n, sx, sy, sz, sv, P,
                                           acc);
        const long long j = (long long)cell * g.C + i;
        const float hdt = 0.5f * mp[MP_DT];
        const float wj = w[j];
        const float s = (METHOD == 1) ? expf(-hdt * sc[0]) : 1.0f;
        for (int a = 0; a < 3; ++a) {
            const long long q = a * M + j;
            float F = acc[a];
            float vn;
            if (METHOD == 2) {
                F = F + noise[q] - mp[MP_GAMMA] * v[q];
                vn = v[q] + hdt * F * wj;
            } else {
                vn = v[q] + hdt * F * wj;
                if (METHOD == 1) vn = vn * s;
            }
            f[q] = F;
            v[q] = vn;
            ke += vn * vn;
        }
        ke *= m[j];
    }
    if (METHOD == 1) {
        ke = block_sum(ke);
        if (threadIdx.x == 0) kpart[blockIdx.x] = ke;
    }
}

template <int EV, bool APPROX, int METHOD>
static cudaError_t launch_force_kick(const float* p, float* v, float* f, const float* w,
                                     const float* m, const int* tag, const float* shifts,
                                     const float* mp, int np, const float* sc,
                                     const float* noise, const Geom g, float* kpart,
                                     cudaStream_t st) {
    const size_t smem = stencil_smem_bytes(g.C);
    cudaError_t e = set_smem(mega_force_kick<EV, APPROX, METHOD>, smem);
    if (e != cudaSuccess) return e;
    mega_force_kick<EV, APPROX, METHOD><<<g.nx * g.ny * g.nz, threads_for(g.C), smem, st>>>(
        p, v, f, w, m, tag, shifts, mp, np, sc, noise, g, kpart);
    return cudaGetLastError();
}

// The force + kick launch of one step, for the evaluator ev; approx only
// with lj.
template <int METHOD>
static cudaError_t force_kick(int ev, int approx, const float* p, float* v, float* f,
                              const float* w, const float* m, const int* tag,
                              const float* shifts, const float* mp, int np, const float* sc,
                              const float* noise, const Geom g, float* kpart,
                              cudaStream_t st) {
    if (approx && ev == EV_LJ)
        return launch_force_kick<EV_LJ, true, METHOD>(p, v, f, w, m, tag, shifts, mp, np, sc,
                                                     noise, g, kpart, st);
    return dispatch_eval(ev, [&](auto t) {
        return launch_force_kick<decltype(t)::value, false, METHOD>(
            p, v, f, w, m, tag, shifts, mp, np, sc, noise, g, kpart, st);
    });
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
// updated in place.  method: 0 nve, 1 nvt, 2 langevin.  noise holds
// k * 3 * M floats (langevin only).  dpart needs 3 * ceil(M / 256)
// Top2 records, kpart max(nc, ceil(M / 256)) floats; mp carries np
// evaluator parameters after [.., rc2, e_shift].
int hoomd_megastep(float* p, float* v, float* f, const float* w, const float* m,
                   const float* r, const int* tag, const float* shifts, const float* mp,
                   int np, float* sc, const float* kt, const float* noise, void* dpart,
                   float* kpart, int nx, int ny, int nz, int C, int k, int method, int ev,
                   int approx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    const long long M = (long long)nx * ny * nz * C;
    const int nb = (int)((M + kRedThreads - 1) / kRedThreads);
    const int nvt = method == 1;
    Top2* part = static_cast<Top2*>(dpart);
    cudaError_t e;
    if (ev < 0 || ev >= EV_COUNT || method < 0 || method > 2) return cudaErrorInvalidValue;
    mega_ke_partial<<<nb, kRedThreads, 0, st>>>(v, m, M, kpart);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    mega_ke_finish<<<1, kRedThreads, 0, st>>>(kpart, nb, mp, sc, kt, 0, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    for (int si = 0; si < k; ++si) {
        mega_drift<<<nb, kRedThreads, 0, st>>>(p, v, f, w, r, M, mp, sc, kt, si, nvt, part);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        mega_drift_finish<<<1, kRedThreads, 0, st>>>(part, nb, mp, sc, kt, si, nvt);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        const float* nz_s = method == 2 ? noise + (long long)si * 3 * M : nullptr;
        if (method == 0)
            e = force_kick<0>(ev, approx, p, v, f, w, m, tag, shifts, mp, np, sc, nz_s, g,
                              kpart, st);
        else if (method == 1)
            e = force_kick<1>(ev, approx, p, v, f, w, m, tag, shifts, mp, np, sc, nz_s, g,
                              kpart, st);
        else
            e = force_kick<2>(ev, approx, p, v, f, w, m, tag, shifts, mp, np, sc, nz_s, g,
                              kpart, st);
        if (e != cudaSuccess) return e;
        if (nvt) {
            mega_ke_finish<<<1, kRedThreads, 0, st>>>(kpart, nx * ny * nz, mp, sc, kt, si, 1);
            if ((e = cudaGetLastError()) != cudaSuccess) return e;
        }
    }
    return cudaSuccess;
}

const char* hoomd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
