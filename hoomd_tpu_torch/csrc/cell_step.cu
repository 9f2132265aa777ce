// Hand-written Hopper kernel of the fused single step
// (hoomd_tpu_torch/ops/cell_pair.py cell_step_plane_planes binds it
// through ctypes).
//
// hoomd_step_plane  replaces hoomd_tpu/ops/pallas_pair.py:_kernel_step_plane
//                   (HOOMD_TPU_FUSED=on): one velocity-Verlet step on
//                   plane-layout state (3, nz, ny, nx, C) — drift every
//                   slot, x' = x + dt (s v + dt/2 f/m); the 27-cell force
//                   at the drifted positions; kick, v' = s (vh + dt/2 F/m);
//                   and the sums the host's Nose-Hoover algebra and danger
//                   check read, ke2 = sum m v'^2 and md2 = max |x' - ref|^2.
//
// Instantiated for the ten pair evaluators of cell_stencil.cuh; only lj
// takes the fast reciprocal (NVT), every other evaluator divides exactly.
//
// What bounds it on this card: the pair loop, as for the plane kernel
// (cell_pair.cu): at the 64k LJ bench plan ~102M candidate pairs of ~20
// flops against ~20 MB of state, so the fp32 instruction rate, not
// memory.  Design:
//   * One block per cell, a thread per slot, on the stencil of
//     cell_stencil.cuh.  The drift is not a launch of its own: a block
//     computes the drifted position of every slot it stages from p, v, f,
//     1/m and s.  Each slot's drift is computed by the 27 blocks around
//     it, and must come out with the same bits in all of them and in its
//     owner's output: drift_slot rounds every operation on its own
//     (__fmul_rn / __fadd_rn), so no call site can contract it into an
//     FMA differently, and the plain torch version's separate ops give
//     the same bits.  The cost is 11 reads per staged slot instead of 4;
//     the 27-fold re-reads hit L2.
//   * Out of place: blocks read the pre-step p, v, f of their neighbours
//     while the owner writes the new ones, so the outputs are separate
//     buffers (the wrapper allocates them; the caching allocator hands a
//     step the buffers the step before last released, a ping-pong pair).
//   * ke2 and md2: each block writes its cell's partial sum and maximum,
//     and a one-block launch sums and maxes them in a fixed order, with
//     no float atomics, so equal inputs give equal bits.
//   * Padding slots hold v = f = 0 and tag < 0: they drift by nothing,
//     pair with nothing (validity from the tag) and kick by nothing.
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace hoomd_torch {

constexpr int kFinishThreads = 256;

// x' = x + dt (s v + (dt/2 f) w), and vh = s v + (dt/2 f) w, each
// operation rounded on its own.
__device__ __forceinline__ float drift_slot(const float x, const float v, const float f,
                                            const float w, const float s, const float dt,
                                            const float hdt, float& vh) {
    vh = __fadd_rn(__fmul_rn(s, v), __fmul_rn(__fmul_rn(hdt, f), w));
    return __fadd_rn(x, __fmul_rn(dt, vh));
}

template <int EV, bool APPROX>
__global__ void step_plane_kernel(const float* __restrict__ p, const float* __restrict__ v,
                                  const float* __restrict__ f, const float* __restrict__ w,
                                  const float* __restrict__ r, const int* __restrict__ tag,
                                  const float* __restrict__ shifts,
                                  const float* __restrict__ par, const int np,
                                  const float* __restrict__ s_ptr, const float dt,
                                  const Geom g, float* __restrict__ po,
                                  float* __restrict__ vo, float* __restrict__ fo,
                                  float* __restrict__ kpart, float* __restrict__ mpart) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    const long long M = (long long)g.nx * g.ny * g.nz * g.C;
    const int cell = blockIdx.x;
    const float s = *s_ptr;
    const float hdt = 0.5f * dt;
    float vh;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / g.C;
        const long long q = stencil_slot(g, cell, k, t - k * g.C);
        const float* sh = shifts + ((long long)cell * 27 + k) * 3;
        const float wq = w[q];
        sx[t] = drift_slot(p[q], v[q], f[q], wq, s, dt, hdt, vh) + sh[0];
        sy[t] = drift_slot(p[M + q], v[M + q], f[M + q], wq, s, dt, hdt, vh) + sh[1];
        sz[t] = drift_slot(p[2 * M + q], v[2 * M + q], f[2 * M + q], wq, s, dt, hdt, vh) +
                sh[2];
        sv[t] = tag[q] >= 0;
    }
    __syncthreads();
    const int i = threadIdx.x;
    float ke = 0.0f, md = 0.0f;
    if (i < g.C) {
        const long long j = (long long)cell * g.C + i;
        const float wj = w[j];
        float x[3], vhj[3];
        for (int a = 0; a < 3; ++a)
            x[a] = drift_slot(p[a * M + j], v[a * M + j], f[a * M + j], wj, s, dt, hdt,
                              vhj[a]);
        const PairPar P = load_pair_par(par, np);
        float acc[3] = {0.f, 0.f, 0.f};
        const int ic = 13 * g.C + i;
        if (sv[ic]) stencil_sum<EV, APPROX, false>(x[0], x[1], x[2], ic, n, sx, sy, sz, sv, P, acc);
        for (int a = 0; a < 3; ++a) {
            const long long q = a * M + j;
            const float vn = s * (vhj[a] + hdt * acc[a] * wj);
            po[q] = x[a];
            vo[q] = vn;
            fo[q] = acc[a];
            ke += vn * vn / wj;
            const float d = x[a] - r[q];
            md += d * d;
        }
    }
    ke = block_sum(ke);
    md = block_reduce<true>(md);
    if (threadIdx.x == 0) {
        kpart[cell] = ke;
        mpart[cell] = md;
    }
}

// One block: out = [sum of the nb KE partials, max of the nb drift
// partials], in a fixed order.
__global__ void step_finish(const float* __restrict__ kpart, const float* __restrict__ mpart,
                            const int nb, float* __restrict__ out) {
    float k = 0.0f, m = 0.0f;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
        k += kpart[b];
        m = fmaxf(m, mpart[b]);
    }
    k = block_sum(k);
    m = block_reduce<true>(m);
    if (threadIdx.x == 0) {
        out[0] = k;
        out[1] = m;
    }
}

template <int EV, bool APPROX>
static cudaError_t launch_step(const float* p, const float* v, const float* f, const float* w,
                               const float* r, const int* tag, const float* shifts,
                               const float* par, int np, const float* s, float dt,
                               const Geom g, float* po, float* vo, float* fo, float* kpart,
                               float* mpart, cudaStream_t st) {
    const size_t smem = stencil_smem_bytes(g.C);
    cudaError_t e = set_smem(step_plane_kernel<EV, APPROX>, smem);
    if (e != cudaSuccess) return e;
    step_plane_kernel<EV, APPROX><<<g.nx * g.ny * g.nz, threads_for(g.C), smem, st>>>(
        p, v, f, w, r, tag, shifts, par, np, s, dt, g, po, vo, fo, kpart, mpart);
    return cudaGetLastError();
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// One fused step: p, v, f, r (3, nz, ny, nx, C) planes, w = 1/m and tag
// (nz, ny, nx, C), par = [rc2, e_shift, *pnames] (np names), s the
// thermostat scale on the device, dt.  Writes po, vo, fo (separate from
// p, v, f), part (2 * nx*ny*nz floats of per-cell partials) and out =
// [ke2, md2].
int hoomd_step_plane(const float* p, const float* v, const float* f, const float* w,
                     const float* r, const int* tag, const float* shifts, const float* par,
                     int np, const float* s, float dt, float* po, float* vo, float* fo,
                     float* part, float* out, int nx, int ny, int nz, int C, int ev,
                     int approx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    const int nc = nx * ny * nz;
    float* kpart = part;
    float* mpart = part + nc;
    cudaError_t e;
    if (approx && ev == EV_LJ)
        e = launch_step<EV_LJ, true>(p, v, f, w, r, tag, shifts, par, np, s, dt, g, po, vo,
                                     fo, kpart, mpart, st);
    else
        e = dispatch_eval(ev, [&](auto t) {
            return launch_step<decltype(t)::value, false>(p, v, f, w, r, tag, shifts, par, np,
                                                          s, dt, g, po, vo, fo, kpart, mpart,
                                                          st);
        });
    if (e != cudaSuccess) return e;
    step_finish<<<1, kFinishThreads, 0, st>>>(kpart, mpart, nc, out);
    return cudaGetLastError();
}

}  // extern "C"
