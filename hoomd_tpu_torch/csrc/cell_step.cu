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
//   * A block per tile of tx <= STEP_TILE cells of an x-row, on the walk
//     of the row-blocked LJ kernel (cell_walk.cuh): the block stages the
//     tile's union once, the 9 (dz, dy) rows of tx + 2 cells, compacted
//     to the live slots, with a box per union cell at the drifted
//     positions; a warp per home walks the union cells inside its cut and
//     evaluates the pairs inside it 32 at a time, so an evaluator's
//     transcendentals are paid for pairs inside the cut alone.
//   * The drift is not a launch of its own: a block drifts each slot it
//     stages once, from p, v, f, 1/m and s, 9 (tx + 2) / (27 tx) of the
//     drifts a block per cell would compute.  A slot's drift is computed
//     by every block that stages it and must come out with the same bits
//     in all of them and in its owner's output: drift_slot rounds every
//     operation on its own (__fmul_rn / __fadd_rn), so no call site can
//     contract it into an FMA differently, and the plain torch version's
//     separate ops give the same bits.
//   * Out of place: blocks read the pre-step p, v, f of their neighbours
//     while the owner writes the new ones, so the outputs are separate
//     buffers (the wrapper allocates them; the caching allocator hands a
//     step the buffers the step before last released, a ping-pong pair).
//   * ke2 and md2: each block writes its tile's partial sum and maximum,
//     and a one-block launch sums and maxes them in a fixed order, with
//     no float atomics and no state kept between calls, so equal inputs
//     give equal bits.
//   * Padding slots hold v = f = 0 and tag < 0: they drift by nothing,
//     pair with nothing (validity from the tag) and kick by nothing.
// Its first design, a block per cell and a thread per slot (64 threads, 40
// busy at the bench plan), staged all 27 C slots of the stencil, each
// drifted again by each of the 27 blocks around it, and walked them all,
// padding included, each thread paying for the in-cut branch's evaluator
// whenever one lane of its warp was inside the cut.
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_walk.cuh"

// Cells per tile at most (chosen by timing at the bench plan:
// profile_torch_bench.py tiles builds the other widths with -DSTEP_TILE=n)
#ifndef STEP_TILE
#define STEP_TILE 2
#endif

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
__global__ void __launch_bounds__(kWalkWarps * 32)
    step_plane_kernel(const float* __restrict__ p, const float* __restrict__ v,
                      const float* __restrict__ f, const float* __restrict__ w,
                      const float* __restrict__ r, const int* __restrict__ tag,
                      const float* __restrict__ shifts, const float* __restrict__ par,
                      const int np, const float* __restrict__ s_ptr, const float dt,
                      const Geom g, const int TX, float* __restrict__ po,
                      float* __restrict__ vo, float* __restrict__ fo,
                      float* __restrict__ kpart, float* __restrict__ mpart) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const WalkSmem S = walk_smem(smem4, TX, C);
    const Tile t = tile_of_block(g, TX);
    const long long M = (long long)g.nx * g.ny * g.nz * C;
    const long long cell0 = (long long)t.x0 + g.nx * (t.iy + (long long)g.ny * t.iz);
    const float s = *s_ptr;
    const float hdt = 0.5f * dt;
    // slot j's drifted position x and half-kicked velocity vh
    auto drift = [&](const long long j, const float wj, float* x, float* vh) {
        for (int a = 0; a < 3; ++a)
            x[a] = drift_slot(p[a * M + j], v[a * M + j], f[a * M + j], wj, s, dt, hdt, vh[a]);
    };
    // slot j's outputs from x, vh and its force acc; its KE into ke, its
    // squared drift from the reference into md (the maximum)
    float ke = 0.0f, md = 0.0f;
    auto finish = [&](const long long j, const float wj, const float* x, const float* vh,
                      const float* acc) {
        float m = 0.0f;
        for (int a = 0; a < 3; ++a) {
            const long long q = a * M + j;
            const float vn = s * (vh[a] + hdt * acc[a] * wj);
            po[q] = x[a];
            vo[q] = vn;
            fo[q] = acc[a];
            ke += vn * vn / wj;
            const float d = x[a] - r[q];
            m += d * d;
        }
        md = fmaxf(md, m);
    };
    for (int q = threadIdx.x; q < t.tx * C; q += blockDim.x) {   // the padding slots
        const long long j = cell0 * C + q;
        if (tag[j] >= 0) continue;
        const float wj = w[j];
        const float zero[3] = {0.f, 0.f, 0.f};
        float x[3], vh[3];
        drift(j, wj, x, vh);
        finish(j, wj, x, vh, zero);
    }
    pack_homes(tag, g, t, S.hslot, S.hstart);
    const int nh = S.hstart[t.tx];
    if (nh > 0) {                               // block-uniform
        stage_union(tag, shifts, g, t, 0, 9, S.off,
                    [&](const int idx, const int, const int, const long long sl,
                        const float* sh) {
                        const float wq = w[sl];
                        float vh;
                        S.ent[idx] = make_float4(
                            drift_slot(p[sl], v[sl], f[sl], wq, s, dt, hdt, vh) + sh[0],
                            drift_slot(p[M + sl], v[M + sl], f[M + sl], wq, s, dt, hdt, vh) +
                                sh[1],
                            drift_slot(p[2 * M + sl], v[2 * M + sl], f[2 * M + sl], wq, s, dt,
                                       hdt, vh) +
                                sh[2],
                            0.0f);
                    });
        stage_boxes(9 * t.W, S.ent, S.off, S.box);
        __syncthreads();
        const PairPar P = load_pair_par(par, np);
        float4* L = S.lst + wp * kWalkList;
        for (int hp = wp; hp < nh; hp += kWalkWarps) {  // warp-uniform
            const long long j = S.hslot[hp];
            const int lc = home_cell(S.hstart, t.tx, hp);
            const float wj = w[j];
            float x[3], vh[3], acc[3];
            drift(j, wj, x, vh);
            walk_home<EV, APPROX, false>(x[0], x[1], x[2],
                                         S.off[4 * t.W + lc + 1] + hp - S.hstart[lc], S.ent,
                                         S.box, S.off, t.W, lc, P, L, acc);
            if (lane == 0) finish(j, wj, x, vh, acc);
            __syncwarp();                       // the list is read before the next home
        }
    }
    ke = block_sum(ke);
    md = block_reduce<true>(md);
    if (threadIdx.x == 0) {
        const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
        kpart[b] = ke;
        mpart[b] = md;
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

// fn(kernel) for the kernel of evaluator ev (approx: lj's fast reciprocal)
template <typename Fn>
static cudaError_t with_step_kernel(const int ev, const int approx, Fn&& fn) {
    if (approx && ev == EV_LJ) return fn(step_plane_kernel<EV_LJ, true>);
    return dispatch_eval(ev, [&](auto t) {
        return fn(step_plane_kernel<decltype(t)::value, false>);
    });
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// One fused step: p, v, f, r (3, nz, ny, nx, C) planes, w = 1/m and tag
// (nz, ny, nx, C), par = [rc2, e_shift, *pnames] (np names), s the
// thermostat scale on the device, dt.  Writes po, vo, fo (separate from
// p, v, f), part (2 * nx*ny*nz floats: the per-tile partials, at most one
// per cell) and out = [ke2, md2].
int hoomd_step_plane(const float* p, const float* v, const float* f, const float* w,
                     const float* r, const int* tag, const float* shifts, const float* par,
                     int np, const float* s, float dt, float* po, float* vo, float* fo,
                     float* part, float* out, int nx, int ny, int nz, int C, int ev,
                     int approx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    const int tx = union_tile(nx, C, STEP_TILE);
    const dim3 grid((nx + tx - 1) / tx, ny, nz);   // tiles of an x-row, ny, nz
    const int nb = grid.x * grid.y * grid.z;
    float* kpart = part;
    float* mpart = part + nx * ny * nz;
    cudaError_t e = with_step_kernel(ev, approx, [&](auto kern) {
        const size_t smem = walk_smem_bytes(tx, C);
        cudaError_t e2 = set_smem(kern, smem);
        if (e2 != cudaSuccess) return e2;
        kern<<<grid, kWalkWarps * 32, smem, st>>>(p, v, f, w, r, tag, shifts, par, np, s, dt, g,
                                                  tx, po, vo, fo, kpart, mpart);
        return cudaGetLastError();
    });
    if (e != cudaSuccess) return e;
    step_finish<<<1, kFinishThreads, 0, st>>>(kpart, mpart, nb, out);
    return cudaGetLastError();
}

// The build and occupancy of the fused step's kernel of evaluator ev
// (approx: lj's fast reciprocal) at an x-row of nx cells of capacity C
// (kernel_occupancy's out[5]) and its threads per block (out[5]).
int hoomd_step_plane_occupancy(int ev, int approx, int nx, int C, int* out) {
    out[5] = kWalkWarps * 32;
    const size_t smem = walk_smem_bytes(union_tile(nx, C, STEP_TILE), C);
    return with_step_kernel(ev, approx,
                            [&](auto kern) { return kernel_occupancy(kern, out[5], smem, out); });
}

}  // extern "C"
