// Hand-written Hopper kernel of the LJ engine's mixtures (hoomd_tpu_torch/
// ops/cell_pair.py binds it through ctypes):
//
// hoomd_cell_pair_planar_typed  replaces the typed branch of
//                               hoomd_tpu/ops/pallas_pair.py:_kernel_planar
//                               (ntypes > 1): forces, half-pair energy and
//                               virial of a mixture of up to kMaxTypes
//                               particle types, each pair (i, j) with the
//                               parameters [k, type_i, type_j] of a
//                               (2 + np, T, T) table.
//
// The JAX engine runs it on every step of a job with 2 to 4 types (its
// megastep, plane and fused-step kernels are single-type), so a mixture's
// step time is this kernel's.  It keeps the single-type planar kernel's
// shape (cell_pair.cu cell_pair_kernel): one block per cell, a thread per
// slot, the 27 C candidates staged in shared memory, here with each
// candidate's type in its validity byte (27 C * 13 bytes, 25 KB at C = 72),
// beside the table (at most 8 * 16 floats).  Each thread holds the row of
// its own type in registers and selects a candidate's column by its type
// (cell_stencil.cuh typed_pair_acc): the TPU kernel's one-hot mixing over
// every (ti, tj) is a select of one of T values here.  Exact divide, as the
// JAX engine takes for T > 1.  No atomics: each pair is evaluated from both
// sides, so the sums are deterministic.
//
// What bounds it on this card: as the single-type stencil, the pair loop's
// fp32 issue rate.  At the 64k Kob-Andersen plan (1728 cells, C = 72, at
// rho = 1.2) a slot walks 27 C = 1944 staged entries, ~1000 of them live,
// ~64M live candidate pairs in all; the lookup adds three selects per
// candidate for rc2 and ~20 for a pair inside the cut.  The known costs of
// the simple design (unused lanes of a rounded-up warp, the full rather
// than the half stencil) are left to later work.  The C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace hoomd_torch {

// Shared memory of one block: the staged stencil with its type bytes and
// the (2 + np, T, T) table.
static inline size_t typed_smem_bytes(const int C, const int ntab) {
    return (size_t)27 * C * 3 * sizeof(float) + (size_t)ntab * sizeof(float) + (size_t)27 * C;
}

template <int EV, bool PV>
__global__ void cell_pair_typed_kernel(const Vec3 pos, const int* __restrict__ tag,
                                       const int* __restrict__ typ,
                                       const float* __restrict__ shifts,
                                       const float* __restrict__ par, const int np, const int T,
                                       const Geom g, float* __restrict__ frc,
                                       float* __restrict__ pe, float* __restrict__ vir) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    const int ntab = (2 + np) * T * T;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    float* tab = sz + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(tab + ntab);
    const int cell = blockIdx.x;
    stage_stencil_typed(pos, tag, typ, T, shifts, g, cell, sx, sy, sz, sv);
    stage_table(par, ntab, tab);
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= g.C) return;
    float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int ic = 13 * g.C + i;
    if (sv[ic]) {
        const TypedRow R = load_typed_row(tab, np, T, sv[ic] - 1);
        typed_stencil_sum<EV, PV>(sx[ic], sy[ic], sz[ic], ic, n, sx, sy, sz, sv, R, acc);
    }
    const long long slot = (long long)cell * g.C + i;
    for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
    if (PV) {
        pe[slot] = 0.5f * acc[3];
        for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
    }
}

template <int EV, bool PV>
static cudaError_t launch_typed(const float* pos, const int* tag, const int* typ,
                                const float* shifts, const float* par, const int np,
                                const int T, float* frc, float* pe, float* vir, const Geom g,
                                cudaStream_t st) {
    const size_t smem = typed_smem_bytes(g.C, (2 + np) * T * T);
    cudaError_t e = set_smem(cell_pair_typed_kernel<EV, PV>, smem);
    if (e != cudaSuccess) return e;
    cell_pair_typed_kernel<EV, PV><<<g.nx * g.ny * g.nz, threads_for(g.C), smem, st>>>(
        Vec3{const_cast<float*>(pos), 3, 1}, tag, typ, shifts, par, np, T, g, frc, pe, vir);
    return cudaGetLastError();
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// pos (nc, C, 3), tag and typ (nc, C), shifts (nc, 27, 3), par the
// (2 + np, ntypes, ntypes) table; frc (nc, C, 3), and with pv pe (nc, C)
// and vir (nc, C, 6) (unused, may be null, without).
int hoomd_cell_pair_planar_typed(const float* pos, const int* tag, const int* typ,
                                 const float* shifts, const float* par, int np, int ntypes,
                                 float* frc, float* pe, float* vir, int nx, int ny, int nz,
                                 int C, int ev, int pv, void* stream) {
    if (ntypes < 1 || ntypes > kMaxTypes || np < 0 || np > kMaxPnames)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    return dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return pv ? launch_typed<EV, true>(pos, tag, typ, shifts, par, np, ntypes, frc, pe,
                                           vir, g, st)
                  : launch_typed<EV, false>(pos, tag, typ, shifts, par, np, ntypes, frc, pe,
                                            vir, g, st);
    });
}

}  // extern "C"
