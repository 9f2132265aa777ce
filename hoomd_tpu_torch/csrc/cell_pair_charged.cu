// Hand-written Hopper kernel of the charged pair stencil (hoomd_tpu_torch/
// ops/cell_pair.py binds it through ctypes):
//
// hoomd_cell_pair_planar_q  replaces the charge channel of
//                           hoomd_tpu/ops/pallas_pair.py:_kernel_planar
//                           (needs_q, :692-697; the wrapper's cell_q specs
//                           at :882-895): forces, half-pair energy and
//                           virial of the evaluators that read q_i q_j,
//                           ewald (exact erfc) and lj_ewald (LJ plus
//                           real-space Ewald, erfc by A&S 7.1.26), for one
//                           particle type or a mixture of 2 to kMaxTypes.
//
// The JAX engine sends every charged force evaluation there, whatever its
// force path (fast_lj.py:372-391): a charged job (md.charge.pppm, or
// md.pair.ewald alone) runs every step as a one_step whose pair force is
// this kernel, beside the PPPM mesh, which is plain torch.
//
// It keeps the planar kernel's shape (cell_pair.cu cell_pair_kernel,
// cell_pair_typed.cu): one block per home cell, a thread per slot, the
// 27 C candidates staged in shared memory with their charge (27 C floats
// more, 4.3 KB at C = 40) and, for a mixture, their type in the validity
// byte, beside the (2 + np, T, T) table, whose row of its own type each
// thread keeps in registers (cell_stencil.cuh load_typed_row,
// typed_pair_acc).  The TPU kernel forms the (nx, C, 3C) tile
// qi * jq[:, None, :] per window; here the charge product is one multiply
// per candidate.  The r^2 cut rounds as torch's separate ops (pair_acc).
// No atomics: each pair is evaluated from both sides, so the sums are
// deterministic.
//
// What bounds it on this card: the fp32 issue rate of the pair loop.  At
// the PPPM charged fluid's plan (160 cells, C = 40, 4096 ions) a slot
// walks 1080 staged candidates; a pair inside r_cut costs an erfc (or the
// polynomial and an expf), an expf and a sqrtf beside the LJ terms.  Its
// work is small (7M candidates per call), so the launch and the 160
// blocks on 132 SMs set its time as much as the arithmetic; a simple
// correct kernel is this design, as for the other stencil kernels.  The C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace hoomd_torch {

// Shared memory of one block: the staged stencil (coordinates, charge,
// validity or type byte) and, for a mixture, the (2 + np, T, T) table.
static inline size_t charged_smem_bytes(const int C, const int ntab) {
    return (size_t)27 * C * 4 * sizeof(float) + (size_t)ntab * sizeof(float) + (size_t)27 * C;
}

template <int EV, bool TYPED, bool PV>
__global__ void cell_pair_q_kernel(const Vec3 pos, const int* __restrict__ tag,
                                   const int* __restrict__ typ, const float* __restrict__ q,
                                   const float* __restrict__ shifts,
                                   const float* __restrict__ par, const int np, const int T,
                                   const Geom g, float* __restrict__ frc,
                                   float* __restrict__ pe, float* __restrict__ vir) {
    extern __shared__ float smem[];
    const int n = 27 * g.C;
    const int ntab = TYPED ? (2 + np) * T * T : 0;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    float* sq = sz + n;
    float* tab = sq + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(tab + ntab);
    const int cell = blockIdx.x;
    if (TYPED) {
        stage_stencil_typed(pos, tag, typ, T, shifts, g, cell, sx, sy, sz, sv);
        stage_table(par, ntab, tab);
    } else {
        stage_stencil(pos, tag, shifts, g, cell, sx, sy, sz, sv);
    }
    stage_charges(q, g, cell, sq);
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= g.C) return;
    float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int ic = 13 * g.C + i;
    if (sv[ic]) {
        const float xi = sx[ic], yi = sy[ic], zi = sz[ic], qi = sq[ic];
        if (TYPED) {
            const TypedRow R = load_typed_row(tab, np, T, sv[ic] - 1);
            for (int t = 0; t < n; ++t) {
                const int b = sv[t];
                if (!b || t == ic) continue;
                typed_pair_acc<EV, PV>(xi - sx[t], yi - sy[t], zi - sz[t], R, b - 1, acc,
                                       qi * sq[t]);
            }
        } else {
            const PairPar P = load_pair_par(par, np);
            for (int t = 0; t < n; ++t) {
                if (!sv[t] || t == ic) continue;
                pair_acc<EV, false, PV>(xi - sx[t], yi - sy[t], zi - sz[t], P, acc,
                                        qi * sq[t]);
            }
        }
    }
    const long long slot = (long long)cell * g.C + i;
    for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
    if (PV) {
        pe[slot] = 0.5f * acc[3];
        for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
    }
}

template <int EV, bool TYPED, bool PV>
static cudaError_t launch_q(const float* pos, const int* tag, const int* typ, const float* q,
                            const float* shifts, const float* par, const int np, const int T,
                            float* frc, float* pe, float* vir, const Geom g, cudaStream_t st) {
    const size_t smem = charged_smem_bytes(g.C, TYPED ? (2 + np) * T * T : 0);
    cudaError_t e = set_smem(cell_pair_q_kernel<EV, TYPED, PV>, smem);
    if (e != cudaSuccess) return e;
    cell_pair_q_kernel<EV, TYPED, PV><<<g.nx * g.ny * g.nz, threads_for(g.C), smem, st>>>(
        Vec3{const_cast<float*>(pos), 3, 1}, tag, typ, q, shifts, par, np, T, g, frc, pe, vir);
    return cudaGetLastError();
}

template <int EV>
static cudaError_t launch_q_ev(const float* pos, const int* tag, const int* typ, const float* q,
                               const float* shifts, const float* par, const int np, const int T,
                               float* frc, float* pe, float* vir, const Geom g, const int pv,
                               cudaStream_t st) {
    if (T > 1)
        return pv ? launch_q<EV, true, true>(pos, tag, typ, q, shifts, par, np, T, frc, pe, vir,
                                             g, st)
                  : launch_q<EV, true, false>(pos, tag, typ, q, shifts, par, np, T, frc, pe,
                                              vir, g, st);
    return pv ? launch_q<EV, false, true>(pos, tag, typ, q, shifts, par, np, T, frc, pe, vir, g,
                                          st)
              : launch_q<EV, false, false>(pos, tag, typ, q, shifts, par, np, T, frc, pe, vir,
                                           g, st);
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// pos (nc, C, 3), tag (nc, C), typ (nc, C) for ntypes > 1 (else unused,
// may be null), q (nc, C) the slots' charges, shifts (nc, 27, 3); par the
// vector [rc2, e_shift, *pnames] for one type, the (2 + np, ntypes,
// ntypes) table for a mixture; frc (nc, C, 3), and with pv pe (nc, C) and
// vir (nc, C, 6) (unused, may be null, without).  ev: EV_EWALD or
// EV_LJ_EWALD.
int hoomd_cell_pair_planar_q(const float* pos, const int* tag, const int* typ, const float* q,
                             const float* shifts, const float* par, int np, int ntypes,
                             float* frc, float* pe, float* vir, int nx, int ny, int nz, int C,
                             int ev, int pv, void* stream) {
    if (ntypes < 1 || ntypes > kMaxTypes || np < 0 || np > kMaxPnames)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    switch (ev) {
        case EV_EWALD:
            return launch_q_ev<EV_EWALD>(pos, tag, typ, q, shifts, par, np, ntypes, frc, pe, vir,
                                         g, pv, st);
        case EV_LJ_EWALD:
            return launch_q_ev<EV_LJ_EWALD>(pos, tag, typ, q, shifts, par, np, ntypes, frc, pe,
                                            vir, g, pv, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
