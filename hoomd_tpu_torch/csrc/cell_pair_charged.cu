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
// What bounds it on this card: a charged system is small and sparse.  At
// the PPPM charged fluid's plan (160 cells of C = 40 holding ~26 ions
// each, 4096 ions) a home has ~690 live candidates in its 27 cells and
// ~16 inside r_cut; the Madelung job has 8 cells of 64 ions.  A block per
// cell and a thread per slot (the first design) left less than a warp per
// SM walking 27 C slots serially, so the kernel waited on latency, not on
// arithmetic or bytes.  This design spreads each home's candidates over
// the lanes of a warp:
//   * the grid covers (cell, group of W homes), a warp per home, W halved
//     from 8 until the live groups cover the SMs (config 4: 640 live
//     blocks of 8 warps; the Madelung plan: 128 of 4);
//   * a block stages the home cell's stencil, all 27 cells at once where
//     they fit in kQStageAll bytes of shared memory (C up to ~170), else
//     one dz plane at a time, in stencil order, compacted to the live
//     slots by ballots and a scan (cell_tile.cuh compact_cells), each
//     entry a float4 of coordinates with the image shift of
//     build_cell_shifts applied and the type, and its charge beside it;
//   * the lanes stride over the staged live entries, test each pair
//     against its own cut rc2[ti, tj] with r^2 rounded as the plain
//     version's torch ops (r2_rn), and append the pairs inside to the
//     warp's list in shared memory (dr and q_i q_j, and the type) by a
//     ballot; each time it holds 32 the warp evaluates them, a pair per
//     lane, converged, and at the end the rest;
//   * each lane keeps its partial F, PE and virial in registers, and a
//     fixed shuffle tree sums the lanes (cell_stencil.cuh warp_sum).
// The list, the lanes' shares and the tree are fixed by the data, so two
// calls on the same input give the same bits; the sum order differs from
// the plain version's (rtol = atol = 1e-4 on the card).  No atomics: each
// pair is evaluated from both sides.  The evaluators are cell_stencil.cuh
// pair_acc / typed_pair_acc (the table's row of the home's type in
// registers, a candidate's column picked by its type).  The C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace hoomd_torch {

constexpr int kQMaxWarps = 8;            // homes (warps) of a block, at most
constexpr int kQList = 64;               // entries of a warp's list of pairs inside the cut
constexpr size_t kQStageAll = 100 * 1024;  // shared bytes up to which a block stages all 27 cells

// Shared memory of one block of W warps staging SP dz planes at a time:
// the staged cells (9 SP C entries and their charges), the warps' lists,
// the offsets, the homes' slots and their count, and the table.
static inline size_t charged_smem_bytes(const int C, const int W, const int ntab, const int SP) {
    return (size_t)9 * SP * C * (sizeof(float4) + sizeof(float)) +
           (size_t)W * kQList * (sizeof(float4) + sizeof(int)) +
           (size_t)(9 * SP + 1 + C + 2) * sizeof(int) + (size_t)ntab * sizeof(float);
}

template <int EV, bool TYPED, bool PV>
__global__ void __launch_bounds__(kQMaxWarps * 32)
    cell_pair_q_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                       const int* __restrict__ typ, const float* __restrict__ q,
                       const float* __restrict__ shifts, const float* __restrict__ par,
                       const int np, const int T, const Geom g, const int SP,
                       float* __restrict__ frc, float* __restrict__ pe,
                       float* __restrict__ vir) {
    constexpr int NA = PV ? 10 : 3;
    extern __shared__ float4 smem4[];
    const int C = g.C, W = blockDim.x >> 5;
    const int ntab = TYPED ? (2 + np) * T * T : 0;
    float4* ent = smem4;
    float4* lst = ent + 9 * SP * C;
    float* sq = reinterpret_cast<float*>(lst + W * kQList);
    int* lty = reinterpret_cast<int*>(sq + 9 * SP * C);
    int* off = lty + W * kQList;
    int* hslot = off + 9 * SP + 1;
    int* hcnt = hslot + C;
    float* tab = reinterpret_cast<float*>(hcnt + 2);
    const int cell = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int ix = cell % g.nx, iy = (cell / g.nx) % g.ny, iz = cell / (g.nx * g.ny);
    if (blockIdx.y == 0) {                      // the padding slots' outputs
        for (int s = threadIdx.x; s < C; s += blockDim.x) {
            const long long slot = (long long)cell * C + s;
            if (tag[slot] >= 0) continue;
            for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = 0.0f;
            if (PV) {
                pe[slot] = 0.0f;
                for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.0f;
            }
        }
    }
    // the table, published by the barriers of the homes' compaction
    if (TYPED) stage_table(par, ntab, tab);
    // the homes: the cell's live slots, in slot order
    compact_cells(
        1, C, tag, [&](const int) { return (long long)cell; }, hcnt,
        [&](const int, const int s, const int idx, const long long) { hslot[idx] = s; });
    const int nh = hcnt[1];
    if ((int)blockIdx.y * W >= nh) return;      // the whole block: no live home
    const int p = blockIdx.y * W + w;
    const bool live = p < nh;                   // warp-uniform
    const long long slot = (long long)cell * C + (live ? hslot[p] : 0);
    const float xi = pos[slot * 3 + 0], yi = pos[slot * 3 + 1], zi = pos[slot * 3 + 2];
    const float qi = q[slot];
    float4* L = lst + w * kQList;
    int* LT = lty + w * kQList;
    float acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
    int nl = 0;                                 // pairs in the warp's list (warp-uniform)
    TypedRow R;
    PairPar P;
    if (TYPED)
        R = load_typed_row(tab, np, T, min(max(typ[slot], 0), T - 1));
    else
        P = load_pair_par(par, np);
    // the first cnt entries of the list, a pair per lane, converged
    auto evaluate = [&](const int cnt) {
        __syncwarp();
        if (lane < cnt) {
            const float4 d = L[lane];
            if (TYPED)
                typed_pair_acc<EV, PV>(d.x, d.y, d.z, R, LT[lane], acc, d.w);
            else
                pair_acc<EV, false, PV>(d.x, d.y, d.z, P, acc, d.w);
        }
        __syncwarp();
    };
    for (int dz0 = -1; dz0 <= 1; dz0 += SP) {
        // the 9 SP cells of planes dz0 .. dz0 + SP - 1 in stencil order
        // ((dz, dy, dx), dx fastest): entries k = (dz0 + 1) 9 + c, each
        // under its shift of build_cell_shifts
        auto cell_of = [&](const int c) {
            const int e = c % 9;
            const int jx = (ix + e % 3 - 1 + g.nx) % g.nx;
            const int jy = (iy + e / 3 - 1 + g.ny) % g.ny;
            const int jz = (iz + dz0 + c / 9 + g.nz) % g.nz;
            return (long long)jx + g.nx * (jy + (long long)g.ny * jz);
        };
        auto put = [&](const int c, const int, const int idx, const long long sl) {
            const float* sh = shifts + ((long long)cell * 27 + (dz0 + 1) * 9 + c) * 3;
            const int ty = TYPED ? min(max(typ[sl], 0), T - 1) : 0;
            ent[idx] = make_float4(pos[sl * 3 + 0] + sh[0], pos[sl * 3 + 1] + sh[1],
                                   pos[sl * 3 + 2] + sh[2], __int_as_float(ty));
            sq[idx] = q[sl];
        };
        compact_cells(9 * SP, C, tag, cell_of, off, put);
        if (live) {
            const int n = off[9 * SP];
            // the home's own entry: the centre cell (0, 0, 0) is cell
            // -9 dz0 + 4 of the stage when the stage holds plane 0
            const int self = dz0 <= 0 && 0 < dz0 + SP ? off[4 - 9 * dz0] + p : -1;
            for (int j0 = 0; j0 < n; j0 += 32) {
                const int j = j0 + lane;
                bool in = false;
                float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
                int tj = 0;
                if (j < n && j != self) {
                    const float4 e = ent[j];
                    d.x = xi - e.x;
                    d.y = yi - e.y;
                    d.z = zi - e.z;
                    tj = __float_as_int(e.w);
                    in = r2_rn(d.x, d.y, d.z) < (TYPED ? pick(R.v[0], tj) : P.rc2);
                    d.w = qi * sq[j];
                }
                const unsigned b = __ballot_sync(0xffffffffu, in);
                if (in) {
                    const int k = nl + __popc(b & lanemask_lt());
                    L[k] = d;
                    if (TYPED) LT[k] = tj;
                }
                nl += __popc(b);
                if (nl >= 32) {
                    evaluate(32);
                    if (lane < nl - 32) {
                        L[lane] = L[32 + lane];
                        if (TYPED) LT[lane] = LT[32 + lane];
                    }
                    nl -= 32;
                }
            }
        }
        __syncthreads();                        // before the next stage
    }
    if (!live) return;
    evaluate(nl);
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = warp_sum(acc[a]);
    if (lane == 0) {
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
        if (PV) {
            pe[slot] = 0.5f * acc[3];
            for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
        }
    }
}

// Warps (homes) per block: 8, halved while fewer blocks than SMs would
// hold a home (C homes at most per cell); and the dz planes a block
// stages at once: all 3 where they fit in kQStageAll bytes, else 1.
static inline cudaError_t charged_plan(const int nc, const int C, const int ntab, int* W,
                                       int* SP) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return e;
    *W = kQMaxWarps;
    while (*W > 1 && (long long)nc * ((C + *W - 1) / *W) < sms) *W >>= 1;
    *SP = charged_smem_bytes(C, *W, ntab, 3) <= kQStageAll ? 3 : 1;
    return cudaSuccess;
}

template <int EV, bool TYPED, bool PV>
static cudaError_t launch_q(const float* pos, const int* tag, const int* typ, const float* q,
                            const float* shifts, const float* par, const int np, const int T,
                            float* frc, float* pe, float* vir, const Geom g, cudaStream_t st) {
    const int nc = g.nx * g.ny * g.nz, ntab = TYPED ? (2 + np) * T * T : 0;
    int W = 0, SP = 0;
    cudaError_t e = charged_plan(nc, g.C, ntab, &W, &SP);
    if (e != cudaSuccess) return e;
    const size_t smem = charged_smem_bytes(g.C, W, ntab, SP);
    e = set_smem(cell_pair_q_kernel<EV, TYPED, PV>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(nc, (g.C + W - 1) / W);
    cell_pair_q_kernel<EV, TYPED, PV><<<grid, 32 * W, smem, st>>>(pos, tag, typ, q, shifts, par,
                                                                  np, T, g, SP, frc, pe, vir);
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

template <int EV>
static cudaError_t occupancy_q(const int pv, const int typed, const int C, const int W,
                               const int SP, const int ntab, int* out) {
    const int threads = 32 * W;
    const size_t smem = charged_smem_bytes(C, W, ntab, SP);
    if (typed)
        return pv ? kernel_occupancy(cell_pair_q_kernel<EV, true, true>, threads, smem, out)
                  : kernel_occupancy(cell_pair_q_kernel<EV, true, false>, threads, smem, out);
    return pv ? kernel_occupancy(cell_pair_q_kernel<EV, false, true>, threads, smem, out)
              : kernel_occupancy(cell_pair_q_kernel<EV, false, false>, threads, smem, out);
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

// The build and occupancy of the kernel of evaluator ev for nc cells of
// capacity C, one type or a mixture (typed) with a table of ntab floats:
// out[0..4] as kernel_occupancy gives them, out[5] the warps per block and
// out[6] the dz planes staged at once that it launches with.
int hoomd_planar_q_occupancy(int ev, int pv, int typed, int nc, int C, int ntab, int* out) {
    cudaError_t e = charged_plan(nc, C, ntab, &out[5], &out[6]);
    if (e != cudaSuccess) return e;
    switch (ev) {
        case EV_EWALD: return occupancy_q<EV_EWALD>(pv, typed, C, out[5], out[6], ntab, out);
        case EV_LJ_EWALD:
            return occupancy_q<EV_LJ_EWALD>(pv, typed, C, out[5], out[6], ntab, out);
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
