// A warp per home over compacted staged cells: the walk of the 27-cell
// kernels of rows 2 and 3 of PERF.md's table (the plane and planar
// kernels, csrc/cell_pair.cu), rows 4, 5 and 6 (csrc/cell_pair_impls.cu)
// and the fused step (row 8, csrc/cell_step.cu).
//
// A block stages the cells its homes meet once, each entry its live slot's
// coordinates with the image shift applied, compacted by compact_cells
// (cell_tile.cuh; stage_union for a tile's union), and each staged cell's
// bounding box.  The homes' 27
// stencil cells are staged cells (k / 3) * W + c0 + k % 3, k = 0 .. 26 in
// build_cell_shifts' order ((dz, dy, dx), dx fastest): W = 3, c0 = 0 where
// a block stages the 27 cells of one cell (rows 4 and 5); W = tx + 2,
// c0 = lc where it stages the union of a tile of tx cells of an x-row, 9
// (dz, dy) rows of tx + 2 cells, and the home lies in tile cell lc (rows 2,
// 3, 6 and 8).  Either way a stencil row (dz, dy) is one contiguous span of
// staged entries.
//
// A warp takes a home at a time (walk_home).  It skips the staged cells
// whose box lies outside its cut (r^2 of the home to the box, rounded as a
// pair's, not below rc2: every pair of the cell is then outside, since
// rounding is monotone), and walks each stencil row's span from its first
// to its last kept cell.  The lanes stride over the entries branch-free,
// test r^2 < rc2 with r^2 rounded as the plain version's torch ops, append
// the pairs inside the cut to the warp's list by a ballot, and evaluate
// them 32 at a time, a pair per lane, with the warp converged.  So an
// evaluator pays its transcendentals only for pairs inside the cut, and no
// float atomic is taken: equal inputs give equal bits.  The self pair is
// excluded by index.  The list holds the pairs in the staged order, which
// is the stencil's order: rows (dz, dy), cells dx = -1, 0, +1, live slots
// in slot order; a skipped cell has no pair inside the cut.
//
// Two ways to sum a home's pairs.  Unordered (rows 4, 5, 6, 8): each lane
// adds its pairs to its own sums (pair_acc) and a fixed shuffle tree adds
// the lanes.  Ordered (rows 2 and 3): the lanes write each evaluated pair's
// terms into the warp's list, and lane a then folds sum a over the batch,
// oldest pair first, with the operations cell_stencil.cuh's pair_acc
// compiles to (fold_ops), each rounded on its own.  So a home's sums are
// those of a serial walk of all 27 C staged slots, bit for bit: the first
// design of rows 2 and 3 (a block per cell, a thread per slot), whose bits
// the bench job's trajectory holds.
#pragma once

#include "cell_tile.cuh"

namespace hoomd_torch {

constexpr int kWalkWarps = 8;            // homes at a time per block (4: 3% slower)
constexpr int kWalkList = 64;            // entries of a warp's list of pairs inside the cut
// home slots of a tile at most (TX C): it bounds the union's staged
// slots, 9 (TX + 2) C, so that a block fits the card's 232 448 B of shared
// memory up to MAX_C = 512 (one cell per tile there)
constexpr int kUnionSlots = 512;

// A block's shared memory, for tiles of TX cells (TX = 1: the 27 cells of
// one cell): the staged entries, the warps' lists, the staged cells'
// boxes ([cell][lo xyz, hi xyz]), the offsets of the staged cells, the
// homes' slots and the first home of each tile cell.
struct WalkSmem {
    float4* ent;
    float4* lst;
    float* box;
    int* off;
    int* hslot;
    int* hstart;
};

__host__ __device__ inline size_t walk_smem_bytes(const int TX, const int C) {
    const int nu = 9 * (TX + 2);                // staged cells
    return (size_t)nu * C * sizeof(float4) + (size_t)kWalkWarps * kWalkList * sizeof(float4) +
           (size_t)nu * 6 * sizeof(float) + (size_t)(nu + 1 + TX * C + TX + 1) * sizeof(int);
}

__device__ inline WalkSmem walk_smem(float4* base, const int TX, const int C) {
    const int nu = 9 * (TX + 2);
    WalkSmem S;
    S.ent = base;
    S.lst = S.ent + nu * C;
    S.box = reinterpret_cast<float*>(S.lst + kWalkWarps * kWalkList);
    S.off = reinterpret_cast<int*>(S.box + nu * 6);
    S.hslot = S.off + nu + 1;
    S.hstart = S.hslot + TX * C;
    return S;
}

// Cells per tile at most TX (and kUnionSlots / C): the x-row in equal
// tiles.  ops/cell_pair.py row_tile is the same rule.
static inline int union_tile(const int nx, const int C, const int TX) {
    const int fit = kUnionSlots / C;
    const int most = fit < 1 ? 1 : TX < fit ? TX : fit;
    const int tiles = (nx + most - 1) / most;
    return (nx + tiles - 1) / tiles;
}

// The box of each of the n staged cells (an empty one lies at infinity),
// a warp per cell; the caller synchronises after.
__device__ inline void stage_boxes(const int n, const float4* ent, const int* off, float* box) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int k = w; k < n; k += nw) {
        float b[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                      -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
        for (int j = off[k] + lane; j < off[k + 1]; j += 32) {
            const float4 e = ent[j];
            b[0] = fminf(b[0], e.x), b[1] = fminf(b[1], e.y), b[2] = fminf(b[2], e.z);
            b[3] = fmaxf(b[3], e.x), b[4] = fmaxf(b[4], e.y), b[5] = fmaxf(b[5], e.z);
        }
        for (int o = 16; o > 0; o >>= 1)
            for (int a = 0; a < 3; ++a) {
                b[a] = fminf(b[a], __shfl_xor_sync(0xffffffffu, b[a], o));
                b[3 + a] = fmaxf(b[3 + a], __shfl_xor_sync(0xffffffffu, b[3 + a], o));
            }
        if (lane < 6) box[k * 6 + lane] = b[lane];
    }
}

// Row k of the ordered fold's batch (8 floats of the warp's list):
// [dx, dy, dz, force_divr, 1, e - e_shift (-0 where r^2 <= 1e-6), 0, 0].
constexpr int kRowF = 3, kRowOne = 4, kRowE = 5;

// Lane a's operands in a batch row: its sum a takes acc = fma(row[oa] *
// row[ob], row[oc], acc), every operation rounded on its own.  This is
// what the first design's pair_acc compiled to (nvcc -O3, sm_90a; read in
// cuobjdump -sass of its cell_pair.cu): the force acc[a] += f d_a (PV:
// acc[a] = acc[a] + f d_a, the product rounded, since f d_a is reused by
// the virial; else one fma), the energy acc[3] += e - e_shift, the virial
// acc[4 + c] += (f d_u) d_v as one fma of the rounded f d_u.  Adding -0 is
// exact, so a pair whose energy the first design skipped adds nothing.
template <bool PV>
__device__ __forceinline__ void fold_ops(const int a, int& oa, int& ob, int& oc) {
    oa = kRowF, ob = kRowOne, oc = kRowOne;
    if (a < 3) {
        if (PV)
            ob = a;
        else
            oc = a;
    } else if (a == 3) {
        oa = kRowE;
    } else if (a < 10) {                        // xx, xy, xz, yy, yz, zz
        const int c = a - 4;
        ob = c < 3 ? 0 : c < 5 ? 1 : 2;
        oc = c < 3 ? c : c < 5 ? c - 2 : 2;
    }
}

// One home at (xi, yi, zi), by the whole warp: its sums over the staged
// entries of its 27 stencil cells (W, c0 as above), skipping entry `self`
// (-1: none), as pair_acc's acc (3 forces; with PV also the full-pair
// energy and the virial, for the caller to halve).  Unordered: acc holds
// the NA sums, valid in lane 0.  ORDERED: lane a < NA holds sum a in
// acc[0].  L is the warp's list of kWalkList entries.
template <int EV, bool APPROX, bool PV, bool ORDERED = false>
__device__ __forceinline__ void walk_home(const float xi, const float yi, const float zi,
                                          const int self, const float4* ent, const float* box,
                                          const int* off, const int W, const int c0,
                                          const PairPar& P, float4* L, float* acc) {
    constexpr int NA = PV ? 10 : 3;
    constexpr int NS = ORDERED ? 1 : NA;        // the sums a lane keeps
    const int lane = threadIdx.x & 31;
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int a = 0; a < NS; ++a) acc[a] = 0.0f;
    int oa = 0, ob = 0, oc = 0;
    if (ORDERED) fold_ops<PV>(lane, oa, ob, oc);
    int nl = 0;                                 // pairs in the warp's list (warp-uniform)
    // the first cnt entries of the list, a pair per lane, converged
    auto evaluate = [&](const int cnt) {
        __syncwarp();
        if constexpr (ORDERED) {
            // each pair's terms into its row (rows k take entries 2k, 2k + 1:
            // every lane reads its entry first), then lane a folds sum a
            float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
            float f = 0.0f, et = 0.0f;
            if (lane < cnt) {
                d = L[lane];
                float e;
                eval_pair<EV, APPROX && EV == EV_LJ>(fmaxf(d.w, 1e-3f), P.q, f, e);
                // formed beside the evaluator, as pair_acc forms it, so
                // that the compiler contracts it with e's last product
                // where it did there (one fma for lj and moliere)
                et = e - P.e_shift;
            }
            __syncwarp();
            if (lane < cnt) {
                L[2 * lane] = make_float4(d.x, d.y, d.z, f);
                L[2 * lane + 1] = make_float4(1.0f, PV && d.w > 1e-6f ? et : -0.0f, 0.f, 0.f);
            }
            __syncwarp();
            if (lane < NA) {
                const float* R = reinterpret_cast<const float*>(L);
#pragma unroll 4
                for (int k = 0; k < cnt; ++k, R += 8)
                    acc[0] = __fmaf_rn(__fmul_rn(R[oa], R[ob]), R[oc], acc[0]);
            }
        } else if (lane < cnt) {
            const float4 d = L[lane];
            pair_acc<EV, APPROX, PV>(d.x, d.y, d.z, P, acc);
        }
        __syncwarp();
    };
    // the stencil cells the home walks: those whose box lies inside its cut
    bool near = lane < 27;
    if (near) {
        const float* b = box + ((lane / 3) * W + c0 + lane % 3) * 6;
        const float dx = fmaxf(fmaxf(__fsub_rn(b[0], xi), __fsub_rn(xi, b[3])), 0.0f);
        const float dy = fmaxf(fmaxf(__fsub_rn(b[1], yi), __fsub_rn(yi, b[4])), 0.0f);
        const float dz = fmaxf(fmaxf(__fsub_rn(b[2], zi), __fsub_rn(zi, b[5])), 0.0f);
        near = r2_rn(dx, dy, dz) < P.rc2;
    }
    const unsigned keep = __ballot_sync(0xffffffffu, near);
    // the span of each stencil row, from its first to its last kept cell (a
    // skipped cell between them is walked, and none of its pairs is inside
    // the cut), found by lane r
    int rb = 0, re = 0;
    if (lane < 9) {
        const unsigned m = (keep >> (3 * lane)) & 7u;
        if (m) {
            rb = off[lane * W + c0 + __ffs(m) - 1];
            re = off[lane * W + c0 + 32 - __clz(m)];
        }
    }
    for (int r = 0; r < 9; ++r) {
        const int beg = __shfl_sync(0xffffffffu, rb, r);
        const int end = __shfl_sync(0xffffffffu, re, r);
        // branch-free: every lane loads and tests an entry of the span
        for (int j0 = beg; j0 < end; j0 += 32) {
            const int j = j0 + lane;
            const float4 e = ent[min(j, end - 1)];
            const float dx = xi - e.x, dy = yi - e.y, dz = zi - e.z;
            const float r2 = r2_rn(dx, dy, dz);
            const bool in = (j < end) & (j != self) & (r2 < P.rc2);
            const unsigned b = __ballot_sync(0xffffffffu, in);
            // the ordered fold reads r^2 from the entry
            if (in) L[nl + __popc(b & lt)] = make_float4(dx, dy, dz, ORDERED ? r2 : 0.0f);
            nl += __popc(b);
            if (nl >= 32) {
                if constexpr (ORDERED) {
                    // the batch's rows take the whole list: the entries
                    // past it wait in registers
                    __syncwarp();
                    float4 held = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (lane < nl - 32) held = L[32 + lane];
                    evaluate(32);
                    if (lane < nl - 32) L[lane] = held;
                } else {
                    evaluate(32);
                    if (lane < nl - 32) L[lane] = L[32 + lane];
                }
                nl -= 32;
            }
        }
    }
    evaluate(nl);
    if constexpr (!ORDERED) {
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] = warp_sum(acc[a]);
    }
}

}  // namespace hoomd_torch
