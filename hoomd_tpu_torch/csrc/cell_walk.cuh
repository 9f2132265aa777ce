// A warp per home over compacted staged cells: the walk of the 27-cell LJ
// kernels (rows 4, 5 and 6 of PERF.md's table, csrc/cell_pair_impls.cu)
// and of the fused step (row 8, csrc/cell_step.cu).
//
// A block stages the cells its homes meet once, each entry its live slot's
// coordinates with the image shift applied, compacted by compact_cells
// (cell_tile.cuh; stage_union for a tile's union), and each staged cell's
// bounding box.  The homes' 27
// stencil cells are staged cells (k / 3) * W + c0 + k % 3, k = 0 .. 26 in
// build_cell_shifts' order ((dz, dy, dx), dx fastest): W = 3, c0 = 0 where
// a block stages the 27 cells of one cell (rows 4 and 5); W = tx + 2,
// c0 = lc where it stages the union of a tile of tx cells of an x-row, 9
// (dz, dy) rows of tx + 2 cells, and the home lies in tile cell lc (rows 6
// and 8).  Either way a stencil row (dz, dy) is one contiguous span of
// staged entries.
//
// A warp takes a home at a time (walk_home).  It skips the staged cells
// whose box lies outside its cut (r^2 of the home to the box, rounded as a
// pair's, not below rc2: every pair of the cell is then outside, since
// rounding is monotone), and walks each stencil row's span from its first
// to its last kept cell.  The lanes stride over the entries branch-free,
// test r^2 < rc2 with r^2 rounded as the plain version's torch ops, append
// the pairs inside the cut to the warp's list by a ballot, and evaluate
// them 32 at a time, a pair per lane, with the warp converged; a fixed
// shuffle tree sums the lanes.  So an evaluator pays its transcendentals
// only for pairs inside the cut, and no float atomic is taken: equal
// inputs give equal bits.  The self pair is excluded by index.
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

// One home at (xi, yi, zi), by the whole warp: its sums over the staged
// entries of its 27 stencil cells (W, c0 as above), skipping entry `self`
// (-1: none), as pair_acc's acc (3 forces; with PV also the full-pair
// energy and the virial, for the caller to halve), valid in lane 0.  L is
// the warp's list of kWalkList entries.
template <int EV, bool APPROX, bool PV>
__device__ __forceinline__ void walk_home(const float xi, const float yi, const float zi,
                                          const int self, const float4* ent, const float* box,
                                          const int* off, const int W, const int c0,
                                          const PairPar& P, float4* L, float* acc) {
    constexpr int NA = PV ? 10 : 3;
    const int lane = threadIdx.x & 31;
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
    int nl = 0;                                 // pairs in the warp's list (warp-uniform)
    // the first cnt entries of the list, a pair per lane, converged
    auto evaluate = [&](const int cnt) {
        __syncwarp();
        if (lane < cnt) {
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
            const float4 d = make_float4(xi - e.x, yi - e.y, zi - e.z, 0.0f);
            const bool in = (j < end) & (j != self) & (r2_rn(d.x, d.y, d.z) < P.rc2);
            const unsigned b = __ballot_sync(0xffffffffu, in);
            if (in) L[nl + __popc(b & lt)] = d;
            nl += __popc(b);
            if (nl >= 32) {
                evaluate(32);
                if (lane < nl - 32) L[lane] = L[32 + lane];
                nl -= 32;
            }
        }
    }
    evaluate(nl);
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = warp_sum(acc[a]);
}

}  // namespace hoomd_torch
