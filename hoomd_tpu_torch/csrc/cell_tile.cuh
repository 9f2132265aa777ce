// Tiles of an x-row of cells, for the mixtures' planar kernel
// (cell_pair_typed.cu), the half stencil, the row-blocked LJ kernel
// (cell_pair_impls.cu) and the fused step (cell_step.cu, the last two
// through cell_walk.cuh); the compaction of live slots (compact_cells)
// also stages the charged kernel's and the other 27-cell LJ kernels'
// cells (rows 4 and 5), and the union of a run of cells for the
// megastep's candidate build.
//
// A block takes a tile: tx <= TX consecutive cells x0 .. x0 + tx - 1 of
// the x-row (iy, iz).  Its home particles are the live slots of those
// cells, packed in (cell, slot) order, so that warps hold live particles
// and not slots.  The neighbour cells of the tile are staged row by row
// of the stencil ((dz, dy), dx fastest): union cell ul = 0 .. tx + 1 of a
// row is the cell x0 - 1 + ul of that row, seen under the image shift of
// build_cell_shifts, and holds only its live slots, compacted in (row,
// ul, slot) order by ballots and a scan over the union cells.  A home of
// cell lc meets, in each row, union cells lc, lc + 1, lc + 2 (dx = -1, 0,
// +1): one contiguous run of the compacted rows, in the stencil's order.
//
// The shift of union cell ul is read from the table entry of a cell of
// the row that reaches it: the shifts of build_cell_shifts depend only on
// whether an index wrapped, so every cell of the row sees that neighbour
// under the same shift.
#pragma once

#include "cell_stencil.cuh"

namespace hoomd_torch {

struct Tile {
    int x0, tx, iy, iz, W;                      // W = tx + 2 union cells per row
};

__device__ __forceinline__ Tile tile_of_block(const Geom g, const int TX) {
    Tile t;
    t.x0 = blockIdx.x * TX;
    t.tx = min(TX, g.nx - t.x0);
    t.iy = blockIdx.y;
    t.iz = blockIdx.z;
    t.W = t.tx + 2;
    return t;
}

// i in [-n, 2n) wrapped to [0, n)
__device__ __forceinline__ int wrap(const int i, const int n) { return (i + n) % n; }

// Cell id of union cell ul of row (dz, dy), and its image shift in sh.
__device__ __forceinline__ long long union_cell(const Geom g, const Tile t, const int dz,
                                                const int dy, const int ul,
                                                const float* __restrict__ shifts,
                                                const float*& sh) {
    const int u = t.x0 - 1 + ul;                // in [-1, nx]
    const int hx = min(max(u, 0), g.nx - 1);    // a cell of the row that reaches u
    const int k = (dz + 1) * 9 + (dy + 1) * 3 + (u - hx) + 1;
    sh = shifts + (((long long)hx + g.nx * (t.iy + (long long)g.ny * t.iz)) * 27 + k) * 3;
    return wrap(u, g.nx) + g.nx * (wrap(t.iy + dy, g.ny) + (long long)g.ny * wrap(t.iz + dz, g.nz));
}

// A staged entry: coordinates (shift applied) and meta = type | row << 4 |
// ul << 8 | slot << 16.
__device__ __forceinline__ int meta_type(const float4 e) { return __float_as_int(e.w) & 15; }
__device__ __forceinline__ int meta_ul(const float4 e) { return (__float_as_int(e.w) >> 8) & 255; }
__device__ __forceinline__ int meta_slot(const float4 e) { return __float_as_int(e.w) >> 16; }

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// Exclusive prefix sum of the counts off[1 .. n] in place (off[0] = 0),
// by warp 0; the caller synchronises before and after.
__device__ inline void scan_counts(int* off, const int n) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int run = 0;
    for (int c0 = 0; c0 < n; c0 += 32) {
        const int c = c0 + lane;
        int v = c < n ? off[c + 1] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += y;
        }
        if (c < n) off[c + 1] = run + v;
        run += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) off[0] = 0;
}

// Stable compaction of the live slots of n cells (cell_of(c) its id; a
// negative id lists nothing): off[c] the first entry of cell c, off[n]
// the count, and put(c, s, index, slot) for each live slot s, in (cell,
// slot) order.  Block-wide, with the barriers it needs; off holds n + 1
// ints of shared memory.
template <typename CellOf, typename Put>
__device__ inline void compact_cells(const int n, const int C, const int* __restrict__ tag,
                                     CellOf cell_of, int* off, Put put) {
    constexpr int U = 4;                        // 32-slot chunks of a cell read at once
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int c = w; c < n; c += nw) {
        const long long id = cell_of(c), base = id * C;
        int cnt = 0;
        for (int s0 = 0; s0 < C; s0 += 32 * U) {
            bool live[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int s = s0 + 32 * u + lane;
                live[u] = id >= 0 && s < C && tag[base + s] >= 0;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) cnt += __popc(__ballot_sync(0xffffffffu, live[u]));
        }
        if (lane == 0) off[c + 1] = cnt;
    }
    __syncthreads();
    scan_counts(off, n);
    __syncthreads();
    for (int c = w; c < n; c += nw) {
        const long long id = cell_of(c), base = id * C;
        int run = off[c];
        for (int s0 = 0; s0 < C; s0 += 32 * U) {
            bool live[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int s = s0 + 32 * u + lane;
                live[u] = id >= 0 && s < C && tag[base + s] >= 0;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const unsigned b = __ballot_sync(0xffffffffu, live[u]);
                const int s = s0 + 32 * u + lane;
                if (live[u]) put(c, s, run + __popc(b & lanemask_lt()), base + s);
                run += __popc(b);
            }
        }
    }
    __syncthreads();
}

// Stage rows r0 .. r0 + nr - 1 of the tile's union, row r = (dz + 1) * 3 +
// dy + 1 of the stencil's (dz, dy), compacted in (row, ul, slot) order:
// off[q * W + ul] the first entry of union cell ul of row r0 + q, off[nr *
// W] the count; put(idx, c, s, slot, sh) writes entry idx from slot s (at
// `slot`) of union cell c = q * W + ul, seen under the image shift sh.
template <typename Put>
__device__ inline void stage_union(const int* __restrict__ tag, const float* __restrict__ shifts,
                                   const Geom g, const Tile t, const int r0, const int nr,
                                   int* off, Put put) {
    auto cell = [&](const int c, const float*& sh) {
        const int r = r0 + c / t.W;
        return union_cell(g, t, r / 3 - 1, r % 3 - 1, c % t.W, shifts, sh);
    };
    compact_cells(
        nr * t.W, g.C, tag,
        [&](const int c) {
            const float* sh;
            return cell(c, sh);
        },
        off,
        [&](const int c, const int s, const int idx, const long long slot) {
            const float* sh;
            cell(c, sh);
            put(idx, c, s, slot, sh);
        });
}

// Stage nr rows (dz, dy0 + q) of the tile's union (stage_union), each
// entry its coordinates and meta = type | q << 4 | ul << 8 | slot << 16.
// TYPED: the type clamped to [0, T).
template <bool TYPED>
__device__ inline void stage_rows(const float* __restrict__ pos, const int* __restrict__ tag,
                                  const int* __restrict__ typ, const int T,
                                  const float* __restrict__ shifts, const Geom g, const Tile t,
                                  const int dz, const int dy0, const int nr, float4* ent,
                                  int* off) {
    stage_union(tag, shifts, g, t, (dz + 1) * 3 + dy0 + 1, nr, off,
                [&](const int idx, const int c, const int s, const long long slot,
                    const float* sh) {
                    const int ty = TYPED ? min(max(typ[slot], 0), T - 1) : 0;
                    ent[idx] = make_float4(
                        pos[slot * 3 + 0] + sh[0], pos[slot * 3 + 1] + sh[1],
                        pos[slot * 3 + 2] + sh[2],
                        __int_as_float(ty | (c / t.W) << 4 | (c % t.W) << 8 | s << 16));
                });
}

// The tile's homes: hslot[p] the slot of home p, hstart[lc] the first home
// of cell lc (hstart[tx] the count).
__device__ inline void pack_homes(const int* __restrict__ tag, const Geom g, const Tile t,
                                  int* hslot, int* hstart) {
    auto cell_of = [&](const int c) {
        return (long long)(t.x0 + c) + g.nx * (t.iy + (long long)g.ny * t.iz);
    };
    auto put = [&](const int, const int, const int idx, const long long slot) {
        hslot[idx] = (int)slot;
    };
    compact_cells(t.tx, g.C, tag, cell_of, hstart, put);
}

// Cell (0 .. tx - 1) of home p.
__device__ __forceinline__ int home_cell(const int* hstart, const int tx, const int p) {
    int lc = 0;
    while (lc + 1 < tx && hstart[lc + 1] <= p) ++lc;
    return lc;
}

// Column tj of every parameter of the table: the parameters of the
// pairs (ti, tj) for ti = 0 .. T - 1, selected by ti in registers.
__device__ __forceinline__ TypedRow load_typed_col(const float* tab, const int np, const int T,
                                                   const int tj) {
    TypedRow R;
#pragma unroll
    for (int k = 0; k < kParRows; ++k)
#pragma unroll
        for (int c = 0; c < kMaxTypes; ++c)
            R.v[k][c] = (k < 2 + np && c < T) ? tab[(k * T + c) * T + tj] : 0.0f;
    return R;
}

// The pair parameters of column c of a TypedRow.
__device__ __forceinline__ PairPar typed_par(const TypedRow& R, const int c) {
    PairPar P;
    P.rc2 = pick(R.v[0], c);
    P.e_shift = pick(R.v[1], c);
#pragma unroll
    for (int k = 0; k < kMaxPnames; ++k) P.q[k] = pick(R.v[2 + k], c);
    return P;
}

// r^2 of (dx, dy, dz), rounded as pair_acc rounds it.
__device__ __forceinline__ float r2_rn(const float dx, const float dy, const float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// What the build gave a kernel and how many of its blocks an SM holds at
// smem bytes of dynamic shared memory: out = [registers per thread, local
// (spill) bytes per thread, static shared bytes, dynamic shared bytes,
// blocks per SM].
template <typename K>
static inline cudaError_t kernel_occupancy(K kernel, const int threads, const size_t smem,
                                           int* out) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, threads, smem);
}

}  // namespace hoomd_torch
