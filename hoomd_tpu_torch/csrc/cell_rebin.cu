// Hand-written Hopper kernels of the plane-local cell rebin
// (hoomd_tpu_torch/ops/cell_rebin.py binds them through ctypes).
//
// hoomd_rebin_select  replaces hoomd_tpu/ops/pallas_rebin.py:_kernel_rebin_select
//                     (z, x, then y: each cell selects its occupants from the
//                     3C-slot window of itself and its two axis neighbours).
// hoomd_rebin_sweep   replaces pallas_rebin.py:_kernel_rebin_sweep (x pass, y
//                     pass, z-emigrant collection into emz).
// hoomd_rebin_place   replaces pallas_rebin.py:_kernel_rebin_place (place the z
//                     immigrants of every plane).
// hoomd_rebin_serial  replaces pallas_rebin.py:_kernel_rebin (sweep and place
//                     as one program).
//
// State: 14 float32 columns (pos xyz, vel xyz, force xyz, image xyz, tag,
// mass) of (nz, ny, nx, C) slots each; the int columns ride by value.
// Emigrant buffers: (2, nz, ny, nx, 14*E), direction 0 = left through the +
// face, 1 = through the - face, column c in [c*E, (c+1)*E), unused entries
// zero with tag -1.
//
// Every kernel gives its plain torch version's bits, slot for slot and flag
// for flag: emigrants in slot order (at most E per face), immigrants
// ordered [the index-1 neighbour's + emigrants, the index+1 neighbour's -
// emigrants], immigrant rank r in the free slot of rank r.  Ranks come
// from __ballot_sync / __popc; no atomics touch ranks or slots and no state
// outlives a call.  Migration decisions compare pos - (i*w - L/2) with 0 and
// w, and the seam shifts are pos -+ L, image +- 1, each operation rounded on
// its own (__fmul_rn and friends, which the compiler never contracts into
// fused multiply-adds), as the torch and JAX versions' separate operations.
//
// What bounds them on this card: each moves the state's bytes once or a few
// times (5.3 MB per copy at the 64k bench plan, 2352 cells x C = 40) and does
// a handful of compares per slot, so memory bounds all four, at ~3.8
// microseconds for a read and a write of the state.  What holds them back is
// the dependence between passes: the y pass reads what the x pass placed,
// z reads both.  The TPU kernels hold whole (ny, nx, C) planes in VMEM and
// walk the z planes in order; a plane of 14 columns (~0.4 MB at the bench
// plan) does not fit a block's 227 KB of shared memory, but a cell's
// result after the y pass depends only on its 3 x 3 neighbourhood in its
// own plane.
//
// sweep (one launch): a block owns a tile of TX x TY cells of one z plane
//   (ops/cell_rebin.py SWEEP_TILE) and stages the tile with a ring of one
//   cell as
//   16-byte decision records (x, y, z, tag).  In shared memory, a warp per
//   cell runs the x pass on the tile's columns of every staged row, the y
//   pass on the tile, and the z compaction, moving 4-byte handles (source
//   slot and seam shifts), not payloads; ranks by warp ballots over chunks
//   of 32 slots.  Each owned slot's 14 columns, and each z emigrant's, are
//   then gathered from cols once, with the seam shifts of its handle.
// place (one launch): a block copies a run of cells (PLACE_CELLS, a warp
//   each) swept -> out with 16-byte accesses where the columns allow; after
//   a barrier each warp ranks its cell's free slots and the 2E immigrants of
//   its two neighbour planes by ballots and writes immigrant r, z-seam
//   shifted, into free slot r.
// select (3 launches, z, x, y window selects through two scratch copies) and
//   serial (1 cooperative launch of persistent blocks, grid.sync() between
//   its four phases) keep the first design: a block per cell, a thread per
//   slot, window candidate or immigrant, ranks by a block-wide count.
// Every C entry point returns cudaGetLastError() (or the error of the
// call that failed before its launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hoomd_rebin {

namespace cg = cooperative_groups;

constexpr int kNcol = 14;
constexpr int kPX = 0, kIX = 9, kTG = 12, kMS = 13;
constexpr float kPad = 1.0e9f;
constexpr int kMaxThreads = 1024;

struct Geom {
    int n[3];        // nx, ny, nz
    int C, E, ncell;
    long long S;     // column stride: ncell * C
    float L[3], w[3];
};

__device__ __forceinline__ float fill_of(int c) {
    return c <= kPX + 2 ? kPad : (c == kTG ? -1.f : (c == kMS ? 1.f : 0.f));
}

__device__ __forceinline__ void coords(const Geom& g, int cell, int* i3) {
    i3[0] = cell % g.n[0];
    i3[1] = (cell / g.n[0]) % g.n[1];
    i3[2] = cell / (g.n[0] * g.n[1]);
}

// the periodic neighbour at offset d (-1 or +1) along axis
__device__ __forceinline__ int neighbour(const Geom& g, const int* i3, int axis, int d) {
    int j[3] = {i3[0], i3[1], i3[2]};
    j[axis] = (j[axis] + d + g.n[axis]) % g.n[axis];
    return j[0] + g.n[0] * (j[1] + g.n[1] * j[2]);
}

// lower face of cell index i along axis: i*w - 0.5*L
__device__ __forceinline__ float origin(const Geom& g, int axis, int i) {
    return __fsub_rn(__fmul_rn((float)i, g.w[axis]), __fmul_rn(0.5f, g.L[axis]));
}

// value of column c after a seam crossing: seam -1 arrived at index 0 from
// n-1 (pos - L, image + 1), +1 arrived at n-1 from 0 (pos + L, image - 1)
__device__ __forceinline__ float seam_shift(const Geom& g, int axis, int c, int seam,
                                            float v) {
    if (seam == 0) return v;
    if (c == kPX + axis) return seam < 0 ? __fsub_rn(v, g.L[axis]) : __fadd_rn(v, g.L[axis]);
    if (c == kIX + axis) return seam < 0 ? __fadd_rn(v, 1.f) : __fsub_rn(v, 1.f);
    return v;
}

// Exclusive rank of this thread's flag among the block's threads in thread
// order, and the block's count in *total.  Every thread of the block calls.
__device__ int block_rank(bool flag, int* warp, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    __syncthreads();                      // earlier readers of warp[] are done
    if (lane == 0) warp[wid] = __popc(b);
    __syncthreads();
    int before = 0, all = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
        const int v = warp[k];
        before += k < wid ? v : 0;
        all += v;
    }
    *total = all;
    return before + __popc(b & ((1u << lane) - 1u));
}

// Compact the emigrants of `cell` through both faces of `axis` from src
// into em (at most E per face, in slot order; more flags), and write the
// cell's slots to dst: staying slots as they are, the rest the padding
// fill.  dst may be src: each thread reads and writes only its own slot.
__device__ bool compact_cell(const float* src, float* dst, float* em, const Geom& g,
                             int cell, int axis, int* warp) {
    const int t = threadIdx.x, C = g.C, E = g.E;
    int i3[3];
    coords(g, cell, i3);
    const long long i = (long long)cell * C + t;
    bool valid = false, mp = false, mm = false;
    if (t < C) {
        valid = src[kTG * g.S + i] >= 0.f;
        const float local = __fsub_rn(src[(kPX + axis) * g.S + i], origin(g, axis, i3[axis]));
        mp = valid && local >= g.w[axis];
        mm = valid && local < 0.f;
    }
    int np, nm;
    const int rp = block_rank(mp, warp, &np);
    const int rm = block_rank(mm, warp, &nm);
    float* ep = em + (long long)cell * kNcol * E;
    float* emn = em + ((long long)g.ncell + cell) * kNcol * E;
    if ((mp && rp < E) || (mm && rm < E)) {
        float* e = mp ? ep : emn;
        const int r = mp ? rp : rm;
        for (int c = 0; c < kNcol; ++c) e[c * E + r] = src[c * g.S + i];
    }
    for (int e = t; e < E; e += blockDim.x) {
        for (int c = 0; c < kNcol; ++c) {
            const float z = c == kTG ? -1.f : 0.f;
            if (e >= np) ep[c * E + e] = z;
            if (e >= nm) emn[c * E + e] = z;
        }
    }
    if (t < C) {
        const bool stay = valid && !mp && !mm;
        if (!stay || dst != src)
            for (int c = 0; c < kNcol; ++c)
                dst[c * g.S + i] = stay ? src[c * g.S + i] : fill_of(c);
    }
    return np > E || nm > E;
}

// Place into the free slots (tag < 0) of `cell` in dst the immigrants of
// axis: entries 0..E-1 are the + emigrants of the neighbour at index-1,
// E..2E-1 the - emigrants of the neighbour at index+1; the valid one of
// rank r lands in the free slot of rank r.  More immigrants than free
// slots flags (the excess is dropped).
__device__ bool place_cell(float* dst, const float* em, const Geom& g, int cell, int axis,
                           int* warp, int* slot_of) {
    const int t = threadIdx.x, C = g.C, E = g.E;
    int i3[3];
    coords(g, cell, i3);
    const bool lo = t < E;
    const float* src = nullptr;
    bool iv = false;
    int e = 0, seam = 0;
    if (t < 2 * E) {
        e = lo ? t : t - E;
        const int nb = neighbour(g, i3, axis, lo ? -1 : 1);
        src = em + ((long long)(lo ? 0 : g.ncell) + nb) * kNcol * E;
        iv = src[kTG * E + e] >= 0.f;
        seam = lo ? -(i3[axis] == 0) : (i3[axis] == g.n[axis] - 1);
    }
    const bool fr = t < C && dst[kTG * g.S + (long long)cell * C + t] < 0.f;
    int nimm, nfree;
    const int ir = block_rank(iv, warp, &nimm);
    const int fk = block_rank(fr, warp, &nfree);
    if (fr) slot_of[fk] = t;
    __syncthreads();
    if (iv && ir < nfree) {
        const long long d = (long long)cell * C + slot_of[ir];
        for (int c = 0; c < kNcol; ++c)
            dst[c * g.S + d] = seam_shift(g, axis, c, seam, src[c * E + e]);
    }
    return nimm > nfree;
}

// Select the occupants of `cell` along axis from the window [index-1, own,
// index+1] of src (seam-shifted), in window order, into dst; the rest of
// the cell gets the padding fill.  More than C claimants flags.
__device__ bool select_cell(const float* src, float* dst, const Geom& g, int cell, int axis,
                            int* warp) {
    const int t = threadIdx.x, C = g.C;
    int i3[3];
    coords(g, cell, i3);
    const int b = t / C, s = t - b * C;
    bool sf = false;
    long long j = 0;
    int seam = 0;
    if (t < 3 * C) {
        const int sc = b == 1 ? cell : neighbour(g, i3, axis, b - 1);
        j = (long long)sc * C + s;
        seam = (b == 0 && i3[axis] == 0) ? -1 : (b == 2 && i3[axis] == g.n[axis] - 1) ? 1 : 0;
        const float p = seam_shift(g, axis, kPX + axis, seam, src[(kPX + axis) * g.S + j]);
        const float local = __fsub_rn(p, origin(g, axis, i3[axis]));
        sf = src[kTG * g.S + j] >= 0.f && local >= 0.f && local < g.w[axis];
    }
    int n;
    const int r = block_rank(sf, warp, &n);
    const long long base = (long long)cell * C;
    if (sf && r < C)
        for (int c = 0; c < kNcol; ++c)
            dst[c * g.S + base + r] = seam_shift(g, axis, c, seam, src[c * g.S + j]);
    if (t < C && t >= n)
        for (int c = 0; c < kNcol; ++c) dst[c * g.S + base + t] = fill_of(c);
    return n > C;
}

__global__ void select_pass(const float* __restrict__ src, float* __restrict__ dst,
                            int* flag, const Geom g, const int axis) {
    __shared__ int warp[32];
    const bool o = select_cell(src, dst, g, blockIdx.x, axis, warp);
    if (o && threadIdx.x == 0) *flag = 1;
}

// The whole sweep and z place in one cooperative launch: persistent blocks
// loop over cells, and grid.sync() orders the four phases.
__global__ void serial_kernel(const float* __restrict__ cols, float* out, float* emx,
                              float* emy, float* emz, int* flag, const Geom g) {
    __shared__ int warp[32];
    __shared__ int slot_of[kMaxThreads];
    cg::grid_group grid = cg::this_grid();
    bool o = false;
    for (int cell = blockIdx.x; cell < g.ncell; cell += gridDim.x)
        o |= compact_cell(cols, out, emx, g, cell, 0, warp);
    grid.sync();
    for (int cell = blockIdx.x; cell < g.ncell; cell += gridDim.x) {
        o |= place_cell(out, emx, g, cell, 0, warp, slot_of);
        __syncthreads();
        o |= compact_cell(out, out, emy, g, cell, 1, warp);
    }
    grid.sync();
    for (int cell = blockIdx.x; cell < g.ncell; cell += gridDim.x) {
        o |= place_cell(out, emy, g, cell, 1, warp, slot_of);
        __syncthreads();
        o |= compact_cell(out, out, emz, g, cell, 2, warp);
    }
    grid.sync();
    for (int cell = blockIdx.x; cell < g.ncell; cell += gridDim.x)
        o |= place_cell(out, emz, g, cell, 2, warp, slot_of);
    if (o && threadIdx.x == 0) *flag = 1;
}

// ---------------------------------------------------------------------------
// The sweep (row 10) as one launch over tiles of a z plane.
//
// A slot of the tile moves by handle: bits 0-8 name its slot, bits 9-23
// its staged cell, bits 24-27 the seam shifts it has taken (x: -L and
// image + 1, or +L and image - 1; the same for y); -1 is an empty slot.
constexpr int kSlotBits = 9;  // C <= 341 < 512
constexpr int kHandle = (1 << 24) - 1;
constexpr int kXM = 1 << 24, kXP = 1 << 25, kYM = 1 << 26, kYP = 1 << 27;
// at most 8 warps per block, and registers capped so that 5 blocks fit an
// SM: a 2 x 2 tile's 588 blocks at the bench plan then run in one wave
constexpr int kSweepMaxWarps = 8, kSweepBlocksPerSM = 5;

// A block owns TX x TY cells of one z plane and stages them with a ring of
// one cell: SX x SY staged cells, SX = TX + 2, SY = TY + 2.  On a grid 1
// or 2 cells wide a ring cell is the owned cell or its other neighbour, as
// torch.roll makes it in the plain version.  The shared-memory layout is
// sized for a full tile; edge tiles use less.
struct Tile {
    int TX, TY, SX, SY;
    int EC;  // entries of an emigrant list: min(E, C)
};

// the seam shifts of handle h applied to column c's value v
__device__ __forceinline__ float handle_shift(const Geom& g, int h, int c, float v) {
    if (h & (kXM | kXP)) v = seam_shift(g, 0, c, (h & kXM) ? -1 : 1, v);
    if (h & (kYM | kYP)) v = seam_shift(g, 1, c, (h & kYM) ? -1 : 1, v);
    return v;
}

// the 14 columns of the slot that handle h names, into dst[c * stride]:
// positions and tag from its staged record r, the rest from cols at its
// source slot src, each with the handle's seam shifts
__device__ __forceinline__ void put_slot(const float* __restrict__ cols, const float4 r,
                                         const Geom& g, const int h, const long long src,
                                         float* dst, const long long stride) {
#pragma unroll
    for (int c = 0; c < kNcol; ++c) {
        const float v = c == kPX       ? r.x
                        : c == kPX + 1 ? r.y
                        : c == kPX + 2 ? r.z
                        : c == kTG     ? r.w
                                       : cols[c * g.S + src];
        dst[c * stride] = handle_shift(g, h, c, v);
    }
}

inline size_t sweep_smem_bytes(const Tile& t, int C) {
    const size_t staged = (size_t)t.SX * t.SY, xpass = (size_t)t.TX * t.SY,
                 owned = (size_t)t.TX * t.TY;
    return staged * C * sizeof(float4) + (staged + owned) * sizeof(long long) +  // records, bases
           (staged * 2 * t.EC + staged * 2) * sizeof(int) +                    // x lists, counts
           (xpass * C + xpass * 2 * t.EC + xpass * 2) * sizeof(int) +  // h1, y lists, counts
           (owned * C + owned * 2 * t.EC + owned * 2) * sizeof(int);   // final, z lists, counts
}

__global__ void __launch_bounds__(32 * kSweepMaxWarps, kSweepBlocksPerSM)
    sweep_tile_kernel(const float* __restrict__ cols, float* __restrict__ swept,
                      float* __restrict__ emz, unsigned char* flag, const Geom g,
                      const Tile T) {
    extern __shared__ float4 smem4[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int C = g.C, E = g.E, EC = T.EC, nx = g.n[0], ny = g.n[1];
    const long long S = g.S;
    const int gx0 = blockIdx.x * T.TX, gy0 = blockIdx.y * T.TY, gz = blockIdx.z;
    const int tx = min(T.TX, nx - gx0), ty = min(T.TY, ny - gy0);
    const int SX = tx + 2, SY = ty + 2, no = tx * ty;
    float4* rec = smem4;                                            // [staged cell][C]
    long long* gb = reinterpret_cast<long long*>(rec + T.SX * T.SY * C);  // [staged] cell * C
    long long* ob = gb + T.SX * T.SY;                               // [owned] cell * C
    int* xl = reinterpret_cast<int*>(ob + T.TX * T.TY);             // [staged][2][EC]
    int* xn = xl + T.SX * T.SY * 2 * EC;                            // [staged][2] counts
    int* h1 = xn + T.SX * T.SY * 2;                                 // [x-pass cell][C]
    int* yl = h1 + T.TX * T.SY * C;                                 // [x-pass cell][2][EC]
    int* yn = yl + T.TX * T.SY * 2 * EC;                            // [x-pass cell][2]
    int* hs = yn + T.TX * T.SY * 2;                                 // [owned cell][C]
    int* zl = hs + T.TX * T.TY * C;                                 // [owned cell][2][EC]
    int* zn = zl + T.TX * T.TY * 2 * EC;                            // [owned cell][2]
    // the global x and y index of staged column sx and row sy (periodic)
    auto gx_of = [&](int sx) { return (gx0 - 1 + sx + nx) % nx; };
    auto gy_of = [&](int sy) { return (gy0 - 1 + sy + ny) % ny; };
    // the staged record and the global slot of handle h
    auto rec_of = [&](int h) {
        return rec[((h & kHandle) >> kSlotBits) * C + (h & ((1 << kSlotBits) - 1))];
    };
    auto src_of = [&](int h) {
        return gb[(h & kHandle) >> kSlotBits] + (h & ((1 << kSlotBits) - 1));
    };
    bool ovf = false;

    // 1. a warp per staged cell: its decision records, the loads of 64
    // slots in flight together, and its x emigrants in slot order, at most E
    // per face
    for (int sc = warp; sc < SX * SY; sc += nwarps) {
        const int sy = sc / SX, sx = sc - sy * SX;
        const long long base = (((long long)gz * ny + gy_of(sy)) * nx + gx_of(sx)) * C;
        if (lane == 0) gb[sc] = base;
        const float ox = origin(g, 0, gx_of(sx));
        int np = 0, nm = 0;
        for (int k0 = 0; k0 < C; k0 += 64) {
            float4 r[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int k = k0 + 32 * u + lane;
                const long long i = base + k;
                r[u] = k < C ? make_float4(cols[kPX * S + i], cols[(kPX + 1) * S + i],
                                           cols[(kPX + 2) * S + i], cols[kTG * S + i])
                             : make_float4(0.f, 0.f, 0.f, -1.f);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int k = k0 + 32 * u + lane;
                if (k < C) rec[sc * C + k] = r[u];
                const float local = __fsub_rn(r[u].x, ox);
                const bool mp = r[u].w >= 0.f && local >= g.w[0];
                const bool mm = r[u].w >= 0.f && local < 0.f;
                const unsigned bp = __ballot_sync(0xffffffffu, mp);
                const unsigned bm = __ballot_sync(0xffffffffu, mm);
                const int rp = np + __popc(bp & below), rm = nm + __popc(bm & below);
                if (mp && rp < E) xl[(sc * 2) * EC + rp] = sc << kSlotBits | k;
                if (mm && rm < E) xl[(sc * 2 + 1) * EC + rm] = sc << kSlotBits | k;
                np += __popc(bp);
                nm += __popc(bm);
            }
        }
        if (lane == 0) {
            xn[sc * 2] = np;
            xn[sc * 2 + 1] = nm;
        }
    }
    __syncthreads();

    // 2. the x pass of the tile's columns in every staged row (h1), and
    // the y emigrants of each result
    for (int xp = warp; xp < tx * SY; xp += nwarps) {
        const int sy = xp / tx, sx = xp - sy * tx + 1, sc = sy * SX + sx;
        const int gx = gx_of(sx), gy = gy_of(sy);
        const int sl = sc - 1, sr = sc + 1;
        const int npl = min(xn[sl * 2], E), nimm = npl + min(xn[sr * 2 + 1], E);
        const int seam_l = gx == 0 ? kXM : 0, seam_r = gx == nx - 1 ? kXP : 0;
        ovf |= xn[sc * 2] > E || xn[sc * 2 + 1] > E;
        const float ox = origin(g, 0, gx), oy = origin(g, 1, gy);
        int nfree = 0, np = 0, nm = 0;
        for (int k0 = 0; k0 < C; k0 += 32) {
            const int k = k0 + lane;
            bool stay = false;
            if (k < C) {
                const float4 r = rec[sc * C + k];
                const float local = __fsub_rn(r.x, ox);
                stay = r.w >= 0.f && !(local >= g.w[0]) && !(local < 0.f);
            }
            const bool fr = k < C && !stay;
            const unsigned bf = __ballot_sync(0xffffffffu, fr);
            const int f = nfree + __popc(bf & below);
            nfree += __popc(bf);
            int h = -1;
            if (stay)
                h = sc << kSlotBits | k;
            else if (fr && f < nimm)
                h = f < npl ? (xl[(sl * 2) * EC + f] | seam_l)
                            : (xl[(sr * 2 + 1) * EC + f - npl] | seam_r);
            if (k < C) h1[xp * C + k] = h;
            bool mp = false, mm = false;
            if (h >= 0) {
                const float local = __fsub_rn(rec_of(h).y, oy);
                mp = local >= g.w[1];
                mm = local < 0.f;
            }
            const unsigned bp = __ballot_sync(0xffffffffu, mp);
            const unsigned bm = __ballot_sync(0xffffffffu, mm);
            const int rp = np + __popc(bp & below), rm = nm + __popc(bm & below);
            if (mp && rp < E) yl[(xp * 2) * EC + rp] = h;
            if (mm && rm < E) yl[(xp * 2 + 1) * EC + rm] = h;
            np += __popc(bp);
            nm += __popc(bm);
        }
        ovf |= nimm > nfree;
        if (lane == 0) {
            yn[xp * 2] = np;
            yn[xp * 2 + 1] = nm;
        }
    }
    __syncthreads();

    // 3. each owned cell's y pass and z emigrants: the handle of each final
    // slot (hs) and the z emigrant lists (zl, zn)
    for (int o = warp; o < no; o += nwarps) {
        const int sy = o / tx + 1, sxo = o - (sy - 1) * tx;
        const int xp = sy * tx + sxo, xd = xp - tx, xu = xp + tx;
        const int gy = gy_of(sy);
        if (lane == 0) ob[o] = gb[sy * SX + sxo + 1];
        const int npd = min(yn[xd * 2], E), nimm = npd + min(yn[xu * 2 + 1], E);
        const int seam_d = gy == 0 ? kYM : 0, seam_u = gy == ny - 1 ? kYP : 0;
        ovf |= yn[xp * 2] > E || yn[xp * 2 + 1] > E;
        const float oy = origin(g, 1, gy), oz = origin(g, 2, gz);
        int nfree = 0, np = 0, nm = 0;
        for (int k0 = 0; k0 < C; k0 += 32) {
            const int k = k0 + lane;
            const int h = k < C ? h1[xp * C + k] : -1;
            bool stay = false;
            if (h >= 0) {
                const float local = __fsub_rn(rec_of(h).y, oy);
                stay = !(local >= g.w[1]) && !(local < 0.f);
            }
            const bool fr = k < C && !stay;
            const unsigned bf = __ballot_sync(0xffffffffu, fr);
            const int f = nfree + __popc(bf & below);
            nfree += __popc(bf);
            int h2 = -1;
            if (stay)
                h2 = h;
            else if (fr && f < nimm)
                h2 = f < npd ? (yl[(xd * 2) * EC + f] | seam_d)
                             : (yl[(xu * 2 + 1) * EC + f - npd] | seam_u);
            bool mp = false, mm = false;
            if (h2 >= 0) {
                const float local = __fsub_rn(rec_of(h2).z, oz);
                mp = local >= g.w[2];
                mm = local < 0.f;
            }
            const unsigned bp = __ballot_sync(0xffffffffu, mp);
            const unsigned bm = __ballot_sync(0xffffffffu, mm);
            const int rp = np + __popc(bp & below), rm = nm + __popc(bm & below);
            if (k < C) hs[o * C + k] = mp || mm ? -1 : h2;
            if (mp && rp < E) zl[(o * 2) * EC + rp] = h2;
            if (mm && rm < E) zl[(o * 2 + 1) * EC + rm] = h2;
            np += __popc(bp);
            nm += __popc(bm);
        }
        ovf |= nimm > nfree || np > E || nm > E;
        if (lane == 0) {
            zn[o * 2] = np;
            zn[o * 2 + 1] = nm;
        }
    }
    __syncthreads();

    // 4. the payload, the block's warps over the owned cells' chunks of 32
    // slots: each slot's 14 columns gathered once by handle, or the
    // padding fill
    const int nch = (C + 31) >> 5;
    for (int j = warp; j < no * nch; j += nwarps) {
        const int o = j / nch, k = (j - o * nch) * 32 + lane;
        if (k >= C) continue;
        const int h = hs[o * C + k];
        float* d = swept + ob[o] + k;
        if (h >= 0) {
            put_slot(cols, rec_of(h), g, h, src_of(h), d, S);
        } else {
#pragma unroll
            for (int c = 0; c < kNcol; ++c) d[c * S] = fill_of(c);
        }
    }
    // and the z emigrants into emz, a warp per owned cell and direction;
    // unused entries zero with tag -1
    for (int j = warp; j < no * 2; j += nwarps) {
        const int o = j >> 1, n = min(zn[j], E);
        float* d = emz + ((j & 1) * S + ob[o]) / C * (kNcol * E);
        for (int e = lane; e < E; e += 32) {
            if (e < n) {
                const int h = zl[j * EC + e];
                put_slot(cols, rec_of(h), g, h, src_of(h), d + e, E);
            } else {
#pragma unroll
                for (int c = 0; c < kNcol; ++c) d[c * E + e] = c == kTG ? -1.f : 0.f;
            }
        }
    }
    if (__syncthreads_or(ovf) && threadIdx.x == 0) *flag = 1;
}

// ---------------------------------------------------------------------------
// The z place (row 11): a block copies the 14 columns of a run of as many
// cells as it has warps, swept -> out (16-byte accesses where vec says
// every column's run is aligned), then a warp per cell places the cell's
// z immigrants into its free slots.

__global__ void __launch_bounds__(1024)
    place_kernel(const float* __restrict__ swept, const float* __restrict__ emz,
                 float* __restrict__ out, unsigned char* flag, const Geom g, const int vec) {
    extern __shared__ int slot_of[];  // [warp][C]: the cell's free slots in order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, pc = blockDim.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int C = g.C, E = g.E;
    const int cell0 = blockIdx.x * pc, cell1 = min(cell0 + pc, g.ncell);
    const long long off = (long long)cell0 * C, n = (long long)(cell1 - cell0) * C;
    long long done = 0;
    if (vec) {
        const long long nv = n >> 2;
        for (long long i = threadIdx.x; i < kNcol * nv; i += blockDim.x) {
            const int c = (int)(i / nv);
            const long long j = i - c * nv;
            reinterpret_cast<float4*>(out + c * g.S + off)[j] =
                reinterpret_cast<const float4*>(swept + c * g.S + off)[j];
        }
        done = nv * 4;
    }
    const long long rest = n - done;
    for (long long i = threadIdx.x; i < kNcol * rest; i += blockDim.x) {
        const int c = (int)(i / rest);
        const long long j = c * g.S + off + done + (i - c * rest);
        out[j] = swept[j];
    }
    __syncthreads();  // the copy's stores come before the immigrants'
    bool ovf = false;
    const int cell = cell0 + warp;
    if (cell < cell1) {
        int* so = slot_of + warp * C;
        const long long base = (long long)cell * C;
        int nfree = 0;
        for (int k0 = 0; k0 < C; k0 += 32) {
            const int k = k0 + lane;
            const bool fr = k < C && swept[kTG * g.S + base + k] < 0.f;
            const unsigned b = __ballot_sync(0xffffffffu, fr);
            if (fr) so[nfree + __popc(b & below)] = k;
            nfree += __popc(b);
        }
        __syncwarp();
        const int plane = g.n[0] * g.n[1], nz = g.n[2], iz = cell / plane;
        const long long xy = cell - (long long)iz * plane;
        // the + emigrants of plane iz-1, then the - emigrants of plane iz+1
        const float* ep = emz + ((long long)((iz + nz - 1) % nz) * plane + xy) * kNcol * E;
        const float* em =
            emz + ((long long)g.ncell + (long long)((iz + 1) % nz) * plane + xy) * kNcol * E;
        const int seam_p = iz == 0 ? -1 : 0, seam_m = iz == nz - 1 ? 1 : 0;
        int nimm = 0;
        for (int j0 = 0; j0 < 2 * E; j0 += 32) {
            const int j = j0 + lane;
            const bool lo = j < E;
            const float* src = lo ? ep : em;
            const int e = lo ? j : j - E;
            const bool iv = j < 2 * E && src[kTG * E + e] >= 0.f;
            const unsigned b = __ballot_sync(0xffffffffu, iv);
            const int r = nimm + __popc(b & below);
            nimm += __popc(b);
            if (iv && r < nfree) {
                const long long d = base + so[r];
                const int seam = lo ? seam_p : seam_m;
#pragma unroll
                for (int c = 0; c < kNcol; ++c)
                    out[c * g.S + d] = seam_shift(g, 2, c, seam, src[c * E + e]);
            }
        }
        ovf = nimm > nfree;
    }
    if (__syncthreads_or(ovf) && threadIdx.x == 0) *flag = 1;
}

Geom make_geom(float Lx, float Ly, float Lz, float wx, float wy, float wz, int nx, int ny,
               int nz, int C, int E) {
    Geom g;
    g.n[0] = nx;
    g.n[1] = ny;
    g.n[2] = nz;
    g.C = C;
    g.E = E;
    g.ncell = nx * ny * nz;
    g.S = (long long)g.ncell * C;
    g.L[0] = Lx;
    g.L[1] = Ly;
    g.L[2] = Lz;
    g.w[0] = wx;
    g.w[1] = wy;
    g.w[2] = wz;
    return g;
}

int threads_for(int items) { return ((items + 31) / 32) * 32; }

int migrate_threads(const Geom& g) { return threads_for(g.C > 2 * g.E ? g.C : 2 * g.E); }

// Dynamic shared memory above the 48 KB default needs an opt-in; a block's
// static shared memory counts against the same default.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
    if (bytes <= 47 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A kernel's build and occupancy: out = [registers, spilled bytes per
// thread, static shared memory, dynamic shared memory, blocks per SM].
template <typename K>
cudaError_t kernel_occupancy(K kernel, const int threads, const size_t smem, int* out) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, threads, smem);
}

// The sweep's tile for a request of tx x ty cells (each at least 1, cut to
// the grid), or a tile of one cell where the request's shared memory or
// its handles do not fit; its shared memory and threads (a warp per x-pass
// cell, at most kSweepMaxWarps).
cudaError_t sweep_plan(const Geom& g, const int tx, const int ty, Tile* t, size_t* smem,
                       int* threads) {
    static int optin = 0;
    if (!optin) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e != cudaSuccess) return e;
    }
    if (tx < 1 || ty < 1) return cudaErrorInvalidValue;
    for (int k = 0; k < 2; ++k) {
        const int rx = k ? 1 : tx, ry = k ? 1 : ty;
        Tile u;
        u.TX = rx < g.n[0] ? rx : g.n[0];
        u.TY = ry < g.n[1] ? ry : g.n[1];
        u.SX = u.TX + 2;
        u.SY = u.TY + 2;
        u.EC = g.E < g.C ? g.E : g.C;
        const size_t bytes = sweep_smem_bytes(u, g.C);
        if (bytes <= (size_t)optin && u.SX * u.SY <= (kHandle + 1) >> kSlotBits) {
            const int w = u.TX * u.SY;
            *t = u;
            *smem = bytes;
            *threads = 32 * (w < kSweepMaxWarps ? w : kSweepMaxWarps);
            return cudaSuccess;
        }
    }
    return cudaErrorInvalidConfiguration;
}

}  // namespace hoomd_rebin

using namespace hoomd_rebin;

extern "C" {

int hoomd_rebin_select(const float* cols, float* tmp, float* out, int* flag, float Lx,
                       float Ly, float Lz, float wx, float wy, float wz, int nx, int ny,
                       int nz, int C, cudaStream_t st) {
    const Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, 0);
    const int threads = threads_for(3 * C);
    const float* src[3] = {cols, tmp, tmp + kNcol * g.S};
    float* dst[3] = {tmp, tmp + kNcol * g.S, out};
    const int axes[3] = {2, 0, 1};                // z, then x, then y
    for (int k = 0; k < 3; ++k) {
        select_pass<<<g.ncell, threads, 0, st>>>(src[k], dst[k], flag, g, axes[k]);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaGetLastError();
}

// cols (14, nz, ny, nx, C) -> swept (the same) and emz (2, nz, ny, nx,
// 14 E); flag one byte, zeroed here and set on overflow; tiles of tx x ty
// cells (sweep_plan).  One launch.
int hoomd_rebin_sweep(const float* cols, float* swept, float* emz, unsigned char* flag,
                      float Lx, float Ly, float Lz, float wx, float wy, float wz, int nx,
                      int ny, int nz, int C, int E, int tx, int ty, cudaStream_t st) {
    const Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, E);
    Tile t;
    size_t smem = 0;
    int threads = 0;
    cudaError_t e = sweep_plan(g, tx, ty, &t, &smem, &threads);
    if (e != cudaSuccess) return e;
    if ((e = cudaMemsetAsync(flag, 0, 1, st)) != cudaSuccess) return e;
    if ((e = set_smem(sweep_tile_kernel, smem)) != cudaSuccess) return e;
    const dim3 grid((nx + t.TX - 1) / t.TX, (ny + t.TY - 1) / t.TY, nz);
    sweep_tile_kernel<<<grid, threads, smem, st>>>(cols, swept, emz, flag, g, t);
    return cudaGetLastError();
}

// swept and emz as hoomd_rebin_sweep gives them -> out; blocks of pc cells
// (a warp each).  One launch.
int hoomd_rebin_place(const float* swept, const float* emz, float* out, unsigned char* flag,
                      float Lx, float Ly, float Lz, float wx, float wy, float wz, int nx,
                      int ny, int nz, int C, int E, int pc, cudaStream_t st) {
    if (pc < 1 || pc > 32) return cudaErrorInvalidValue;
    const Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, E);
    // float4 runs need every block's run of every column 16-byte aligned
    const int vec = g.S % 4 == 0 && (long long)pc * C % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(swept) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    cudaError_t e = cudaMemsetAsync(flag, 0, 1, st);
    if (e != cudaSuccess) return e;
    place_kernel<<<(g.ncell + pc - 1) / pc, 32 * pc, pc * C * sizeof(int), st>>>(swept, emz, out,
                                                                               flag, g, vec);
    return cudaGetLastError();
}

// the sweep kernel's build and occupancy at a plan's C, E, nx, ny and tile
// (out as kernel_occupancy's, out[5] its threads per block)
int hoomd_rebin_sweep_occupancy(int C, int E, int nx, int ny, int tx, int ty, int* out) {
    const Geom g = make_geom(1.f, 1.f, 1.f, 1.f, 1.f, 1.f, nx, ny, 1, C, E);
    Tile t;
    size_t smem = 0;
    cudaError_t e = sweep_plan(g, tx, ty, &t, &smem, &out[5]);
    if (e != cudaSuccess) return e;
    return kernel_occupancy(sweep_tile_kernel, out[5], smem, out);
}

// the place kernel's, at C and pc cells per block
int hoomd_rebin_place_occupancy(int C, int pc, int* out) {
    out[5] = 32 * pc;
    return kernel_occupancy(place_kernel, out[5], pc * C * sizeof(int), out);
}

int hoomd_rebin_serial(const float* cols, float* out, float* emx, float* emy, float* emz,
                       int* flag, float Lx, float Ly, float Lz, float wx, float wy,
                       float wz, int nx, int ny, int nz, int C, int E, cudaStream_t st) {
    Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, E);
    const int threads = migrate_threads(g);
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
        return e;
    if (!coop) return cudaErrorNotSupported;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, serial_kernel, threads,
                                                           0)) != cudaSuccess)
        return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int blocks = g.ncell < per_sm * sms ? g.ncell : per_sm * sms;
    void* args[] = {(void*)&cols, (void*)&out, (void*)&emx, (void*)&emy,
                    (void*)&emz, (void*)&flag, (void*)&g};
    e = cudaLaunchCooperativeKernel((void*)serial_kernel, blocks, threads, args, 0, st);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // extern "C"
