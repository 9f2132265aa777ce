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
// The TPU kernels hold whole (ny, nx, C) planes in VMEM and walk the z
// planes in order.  A plane of 14 columns is ~0.4 MB at the bench plans,
// more than a block's 227 KB of shared memory, and the passes depend on
// each other across cells: the y pass reads what the x pass placed, z reads
// both.  So here one block owns one cell (one thread per slot, per window
// candidate or per immigrant), emigrants go through device memory, and
// every dependent pass is its own launch on one stream:
//   select: 3 launches (z, x, y window selects, through two scratch copies);
//   sweep:  3 launches (x compact; x place + y compact; y place + z compact);
//   place:  1 launch (z place);
//   serial: 1 cooperative launch of persistent blocks that loop over cells,
//           with grid.sync() between the same four phases.
// Ranks are exclusive block-wide counts in slot (or window) order from
// __ballot_sync / __popc; no atomics touch ranks or slots, so slot order is
// deterministic and equal to the plain torch version's and the JAX
// package's.  Migration decisions compare pos - (i*w - L/2) with 0 and w,
// and the seam shifts are pos -+ L, each operation rounded on its own
// (__fmul_rn and friends, which the compiler never contracts into fused
// multiply-adds), as the torch and JAX versions' separate operations.
//
// What bounds them on this card: each moves the state's bytes a few times
// (5.3 MB per copy at the 64k bench plan, 2352 cells x C = 40) and does a
// handful of compares per slot, so memory bounds all four, at under 2
// microseconds per pass; a block's work is one short chain of block-wide
// scans, and a pass measured 9-10 microseconds of device time on an H100
// at that plan: about a launch.  Every C entry point returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

__global__ void compact_pass(const float* __restrict__ src, float* __restrict__ dst,
                             float* __restrict__ em, int* flag, const Geom g,
                             const int axis) {
    __shared__ int warp[32];
    const bool o = compact_cell(src, dst, em, g, blockIdx.x, axis, warp);
    if (o && threadIdx.x == 0) *flag = 1;
}

// place the immigrants of axis_in, then compact the emigrants of axis_out,
// in place on the cell's slots
__global__ void place_compact_pass(float* state, const float* __restrict__ em_in,
                                   float* __restrict__ em_out, int* flag, const Geom g,
                                   const int axis_in, const int axis_out) {
    __shared__ int warp[32];
    __shared__ int slot_of[kMaxThreads];
    bool o = place_cell(state, em_in, g, blockIdx.x, axis_in, warp, slot_of);
    __syncthreads();
    o |= compact_cell(state, state, em_out, g, blockIdx.x, axis_out, warp);
    if (o && threadIdx.x == 0) *flag = 1;
}

// copy the cell from src to dst, then place the immigrants of axis in dst
__global__ void place_pass(const float* __restrict__ src, const float* __restrict__ em,
                           float* __restrict__ dst, int* flag, const Geom g,
                           const int axis) {
    __shared__ int warp[32];
    __shared__ int slot_of[kMaxThreads];
    const int t = threadIdx.x;
    if (t < g.C) {
        const long long i = (long long)blockIdx.x * g.C + t;
        for (int c = 0; c < kNcol; ++c) dst[c * g.S + i] = src[c * g.S + i];
    }
    __syncthreads();
    const bool o = place_cell(dst, em, g, blockIdx.x, axis, warp, slot_of);
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

int hoomd_rebin_sweep(const float* cols, float* swept, float* emx, float* emy, float* emz,
                      int* flag, float Lx, float Ly, float Lz, float wx, float wy,
                      float wz, int nx, int ny, int nz, int C, int E, cudaStream_t st) {
    const Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, E);
    const int threads = migrate_threads(g);
    compact_pass<<<g.ncell, threads, 0, st>>>(cols, swept, emx, flag, g, 0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    place_compact_pass<<<g.ncell, threads, 0, st>>>(swept, emx, emy, flag, g, 0, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    place_compact_pass<<<g.ncell, threads, 0, st>>>(swept, emy, emz, flag, g, 1, 2);
    return cudaGetLastError();
}

int hoomd_rebin_place(const float* swept, const float* emz, float* out, int* flag,
                      float Lx, float Ly, float Lz, float wx, float wy, float wz, int nx,
                      int ny, int nz, int C, int E, cudaStream_t st) {
    const Geom g = make_geom(Lx, Ly, Lz, wx, wy, wz, nx, ny, nz, C, E);
    place_pass<<<g.ncell, migrate_threads(g), 0, st>>>(swept, emz, out, flag, g, 2);
    return cudaGetLastError();
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
