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
// step time is this kernel's.
//
// What bounds it on this card: the pair loop's issue rate.  At the 64k
// Kob-Andersen plan (1728 cells, C = 72, rho = 1.2) a particle has ~1000
// live candidates in its 27 cells, ~64 of them inside the cut; C is sized
// for the fullest cell, so half the slots are padding.  The design
// (cell_tile.cuh):
//   * a block takes a tile of TX cells of an x-row and packs the live
//     particles of those cells into its warps, a lane per particle;
//   * it stages the tile's stencil one dz plane at a time (3 rows of
//     TX + 2 cells, image shifts applied), compacted to the live slots in
//     stencil order, so a lane walks its ~1000 live candidates and not
//     27 C slots;
//   * the walk tests r^2 against the widest cut of the home's type alone
//     and appends the index of each candidate inside it to its lane's
//     ring of indices in shared memory, four candidates per look at the
//     rings; when a ring is about to fill, the warp evaluates as many
//     entries of every ring as the emptiest holds (at least four), with
//     its lanes converged, oldest first, and at the end of each plane
//     all of them; each pair is tested there against its own cut
//     rc2[ti, tj], r^2 rounded as the plain version's torch ops, and the
//     home itself skipped.
// Each slot thus sums the same pairs in the same order, with the same
// arithmetic (cell_stencil.cuh typed_pair_acc), as the first design (a
// block per cell walking all 27 C staged slots), so the two give the
// same bits.  No atomics: each pair is evaluated from both sides.  A
// thread keeps its particle's row of the table in registers and selects
// a candidate's column by its type: the TPU kernel's one-hot mixing over
// every (ti, tj) is a select of one of T values here.  Exact divide, as
// the JAX engine takes for T > 1.  The C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace hoomd_torch {

constexpr int kTypedThreads = 128;
constexpr int kListLen = 16;             // entries of a lane's ring of candidate indices (2^k)
constexpr int kWalkUnroll = 4;           // candidates a lane tests between two looks at the rings

// Shared memory of one block: a staged plane (3 rows of TX + 2 cells), the
// homes' sums between planes (na floats each), the lanes' rings, the
// homes' slots, the offsets and the table.
static inline size_t typed_smem_bytes(const int C, const int TX, const int na, const int ntab) {
    return (size_t)3 * (TX + 2) * C * sizeof(float4) + (size_t)TX * C * na * sizeof(float) +
           (size_t)(kTypedThreads / 32) * kListLen * 32 * sizeof(int) +
           (size_t)TX * C * sizeof(int) + (size_t)(3 * (TX + 2) + 1 + TX + 1) * sizeof(int) +
           (size_t)ntab * sizeof(float);
}

template <int EV, bool PV>
__global__ void __launch_bounds__(kTypedThreads)
    planar_typed_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                        const int* __restrict__ typ, const float* __restrict__ shifts,
                        const float* __restrict__ par, const int np, const int T, const Geom g,
                        const int TX, float* __restrict__ frc, float* __restrict__ pe,
                        float* __restrict__ vir) {
    constexpr int NA = PV ? 10 : 3;
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int ntab = (2 + np) * T * T;
    float4* ent = smem4;
    float* hacc = reinterpret_cast<float*>(ent + 3 * (TX + 2) * C);
    int* list = reinterpret_cast<int*>(hacc + TX * C * NA);
    int* hslot = list + (blockDim.x >> 5) * kListLen * 32;
    int* off = hslot + TX * C;
    int* hstart = off + 3 * (TX + 2) + 1;
    float* tab = reinterpret_cast<float*>(hstart + TX + 1);
    const Tile t = tile_of_block(g, TX);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    stage_table(par, ntab, tab);
    const long long cell0 = (long long)t.x0 + g.nx * (t.iy + (long long)g.ny * t.iz);
    for (int q = threadIdx.x; q < t.tx * C; q += blockDim.x) {
        const long long slot = cell0 * C + q;
        if (tag[slot] >= 0) continue;
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = 0.0f;
        if (PV) {
            pe[slot] = 0.0f;
            for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.0f;
        }
    }
    pack_homes(tag, g, t, hslot, hstart);
    const int nh = hstart[t.tx];
    int* mine = list + w * kListLen * 32 + lane;
    for (int dz = -1; dz <= 1; ++dz) {
        stage_rows<true>(pos, tag, typ, T, shifts, g, t, dz, -1, 3, ent, off);
        for (int gi = w; gi * 32 < nh; gi += nw) {
            const int p = gi * 32 + lane;
            const bool live = p < nh;
            const int slot = live ? hslot[p] : 0;
            const int lc = live ? home_cell(hstart, t.tx, p) : 0;
            // the home's coordinates as the first design staged them (its
            // own cell's zero shift added)
            const float* s13 = shifts + ((long long)(slot / C) * 27 + 13) * 3;
            const float xi = live ? pos[slot * 3 + 0] + s13[0] : 0.0f;
            const float yi = live ? pos[slot * 3 + 1] + s13[1] : 0.0f;
            const float zi = live ? pos[slot * 3 + 2] + s13[2] : 0.0f;
            const TypedRow R = load_typed_row(tab, np, T, live ? min(max(typ[slot], 0), T - 1) : 0);
            float acc[NA];
#pragma unroll
            for (int a = 0; a < NA; ++a) acc[a] = (dz == -1 || !live) ? 0.0f : hacc[p * NA + a];
            // the home's own entry (excluded)
            const int self = dz == 0 ? off[t.W + lc + 1] + (p - hstart[lc]) : -1;
            // the walk keeps the candidates inside the home's widest cut
            // (r^2 in fused multiply-adds, the cut widened by far more than
            // their rounding); the evaluation tests each, with r^2 rounded
            // as the plain version's, against its own pair's cut
            float rc2max = R.v[0][0];
#pragma unroll
            for (int c = 1; c < kMaxTypes; ++c) rc2max = fmaxf(rc2max, R.v[0][c]);
            rc2max *= 1.0f + 1e-5f;
            // the lane's list is a ring: entries head .. tail - 1
            int head = 0, tail = 0;
            auto drain = [&](const int d) {     // up to d entries, oldest first
                for (int e = 0; e < d; ++e) {
                    const int u = head < tail ? mine[(head & (kListLen - 1)) * 32] : self;
                    if (u != self) {
                        const float4 c = ent[u];
                        typed_pair_acc<EV, PV>(xi - c.x, yi - c.y, zi - c.z, R, meta_type(c), acc);
                    }
                    head += head < tail;
                }
            };
            // the home's run of each row: union cells lc .. lc + 2
            for (int q = 0; q < 3; ++q) {
                const int s = off[q * t.W + lc];
                const int len = live ? off[q * t.W + lc + 3] - s : 0;
                const int m = __reduce_max_sync(0xffffffffu, len);
                for (int j0 = 0; j0 < m; j0 += kWalkUnroll) {
                    float4 c[kWalkUnroll];
#pragma unroll
                    for (int k = 0; k < kWalkUnroll; ++k)
                        c[k] = j0 + k < len ? ent[s + j0 + k] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                    for (int k = 0; k < kWalkUnroll; ++k) {
                        // the entry goes in at the tail either way (the ring
                        // has room); it stays only inside the cut
                        mine[(tail & (kListLen - 1)) * 32] = s + j0 + k;
                        const float dx = xi - c[k].x, dy = yi - c[k].y, dz2 = zi - c[k].z;
                        tail += j0 + k < len && fmaf(dx, dx, fmaf(dy, dy, dz2 * dz2)) < rc2max;
                    }
                    // a ring about to fill: every lane evaluates as many
                    // entries as the emptiest holds, and at least
                    // kWalkUnroll, which makes room for the next step
                    if (__any_sync(0xffffffffu, tail - head > kListLen - kWalkUnroll))
                        drain(max(__reduce_min_sync(0xffffffffu, tail - head), kWalkUnroll));
                }
            }
            drain(__reduce_max_sync(0xffffffffu, tail - head));
            if (!live) continue;
            if (dz < 1) {
#pragma unroll
                for (int a = 0; a < NA; ++a) hacc[p * NA + a] = acc[a];
            } else {
                for (int a = 0; a < 3; ++a) frc[(long long)slot * 3 + a] = acc[a];
                if (PV) {
                    pe[slot] = 0.5f * acc[3];
                    for (int c = 0; c < 6; ++c) vir[(long long)slot * 6 + c] = 0.5f * acc[4 + c];
                }
            }
        }
        __syncthreads();                        // before the next plane is staged
    }
}

template <int EV, bool PV>
static cudaError_t launch_typed(const float* pos, const int* tag, const int* typ,
                                const float* shifts, const float* par, const int np,
                                const int T, float* frc, float* pe, float* vir, const Geom g,
                                const int TX, cudaStream_t st) {
    const size_t smem = typed_smem_bytes(g.C, TX, PV ? 10 : 3, (2 + np) * T * T);
    cudaError_t e = set_smem(planar_typed_kernel<EV, PV>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((g.nx + TX - 1) / TX, g.ny, g.nz);
    planar_typed_kernel<EV, PV><<<grid, kTypedThreads, smem, st>>>(pos, tag, typ, shifts, par,
                                                                   np, T, g, TX, frc, pe, vir);
    return cudaGetLastError();
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// pos (nc, C, 3), tag and typ (nc, C), shifts (nc, 27, 3) as
// build_cell_shifts makes them, par the (2 + np, ntypes, ntypes) table;
// frc (nc, C, 3), and with pv pe (nc, C) and vir (nc, C, 6) (unused, may
// be null, without); tiles of tx cells of an x-row.
int hoomd_cell_pair_planar_typed(const float* pos, const int* tag, const int* typ,
                                 const float* shifts, const float* par, int np, int ntypes,
                                 float* frc, float* pe, float* vir, int nx, int ny, int nz,
                                 int C, int ev, int pv, int tx, void* stream) {
    if (ntypes < 1 || ntypes > kMaxTypes || np < 0 || np > kMaxPnames || tx < 1 || tx > 64)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    return dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return pv ? launch_typed<EV, true>(pos, tag, typ, shifts, par, np, ntypes, frc, pe,
                                           vir, g, tx, st)
                  : launch_typed<EV, false>(pos, tag, typ, shifts, par, np, ntypes, frc, pe,
                                            vir, g, tx, st);
    });
}

// The build and occupancy of the kernel of evaluator ev (kernel_occupancy's
// out[5]) at capacity C, tiles of tx cells and a table of ntab floats.
int hoomd_planar_typed_occupancy(int ev, int pv, int C, int tx, int ntab, int* out) {
    return dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return pv ? kernel_occupancy(planar_typed_kernel<EV, true>, kTypedThreads,
                                     typed_smem_bytes(C, tx, 10, ntab), out)
                  : kernel_occupancy(planar_typed_kernel<EV, false>, kTypedThreads,
                                     typed_smem_bytes(C, tx, 3, ntab), out);
    });
}

}  // extern "C"
