// Hand-written Hopper kernels of the LJ engine's other force paths, chosen
// by HOOMD_TPU_FAST_IMPL (hoomd_tpu_torch/ops/cell_pair.py binds them
// through ctypes):
//
// hoomd_cell_pair_lj      replaces hoomd_tpu/ops/pallas_pair.py:_kernel
//                         ('pallas'): a cell against the 27 cells its row of
//                         the adjacency table lists; forces, half-pair
//                         energy and virial.
// hoomd_cell_pair_lj3d    replaces pallas_pair.py:_kernel3d ('pallas3d'): a
//                         cell against its 27 modular-indexed neighbours, one
//                         neighbour at a time; forces.
// hoomd_cell_pair_lj_row  replaces pallas_pair.py:_kernel_row ('row'): a tile
//                         of an x-row of cells against its 9 (dz, dy) stencil
//                         rows, each row staged once and reused for
//                         dx = -1, 0, +1; forces.
// hoomd_cell_pair_n3l     replaces pallas_pair.py:_kernel_planar_n3l
//                         ('planar_n3l'): the half stencil, each pair once and
//                         its -F put on the other particle; forces.  Like the
//                         TPU kernel it takes any of the ten evaluators, and
//                         a mixture of up to kMaxTypes types (its typed
//                         branch, pallas_pair.py:944-990) through the
//                         per-pair table lookup of cell_stencil.cuh.
//
// All four take the rules of cell_stencil.cuh: validity from tag >= 0, the
// self pair excluded by index, dr = xi - (xj + shift) directly (the TPU's
// 'pallas' kernel forms r^2 as |xi|^2 + |xj|^2 - 2 xi.xj for its matrix
// unit, which loses digits at |x| ~ 20), the exact divide.  The first three
// are LJ only and single-type, as their TPU kernels are.
//
// What bounds them on this card: as for cell_pair.cu, the pair loop.  At
// the 64k bench plan (2352 cells, C = 40) the full stencil visits 102M
// candidate pairs of ~20 flops against a few MB of state, so the fp32
// issue rate bounds them; the half stencil's function needs half the
// pairs.  What each design does:
//   * lj: one block per cell stages the 27 listed cells (27*C*13 bytes of
//     shared memory, 14 KB at C = 40), a thread per slot.
//   * lj3d: one block per cell stages one neighbour at a time into a
//     double buffer (2*C*13 bytes, 1 KB at C = 40), one barrier per
//     neighbour: less shared memory per block than lj, more barriers.
//   * lj_row: one block per tile of TX cells of an x-row (TX*C threads:
//     at MAX_C one row does not fit a block) stages each (dz, dy) row's
//     TX + 2 cells once, image shifts applied, and every thread reads it
//     for its dx = -1, 0, +1 neighbours: 9 stagings of (TX+2)*C slots
//     instead of 27 of C per cell.
//   * n3l: a block takes a tile of TX cells of an x-row and packs their
//     live particles (cell_tile.cuh); it stages the half stencil's two dz
//     planes once each, compacted to the live slots, and a warp keeps 32
//     candidates j in registers, their -F included, while the tile's
//     homes pass by in 32 rotated steps: cut tests first, then the pairs
//     inside the cut with the warp converged, then each home's sum passed
//     one lane on per step with __shfl_sync.  No candidate costs a shared
//     read-modify-write.  The j side of the own row's tile cells joins the
//     homes' sums in the block; the rest goes to 13 partial planes (a
//     (13, M, 3) buffer, one source block per entry), and a second launch
//     adds each particle's planes in a fixed order.  The sums are
//     deterministic: the same inputs give the same bits, run after run.
//     A mixture's variant stages each candidate's type in its meta word
//     and the table in shared memory, and each lane keeps the column of
//     its candidate's type in registers; the single-type variants read
//     [rc2, e_shift, *pnames].
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace hoomd_torch {

// ---------------------------------------------------------------------------
// lj: the adjacency-listed stencil.  lj = [lj1, lj2, rc2, e_shift].

__global__ void lj_adj_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                              const int* __restrict__ adj, const float* __restrict__ shifts,
                              const float* __restrict__ ljp, const int C,
                              float* __restrict__ frc, float* __restrict__ pe,
                              float* __restrict__ vir) {
    extern __shared__ float smem[];
    __shared__ int self_k;
    const int n = 27 * C;
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + n);
    const long long cell = blockIdx.x;
    const int* row = adj + cell * 27;
    const float* shc = shifts + cell * 27 * 3;
    if (threadIdx.x == 0) {
        // the entry that lists this cell itself under no image shift
        int s = -1;
        for (int k = 0; k < 27 && s < 0; ++k)
            if (row[k] == cell && shc[3 * k] == 0.0f && shc[3 * k + 1] == 0.0f &&
                shc[3 * k + 2] == 0.0f)
                s = k;
        self_k = s;
    }
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / C;
        if (row[k] < 0 || row[k] >= (int)gridDim.x) {
            // an id outside the grid lists nothing: never read past it
            sx[t] = sy[t] = sz[t] = 0.0f;
            sv[t] = 0;
            continue;
        }
        const long long slot = (long long)row[k] * C + (t - k * C);
        sx[t] = pos[slot * 3 + 0] + shc[3 * k + 0];
        sy[t] = pos[slot * 3 + 1] + shc[3 * k + 1];
        sz[t] = pos[slot * 3 + 2] + shc[3 * k + 2];
        sv[t] = tag[slot] >= 0;
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i >= C) return;
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const long long slot = cell * C + i;
    if (tag[slot] >= 0)
        stencil_sum<EV_LJ, false, true>(pos[slot * 3], pos[slot * 3 + 1], pos[slot * 3 + 2],
                                 self_k >= 0 ? self_k * C + i : -1, n, sx, sy, sz, sv, lj,
                                 acc);
    for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
    pe[slot] = 0.5f * acc[3];
    for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
}

// ---------------------------------------------------------------------------
// lj3d: one neighbour at a time, double-buffered.

__global__ void lj_3d_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                             const float* __restrict__ shifts, const float* __restrict__ ljp,
                             const Geom g, float* __restrict__ frc) {
    extern __shared__ float smem[];
    const int C = g.C;
    unsigned char* sv0 = reinterpret_cast<unsigned char*>(smem + 6 * C);
    const int cell = blockIdx.x;
    const int ix = cell % g.nx, iy = (cell / g.nx) % g.ny, iz = cell / (g.nx * g.ny);
    const float* shc = shifts + (long long)cell * 27 * 3;
    auto stage = [&](const int k, const int b) {
        const int jc = wrap(ix + k % 3 - 1, g.nx) +
                       g.nx * (wrap(iy + (k / 3) % 3 - 1, g.ny) + g.ny * wrap(iz + k / 9 - 1, g.nz));
        float* s = smem + b * 3 * C;
        for (int t = threadIdx.x; t < C; t += blockDim.x) {
            const long long slot = (long long)jc * C + t;
            s[t] = pos[slot * 3 + 0] + shc[3 * k + 0];
            s[C + t] = pos[slot * 3 + 1] + shc[3 * k + 1];
            s[2 * C + t] = pos[slot * 3 + 2] + shc[3 * k + 2];
            sv0[b * C + t] = tag[slot] >= 0;
        }
    };
    const int i = threadIdx.x;
    const long long slot = (long long)cell * C + i;
    const bool vi = i < C && tag[slot] >= 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (vi) {
        xi = pos[slot * 3];
        yi = pos[slot * 3 + 1];
        zi = pos[slot * 3 + 2];
    }
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[3] = {0.f, 0.f, 0.f};
    stage(0, 0);
    __syncthreads();
    for (int k = 0; k < 27; ++k) {
        // the next neighbour goes to the other buffer, which every thread
        // left at the previous barrier
        if (k + 1 < 27) stage(k + 1, (k + 1) & 1);
        const int b = k & 1;
        if (vi)
            stencil_sum<EV_LJ, false, false>(xi, yi, zi, k == 13 ? i : -1, C, smem + b * 3 * C,
                                      smem + b * 3 * C + C, smem + b * 3 * C + 2 * C,
                                      sv0 + b * C, lj, acc);
        __syncthreads();
    }
    if (i < C)
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
}

// ---------------------------------------------------------------------------
// lj_row: grid (tiles of TX cells, ny, nz).

__global__ void lj_row_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                              const float* __restrict__ shifts, const float* __restrict__ ljp,
                              const Geom g, const int TX, float* __restrict__ frc) {
    extern __shared__ float smem[];
    const int C = g.C;
    const int W = (TX + 2) * C;
    float* sx = smem;
    float* sy = sx + W;
    float* sz = sy + W;
    unsigned char* sv = reinterpret_cast<unsigned char*>(sz + W);
    const int x0 = blockIdx.x * TX, iy = blockIdx.y, iz = blockIdx.z;
    const int tx = min(TX, g.nx - x0);          // cells of this tile
    const int t = threadIdx.x;
    const int lc = t / C, i = t - lc * C;
    const long long slot = ((long long)(x0 + lc) + g.nx * (iy + (long long)g.ny * iz)) * C + i;
    const bool vi = lc < tx && tag[slot] >= 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (vi) {
        xi = pos[slot * 3];
        yi = pos[slot * 3 + 1];
        zi = pos[slot * 3 + 2];
    }
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float acc[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < 9; ++r) {
        const int jy = wrap(iy + r % 3 - 1, g.ny), jz = wrap(iz + r / 3 - 1, g.nz);
        __syncthreads();                        // the last row's reads are done
        // staged entry u_local holds cell x0 - 1 + u_local of the row under
        // the image shift of the (home, dx) that reaches it
        for (int s = t; s < (tx + 2) * C; s += blockDim.x) {
            const int ul = s / C, js = s - ul * C;
            const int u = x0 - 1 + ul;          // in [-1, nx]
            const int hx = min(max(u, 0), g.nx - 1);
            const int k = r * 3 + (u - hx) + 1;
            const float* sh =
                shifts + (((long long)hx + g.nx * (iy + (long long)g.ny * iz)) * 27 + k) * 3;
            const long long js_slot =
                ((long long)wrap(u, g.nx) + g.nx * (jy + (long long)g.ny * jz)) * C + js;
            sx[s] = pos[js_slot * 3 + 0] + sh[0];
            sy[s] = pos[js_slot * 3 + 1] + sh[1];
            sz[s] = pos[js_slot * 3 + 2] + sh[2];
            sv[s] = tag[js_slot] >= 0;
        }
        __syncthreads();
        if (!vi) continue;
        for (int d = 0; d < 3; ++d) {           // dx = d - 1: staged cell lc + d
            const int base = (lc + d) * C;
            stencil_sum<EV_LJ, false, false>(xi, yi, zi, (r == 4 && d == 1) ? i : -1, C, sx + base,
                                      sy + base, sz + base, sv + base, lj, acc);
        }
    }
    if (lc < tx)
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
}

// ---------------------------------------------------------------------------
// n3l: the half stencil.  par = [rc2, e_shift, *pnames] of one type, or the
// (2 + np, T, T) table of a mixture (TYPED).
//
// A block takes a tile of TX cells of an x-row (cell_tile.cuh).  The half
// stencil of a home of cell lc is, in union cells of the tile: the own
// row's lc + 1 (its own cell, pairs i < j) and lc + 2 (dx = +1), then
// lc .. lc + 2 of the rows (dz, dy) = (0, +1), (+1, -1), (+1, 0), (+1, +1).
// The block stages the dz = 0 plane (the own row and (0, +1)) and then
// the dz = +1 plane, compacted to the live slots; a warp takes 32
// consecutive entries of one row, one candidate j per lane, and keeps j in
// registers, its -F included, while it meets each group of 32 homes that
// reaches the tile's cells.  Per (home group, tile):
//   1. in 32 steps lane l tests home (l + s) mod 32 against its j (the
//      half-stencil relation, then r^2 < rc2 rounded as the plain version
//      rounds it) and keeps a bit per pair inside the cut (a group of
//      fewer homes rotates within segments of the warp, in fewer steps);
//   2. the lanes evaluate their in-cut pairs with the warp converged, up to
//      kN3lChunk each, in ascending step: -F on j in registers, F into the
//      lane's own column of the warp's shared buffer;
//   3. the home sums pass one lane on per step with __shfl_sync (the steps
//      at which no lane has a pair in one shuffle), so that lane l adds
//      its pair of step s to home (l + s) mod 32; after them lane l holds
//      home l - 1's sum and adds it to the warp's own row of home sums.
// So no shared location is written by two lanes at once and no candidate
// costs a shared read-modify-write.  After each tile, j's -F goes out:
// to the home's sum for the own row's tile cells, else to a partial plane
// of the (13, M, 3) buffer: plane 0 the own row's right halo (the cell
// after the tile); for the other four rows rho = 1 .. 4, plane
// 3 rho - 2 the tile's own x-range, 3 rho - 1 the right halo, 3 rho the
// left halo (the cell before it).  Each (plane, particle) has one source
// block, and a second launch adds to each particle its planes in a fixed
// order, so the same inputs give the same bits without atomics.

constexpr int kN3lThreads = 128;
constexpr int kN3lChunk = 8;

// Shared memory of one block: a staged plane (3 rows of TX + 2 cells), the
// homes (coordinates and meta), the warps' home sums, the warps' step
// buffers, the own row's j sums, the table, the homes' slots and the
// offsets.
static inline size_t n3l_smem_bytes(const int C, const int TX, const int ntab) {
    const int nw = kN3lThreads / 32;
    return (size_t)(3 * (TX + 2) * C + TX * C) * sizeof(float4) +
           (size_t)(nw * TX * C * 3 + nw * kN3lChunk * 32 * 3 + TX * C * 3 + ntab) *
               sizeof(float) +
           (size_t)(TX * C + TX + 1 + 3 * (TX + 2) + 1) * sizeof(int);
}

// Register caps, chosen by timing on the card: a mixture's variant (it
// holds its candidates' column of the table) runs faster held to 64
// registers (8 blocks of kN3lThreads per SM) than with the compiler's own
// choice; the one-type variants take 51 (10 blocks).
template <int EV, bool TYPED>
__global__ void __launch_bounds__(kN3lThreads, TYPED ? 8 : 10)
    n3l_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
               const int* __restrict__ typ, const float* __restrict__ shifts,
               const float* __restrict__ par, const int np, const int T, const Geom g,
               const int TX, float* __restrict__ frc, float* __restrict__ part) {
    extern __shared__ float4 smem4[];
    const int C = g.C, HC = TX * C;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int ntab = TYPED ? (2 + np) * T * T : 0;
    float4* ent = smem4;                        // a staged plane
    float4* hpos = ent + 3 * (TX + 2) * C;      // homes: coordinates, type | cell << 8
    float* acch = reinterpret_cast<float*>(hpos + HC);   // [warp][home][axis]
    float* hf = acch + nw * HC * 3;             // [warp][chunk][lane][axis]
    float* jown = hf + nw * kN3lChunk * 32 * 3; // [home][axis]
    float* tab = jown + HC * 3;
    int* hslot = reinterpret_cast<int*>(tab + ntab);
    int* hstart = hslot + HC;
    int* off = hstart + TX + 1;
    const Tile t = tile_of_block(g, TX);
    const long long M = (long long)g.nx * g.ny * g.nz * C;
    if constexpr (TYPED) stage_table(par, ntab, tab);
    const PairPar P = load_pair_par(par, np);   // one type's parameters
    for (int q = threadIdx.x; q < nw * HC * 3; q += blockDim.x) acch[q] = 0.0f;
    const long long cell0 = (long long)t.x0 + g.nx * (t.iy + (long long)g.ny * t.iz);
    for (int q = threadIdx.x; q < t.tx * C; q += blockDim.x)
        if (tag[cell0 * C + q] < 0)
            for (int a = 0; a < 3; ++a) frc[(cell0 * C + q) * 3 + a] = 0.0f;
    pack_homes(tag, g, t, hslot, hstart);
    const int nh = hstart[t.tx];
    for (int p = threadIdx.x; p < nh; p += blockDim.x) {
        const long long slot = hslot[p];
        const float* s13 = shifts + ((slot / C) * 27 + 13) * 3;
        const int ty = TYPED ? min(max(typ[slot], 0), T - 1) : 0;
        hpos[p] = make_float4(pos[slot * 3 + 0] + s13[0], pos[slot * 3 + 1] + s13[1],
                              pos[slot * 3 + 2] + s13[2],
                              __int_as_float(ty | home_cell(hstart, t.tx, p) << 8));
    }
    float* hfw = hf + w * kN3lChunk * 32 * 3;
    for (int dz = 0; dz <= 1; ++dz) {
        const int nr = dz ? 3 : 2, dy0 = dz ? -1 : 0;
        stage_rows<TYPED>(pos, tag, typ, T, shifts, g, t, dz, dy0, nr, ent, off);
        int ntile = 0;
        for (int q = 0; q < nr; ++q) ntile += (off[(q + 1) * t.W] - off[q * t.W] + 31) / 32;
        for (int tau = w; tau < ntile; tau += nw) {
            int q = 0, r = tau, nt;
            while (r >= (nt = (off[(q + 1) * t.W] - off[q * t.W] + 31) / 32)) {
                r -= nt;
                ++q;
            }
            const int rho = dz ? 2 + q : q;     // 0 the own row
            const int start = off[q * t.W] + 32 * r, end = off[(q + 1) * t.W];
            const int j = start + lane;
            const bool jv = j < end;
            const float4 ej = ent[jv ? j : start];
            const int ulj = meta_ul(ej);
            TypedRow Rc;                        // column tj of the table
            if constexpr (TYPED) Rc = load_typed_col(tab, np, T, meta_type(ej));
            float fj[3] = {0.f, 0.f, 0.f};
            // the homes whose half stencil reaches the tile's cells
            const int ula = meta_ul(ent[start]), ulb = meta_ul(ent[min(start + 31, end - 1)]);
            const int lc_lo = max(0, ula - 2), lc_hi = min(t.tx - 1, rho == 0 ? ulb - 1 : ulb);
            const int h0 = lc_lo <= lc_hi ? hstart[lc_lo] : 0;
            const int h1 = lc_lo <= lc_hi ? hstart[lc_hi + 1] : 0;
            for (int hb = h0; hb < h1; hb += 32) {
                // a group of the homes hb .. he - 1 rotates among gw lanes
                // (the power of 2 that holds them): the warp's 32 / gw
                // segments each meet all of them in gw steps
                const int he = min(hb + 32, h1), r = he - hb;
                const int gw = r <= 1 ? 1 : 1 << (32 - __clz(r - 1));
                const int sl = lane & (gw - 1);
                // 1. the cut test of each of this lane's gw pairs
                unsigned mask = 0;
                for (int s = 0; s < gw; ++s) {
                    const int hp = hb + ((sl + s) & (gw - 1));
                    if (!jv || hp >= he) continue;
                    const float4 h = hpos[hp];
                    const int lch = __float_as_int(h.w) >> 8;
                    const bool rel = rho == 0
                                         ? (ulj == lch + 2 || (ulj == lch + 1 && j > off[1] + hp))
                                         : (unsigned)(ulj - lch) <= 2u;
                    if (!rel) continue;
                    const float rc2 = TYPED ? pick(Rc.v[0], __float_as_int(h.w) & 15) : P.rc2;
                    if (r2_rn(h.x - ej.x, h.y - ej.y, h.z - ej.z) < rc2) mask |= 1u << s;
                }
                while (__any_sync(0xffffffffu, mask)) {
                    // 2. evaluate up to kN3lChunk pairs per lane, in step order
                    unsigned done = 0;
                    for (int k = 0; k < kN3lChunk; ++k) {
                        if (!__any_sync(0xffffffffu, mask)) break;
                        if (!mask) continue;
                        const int s = __ffs(mask) - 1;
                        mask &= mask - 1;
                        done |= 1u << s;
                        const float4 h = hpos[hb + ((sl + s) & (gw - 1))];
                        float f[3] = {0.f, 0.f, 0.f};
                        if constexpr (TYPED)
                            pair_acc<EV, false, false>(h.x - ej.x, h.y - ej.y, h.z - ej.z,
                                                       typed_par(Rc, __float_as_int(h.w) & 15),
                                                       f);
                        else
                            pair_acc<EV, false, false>(h.x - ej.x, h.y - ej.y, h.z - ej.z, P, f);
                        for (int a = 0; a < 3; ++a) {
                            fj[a] -= f[a];
                            hfw[(k * 32 + lane) * 3 + a] = f[a];
                        }
                    }
                    // 3. each home's sum passes one lane on per step within
                    // its segment (the steps where no lane has a pair in
                    // one shuffle), then the segments' sums add up in
                    // lanes 0 .. gw - 1
                    float hs[3] = {0.f, 0.f, 0.f};  // home (sl + at) mod gw's
                    int k = 0, at = 0;
                    for (unsigned u = __reduce_or_sync(0xffffffffu, done); u; u &= u - 1) {
                        const int s = __ffs(u) - 1;
                        if (s != at)
                            for (int a = 0; a < 3; ++a)
                                hs[a] = __shfl_sync(0xffffffffu, hs[a], sl + s - at, gw);
                        at = s;
                        if (done >> s & 1) {
                            for (int a = 0; a < 3; ++a) hs[a] += hfw[(k * 32 + lane) * 3 + a];
                            ++k;
                        }
                    }
                    if (at != gw - 1)
                        for (int a = 0; a < 3; ++a)
                            hs[a] = __shfl_sync(0xffffffffu, hs[a], sl + gw - 1 - at, gw);
                    for (int o = gw; o < 32; o <<= 1)
                        for (int a = 0; a < 3; ++a)
                            hs[a] += __shfl_down_sync(0xffffffffu, hs[a], o);
                    const int hp = hb + ((sl + gw - 1) & (gw - 1));
                    if (lane < gw && hp < he)
                        for (int a = 0; a < 3; ++a) acch[(w * HC + hp) * 3 + a] += hs[a];
                }
            }
            if (!jv) continue;
            if (rho == 0) {
                if (ulj >= 1 && ulj <= t.tx) {
                    for (int a = 0; a < 3; ++a) jown[(j - off[1]) * 3 + a] = fj[a];
                    continue;
                }
                if (ulj == 0) continue;         // no home reaches the cell before the tile
            }
            const float* sh;
            const long long jc = union_cell(g, t, dz, dy0 + q, ulj, shifts, sh);
            const int pl = rho == 0 ? 0 : 3 * rho - 2 + (ulj == t.tx + 1 ? 1 : ulj == 0 ? 2 : 0);
            float* dst = part + (pl * M + jc * C + meta_slot(ej)) * 3;
            for (int a = 0; a < 3; ++a) dst[a] = fj[a];
        }
        __syncthreads();                        // before the next plane is staged
    }
    // each home: its warps' sums in warp order, then its own row's j side
    for (int p = threadIdx.x; p < nh; p += blockDim.x) {
        float f[3] = {0.f, 0.f, 0.f};
        for (int ww = 0; ww < nw; ++ww)
            for (int a = 0; a < 3; ++a) f[a] += acch[(ww * HC + p) * 3 + a];
        for (int a = 0; a < 3; ++a) frc[(long long)hslot[p] * 3 + a] = f[a] + jown[p * 3 + a];
    }
}

// Each live particle: frc += its partial planes, in a fixed order: the
// four rows' own x-range, then, for the first cell of a tile, the own
// row's and the four rows' right halo of the tile before, then, for the
// last cell, the four rows' left halo of the tile after.
__global__ void n3l_fold_kernel(float* __restrict__ frc, const float* __restrict__ part,
                                const int* __restrict__ tag, const Geom g, const int TX) {
    const long long M = (long long)g.nx * g.ny * g.nz * g.C;
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= M || tag[q] < 0) return;
    const int cx = (int)((q / g.C) % g.nx);
    const bool first = cx % TX == 0, last = cx % TX == TX - 1 || cx == g.nx - 1;
    float f[3];
    for (int a = 0; a < 3; ++a) f[a] = frc[q * 3 + a];
    auto add = [&](const int pl) {
        for (int a = 0; a < 3; ++a) f[a] += part[(pl * M + q) * 3 + a];
    };
    for (int rho = 1; rho <= 4; ++rho) add(3 * rho - 2);
    if (first) {
        add(0);
        for (int rho = 1; rho <= 4; ++rho) add(3 * rho - 1);
    }
    if (last)
        for (int rho = 1; rho <= 4; ++rho) add(3 * rho);
    for (int a = 0; a < 3; ++a) frc[q * 3 + a] = f[a];
}

template <int EV, bool TYPED>
static cudaError_t launch_n3l(const float* pos, const int* tag, const int* typ,
                              const float* shifts, const float* par, const int np, const int T,
                              float* frc, float* part, const Geom g, const int TX,
                              cudaStream_t st) {
    const size_t smem = n3l_smem_bytes(g.C, TX, TYPED ? (2 + np) * T * T : 0);
    cudaError_t e = set_smem(n3l_kernel<EV, TYPED>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((g.nx + TX - 1) / TX, g.ny, g.nz);
    n3l_kernel<EV, TYPED><<<grid, kN3lThreads, smem, st>>>(pos, tag, typ, shifts, par, np, T,
                                                            g, TX, frc, part);
    return cudaGetLastError();
}

}  // namespace hoomd_torch

using namespace hoomd_torch;

extern "C" {

// pos (nc, C, 3), tag (nc, C), adj (nc, 27), shifts (nc, 27, 3),
// ljp [lj1, lj2, rc2, e_shift]; frc (nc, C, 3), pe (nc, C), vir (nc, C, 6).
int hoomd_cell_pair_lj(const float* pos, const int* tag, const int* adj, const float* shifts,
                       const float* ljp, float* frc, float* pe, float* vir, int nc, int C,
                       void* stream) {
    const size_t smem = stencil_smem_bytes(C);
    cudaError_t e = set_smem(lj_adj_kernel, smem);
    if (e != cudaSuccess) return e;
    lj_adj_kernel<<<nc, threads_for(C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, adj, shifts, ljp, C, frc, pe, vir);
    return cudaGetLastError();
}

// pos (nz, ny, nx, C, 3) cell-major, tag, shifts (nc, 27, 3), ljp as above;
// frc (nc, C, 3).
int hoomd_cell_pair_lj3d(const float* pos, const int* tag, const float* shifts,
                         const float* ljp, float* frc, int nx, int ny, int nz, int C,
                         void* stream) {
    const size_t smem = (size_t)2 * C * (3 * sizeof(float) + 1);
    cudaError_t e = set_smem(lj_3d_kernel, smem);
    if (e != cudaSuccess) return e;
    lj_3d_kernel<<<nx * ny * nz, threads_for(C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, shifts, ljp, Geom{nx, ny, nz, C}, frc);
    return cudaGetLastError();
}

// As hoomd_cell_pair_lj3d, in tiles of tx cells of an x-row (tx * C <= 1024).
int hoomd_cell_pair_lj_row(const float* pos, const int* tag, const float* shifts,
                           const float* ljp, float* frc, int nx, int ny, int nz, int C, int tx,
                           void* stream) {
    const size_t smem = (size_t)(tx + 2) * C * (3 * sizeof(float) + 1);
    cudaError_t e = set_smem(lj_row_kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((nx + tx - 1) / tx, ny, nz);
    lj_row_kernel<<<grid, threads_for(tx * C), smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, shifts, ljp, Geom{nx, ny, nz, C}, tx, frc);
    return cudaGetLastError();
}

// pos, tag, shifts as above, typ (nc, C) (a mixture only, else null), par
// [rc2, e_shift, *pnames] of evaluator ev, or with ntypes > 1 the
// (2 + np, ntypes, ntypes) table; frc (nc, C, 3); part a (13, nc * C, 3)
// scratch buffer; tiles of tx cells of an x-row.  Two launches.
int hoomd_cell_pair_n3l(const float* pos, const int* tag, const int* typ, const float* shifts,
                        const float* par, int np, int ntypes, float* frc, float* part, int nx,
                        int ny, int nz, int C, int ev, int tx, void* stream) {
    if (ntypes < 1 || ntypes > kMaxTypes || np < 0 || np > kMaxPnames || tx < 1 || tx > 64)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geom g{nx, ny, nz, C};
    cudaError_t e = dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return ntypes > 1
                   ? launch_n3l<EV, true>(pos, tag, typ, shifts, par, np, ntypes, frc, part, g,
                                          tx, st)
                   : launch_n3l<EV, false>(pos, tag, typ, shifts, par, np, 1, frc, part, g, tx,
                                           st);
    });
    if (e != cudaSuccess) return e;
    const long long m = (long long)nx * ny * nz * C;
    n3l_fold_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(frc, part, tag, g, tx);
    return cudaGetLastError();
}

// The build and occupancy of the half stencil's kernel of evaluator ev
// (kernel_occupancy's out[5]), one type or a mixture (typed, a table of
// ntab floats), at capacity C and tiles of tx cells.
int hoomd_n3l_occupancy(int ev, int typed, int C, int tx, int ntab, int* out) {
    return dispatch_eval(ev, [&](auto t) {
        constexpr int EV = decltype(t)::value;
        return typed ? kernel_occupancy(n3l_kernel<EV, true>, kN3lThreads,
                                        n3l_smem_bytes(C, tx, ntab), out)
                     : kernel_occupancy(n3l_kernel<EV, false>, kN3lThreads,
                                        n3l_smem_bytes(C, tx, 0), out);
    });
}

}  // extern "C"
