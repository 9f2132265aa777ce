// Hand-written Hopper kernels of the LJ engine's other force paths, chosen
// by HOOMD_TPU_FAST_IMPL (hoomd_tpu_torch/ops/cell_pair.py binds them
// through ctypes):
//
// hoomd_cell_pair_lj      replaces hoomd_tpu/ops/pallas_pair.py:_kernel
//                         ('pallas'): a cell against the 27 cells its row of
//                         the adjacency table lists; forces, half-pair
//                         energy and virial.
// hoomd_cell_pair_lj3d    replaces pallas_pair.py:_kernel3d ('pallas3d'): a
//                         cell against its 27 modular-indexed neighbours;
//                         forces.
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
//   * lj, lj3d, lj_row: one walk (cell_walk.cuh), three sources of the
//     staged cells.  A block stages the cells its homes meet once,
//     compacted to their live slots, with a bounding box per cell, and a
//     warp takes a home at a time: its lanes stride over the staged
//     entries of the cells whose box lies inside the home's cut, and the
//     pairs inside the cut are evaluated 32 at a time, a pair per lane (as
//     the charged kernel, cell_pair_charged.cu).  lj: a block per cell, the
//     27 cells its row of the table lists.  lj3d: the same kernel with the
//     modular index in place of the table's row and the forces alone (one
//     template, two instances).  lj_row: a block per tile of tx cells of an
//     x-row stages the tile's union, each (dz, dy) row's tx + 2 cells once
//     for dx = -1, 0, +1 of every home: 9 (tx + 2) staged cells for tx
//     cells instead of 27 per cell (18 per cell at the 2 cells per tile
//     the wrapper takes at the bench plan, ops/cell_pair.py row_tile).
//     The first designs left most of a block idle and walked every staged
//     slot, padding included: lj a thread per slot of the cell (40
//     threads busy at the bench plan); lj3d one neighbour at a time into
//     a double buffer behind 27 barriers; lj_row a thread per slot of the
//     tile (TX C threads), each (dz, dy) row staged behind two barriers,
//     and every thread walked the row's 3 C slots of its dx = -1, 0, +1
//     cells under a divergent in-cut branch.
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

#include "cell_walk.cuh"

namespace hoomd_torch {

// ---------------------------------------------------------------------------
// lj and lj3d: the 27-cell stencil of a cell, a warp per home
// (cell_walk.cuh).  lj = [lj1, lj2, rc2, e_shift].
//
// A block takes a cell and kWalkWarps warps.  It stages the cell's 27
// neighbours once (NB_ADJ: the cells its row of the table lists, an id
// outside [0, nc) listing nothing; NB_MOD: the modular index of
// build_cell_shifts' order, as _kernel3d reads them), each entry's image
// shift applied, compacted to the live slots, with each staged cell's
// bounding box; on a grid 1 or 2 cells wide a cell listed under two shifts
// is two staged cells, each with its own box.  A warp takes a home at a
// time and walks the cells inside its cut (the skip drops ~45% of the
// candidates at the bench plan).  The self pair is excluded by index: the home's own entry
// under the first table entry that lists its cell under no shift (NB_MOD:
// entry 13; an entry listed twice counts twice).  PV: the forces,
// half-pair energy and virial (row 4), else the forces alone (row 5).

constexpr int NB_ADJ = 0, NB_MOD = 1;    // where a cell's 27 neighbours come from

template <int NB, bool PV>
__global__ void __launch_bounds__(kWalkWarps * 32)
    lj_adj_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                  const int* __restrict__ adj, const float* __restrict__ shifts,
                  const float* __restrict__ ljp, const Geom g, float* __restrict__ frc,
                  float* __restrict__ pe, float* __restrict__ vir) {
    extern __shared__ float4 smem4[];
    __shared__ int self_k;
    constexpr int NA = PV ? 10 : 3;             // the sums a home keeps
    const int C = g.C;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const WalkSmem S = walk_smem(smem4, 1, C);
    const int cell = blockIdx.x, nc = gridDim.x;
    const int* row = NB == NB_ADJ ? adj + (long long)cell * 27 : nullptr;
    const int ix = cell % g.nx, iy = (cell / g.nx) % g.ny, iz = cell / (g.nx * g.ny);
    const float* shc = shifts + (long long)cell * 27 * 3;
    for (int s = threadIdx.x; s < C; s += blockDim.x) {   // the padding slots' outputs
        const long long slot = (long long)cell * C + s;
        if (tag[slot] >= 0) continue;
        for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = 0.0f;
        if (PV) {
            pe[slot] = 0.0f;
            for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.0f;
        }
    }
    if (threadIdx.x == 0) {
        // the entry that lists this cell itself under no image shift
        int sk = NB == NB_MOD ? 13 : -1;
        for (int k = 0; k < 27 && sk < 0; ++k)
            if (row[k] == cell && shc[3 * k] == 0.0f && shc[3 * k + 1] == 0.0f &&
                shc[3 * k + 2] == 0.0f)
                sk = k;
        self_k = sk;
    }
    // the homes: the cell's live slots, in slot order (the barriers of the
    // compaction publish self_k)
    compact_cells(
        1, C, tag, [&](const int) { return (long long)cell; }, S.hstart,
        [&](const int, const int s, const int idx, const long long) { S.hslot[idx] = s; });
    const int nh = S.hstart[1];
    if (nh == 0) return;                        // the whole block: no live home
    // the 27 neighbours, in table order, compacted
    compact_cells(
        27, C, tag,
        [&](const int k) -> long long {
            if (NB == NB_MOD)
                return wrap(ix + k % 3 - 1, g.nx) +
                       g.nx * (wrap(iy + (k / 3) % 3 - 1, g.ny) +
                               (long long)g.ny * wrap(iz + k / 9 - 1, g.nz));
            return row[k] < 0 || row[k] >= nc ? -1LL : (long long)row[k];
        },
        S.off,
        [&](const int k, const int, const int idx, const long long sl) {
            S.ent[idx] = make_float4(pos[sl * 3 + 0] + shc[3 * k + 0],
                                     pos[sl * 3 + 1] + shc[3 * k + 1],
                                     pos[sl * 3 + 2] + shc[3 * k + 2], 0.0f);
        });
    stage_boxes(27, S.ent, S.off, S.box);
    __syncthreads();
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float4* L = S.lst + w * kWalkList;
    for (int p = w; p < nh; p += kWalkWarps) {  // warp-uniform
        const long long slot = (long long)cell * C + S.hslot[p];
        float acc[NA];
        walk_home<EV_LJ, false, PV>(pos[slot * 3 + 0], pos[slot * 3 + 1], pos[slot * 3 + 2],
                                    self_k >= 0 ? S.off[self_k] + p : -1, S.ent, S.box, S.off,
                                    3, 0, lj, L, acc);
        if (lane == 0) {
            for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
            if (PV) {
                pe[slot] = 0.5f * acc[3];
                for (int c = 0; c < 6; ++c) vir[slot * 6 + c] = 0.5f * acc[4 + c];
            }
        }
        __syncwarp();                           // the list is read before the next home
    }
}

// ---------------------------------------------------------------------------
// lj_row: a tile of tx <= TX cells of an x-row (grid: tiles, ny, nz), forces
// alone.  The block stages the tile's union once (cell_tile.cuh: the 9
// (dz, dy) rows of tx + 2 cells, each row's cells seen under the shift of
// the home cells that reach them), compacted to the live slots, with each
// union cell's box: each row serves dx = -1, 0, +1 of every home of the
// tile, 9 (tx + 2) staged cells for tx cells against 27 per cell.  On a
// grid 1 or 2 cells wide a cell of a row is two or three union cells,
// each under its own shift and with its own box.  The homes are the
// tile's live slots (pack_homes); a warp per home walks union cells
// lc .. lc + 2 of each row (cell_walk.cuh).  The self pair: row (0, 0),
// union cell lc + 1, the home's rank among its cell's live slots.

__global__ void __launch_bounds__(kWalkWarps * 32)
    lj_row_kernel(const float* __restrict__ pos, const int* __restrict__ tag,
                  const float* __restrict__ shifts, const float* __restrict__ ljp, const Geom g,
                  const int TX, float* __restrict__ frc) {
    extern __shared__ float4 smem4[];
    const int C = g.C;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const WalkSmem S = walk_smem(smem4, TX, C);
    const Tile t = tile_of_block(g, TX);
    const long long cell0 = (long long)t.x0 + g.nx * (t.iy + (long long)g.ny * t.iz);
    for (int q = threadIdx.x; q < t.tx * C; q += blockDim.x)   // the padding slots' forces
        if (tag[cell0 * C + q] < 0)
            for (int a = 0; a < 3; ++a) frc[(cell0 * C + q) * 3 + a] = 0.0f;
    pack_homes(tag, g, t, S.hslot, S.hstart);
    const int nh = S.hstart[t.tx];
    if (nh == 0) return;                        // the whole block: no live home
    stage_union(tag, shifts, g, t, 0, 9, S.off,
                [&](const int idx, const int, const int, const long long sl, const float* sh) {
                    S.ent[idx] = make_float4(pos[sl * 3 + 0] + sh[0], pos[sl * 3 + 1] + sh[1],
                                             pos[sl * 3 + 2] + sh[2], 0.0f);
                });
    stage_boxes(9 * t.W, S.ent, S.off, S.box);
    __syncthreads();
    const PairPar lj = lj_par(ljp[2], ljp[3], ljp[0], ljp[1]);
    float4* L = S.lst + w * kWalkList;
    for (int p = w; p < nh; p += kWalkWarps) {  // warp-uniform
        const long long slot = S.hslot[p];
        const int lc = home_cell(S.hstart, t.tx, p);
        float acc[3];
        walk_home<EV_LJ, false, false>(pos[slot * 3 + 0], pos[slot * 3 + 1], pos[slot * 3 + 2],
                                       S.off[4 * t.W + lc + 1] + p - S.hstart[lc], S.ent,
                                       S.box, S.off, t.W, lc, lj, L, acc);
        if (lane == 0)
            for (int a = 0; a < 3; ++a) frc[slot * 3 + a] = acc[a];
        __syncwarp();                           // the list is read before the next home
    }
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
    const size_t smem = walk_smem_bytes(1, C);
    auto kern = lj_adj_kernel<NB_ADJ, true>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<nc, 32 * kWalkWarps, smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, adj, shifts, ljp, Geom{nc, 1, 1, C}, frc, pe, vir);
    return cudaGetLastError();
}

// The build and occupancy of the adjacency-listed LJ kernel at capacity
// C (kernel_occupancy's out[5]) and its threads per block (out[5]).
int hoomd_cell_pair_lj_occupancy(int C, int* out) {
    out[5] = 32 * kWalkWarps;
    return kernel_occupancy(lj_adj_kernel<NB_ADJ, true>, out[5], walk_smem_bytes(1, C), out);
}

// pos (nz, ny, nx, C, 3) cell-major, tag, shifts (nc, 27, 3), ljp as above;
// frc (nc, C, 3).
int hoomd_cell_pair_lj3d(const float* pos, const int* tag, const float* shifts,
                         const float* ljp, float* frc, int nx, int ny, int nz, int C,
                         void* stream) {
    const size_t smem = walk_smem_bytes(1, C);
    auto kern = lj_adj_kernel<NB_MOD, false>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<nx * ny * nz, 32 * kWalkWarps, smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, nullptr, shifts, ljp, Geom{nx, ny, nz, C}, frc, nullptr, nullptr);
    return cudaGetLastError();
}

// The same for the modular-indexed kernel (hoomd_cell_pair_lj3d).
int hoomd_cell_pair_lj3d_occupancy(int C, int* out) {
    out[5] = 32 * kWalkWarps;
    return kernel_occupancy(lj_adj_kernel<NB_MOD, false>, out[5], walk_smem_bytes(1, C), out);
}

// As hoomd_cell_pair_lj3d, in tiles of tx cells of an x-row (tx * C <=
// kUnionSlots).
int hoomd_cell_pair_lj_row(const float* pos, const int* tag, const float* shifts,
                           const float* ljp, float* frc, int nx, int ny, int nz, int C, int tx,
                           void* stream) {
    if (tx < 1 || tx * C > kUnionSlots) return cudaErrorInvalidValue;
    const size_t smem = walk_smem_bytes(tx, C);
    cudaError_t e = set_smem(lj_row_kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((nx + tx - 1) / tx, ny, nz);
    lj_row_kernel<<<grid, 32 * kWalkWarps, smem, static_cast<cudaStream_t>(stream)>>>(
        pos, tag, shifts, ljp, Geom{nx, ny, nz, C}, tx, frc);
    return cudaGetLastError();
}

// The same for the row kernel (hoomd_cell_pair_lj_row) at tiles of tx cells.
int hoomd_cell_pair_lj_row_occupancy(int C, int tx, int* out) {
    out[5] = 32 * kWalkWarps;
    return kernel_occupancy(lj_row_kernel, out[5], walk_smem_bytes(tx, C), out);
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
