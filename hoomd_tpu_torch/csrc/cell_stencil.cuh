// 27-cell pair stencil shared by the cell kernels (cell_pair.cu,
// cell_pair_typed.cu, cell_step.cu, cell_pair_impls.cu).
//
// It computes what the TPU kernels of hoomd_tpu/ops/pallas_pair.py
// compute (_kernel_plane, _kernel_planar, _kernel_step_plane, the force
// pass of _kernel_megastep): for every particle of a home cell, the pair
// force (and, when asked, the half-pair energy and virial) against every
// particle of the 27 surrounding cells, each neighbour cell carrying the
// periodic image shift of build_cell_shifts.  It does not copy their
// plane windows or lane rolls.
//
// Layout: one thread block per home cell, thread i owns slot i.  The
// block stages the 27 neighbour cells (coordinates plus shift, and a
// validity byte) into shared memory — 27*C*13 bytes, 14 KB at C = 40 —
// and every thread walks the 27*C candidates in the same order, so each
// shared-memory read is a broadcast.
//
// Rules kept from the JAX kernels, and made explicit:
//   * validity comes from tag >= 0, never from coordinate magnitude, so
//     padding slots (PAD_COORD) never pair;
//   * the self pair (centre cell, same slot) is excluded by index;
//   * dr = xi - (xj + shift) directly, never the expanded
//     |xi|^2 + |xj|^2 - 2 xi.xj form, which loses digits at |x| ~ 20;
//   * r^2 is clamped to 1e-3 before the evaluator, and the energy skips
//     r^2 <= 1e-6, as _kernel_planar does; r^2 itself rounds as the plain
//     version's torch ops, so both cut the same pairs at r_cut;
//   * only lj takes the fast reciprocal (under a thermostat); every other
//     evaluator divides exactly, as the JAX kernels do.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hoomd_torch {

// Per-slot 3-vectors with explicit strides: component a of slot s lives
// at p[s * ss + a * cs].  (nc, C, 3) arrays have ss = 3, cs = 1; plane
// arrays (3, nz, ny, nx, C) have ss = 1, cs = nc * C.
struct Vec3 {
    float* p;
    long long ss, cs;
    __device__ __forceinline__ float& at(long long s, int a) const {
        return p[s * ss + a * cs];
    }
};

struct Geom {
    int nx, ny, nz, C;
};

// Shared-memory bytes one block of the stencil needs.
__host__ __device__ inline size_t stencil_smem_bytes(int C) {
    return (size_t)27 * C * (3 * sizeof(float) + 1);
}

// Slot of entry k (build_cell_shifts order: (dz, dy, dx), dx fastest) of
// the stencil of `cell`, and the shift it is seen under.
__device__ __forceinline__ long long stencil_slot(const Geom g, const int cell, const int k,
                                                  const int s) {
    const int ix = cell % g.nx;
    const int iy = (cell / g.nx) % g.ny;
    const int iz = cell / (g.nx * g.ny);
    const int jx = (ix + k % 3 - 1 + g.nx) % g.nx;
    const int jy = (iy + (k / 3) % 3 - 1 + g.ny) % g.ny;
    const int jz = (iz + k / 9 - 1 + g.nz) % g.nz;
    return (long long)(jx + g.nx * (jy + g.ny * jz)) * g.C + s;
}

// Stage the 27 neighbour cells of `cell` into sx/sy/sz/sv.
__device__ inline void stage_stencil(const Vec3 pos, const int* __restrict__ tag,
                                     const float* __restrict__ shifts, const Geom g,
                                     const int cell, float* sx, float* sy, float* sz,
                                     unsigned char* sv) {
    const int n = 27 * g.C;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / g.C;
        const long long slot = stencil_slot(g, cell, k, t - k * g.C);
        const float* sh = shifts + ((long long)cell * 27 + k) * 3;
        sx[t] = pos.at(slot, 0) + sh[0];
        sy[t] = pos.at(slot, 1) + sh[1];
        sz[t] = pos.at(slot, 2) + sh[2];
        sv[t] = tag[slot] >= 0;
    }
}

// ---------------------------------------------------------------------------
// The evaluators of hoomd_tpu_torch/ops/pair_eval.py, by the id the host
// passes (pair_eval.EVAL_IDS, FAST_EVALS order).  Each reads its
// parameters q[] in the order of pair_eval.kernel_pnames: its derived
// table names sorted, then rcut.  The line "pv <name>: ..." of each is
// that order; tests/test_torch_evaluators.py holds it to kernel_pnames.
enum Eval {
    EV_LJ = 0,             // pv lj: lj1 lj2 rcut
    EV_GAUSS = 1,          // pv gauss: epsilon sigma2 rcut
    EV_YUKAWA = 2,         // pv yukawa: epsilon kappa rcut
    EV_MORSE = 3,          // pv morse: D0 alpha r0 rcut
    EV_MIE = 4,            // pv mie: c_m c_n m n rcut
    EV_BUCKINGHAM = 5,     // pv buckingham: A C rho rcut
    EV_LJ1208 = 6,         // pv lj1208: lj1 lj2 rcut
    EV_FSLJ = 7,           // pv force_shifted_lj: lj1 lj2 rcut
    EV_DPD = 8,            // pv dpd_conservative: A rcut
    EV_MOLIERE = 9,        // pv moliere: Zsq aF rcut
    EV_COUNT = 10
};

// Most parameters an evaluator reads after [rc2, e_shift] (mie: 5).
constexpr int kMaxPnames = 6;

// The parameter vector [rc2, e_shift, *pnames] of one launch.
struct PairPar {
    float rc2, e_shift;
    float q[kMaxPnames];
};

__device__ __forceinline__ PairPar load_pair_par(const float* __restrict__ pv, const int np) {
    PairPar P;
    P.rc2 = pv[0];
    P.e_shift = pv[1];
#pragma unroll
    for (int k = 0; k < kMaxPnames; ++k) P.q[k] = k < np ? pv[2 + k] : 0.0f;
    return P;
}

// The LJ-only kernels' parameters as a PairPar of EV_LJ.
__host__ __device__ inline PairPar lj_par(const float rc2, const float e_shift,
                                          const float lj1, const float lj2) {
    return PairPar{rc2, e_shift, {lj1, lj2, 0.f, 0.f, 0.f, 0.f}};
}

__device__ __forceinline__ void lj_raw(const float r2i, const float lj1, const float lj2,
                                       float& f, float& e) {
    const float r6i = r2i * r2i * r2i;
    f = r2i * r6i * (12.0f * lj1 * r6i - 6.0f * lj2);
    e = r6i * (lj1 * r6i - lj2);
}

// (force_divr, energy) of evaluator EV at r2 (already clamped), in the
// operation order of its pair_eval.energy_force.
template <int EV, bool APPROX>
__device__ __forceinline__ void eval_pair(const float r2, const float* q, float& f,
                                          float& e) {
    if constexpr (EV == EV_LJ) {
        lj_raw(APPROX ? __fdividef(1.0f, r2) : 1.0f / r2, q[0], q[1], f, e);
    } else if constexpr (EV == EV_GAUSS) {
        e = q[0] * expf(-0.5f * r2 / q[1]);
        f = e / q[1];
    } else if constexpr (EV == EV_YUKAWA) {
        const float r = sqrtf(r2);
        e = q[0] * expf(-q[1] * r) / r;
        f = e * (q[1] * r + 1.0f) / r2;
    } else if constexpr (EV == EV_MORSE) {
        const float r = sqrtf(r2);
        const float ex = expf(-q[1] * (r - q[2]));
        e = q[0] * (ex * ex - 2.0f * ex);
        f = 2.0f * q[0] * q[1] * (ex * ex - ex) / r;
    } else if constexpr (EV == EV_MIE) {
        const float r = sqrtf(r2);
        const float rn = powf(r, -q[3]);
        const float rm = powf(r, -q[2]);
        e = q[1] * rn - q[0] * rm;
        f = (q[3] * q[1] * rn - q[2] * q[0] * rm) / r2;
    } else if constexpr (EV == EV_BUCKINGHAM) {
        const float r = sqrtf(r2);
        const float ex = q[0] * expf(-r / q[2]);
        const float r2i = 1.0f / r2;
        const float r6i = r2i * r2i * r2i;
        e = ex - q[1] * r6i;
        f = ex / (q[2] * r) - 6.0f * q[1] * r6i * r2i;
    } else if constexpr (EV == EV_LJ1208) {
        const float r2i = 1.0f / r2;
        const float r4i = r2i * r2i;
        const float r8i = r4i * r4i;
        e = q[0] * r8i * r4i - q[1] * r8i;
        f = r2i * r8i * (12.0f * q[0] * r4i - 8.0f * q[1]);
    } else if constexpr (EV == EV_FSLJ) {
        const float rc = q[2];
        float f_rc, e_rc;
        lj_raw(1.0f / r2, q[0], q[1], f, e);
        lj_raw(1.0f / (rc * rc), q[0], q[1], f_rc, e_rc);
        const float r = sqrtf(r2);
        const float fmag_rc = f_rc * rc;
        f = f - fmag_rc / r;
        e = e - e_rc + (r - rc) * fmag_rc;
    } else if constexpr (EV == EV_DPD) {
        const float r = sqrtf(r2);
        const float rc = q[1];
        const float w = fmaxf(1.0f - r / rc, 0.0f);
        e = 0.5f * q[0] * rc * w * w;
        f = q[0] * w / r;
    } else {
        static_assert(EV == EV_MOLIERE, "unknown evaluator");
        const float r = sqrtf(r2);
        const float aF = q[1];
        const float c[3] = {0.35f, 0.55f, 0.10f};
        const float d[3] = {0.3f, 1.2f, 6.0f};
        float es = 0.0f, fs = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float ex = expf(-d[k] * r / aF);
            es = es + c[k] * ex;
            fs = fs + c[k] * ex * (1.0f / r + d[k] / aF);
        }
        const float pref = q[0] / r;
        f = pref * fs / r;
        e = pref * es;
    }
}

// One candidate at (dx, dy, dz) = x_i - x_j from slot i: adds the force
// (3) and, with PV, the full-pair energy (1) and virial (6, order xx, xy,
// xz, yy, yz, zz) to acc.  Nothing is added outside r_cut.  APPROX picks
// the fast reciprocal of lj under a thermostat; it means nothing for the
// other evaluators.
template <int EV, bool APPROX, bool PV>
__device__ __forceinline__ void pair_acc(const float dx, const float dy, const float dz,
                                         const PairPar& P, float* acc) {
    // r^2 rounded as torch's separate ops, (dx dx + dy dy) + dz dz, with no
    // FMA contraction: a pair within an ulp of r_cut is in or out alike in
    // the kernel and its plain version
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (!(r2 < P.rc2)) return;
    float fdivr, e;
    eval_pair<EV, APPROX && EV == EV_LJ>(fmaxf(r2, 1e-3f), P.q, fdivr, e);
    acc[0] += fdivr * dx;
    acc[1] += fdivr * dy;
    acc[2] += fdivr * dz;
    if (PV) {
        if (r2 > 1e-6f) acc[3] += e - P.e_shift;
        acc[4] += fdivr * dx * dx;
        acc[5] += fdivr * dx * dy;
        acc[6] += fdivr * dx * dz;
        acc[7] += fdivr * dy * dy;
        acc[8] += fdivr * dy * dz;
        acc[9] += fdivr * dz * dz;
    }
}

// Sum over the n staged candidates for the slot at (xi, yi, zi), skipping
// the invalid ones and the candidate `self` (-1: none); acc as pair_acc's,
// energy and virial for the caller to halve.
template <int EV, bool APPROX, bool PV>
__device__ inline void stencil_sum(const float xi, const float yi, const float zi,
                                   const int self, const int n, const float* sx,
                                   const float* sy, const float* sz,
                                   const unsigned char* sv, const PairPar& P, float* acc) {
    for (int t = 0; t < n; ++t) {
        if (!sv[t] || t == self) continue;
        pair_acc<EV, APPROX, PV>(xi - sx[t], yi - sy[t], zi - sz[t], P, acc);
    }
}

// ---------------------------------------------------------------------------
// Mixtures of up to kMaxTypes particle types: the typed branches of
// _kernel_planar and _kernel_planar_n3l.  The parameter table is the
// (2 + np, T, T) tensor [rc2, e_shift, *pnames], entry [k, ti, tj] at
// (k * T + ti) * T + tj.  The TPU mixes it per pair with one-hot sums (its
// kernels have no gather); here a block copies the table into shared
// memory once, each thread keeps the row of its own type ti in registers,
// and a candidate of type tj selects column tj.  A staged candidate's
// byte holds its type plus one, 0 for an invalid slot.
constexpr int kMaxTypes = 4;
constexpr int kParRows = 2 + kMaxPnames;

// The staging byte of a slot: 0 for padding, else its type plus one, the
// type clamped to [0, T) so that no lookup leaves the table.
__device__ __forceinline__ unsigned char type_byte(const int tag, const int typ, const int T) {
    return tag >= 0 ? (unsigned char)(min(max(typ, 0), T - 1) + 1) : (unsigned char)0;
}

// The table into shared memory, block-wide (the caller synchronises).
__device__ inline void stage_table(const float* __restrict__ par, const int n, float* tab) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) tab[t] = par[t];
}

// As stage_stencil, with each candidate's type byte.
__device__ inline void stage_stencil_typed(const Vec3 pos, const int* __restrict__ tag,
                                           const int* __restrict__ typ, const int T,
                                           const float* __restrict__ shifts, const Geom g,
                                           const int cell, float* sx, float* sy, float* sz,
                                           unsigned char* sv) {
    const int n = 27 * g.C;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int k = t / g.C;
        const long long slot = stencil_slot(g, cell, k, t - k * g.C);
        const float* sh = shifts + ((long long)cell * 27 + k) * 3;
        sx[t] = pos.at(slot, 0) + sh[0];
        sy[t] = pos.at(slot, 1) + sh[1];
        sz[t] = pos.at(slot, 2) + sh[2];
        sv[t] = type_byte(tag[slot], typ[slot], T);
    }
}

// Row ti of every parameter of the table in shared memory.
struct TypedRow {
    float v[kParRows][kMaxTypes];
};

__device__ __forceinline__ TypedRow load_typed_row(const float* tab, const int np, const int T,
                                                   const int ti) {
    TypedRow R;
#pragma unroll
    for (int k = 0; k < kParRows; ++k)
#pragma unroll
        for (int c = 0; c < kMaxTypes; ++c)
            R.v[k][c] = (k < 2 + np && c < T) ? tab[(k * T + ti) * T + c] : 0.0f;
    return R;
}

// Column tj of one row, selected in registers.
__device__ __forceinline__ float pick(const float (&col)[kMaxTypes], const int tj) {
    float x = col[0];
#pragma unroll
    for (int c = 1; c < kMaxTypes; ++c) x = tj == c ? col[c] : x;
    return x;
}

// One candidate of type tj, as pair_acc with the pair's own parameters
// (exact divide): the cut tests r^2 < rc2[ti, tj], r^2 rounded as
// pair_acc rounds it, and only a pair inside it picks the others.
template <int EV, bool PV>
__device__ __forceinline__ void typed_pair_acc(const float dx, const float dy, const float dz,
                                               const TypedRow& R, const int tj, float* acc) {
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (!(r2 < pick(R.v[0], tj))) return;
    PairPar P;
    P.rc2 = pick(R.v[0], tj);
    P.e_shift = pick(R.v[1], tj);
#pragma unroll
    for (int k = 0; k < kMaxPnames; ++k) P.q[k] = pick(R.v[2 + k], tj);
    pair_acc<EV, false, PV>(dx, dy, dz, P, acc);
}

// stencil_sum over typed candidates.
template <int EV, bool PV>
__device__ inline void typed_stencil_sum(const float xi, const float yi, const float zi,
                                         const int self, const int n, const float* sx,
                                         const float* sy, const float* sz,
                                         const unsigned char* sv, const TypedRow& R,
                                         float* acc) {
    for (int t = 0; t < n; ++t) {
        const int b = sv[t];
        if (!b || t == self) continue;
        typed_pair_acc<EV, PV>(xi - sx[t], yi - sy[t], zi - sz[t], R, b - 1, acc);
    }
}

// ---------------------------------------------------------------------------
// Block reductions in a fixed order (no atomics): the result is valid in
// thread 0, and equal inputs give equal bits.

__device__ inline float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;
}

__device__ inline float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, o));
    return x;
}

// Sum (MAX = false) or maximum (MAX = true) of x over the block.
template <bool MAX = false>
__device__ inline float block_reduce(float x) {
    __shared__ float red[32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    x = MAX ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[wid] = x;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    x = (threadIdx.x < nw) ? red[threadIdx.x] : (MAX ? -CUDART_INF_F : 0.0f);
    if (wid == 0) x = MAX ? warp_max(x) : warp_sum(x);
    __syncthreads();
    return x;
}

__device__ inline float block_sum(float x) { return block_reduce<false>(x); }

// ---------------------------------------------------------------------------
// Host side.

// Threads of a block of n slots: whole warps.
static inline int threads_for(int n) { return ((n + 31) / 32) * 32; }

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename K>
static inline cudaError_t set_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Run fn(EvalTag<EV>{}) for the evaluator id ev, so a launcher
// instantiates its kernel for all ten evaluators.
template <int E>
struct EvalTag {
    static constexpr int value = E;
};

template <typename Fn>
inline cudaError_t dispatch_eval(const int ev, Fn&& fn) {
    switch (ev) {
        case EV_LJ: return fn(EvalTag<EV_LJ>{});
        case EV_GAUSS: return fn(EvalTag<EV_GAUSS>{});
        case EV_YUKAWA: return fn(EvalTag<EV_YUKAWA>{});
        case EV_MORSE: return fn(EvalTag<EV_MORSE>{});
        case EV_MIE: return fn(EvalTag<EV_MIE>{});
        case EV_BUCKINGHAM: return fn(EvalTag<EV_BUCKINGHAM>{});
        case EV_LJ1208: return fn(EvalTag<EV_LJ1208>{});
        case EV_FSLJ: return fn(EvalTag<EV_FSLJ>{});
        case EV_DPD: return fn(EvalTag<EV_DPD>{});
        case EV_MOLIERE: return fn(EvalTag<EV_MOLIERE>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace hoomd_torch
