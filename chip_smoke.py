#!/usr/bin/env python3
"""Smoke run of hoomd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository.  In order it prints:
  1. the torch/CUDA versions and the card (nvidia-smi name, power limit);
  2. the time to build the CUDA kernels from hoomd_tpu_torch/csrc;
  3. one phase per kernel: the kernel against its plain torch version at
     the 64k bench shape (cell grid (14, 14, 12), C = 40, N = 64 000 in a
     jittered-lattice liquid-like fill) and at one ragged small shape,
     element by element, with the largest error and CUDA-event times,
     failing past tolerance; the fused step (cell_step_plane_planes) NVE
     and NVT also on a 2x2x2 grid, its drifted positions bit for bit;
  3a. per other pair evaluator (EVAL_JOBS), at the bench fill: the plane,
     planar and fused-step kernels against their plain versions with the
     evaluator's ATOL (EVAL_ATOL);
  3b. the megastep (megastep_phases) at the bench, ragged and 2x2x2
     shapes: its candidate set (counts, lists) against the plain
     builder bit for bit, with its build time; for LJ and each other
     evaluator, nve, nvt and langevin, k = 1 and 4, one window against
     the plain megastep; for LJ also a window at the edge of the drift
     guard (every pair inside r_cut a candidate) and one past it (equal
     danger flags); two runs of every LJ window at the bench shape equal
     bit for bit, and equal to a window whose lists overflow.  Where a copy of the parent's cell_pair.cu lies under
     scratch/parent_megastep (an ignored directory; a checkout has none),
     parent_megastep_phase builds it under another name and holds the
     parent's megastep against the new one bit for bit and in turns by
     time.  Then the torch calls the engine issues per window
     (window_torch_calls);
  4. one phase per rebin kernel (cell_rebin_select, cell_rebin_sweep,
     cell_rebin_place, cell_rebin_serial): the kernel against its plain
     torch version bit for bit, slot for slot, with equal overflow flags,
     on lattice fills drifted up to 0.45 of a cell width at the bench
     shape and at (5, 3, 4), C = 32, and on two overflowing fills;
  5. one phase per HPMC sweep kernel (fused_poly_sweep,
     fused_sphere_sweep): the kernel against its plain torch version on
     the same planes, class orders and uniforms at three shapes (the job
     script's plan, a 32^3-lattice fill, a ragged grid), with equal try
     counts, every slot within 1e-5 (positions) and 1e-6 (quaternions)
     but for at most 1 flipped decision per 10^4 trials (each printed
     with its cell), and CUDA-event times;
  4a. one phase per force kernel of the other HOOMD_TPU_FAST_IMPL paths
     (cell_pair_lj, cell_pair_lj_pallas3d, cell_pair_lj_row,
     cell_pair_planar_n3l): the kernel against its plain torch version at
     the bench shape, the ragged shape and a 2x2x2 grid, as in 3; then
     the cross-kernel phase: on the bench fill the four kernels' forces
     and cell_pair_plane's agree, and cell_pair_lj's PE and virial
     cell_pair_planar's;
  4b. the mixtures' kernels (typed_kernel_phases) at the Kob-Andersen
     shape (64 000 particles at rho = 1.2 on the engine's plan of the
     KA start): for every evaluator the typed planar kernel (two and four
     types) and the half stencil (one, two and four types) against their
     plain versions with the evaluator's ATOL, each with its CUDA-event
     time; for the KA table also the device time, the plain version's
     time and the bound;
  6. the bench.py job script (64k LJ, Langevin melt then Nose-Hoover NVT)
     through ``import hoomd_tpu_torch as hoomd`` on --mode=gpu, on its
     default rebin (xsel at this N), with all three launch counters > 0
     and a candidate set built, finite output, T = 1.2 +- 0.03 and PE/N
     in [-4.80, -4.60], its busy share over 1024 profiled steps and the
     device time of its megastep windows and rebuild cycle; then the
     same script to the melt plus 1000 NVT steps with HOOMD_TPU_REBIN=pallas
     (the sweep and place kernels launched) and =off (the sort), each with
     the same gates and its rebuild and retry counts; then the op's three
     variants through cell_rebin_plane on the pallas job's state, and one
     rebuild of each rebin the engine runs (sort, xsel, the migration
     sweep + place) on that job's liquid, by CUDA events and by the
     profiler's device time; then the same script to the melt plus 1000
     NVT steps with HOOMD_TPU_FAST_IMPL = planar_n3l, pallas, pallas3d and
     row, and with plane plus HOOMD_TPU_MEGA=off, each with the same
     gates, its kernel launched and the megastep not, the rebin of its
     gate, the ms per step of a timed 500-step window and the device's
     busy share over 50 profiled steps; then the same with
     HOOMD_TPU_MEGA=off HOOMD_TPU_FUSED=on (the fused step launched, the
     megastep not) and its NVE continuation, gated on the energy drift;
     then a 64 000-particle job per other pair evaluator on the default
     path (T, a fluid's mean-square displacement, the megastep launched,
     the end state's PE against the plain version's); then the
     Kob-Andersen 80:20 melt (ka_script: 64 000 particles, 2000 Langevin
     and 500 + 1000 Nose-Hoover steps at kT = 1) on the typed planar kernel:
     finite, T = 1 +- 0.03 over the NVT window, every tag's type kept, no
     single-type stencil launched, the kernel's F, PE and virial on the
     end state against its plain version's, ms per step, busy share, and a
     1000-step NVE continuation gated on its drift; and the same script
     with HOOMD_TPU_FAST_IMPL=planar_n3l (300 NVT steps, the typed half
     stencil launched).  The bench job's T and PE/N must equal PR 6's
     bit for bit;
  7. the BASELINE.json config-5 job script (4096 hard cubes at phi = 0.4,
     50 settle and 200 timed sweeps) and the hard-sphere job (4096
     spheres at a = 1.05), each with its metric line, zero overlaps
     after the run, translate acceptance within 0.03 of the JAX
     package's value for the script, and its kernel launched; then a
     torch.profiler trace of 50 more sweeps (device busy share, device
     time by kernel);
  8. the evaluators' kernel times, the kernels' JSON line (each with its
     bound: the larger of the bytes its inputs and outputs move over
     3.35 TB/s and the operations this run's data needs over 67 TFLOP/s
     fp32), the card line, and the final {"ok": true, "device": {...}}
     line.
Every path runs with the launch counters set to 0 just before it and
read just after.  It exits non-zero without a CUDA device, outside a
checkout, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

RHO = 0.8442
# a kernel against its plain version, element by element:
# |kernel - plain| <= ATOL + RTOL * |plain|.  RTOL covers the two sides'
# different summation order over ~1000 candidates per slot (and the
# 2-ulp reciprocal of the thermostat paths) on the large forces of close
# pairs; ATOL, about 3x the largest force error measured at the bench
# shape, is far below the force of one pair at the cutoff (0.039), so a
# kernel that drops or adds pairs near r_cut fails.
RTOL, ATOL = 1e-4, 1e-3
# positions after a k-step window, absolute (|x| <= 21, f32 ulp ~2e-6).
# The window's forces are held to the plain stencil at the positions the
# kernel reached, not to the plain window's: one ulp of position moves
# the force on a particle between two close neighbours by ~1e-3.
POS_TOL = 1e-4
GAMMA = 1.0                     # Langevin drag of the megastep phases
# the fills of the force kernel phases: lattice dims, cell grid, capacity
SHAPES = {'bench': ((40, 40, 40), (14, 14, 12), 40),
          'ragged': ((9, 11, 14), (3, 4, 5), 37),
          '2x2x2': ((6, 6, 6), (2, 2, 2), 40)}
TEMP_TARGET, TEMP_TOL = 1.2, 0.03
PE_RANGE = (-4.80, -4.60)
# an NVE continuation's energy drift, per particle per 1000 steps
NVE_DRIFT_MAX = 1e-3
# the bench job's T and PE/N after its timed window in PR 6's chip runs
# (NVIDIA H100 80GB HBM3, 700 W).  The job's trajectory depends on the
# data alone (deterministic kernels, the cadence controller reads no
# clock), so the single-type path must reproduce them bit for bit; a
# change that alters that path's arithmetic on purpose says so and
# records the new values here
PR6_BENCH_T, PR6_BENCH_PE = 1.1909790651919536, -4.693221126138524

# the H100 SXM's published peaks: HBM bytes/s
# and fp32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12

# HPMC: a kernel slot against its plain version (positions are |x| <= 22,
# an f32 ulp ~2e-6; unit quaternions); at most one flipped decision per
# FLIP_PER trials
MC_POS_TOL, MC_QUAT_TOL, FLIP_PER = 1e-5, 1e-6, 10000
PHI_CUBES = 0.4
CUBE_VERTS = [(sx / 2, sy / 2, sz / 2) for sx in (-1, 1) for sy in (-1, 1)
              for sz in (-1, 1)]
# translate acceptance of each job script in the JAX package, and the band
# the port must fall in: hoomd_tpu's fused path (its default on the TPU)
# at the script's n = 16, in interpret mode on the CPU, as
# `PYTHONPATH=. python tests/test_torch_hpmc.py {cube|sphere}` derives
# them (tests/test_torch_hpmc.py::test_sphere_job_acceptance_reference
# checks the sphere value in the CPU suite)
CUBE_TRANSLATE_ACC, SPHERE_TRANSLATE_ACC, ACC_BAND = 0.3930, 0.2889, 0.03


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def lattice_cells(dims, cell_dim, C, jitter, seed, dev):
    """Cell-major carry of a jittered sc lattice at rho* = 0.8442 with
    Maxwell velocities at T = 1.2, binned by the engine's own rebin."""
    from hoomd_tpu_torch import lattice
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    from hoomd_tpu_torch.state import state_from_snapshot
    a = (1.0 / RHO) ** (1.0 / 3.0)
    snap = lattice.sc(a=a).get_snapshot().replicate(*dims)
    N = snap.particles.N
    rng = np.random.RandomState(seed)
    snap.particles.position[:] += rng.uniform(-jitter, jitter, (N, 3)) * a
    v = rng.normal(0, np.sqrt(1.2), (N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    st = state_from_snapshot(snap, dev)
    to_fast, _, _, _ = build_fast_lj_chunk(
        N=N, box=st.box, cell_dim=cell_dim, C=C, r_buff=0.4, rcut=2.5,
        method_kind='nvt', method_seed=0, device=dev)
    carry = to_fast(st, {})
    if bool(carry.overflow):
        raise RuntimeError(f"test fill overflows C={C} on {cell_dim}")
    L = st.box.L.cpu().numpy().astype(np.float64)
    return carry, L, N, st.box


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def compare(name, outputs):
    """Check (label, kernel, plain, rtol, atol) outputs element by
    element against |kernel - plain| <= atol + rtol |plain|, and print
    the element that comes closest to its bound.  Returns the largest
    absolute error and that element's share of its bound."""
    import torch
    worst_abs, worst = 0.0, (-1.0, '', 0.0, 0.0)
    for label, g, w, rtol, atol in outputs:
        g = torch.as_tensor(g).double().reshape(-1)
        w = torch.as_tensor(w).double().reshape(-1)
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name} {label}: kernel output not finite")
        err = (g - w).abs()
        share = err / (atol + rtol * w.abs())
        i = int(share.argmax())
        worst_abs = max(worst_abs, float(err.max()))
        if float(share[i]) > worst[0]:
            worst = (float(share[i]), label, float(err[i]),
                     float(w[i].abs()))
    share, label, err, mag = worst
    print(f"  {name}: max_abs_err={worst_abs:.3e}; closest to its bound: "
          f"{label} err={err:.3e} at |plain|={mag:.4g}, {share:.3f} of "
          f"the bound", flush=True)
    if share > 1.0:
        raise RuntimeError(f"{name}: {label} differs past |kernel - plain| "
                           f"<= atol + rtol |plain|")
    return worst_abs, share


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def lj_pair_counts(pos, tag, cdim, sh, rc):
    """Candidate pairs (two live slots of the 27-cell stencil, not the
    same particle) and pairs inside r_cut, of a cell-major fill."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    adj = torch.as_tensor(cp._adjacency_np(tuple(cdim)), dtype=torch.int64,
                          device=pos.device)
    live = tag >= 0
    C = pos.shape[1]
    eye = torch.eye(C, dtype=torch.bool, device=pos.device)
    cand = inr = 0
    for o in range(27):
        nb = pos[adj[:, o]] + sh[:, o, None, :]
        d = pos[:, :, None, :] - nb[:, None, :, :]
        ok = live[:, :, None] & live[adj[:, o]][:, None, :]
        if o == 13:
            ok &= ~eye
        cand += int(ok.sum())
        inr += int((ok & ((d * d).sum(-1) < rc * rc)).sum())
    return cand, inr


def lj_bounds(pos, tag, cdim, sh, N, k):
    """Bound of each LJ kernel at this fill, counting 8 operations per
    candidate pair (the r^2 test), 15 more per pair inside r_cut for the
    force, 12 more for PE and virial (planar, lj), and 30 per particle
    and step for a megastep window's kick, drift and thermostat sums.
    The half stencil visits half the candidate pairs and puts 3 more
    operations (the -F on j) on each pair inside r_cut."""
    cand, inr = lj_pair_counts(pos, tag, cdim, sh, 2.5)
    slots = pos.shape[0] * pos.shape[1]
    P = slots * 4                                  # one f32 per slot
    sh_bytes = sh.numel() * 4
    adj_bytes = sh.numel() // 3 * 4
    plane_ops = 8 * cand + 15 * inr
    force = bound(3 * P + P + sh_bytes + 3 * P, plane_ops)
    return {
        'cell_pair_plane': force,
        'cell_pair_planar': bound(3 * P + P + sh_bytes + 10 * P,
                                  plane_ops + 12 * inr),
        # in: pos, vel, frc, ref pos (3 planes each), 1/m, m, tags;
        # out: pos, vel, frc
        'cell_megastep_planes': bound(15 * P + sh_bytes + 9 * P,
                                      k * (plane_ops + 30 * N)),
        # in: pos, vel, frc, ref pos (3 planes each), 1/m, tags; out:
        # pos, vel, frc, and per slot the drift, kick and sums (30 ops)
        'cell_step_plane_planes': bound(14 * P + sh_bytes + 9 * P,
                                        plane_ops + 30 * N),
        'cell_pair_lj': bound(3 * P + P + adj_bytes + sh_bytes + 10 * P,
                              plane_ops + 12 * inr),
        'cell_pair_lj_pallas3d': force,
        'cell_pair_lj_row': force,
        'cell_pair_planar_n3l': bound(3 * P + P + sh_bytes + 3 * P,
                                      (8 * cand + 18 * inr) / 2),
    }


def kernel_phases(dev):
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    results = {}
    pv, _ = lj_params(dev)
    for tag_name in ('bench', 'ragged'):
        dims, cdim, C = SHAPES[tag_name]
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag = carry.pos, carry.tag
        iters = 50 if tag_name == 'bench' else 5
        piters = 3 if tag_name == 'bench' else 1
        row = {}
        # ---- cell_pair_plane (thermostat path: approx reciprocal)
        def k_plane():
            return cp.cell_pair_plane(pos, cdim, sh, pv, C=C, cell_tag=tag,
                                      recip='approx')

        def p_plane():
            return cp.cell_pair_plane_plain(pos, cdim, sh, pv, cell_tag=tag)
        ea, er = compare(f'cell_pair_plane[{tag_name}]',
                         [('F', k_plane(), p_plane(), RTOL, ATOL)])
        row['cell_pair_plane'] = dict(max_abs_err=ea, bound_share=er,
                                      ms=cuda_ms(k_plane, iters),
                                      plain_ms=cuda_ms(p_plane, piters))
        # ---- cell_pair_planar
        def k_planar():
            return cp.cell_pair_planar(pos, cdim, sh, pv, C=C, cell_tag=tag)

        def p_planar():
            return cp.cell_pair_planar_plain(pos, cdim, sh, pv,
                                             cell_tag=tag)
        ea, er = compare(f'cell_pair_planar[{tag_name}]',
                         [(lab, g, w, RTOL, ATOL) for lab, g, w in
                          zip(('F', 'pe', 'virial'), k_planar(),
                              p_planar())])
        row['cell_pair_planar'] = dict(max_abs_err=ea, bound_share=er,
                                       ms=cuda_ms(k_planar, iters),
                                       plain_ms=cuda_ms(p_planar, piters))
        for kname, r in row.items():
            print(f"phase {kname} [{tag_name} cell_dim={cdim} C={C} N={N}]: "
                  f"max_abs_err={r['max_abs_err']:.3e} "
                  f"bound_share={r['bound_share']:.3f} "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}",
                  flush=True)
        for kname, (b_ms, b_by) in lj_bounds(pos.reshape(-1, C, 3),
                                             tag.reshape(-1, C), cdim, sh,
                                             N, 4).items():
            if kname in row:
                row[kname].update(bound_ms=b_ms, bound_by=b_by)
        results[tag_name] = row
    return results['bench']


def plane_state(carry, cdim, C, sh, pv, eval_kw=None):
    """Plane-layout (3, nz, ny, nx, C) state of a cell-major fill: pos,
    vel, the plain stencil's forces, 1/m, tags, and a reference position
    0.02 behind each live slot's (so md2 > 0)."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    nx, ny, nz = cdim
    plane4 = (nz, ny, nx, C)

    def planes(a):
        return a.reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2,
                                                   3).contiguous()
    frc = cp.cell_pair_plane_plain(carry.pos, cdim, sh, pv,
                                   cell_tag=carry.tag, **(eval_kw or {}))
    live = (carry.tag >= 0)[..., None]
    ref = torch.where(live, carry.pos - 0.02, carry.pos)
    return dict(gp=planes(carry.pos), gv=planes(carry.vel), gf=planes(frc),
                gw=(1.0 / carry.mass).reshape(plane4),
                gm=carry.mass.reshape(plane4), gr=planes(ref),
                gt=carry.tag.reshape(plane4))


def check_step(name, got, want, rtol, atol):
    """A fused step against its plain version: positions bit for bit (the
    drift rounds each operation as torch's separate ops), velocities and
    forces element by element, ke2 and md2 to the sums' rounding."""
    import torch
    if not torch.equal(got[0], want[0]):
        raise RuntimeError(f"{name}: drifted positions differ from the "
                           f"plain version's (max "
                           f"{float((got[0] - want[0]).abs().max()):.3e})")
    return compare(name, [('vel', got[1], want[1], rtol, atol),
                          ('frc', got[2], want[2], rtol, atol),
                          ('ke2', got[3], want[3], 1e-5, 0.0),
                          ('md2', got[4], want[4], 1e-5, 0.0)])


def step_plane_phases(dev):
    """cell_step_plane_planes against its plain version, NVE (exact
    divide, s = 1) and NVT (fast reciprocal, s < 1), at the bench shape,
    the ragged shape and a 2x2x2 grid.  Returns the bench row (times of
    the NVT variant, the fused NVT job's)."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    pv, _ = lj_params(dev)
    out = {}
    for tag_name, (dims, cdim, C) in SHAPES.items():
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        st = plane_state(carry, cdim, C, sh, pv)
        worst = (0.0, 0.0)
        for method, recip, s in (('nve', 'div', 1.0),
                                 ('nvt', 'approx', float(np.exp(-0.0025 * 0.2)))):
            s_t = torch.tensor(s, dtype=torch.float32, device=dev)
            args = (st['gp'], st['gv'], st['gf'], st['gw'], st['gr'], cdim,
                    sh, pv, 0.005, s_t)

            def k_step():
                return cp.cell_step_plane_planes(*args, C=C, gt=st['gt'],
                                                 recip=recip)

            def p_step():
                return cp.cell_step_plane_planes_plain(*args, C=C,
                                                       gt=st['gt'])
            ea, er = check_step(f'cell_step_plane_planes[{tag_name},{method}]',
                                k_step(), p_step(), RTOL, ATOL)
            worst = (max(worst[0], ea), max(worst[1], er))
        iters = 50 if tag_name == 'bench' else 5
        row = dict(max_abs_err=worst[0], bound_share=worst[1],
                   ms=cuda_ms(k_step, iters),
                   plain_ms=cuda_ms(p_step, 3 if tag_name == 'bench' else 1))
        row['bound_ms'], row['bound_by'] = lj_bounds(
            carry.pos, carry.tag, cdim, sh, N, 4)['cell_step_plane_planes']
        print(f"phase cell_step_plane_planes [{tag_name} cell_dim={cdim} "
              f"C={C} N={N}]: positions bit-exact, max_abs_err={worst[0]:.3e} "
              f"bound_share={worst[1]:.3f} kernel_ms={row['ms']:.4f} (nvt) "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']})", flush=True)
        if tag_name == 'bench':
            out['cell_step_plane_planes'] = row
    return out


# ---------------------------------------------------------------------------
# the other pair evaluators

# each evaluator's job: its coefficients and r_cut.  From the JAX
# package's tests where they have them (gauss, morse, yukawa, mie:
# tests/test_fast_engine.py:187-192; force_shifted_lj:
# tests/test_fast_bonded.py:184); for the others a set that holds a
# fluid at the bench density and kT = 1.2: buckingham the exp-6 form with
# alpha = 13 fitted to LJ's minimum (A = 6/7 e^13, rho = 2^(1/6)/13,
# C = 13/7 2^(1/3)), its barrier before the collapse ~7000 kT high at
# r ~ 0.28; lj1208 at eps = sigma = 1; dpd_conservative at A = 25 on its
# usual r_cut = 1 (it plans its own grid); moliere at Z_i = Z_j = 2 in
# units of the elementary charge and a_0 = 1.
EVAL_JOBS = {
    'gauss': (dict(epsilon=1.0, sigma=0.8), 2.5),
    'yukawa': (dict(epsilon=1.5, kappa=1.0), 2.5),
    'morse': (dict(D0=0.5, alpha=3.0, r0=1.0), 2.5),
    'mie': (dict(epsilon=1.0, sigma=1.0, n=12.0, m=6.0), 2.5),
    'buckingham': (dict(A=3.8e5, rho=0.0863, C=3.71), 2.5),
    'lj1208': (dict(epsilon=1.0, sigma=1.0), 2.5),
    'force_shifted_lj': (dict(epsilon=1.0, sigma=1.0), 2.5),
    'dpd_conservative': (dict(A=25.0), 1.0),
    'moliere': (dict(Z_i=2.0, Z_j=2.0), 2.5),
}
# each evaluator's ATOL in the kernel phases, derived as the LJ one:
# about 3x the largest error of force, PE or virial measured on the bench
# fill (NVIDIA H100 80GB HBM3, 700 W: gauss 1.9e-6, yukawa 1.9e-6, morse 2.9e-6, mie 2.1e-4,
# buckingham 9.2e-5, lj1208 1.2e-4, force_shifted_lj 1.5e-4,
# dpd_conservative 4.8e-7, moliere 3.8e-6), rounded up to 1, 2 or 5, and
# far below the force of one pair at r_cut - 0.05 (0.035, 0.074, 0.038,
# 0.045, 0.042, 0.0096, 0.0059, 1.25, 0.12), so a kernel that drops or
# adds a pair near the cutoff fails.  mie at n = 12, m = 6 is LJ and
# takes LJ's.
EVAL_ATOL = {'gauss': 1e-5, 'yukawa': 1e-5, 'morse': 1e-5, 'mie': ATOL,
             'buckingham': 5e-4, 'lj1208': 5e-4, 'force_shifted_lj': 5e-4,
             'dpd_conservative': 2e-6, 'moliere': 2e-5}


def eval_params(name, dev):
    """[rc2, e_shift, *pnames] of the evaluator's job coefficients in
    shift mode (float32 tables derived on the host, as the System does),
    its pnames, and |F| of one pair at r_cut - 0.05."""
    import torch
    from hoomd_tpu_torch.ops import pair_eval
    ev = pair_eval.ALL_EVALUATORS[name]
    coeffs, rc = EVAL_JOBS[name]
    raw = dict(ev.defaults)
    raw.update(coeffs)
    tab = {k: torch.tensor(np.float32(np.asarray(v)), device=dev)
           for k, v in ev.derive({k: np.float32(v)
                                  for k, v in raw.items()}).items()}
    tab['rcut'] = torch.tensor(np.float32(rc), device=dev)
    rc2 = tab['rcut'] * tab['rcut']
    _, es = ev.energy_force(rc2, tab)
    pn = pair_eval.kernel_pnames(name)
    pv = torch.stack([rc2, es] + [tab[k] for k in pn]).float()
    r = torch.tensor(np.float32(rc - 0.05), device=dev)
    f_edge = float(ev.energy_force(r * r, tab)[0] * r)
    return pv, pn, abs(f_edge)


def eval_kernel_phases(dev):
    """Per evaluator, at the bench fill: cell_pair_plane,
    cell_pair_planar and cell_step_plane_planes (NVE) against their plain
    versions, element by element with the evaluator's ATOL, and each
    kernel's CUDA-event time (the megastep's: megastep_phases)."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    dims, cdim, C = SHAPES['bench']
    carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    _, sh = cp.build_cell_shifts(cdim, L)
    sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
    pos, tag = carry.pos, carry.tag
    rows = {}
    for name in EVAL_JOBS:
        pv, pn, f_edge = eval_params(name, dev)
        atol = EVAL_ATOL[name]
        ek = dict(eval_name=name, pnames=pn)
        st = plane_state(carry, cdim, C, sh, pv, ek)
        one = torch.ones((), device=dev)
        sargs = (st['gp'], st['gv'], st['gf'], st['gw'], st['gr'], cdim, sh,
                 pv, 0.005, one)
        calls = {
            'cell_pair_plane': (
                lambda: cp.cell_pair_plane(pos, cdim, sh, pv, C=C,
                                           cell_tag=tag, **ek),
                lambda: cp.cell_pair_plane_plain(pos, cdim, sh, pv,
                                                 cell_tag=tag, **ek)),
            'cell_pair_planar': (
                lambda: cp.cell_pair_planar(pos, cdim, sh, pv, C=C,
                                            cell_tag=tag, **ek),
                lambda: cp.cell_pair_planar_plain(pos, cdim, sh, pv,
                                                  cell_tag=tag, **ek)),
            'cell_step_plane_planes': (
                lambda: cp.cell_step_plane_planes(*sargs, C=C, gt=st['gt'],
                                                  recip='div', **ek),
                lambda: cp.cell_step_plane_planes_plain(*sargs, C=C,
                                                        gt=st['gt'], **ek)),
        }
        row = {}
        for kname, (kern, plain) in calls.items():
            got, want = kern(), plain()
            label = f'{kname}[{name}]'
            if kname == 'cell_step_plane_planes':
                ea, _ = check_step(label, got, want, RTOL, atol)
            else:
                if not isinstance(got, tuple):
                    got, want = (got,), (want,)
                ea, _ = compare(label, [
                    (lab, g, w, RTOL, atol)
                    for lab, g, w in zip(('F', 'pe', 'virial'), got, want)])
            row[kname] = dict(max_abs_err=ea, ms=cuda_ms(kern, 20))
        rows[name] = row
        print(f"phase evaluator {name} [bench cell_dim={cdim} C={C} N={N}] "
              f"pnames={pn} ATOL={atol:g} |F| of one pair at r_cut - 0.05 "
              f"{f_edge:.4g}: " + ', '.join(
                  f"{k} {r['ms']:.4f} ms (max_abs_err {r['max_abs_err']:.3e})"
                  for k, r in row.items()), flush=True)
    return rows


# ---------------------------------------------------------------------------
# the megastep and its candidate set

# A window's velocities (and xi, eta, ke2, mdmax) against the plain
# window's: the two sides' positions part by an ulp (the kernel's drift
# contracts to FMA, the plain version's separate ops do not), and a pair
# within an ulp of r_cut is then in on one side and out on the other: it
# moves a velocity by dt/2 |F(r_cut)|, 3e-4 for moliere at dt = 0.005
# (its |F| at r_cut ~0.1), far above its force ATOL (2e-5), which holds
# forces compared at the same positions.  So the window's outputs take
# ATOL (1e-3) for every evaluator, and the forces, compared at the
# positions the kernel reached, keep the evaluator's ATOL.  The window PR
# 5 checked (NVT, k = 4, at the bench fill) keeps the evaluator's ATOL
# throughout.  Measured: moliere's float32 stencil at the bench fill
# differs from float64 by 0.095 on one force (a pair at r_cut), the
# parent kernel and the new one by no bit.
MEGA_OUT_ATOL = ATOL
GUARD_FRAC = 0.999       # the guard-edge window's drift, of each axis' skin
GUARD_PAIRS = 400        # pairs it moves at most, 4 per cell
GUARD_DT = 1e-4          # its step: a particle 0.8 from another moves less
                         # than 1e-5 in 4 steps, within the guard's slack
WIDE_SKIN = 4.0          # skins whose candidates overflow the lists


def guard_edge_state(st, cdim, C, sh, skin, rc, seed):
    """The plane state of ``st`` with its positions drifted from the
    reference planes gr to the edge of the megastep's guard: disjoint
    pairs outside r_cut at the reference, whose bound lets them come
    inside (0.8 - 0.98 r_cut^2), each moved toward the other by
    GUARD_FRAC / 2 of each axis' skin, so the two largest drifts of an
    axis sum to GUARD_FRAC of its skin; a move that would bring either
    particle within 0.8 of another is not made.  The moved particles are
    at rest.  Returns the new state and the number of pairs moved."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    nx, ny, nz = cdim
    nc = nx * ny * nz
    gr = st['gr'].permute(1, 2, 3, 4, 0).reshape(nc, C, 3).cpu().numpy()
    pos = gr.copy()
    live = (st['gt'].reshape(nc, C) >= 0).cpu().numpy()
    adj = cp._adjacency_np(tuple(cdim))
    shn = sh.cpu().numpy()
    step = (np.float32(0.5 * GUARD_FRAC)
            * np.asarray(skin.cpu(), np.float32).reshape(3))
    rng = np.random.RandomState(seed)
    moved = np.zeros((nc, C), bool)
    rc2 = rc * rc

    def crowded(c, i):
        nb = (pos[adj[c]] + shn[c][:, None, :]).reshape(-1, 3)
        dd = nb[live[adj[c]].reshape(-1)] - pos[c, i]
        r2 = np.sort((dd * dd).sum(-1))
        return r2[1] < 0.64                 # r2[0]: the particle itself

    npairs = 0
    for c in rng.permutation(nc):
        if npairs >= GUARD_PAIRS:
            break
        dr = pos[c][:, None, None, :] - (pos[adj[c]]
                                         + shn[c][:, None, :])[None]
        m = np.maximum(np.abs(dr) - 2 * step, 0)
        lb = (m * m).sum(-1)
        ok = (((dr * dr).sum(-1) >= rc2) & (lb >= 0.8 * rc2)
              & (lb < 0.98 * rc2) & live[c][:, None, None]
              & live[adj[c]][None])
        in_cell = 0
        for i, k, j in np.argwhere(ok)[rng.permutation(int(ok.sum()))]:
            if in_cell == 4 or npairs >= GUARD_PAIRS:
                break
            cj = adj[c, k]
            if moved[c, i] or moved[cj, j] or (cj == c and j == i):
                continue
            sgn = np.sign(dr[i, k, j])
            old = pos[c, i].copy(), pos[cj, j].copy()
            pos[c, i] -= step * sgn
            pos[cj, j] += step * sgn
            if crowded(c, i) or crowded(cj, j):
                pos[c, i], pos[cj, j] = old
                continue
            moved[c, i] = moved[cj, j] = True
            npairs += 1
            in_cell += 1
    dev = st['gp'].device
    gp = torch.as_tensor(pos, device=dev).reshape(nz, ny, nx, C, 3).permute(
        4, 0, 1, 2, 3).contiguous()
    still = torch.as_tensor(moved, device=dev).reshape(nz, ny, nx, C)
    gv = torch.where(still[None], 0.0, st['gv']).contiguous()
    return dict(st, gp=gp, gv=gv), npairs


def missing_pairs(gp, gr, gt, cdim, sh, pads, rc2, C):
    """The pairs inside r_cut at gp (the candidate test with no skin: r^2
    < rc2, rounded as the kernels round it) that the candidate test at
    the reference gr with pads leaves out."""
    from hoomd_tpu_torch.ops import cell_pair as cp
    inside = cp.candidate_keep(gp.contiguous(), gt, cdim, sh,
                               np.zeros(3, np.float32), rc2, C=C)
    inside &= ~cp.candidate_keep(gr, gt, cdim, sh, pads, rc2, C=C)
    return int(inside.sum())


def same_candidates(name, cand, plain):
    """The kernel's candidate set against the plain version's (count,
    listed): the counts equal, and each slot's list equal as far as it is
    written."""
    import torch
    count, listed = plain
    if not torch.equal(cand.count, count):
        raise RuntimeError(f"{name}: the kernel's counts differ from the "
                           f"plain version's")
    n = torch.clamp(count, max=cand.cap).long()
    used = torch.arange(cand.cap, device=n.device)[None, :] < n[:, None]
    if not torch.equal(torch.where(used, cand.listed, 0), listed):
        raise RuntimeError(f"{name}: the kernel's candidate lists differ from "
                           f"the plain version's")


def candidates_bound(cand, n_live, sh, C):
    """Bound of one candidate build: 12 operations per pair it tests
    (each live slot against its 27 C staged entries: three differences,
    magnitudes, skins subtracted, clamps, squares and sums, one compare)
    against the bytes of the reference planes, tags and shifts in and of
    the written list entries and the counts out."""
    M = cand.count.numel()
    written = int(cand.count.clamp(max=cand.cap).sum())
    nbytes = (3 * M + M) * 4 + sh.numel() * 4 + written * 2 + M * 4
    return bound(nbytes, 12 * n_live * 27 * C)


def visited_bound(cand, pos, tag, cdim, sh, N, k):
    """A second bound of an LJ megastep window, beside lj_bounds' (which
    counts every staged pair, as the parent kernel walked them): the
    candidates the window visits, 8 operations each per step (the r^2
    test), 15 more per pair inside r_cut and 30 per particle and step,
    against lj_bounds' bytes plus the candidate lists and counts read."""
    _, inr = lj_pair_counts(pos, tag, cdim, sh, 2.5)
    slots = pos.shape[0] * pos.shape[1]
    P = slots * 4
    M = cand.count.numel()
    lists = int(cand.count.clamp(max=cand.cap).sum()) * 2 + M * 4
    ops = k * (8 * int(cand.count.sum()) + 15 * inr + 30 * N)
    return bound(15 * P + sh.numel() * 4 + 9 * P + lists, ops)


def megastep_phases(dev):
    """The megastep at the bench, ragged and 2x2x2 shapes.  Per shape:
    the candidate set of the kernel against its plain version, bit for
    bit; per pair evaluator, method (nve, nvt, langevin) and k in (1, 4),
    one window from the plain state (reference 0.02 behind) against the
    plain megastep, element by element (positions to POS_TOL, forces
    against the plain stencil at the positions the kernel reached, the
    rest to RTOL and the evaluator's ATOL), the guard held on both sides;
    for LJ also the guard-edge window (guard_edge_state), which holds the
    guard with every pair inside r_cut at its start and end in the
    candidate set, and a window whose skin of 0.03 trips the guard on
    both sides (past the trip the kernel walks every staged slot); at the
    bench shape two runs of every LJ window give equal bits, and so does
    the window with skins of WIDE_SKIN, whose lists overflow (every slot
    then walks every staged slot).  Returns the bench row of
    cell_megastep_planes (ms: one wrapper call of an NVT k = 4 window by
    CUDA events, the set built beforehand, as the engine builds it once
    per rebuild; beside it the engine's call, the device time and the
    bound of the candidates visited) and each evaluator's wrapper ms of
    that window."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    row, eval_ms = None, {}
    for tag_name, (dims, cdim, C) in SHAPES.items():
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        skin = torch.as_tensor(np.maximum(L / np.asarray(cdim) - 2.5, 0.4),
                               dtype=torch.float32, device=dev)
        pads = cp.candidate_pads(skin.cpu().numpy(), L)
        gen = torch.Generator(device=dev).manual_seed(5)
        worst = (0.0, 0.0)
        bench = tag_name == 'bench'
        for name in ('lj',) + tuple(EVAL_JOBS):
            if name == 'lj':
                pv, atol, ek = lj_params(dev)[0], ATOL, {}
            else:
                pv, pn, _ = eval_params(name, dev)
                atol, ek = EVAL_ATOL[name], dict(eval_name=name, pnames=pn)
            rc2 = float(pv[0])
            st = plane_state(carry, cdim, C, sh, pv, ek)
            gt = st['gt'].to(torch.int32).contiguous()
            plane4 = tuple(gt.shape)
            gn = ((torch.rand((4, 3) + plane4, generator=gen, device=dev) * 2
                   - 1) * 8.0 * (gt >= 0))
            states = [('plain state', st, skin)]
            if name == 'lj':
                edge, npairs = guard_edge_state(st, cdim, C, sh, skin, 2.5,
                                                seed=7)
                states.append(('guard edge', edge, skin))
                # a skin far below the drift: the guard trips in the
                # first step, and the kernel walks every staged slot
                states.append(('danger', st, torch.full_like(skin, 0.03)))
            for label, s, s_skin in states:
                gr = s['gr'].contiguous()
                s_pads = cp.candidate_pads(s_skin.cpu().numpy(), L)
                t0 = time.perf_counter()
                cand = cp.mega_candidates(gr, gt, cdim, sh, s_pads, rc2, C=C)
                torch.cuda.synchronize()
                if name == 'lj':
                    same_candidates(f'mega_candidates[{tag_name},{label}]',
                                    cand, cp.mega_candidates_plain(
                                        gr, gt, cdim, sh, s_pads, rc2, C=C))
                if name == 'lj' and label == 'plain state':
                    n_live = int((gt >= 0).sum())
                    per = int(cand.count.sum()) / n_live
                    ms = cuda_ms(lambda: cp.mega_candidates(
                        gr, gt, cdim, sh, pads, rc2, C=C), 20 if bench else 3)
                    print(f"phase mega_candidates [{tag_name} cell_dim={cdim} "
                          f"C={C} N={N}]: equal to the plain version bit for "
                          f"bit, lists too; {per:.1f} candidates per live "
                          f"slot (at most {int(cand.count.max())}) of "
                          f"{27 * C} staged; {ms:.4f} ms per build (CUDA "
                          f"events; first call {1e3 * (time.perf_counter() - t0):.1f} "
                          f"ms)", flush=True)
                    if bench:
                        cand_ms = dict(ms=ms, device_ms=device_ms(
                            lambda: cp.mega_candidates(gr, gt, cdim, sh, pads,
                                                       rc2, C=C), 10),
                            per_slot=per)
                        cand_ms['bound_ms'], cand_ms['bound_by'] = \
                            candidates_bound(cand, n_live, sh, C)
                dt = GUARD_DT if label == 'guard edge' else 0.005
                if label == 'guard edge':
                    missing = missing_pairs(s['gp'], gr, gt, cdim, sh,
                                            s_pads, rc2, C)
                    if missing:
                        raise RuntimeError(f"guard edge [{tag_name}]: {missing} "
                                           f"pairs inside r_cut are not "
                                           f"candidates")
                for method in ('nve', 'nvt', 'langevin'):
                    recip = 'div' if method == 'nve' else 'approx'
                    for k in (1, 4):
                        args = (s['gp'], s['gv'], s['gf'], s['gw'], s['gm'],
                                gr, cdim, sh, pv, dt,
                                torch.full((k,), 1.2, device=dev),
                                torch.tensor(0.1, device=dev),
                                torch.tensor(0.0, device=dev), s_skin)
                        kw = dict(C=C, k=k, method=method, gt=gt,
                                  ndof=3.0 * N, tau_inv2=4.0, gamma=GAMMA,
                                  gn=gn[:k] if method == 'langevin' else None,
                                  **ek)

                        def k_mega():
                            return cp.cell_megastep_planes(
                                *args, recip=recip, cand=cand, **kw)

                        def p_mega():
                            return cp.cell_megastep_planes_plain(*args, **kw)
                        got, want = k_mega(), p_mega()
                        lab = (f'cell_megastep_planes[{tag_name},{name},'
                               f'{label},{method},k={k}]')
                        if (bool(got[5]) != bool(want[5])
                                or bool(got[5]) != (label == 'danger')):
                            raise RuntimeError(f"{lab}: danger flags "
                                               f"{bool(got[5])} (kernel), "
                                               f"{bool(want[5])} (plain)")
                        if name == 'lj' and bench:
                            again = k_mega()
                            if not all(torch.equal(a, b)
                                       for a, b in zip(got, again)):
                                raise RuntimeError(f"{lab}: two runs differ")
                        if name == 'lj' and bench and label != 'danger':
                            # lists that overflow: every slot walks every
                            # staged slot, to the listed walk's bits (but
                            # the drift ratio, which the skin scales)
                            wide = cp.mega_candidates(
                                gr, gt, cdim, sh, cp.candidate_pads(
                                    WIDE_SKIN, L), rc2, C=C)
                            n_over = int((wide.count > wide.cap).sum())
                            if n_over == 0:
                                raise RuntimeError(f"{lab}: no list "
                                                   f"overflowed at skins "
                                                   f"{WIDE_SKIN}")
                            full = cp.cell_megastep_planes(
                                *args[:-1], torch.full_like(s_skin, WIDE_SKIN),
                                recip=recip, cand=wide, **kw)
                            if not all(torch.equal(got[i], full[i])
                                       for i in (0, 1, 2, 3, 4, 6)):
                                raise RuntimeError(f"{lab}: the walk of every "
                                                   f"staged slot differs from "
                                                   f"the listed walk")
                        if label == 'guard edge':
                            missing = missing_pairs(got[0], gr, gt, cdim, sh,
                                                    s_pads, rc2, C)
                            if missing:
                                raise RuntimeError(
                                    f"{lab}: {missing} pairs inside r_cut "
                                    f"are not candidates")
                        # the stencil part of the last step's force:
                        # Langevin adds the noise and the drag on the
                        # half-kicked velocity
                        f_st = got[2]
                        if method == 'langevin':
                            v_half = got[1] - 0.5 * dt * got[2] * s['gw']
                            f_st = got[2] - gn[k - 1] + GAMMA * v_half
                        f_own = cp.cell_pair_plane_plain(
                            got[0].permute(1, 2, 3, 4, 0).reshape(-1, C, 3),
                            cdim, sh, pv, cell_tag=carry.tag, **ek)
                        # the window's other outputs: PR 5's window (NVT,
                        # k = 4, the bench fill) to the evaluator's ATOL,
                        # the others to MEGA_OUT_ATOL
                        pr5 = (bench and method == 'nvt' and k == 4
                               and label == 'plain state')
                        out_atol = atol if pr5 else max(atol, MEGA_OUT_ATOL)
                        ea, er = compare(lab, [
                            ('pos', got[0], want[0], 0.0, POS_TOL),
                            ('frc at its own positions',
                             f_st.permute(1, 2, 3, 4, 0).reshape(-1, C, 3),
                             f_own, RTOL, atol)] + [
                            (lb, got[i], want[i], RTOL, out_atol)
                            for i, lb in
                            ((1, 'vel'), (3, 'xi'), (4, 'eta'), (6, 'ke2'),
                             (7, 'mdmax'))])
                        if name == 'lj':
                            worst = (max(worst[0], ea), max(worst[1], er))
                        if (bench and method == 'nvt' and k == 4
                                and label == 'plain state'):
                            eval_ms[name] = cuda_ms(k_mega, 20)
                            if name == 'lj':
                                t_p = cuda_ms(p_mega, 1)
                                eng = engine_window_ms(
                                    s, gt, cand, cp.MegaWorkspace(
                                        cdim, C, k, method, sh, pv, dt,
                                        s_skin, ndof=3.0 * N, tau_inv2=4.0,
                                        gamma=GAMMA, recip=recip), k)
                                eng['bound_visited_ms'], _ = visited_bound(
                                    cand, carry.pos, carry.tag, cdim, sh, N,
                                    k)
                                eng['wrapper_torch_calls'] = torch_calls(
                                    k_mega)
                if label == 'guard edge':
                    print(f"guard edge [{tag_name}]: {npairs} pairs moved to "
                          f"{GUARD_FRAC} of the guard; every window held it, "
                          f"and every pair inside r_cut at its start and end "
                          f"is a candidate", flush=True)
        print(f"phase cell_megastep_planes [{tag_name} cell_dim={cdim} C={C} "
              f"N={N}]: every evaluator, method and k in (1, 4) within "
              f"tolerance; LJ max_abs_err={worst[0]:.3e} bound_share="
              f"{worst[1]:.3f}" + (f"; two runs bit-identical, and the "
                                   f"walk of every staged slot ({n_over} "
                                   f"lists overflowed); NVT k = 4 "
                                   f"window {eval_ms['lj']:.4f} ms per "
                                   f"wrapper call (CUDA events), plain "
                                   f"{t_p:.4f} ms" if bench else ''),
              flush=True)
        if bench:
            row = dict(max_abs_err=worst[0], bound_share=worst[1],
                       ms=eval_ms['lj'], plain_ms=t_p)
            row['bound_ms'], row['bound_by'] = lj_bounds(
                carry.pos, carry.tag, cdim, sh, N, 4)['cell_megastep_planes']
            print("megastep window [bench, lj, nvt, k=4]: " + json.dumps(dict(
                wrapper_ms=row['ms'], bound_ms=row['bound_ms'], **eng)),
                flush=True)
            print(f"mega_candidates at the bench fill: {cand_ms['ms']:.4f} ms "
                  f"per build (CUDA events), device {cand_ms['device_ms']:.4f} "
                  f"ms, bound {cand_ms['bound_ms']:.6f} ms "
                  f"({cand_ms['bound_by']}), {cand_ms['per_slot']:.1f} "
                  f"candidates per live slot", flush=True)
    return row, eval_ms


def engine_window_ms(s, gt, cand, ws, k):
    """The main path's call of one megastep window (megastep_window on
    the engine's prepared planes, workspace and candidate set) from the
    plane state s, after restoring the start state: CUDA-event ms of
    restore + window and of the restore alone, and the profiler's device
    ms of the window kernel."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    dev = s['gp'].device
    bufs = [s[key].clone() for key in ('gp', 'gv', 'gf')]
    sc0 = torch.tensor([0.1, 0.0, 0.0, 0.0], device=dev)
    sc = sc0.clone()
    gw, gm = s['gw'].contiguous(), s['gm'].contiguous()
    kt = torch.full((k,), 1.2, device=dev)

    def restore():
        for b, key in zip(bufs, ('gp', 'gv', 'gf')):
            b.copy_(s[key])
        sc.copy_(sc0)

    def window():
        restore()
        cp.megastep_window(*bufs, gw, gm, gt, cand, ws, sc, kt)
    return dict(engine_ms=cuda_ms(window, 50), restore_ms=cuda_ms(restore, 50),
                device_ms=device_ms(window, 10, only='mega_window'))


def _engine_at_bench(dev, method):
    """A megastep program at the bench shape, its carry of the bench fill
    and its dyn (bench job's LJ, kT = 1.2, tau = 0.5, gamma = 1)."""
    import torch
    from hoomd_tpu_torch import lattice
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    from hoomd_tpu_torch.state import state_from_snapshot
    dims, cdim, C = SHAPES['bench']
    a = (1.0 / RHO) ** (1.0 / 3.0)
    snap = lattice.sc(a=a).get_snapshot().replicate(*dims)
    rng = np.random.RandomState(3)
    snap.particles.position[:] += rng.uniform(-0.1, 0.1, (snap.particles.N,
                                                         3)) * a
    v = rng.normal(0, np.sqrt(1.2), (snap.particles.N, 3))
    snap.particles.velocity[:] = v - v.mean(0)
    st = state_from_snapshot(snap, dev)
    to_fast, refresh, run, _ = build_fast_lj_chunk(
        N=st.N, box=st.box, cell_dim=cdim, C=C, r_buff=0.4, rcut=2.5,
        method_kind=method, method_seed=7, device=dev)
    pv, ljv = lj_params(dev)
    dyn = {'pv': pv, 'lj': ljv, 'dt': 0.005, 'tau': 0.5, 'gamma': 1.0,
           'kT': (torch.zeros(1, device=dev), torch.full((1,), 1.2,
                                                         device=dev))}
    z = torch.zeros((), device=dev)
    carry = refresh(to_fast(st, {'xi': z, 'eta': z} if method == 'nvt'
                            else {}), dyn)
    return run, carry, dyn


def torch_calls(fn):
    """The torch operations (aten calls, counted by a dispatch mode) one
    call of fn issues."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    with Count() as c:
        fn()
    return c.n


def window_torch_calls(dev, nw=8):
    """The torch operations the engine's megastep issues per window,
    beside its kernel launches, at the bench shape: for one window and per
    window of nw chained ones (one run_chunk rebuild cycle), NVT and
    Langevin.  Runs against any version of the package on the path."""
    out = {}
    for method in ('nvt', 'langevin'):
        run, carry, dyn = _engine_at_bench(dev, method)
        run.wins(carry, dyn, 1, 4)
        for n in (1, nw):
            out[f'{method} nw={n}'] = torch_calls(
                lambda: run.wins(carry, dyn, n, 4)) / n
    print(f"torch calls per megastep window at the bench shape (k = 4): "
          + ', '.join(f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


def parent_megastep_phase(dev, src='scratch/parent_megastep'):
    """Where a copy of the parent's cell_pair.cu and cell_stencil.cuh lies
    in ``src`` (an ignored directory; the checkout has none): build it
    under another library name and hold the parent's megastep (one launch
    per step phase) against the new one at the bench fill, from the same
    prepared buffers: their bits for every pair evaluator, method and k in
    (1, 4) on windows within the guard, and the time of an LJ NVT k = 4
    window (restore the start state, launch) in turns, parent, new, new,
    parent.  One more LJ window trips the guard in its first step: past
    the trip the new kernel walks every staged slot, as the parent did,
    so it gives the parent's bits there too."""
    import ctypes
    import torch
    from pathlib import Path
    from hoomd_tpu_torch.ops import _build, pair_eval
    from hoomd_tpu_torch.ops import cell_pair as cp
    d = Path(src)
    if not (d / 'cell_pair.cu').exists():
        print(f"parent megastep: no copy of the parent's cell_pair.cu under "
              f"{src}; skipped", flush=True)
        return None
    lib_path = d / 'libparent_cell_pair.so'
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib_path),
                    str(d / 'cell_pair.cu')], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hoomd_megastep.argtypes = [P] * 9 + [I] + [P] * 5 + [I] * 8 + [P]
    lib.hoomd_megastep.restype = I
    print(f"parent megastep built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dims, cdim, C = SHAPES['bench']
    nx, ny, nz = cdim
    carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    _, sh = cp.build_cell_shifts(cdim, L)
    sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
    skin = torch.as_tensor(np.maximum(L / np.asarray(cdim) - 2.5, 0.4),
                           dtype=torch.float32, device=dev)
    M = carry.tag.numel()
    nb = -(-M // 256)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(5)
    dpart = torch.empty((nb * 9,), device=dev)
    kpart = torch.empty((max(nb, nx * ny * nz),), device=dev)
    sc0 = torch.tensor([0.1, 0.0, 0.0, 0.0], device=dev)
    result, same, differ = {}, 0, []
    for name in ('lj',) + tuple(EVAL_JOBS):
        if name == 'lj':
            pv, ek = lj_params(dev)[0], {}
        else:
            pv, pn, _ = eval_params(name, dev)
            ek = dict(eval_name=name, pnames=pn)
        npn = len(ek.get('pnames', cp.LJ_PNAMES))
        ev = pair_eval.EVAL_IDS[name]
        st = plane_state(carry, cdim, C, sh, pv, ek)
        gt = st['gt'].to(torch.int32).contiguous()
        gw, gm = st['gw'].contiguous(), st['gm'].contiguous()
        gr = st['gr'].contiguous()
        cand = cp.mega_candidates(gr, gt, cdim, sh, cp.candidate_pads(
            skin.cpu().numpy(), L), float(pv[0]), C=C)
        gn = ((torch.rand((4, 3) + tuple(gt.shape), generator=gen,
                          device=dev) * 2 - 1) * 8.0 * (gt >= 0)).contiguous()
        cases = [(m, k, skin) for m in ('nve', 'nvt', 'langevin')
                 for k in (1, 4)]
        if name == 'lj':
            # past the guard: a skin of 0.03 trips it in the first step
            cases.append(('nvt', 4, torch.full_like(skin, 0.03)))
        for method, k, w_skin in cases:
            recip = 'div' if method == 'nve' else 'approx'
            if w_skin is not skin:
                cand = cp.mega_candidates(gr, gt, cdim, sh, cp.candidate_pads(
                    w_skin.cpu().numpy(), L), float(pv[0]), C=C)
            ws = cp.MegaWorkspace(cdim, C, k, method, sh, pv, 0.005,
                                  w_skin, ndof=3.0 * N, tau_inv2=4.0,
                                  gamma=GAMMA, recip=recip, **ek)
            kt = torch.full((k,), 1.2, device=dev)
            noise = gn[:k] if method == 'langevin' else None
            bufs = {who: [st[key].clone() for key in ('gp', 'gv', 'gf')]
                    + [sc0.clone()] for who in ('parent', 'new')}

            def restore(who):
                p, v, f, sc = bufs[who]
                p.copy_(st['gp'])
                v.copy_(st['gv'])
                f.copy_(st['gf'])
                sc.copy_(sc0)

            def parent():
                restore('parent')
                p, v, f, sc = bufs['parent']
                err = lib.hoomd_megastep(
                    p.data_ptr(), v.data_ptr(), f.data_ptr(),
                    gw.data_ptr(), gm.data_ptr(), gr.data_ptr(),
                    gt.data_ptr(), ws.shift.data_ptr(), ws.mp.data_ptr(),
                    npn, sc.data_ptr(), kt.data_ptr(),
                    noise.data_ptr() if noise is not None else None,
                    dpart.data_ptr(), kpart.data_ptr(), nx, ny, nz, C, k,
                    cp._METHODS[method], ev, ws.approx, stream)
                if err:
                    raise RuntimeError(f"parent hoomd_megastep: CUDA "
                                       f"error {err}")

            def new():
                restore('new')
                p, v, f, sc = bufs['new']
                cp.megastep_window(p, v, f, gw, gm, gt, cand, ws, sc, kt,
                                   noise)
            parent()
            new()
            torch.cuda.synchronize()
            if (float(bufs['new'][3][3]) > 1.0) != (w_skin is not skin):
                raise RuntimeError(f"parent vs new [{name}, {method}, "
                                   f"k={k}]: the guard was "
                                   f"{'' if w_skin is skin else 'not '}"
                                   f"left")
            if all(torch.equal(a, b) for a, b in zip(bufs['parent'],
                                                     bufs['new'])):
                same += 1
            else:
                differ.append(f"{name}/{method}/k={k}/skin "
                              f"{float(w_skin[0]):.2f} (largest "
                              f"difference " + ', '.join(
                                  f"{lab} {float((a - b).abs().max()):.3e}"
                                  for lab, a, b in zip(
                                      ('pos', 'vel', 'frc', 'sc'),
                                      bufs['parent'], bufs['new']))
                              + ")")
            if (name == 'lj' and method == 'nvt' and k == 4
                    and w_skin is skin):
                t = [cuda_ms(fn, 50) for fn in (parent, new, new, parent)]
                restore_ms = cuda_ms(lambda: restore('new'), 50)
                result = dict(parent_ms=(t[0] + t[3]) / 2,
                              new_ms=(t[1] + t[2]) / 2, turns=t,
                              restore_ms=restore_ms)
                print(f"parent vs new megastep [bench, lj, nvt, k=4]: "
                      f"window ms (restore + launch, CUDA events) in "
                      f"turns parent {t[0]:.4f}, new {t[1]:.4f}, new "
                      f"{t[2]:.4f}, parent {t[3]:.4f}; the restore alone "
                      f"{restore_ms:.4f}", flush=True)
    print(f"parent vs new megastep at the bench fill: "
          f"bit-identical on {same} of {same + len(differ)} windows (10 "
          f"evaluators x nve, nvt, langevin x k = 1, 4, and an LJ NVT k = 4 "
          f"window past the guard)" + (
              "; differing: " + '; '.join(differ) if differ else ''),
          flush=True)
    result.update(same=same, windows=same + len(differ))
    return result


def eval_job(name):
    """A 64 000-particle job of the evaluator on the default path: the
    bench lattice at rho* = 0.8442, 600 Langevin steps then 600
    Nose-Hoover steps at kT = 1.2, dt = 0.005.  Gates: finite state,
    T = 1.2 +- 0.03, the megastep launched, a fluid (mean-square
    displacement over the NVT steps above 0.2), and the end state's
    planar PE equal to its plain version's to 1e-5 of it plus 0.01 (the
    two sum 64 000 particles' ~1000 candidates in different orders).  Returns the
    launch counts."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    from hoomd_tpu_torch.ops import cell_pair as cp
    t_job = time.perf_counter()
    coeffs, rc = EVAL_JOBS[name]
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    a = (1.0 / RHO) ** (1.0 / 3.0)
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=a), n=40)
    system = hoomd.context.current.system
    N = system.state.N
    rng = np.random.RandomState(2)
    snap = system.take_snapshot()
    v = rng.normal(0, np.sqrt(1.2), (N, 3))
    snap.particles.velocity[:] = v - v.mean(axis=0)
    system.restore_snapshot(snap)
    pair = getattr(md.pair, name)(r_cut=rc, nlist=md.nlist.cell(r_buff=0.4))
    pair.pair_coeff.set('A', 'A', **coeffs)
    pair.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.005)
    reset_launch_counts()
    lan = md.integrate.langevin(group=hoomd.group.all(), kT=1.2, seed=9)
    system.run(600, quiet=True)
    lan.disable()
    md.integrate.nvt(group=hoomd.group.all(), kT=1.2, tau=0.5)
    s0 = system.take_snapshot()
    system.run(600, quiet=True)
    counts = launch_counts()
    q = system.thermo_quantities()
    s1 = system.take_snapshot()
    box_L = np.array([s0.box.Lx, s0.box.Ly, s0.box.Lz])

    def unwrapped(sn):
        return (sn.particles.position.astype(np.float64)
                + sn.particles.image * box_L)
    msd = float(((unwrapped(s1) - unwrapped(s0)) ** 2).sum(1).mean())
    fast = system._program['fast']
    what = f'{name} job'
    if not (np.isfinite(s1.particles.position).all()
            and np.isfinite(s1.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError(f"{what}: non-finite state")
    if abs(q['temperature'] - TEMP_TARGET) > TEMP_TOL:
        raise RuntimeError(f"{what}: T = {q['temperature']:.4f} outside "
                           f"{TEMP_TARGET} +- {TEMP_TOL}")
    if counts['cell_megastep_planes'] <= 0 or not fast['mega']:
        raise RuntimeError(f"{what} never ran the megastep")
    if fast['eval_name'] != name:
        raise RuntimeError(f"{what} ran evaluator {fast['eval_name']}")
    if msd < 0.2:
        raise RuntimeError(f"{what}: mean-square displacement {msd:.4f} "
                           f"over 600 steps: not a fluid")
    check_rebin_lost(system, what)
    # the end state's PE: the kernel (which thermo_quantities read)
    # against the plain version on the same carry
    c = system._fast_carry
    _, sh = cp.build_cell_shifts(fast['cell_dim'],
                                 system._state_raw.box.L.cpu().numpy())
    sh = torch.as_tensor(sh, dtype=torch.float32, device=c.pos.device)
    pv = system._dyn['fast']['pv']
    ek = dict(eval_name=name, pnames=fast['pnames'])
    got = cp.cell_pair_planar(c.pos, fast['cell_dim'], sh, pv, C=fast['C'],
                              cell_tag=c.tag, **ek)[1]
    want = cp.cell_pair_planar_plain(c.pos, fast['cell_dim'], sh, pv,
                                     cell_tag=c.tag, **ek)[1]
    pe_k, pe_p = float(got.double().sum()), float(want.double().sum())
    if abs(pe_k - pe_p) > 1e-5 * abs(pe_p) + 1e-2:
        raise RuntimeError(f"{what}: end-state PE {pe_k} against the plain "
                           f"version's {pe_p}")
    print(f"{what}: coefficients {coeffs} r_cut={rc} shift; plan "
          f"cell_dim={fast['cell_dim']} C={fast['C']} "
          f"rebin={fast['rebin_impl']}; T={q['temperature']:.5f} "
          f"PE/N={q['potential_energy'] / N:.5f} (plain {pe_p / N:.5f}) "
          f"P={q['pressure']:.4f} MSD={msd:.4f}, {system.fast_stats}, "
          f"launches={counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    return counts


def fused_job():
    """bench.py's script with HOOMD_TPU_MEGA=off HOOMD_TPU_FUSED=on: the
    Langevin melt (one_step), 1000 Nose-Hoover steps on the fused step,
    then a timed 500-step window and the busy share over 50 profiled
    steps; gates as the bench job's, with the step-plane kernel launched
    and the megastep not.  Then an NVE continuation of 1000 fused steps,
    gated on the energy drift (< 1e-3 per particle per 1000 steps at
    dt = 0.005).  Returns the launch counts of the NVT run."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    t_job = time.perf_counter()
    env = {'HOOMD_TPU_MEGA': 'off', 'HOOMD_TPU_FUSED': 'on'}
    os.environ.update(env)
    try:
        reset_launch_counts()
        system, N = bench_job(time.perf_counter(), nvt_steps=1000,
                              warmup=False)
        counts = launch_counts()
        what = 'HOOMD_TPU_MEGA=off HOOMD_TPU_FUSED=on job'
        q = check_lj_output(system, N, what)
        check_rebin_lost(system, what)
        fast = system._program['fast']
        if counts['cell_step_plane_planes'] <= 0 or not fast['fused']:
            raise RuntimeError(f"the {what} never ran the fused step")
        if counts['cell_megastep_planes'] or fast['mega']:
            raise RuntimeError(f"the {what} ran the megastep")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(500, quiet=True)
        ms = (time.perf_counter() - t0) * 2.0
        busy = device_profile(lambda: system.run(50, quiet=True),
                              f'50 steps of the {what}', top=4)
        print(f"{what}: T={q['temperature']:.5f} "
              f"PE/N={q['potential_energy'] / N:.5f}, {system.fast_stats}, "
              f"{ms:.4f} ms/step over 500 steps, busy share {busy:.4f}, "
              f"launches={counts}", flush=True)
        # NVE continuation
        for m in system.methods:
            m.disable()
        md.integrate.nve(group=hoomd.group.all())
        q0 = system.thermo_quantities()
        reset_launch_counts()
        system.run(1000, quiet=True)
        nve_counts = launch_counts()
        q1 = system.thermo_quantities()
    finally:
        for k in env:
            os.environ.pop(k)
    e0 = q0['kinetic_energy'] + q0['potential_energy']
    e1 = q1['kinetic_energy'] + q1['potential_energy']
    drift = abs(e1 - e0) / N
    fast = system._program['fast']
    print(f"fused NVE continuation: E/N {e0 / N:.6f} -> {e1 / N:.6f}, drift "
          f"{drift:.3e} per particle over 1000 steps at dt = 0.005, "
          f"T={q1['temperature']:.5f}, {system.fast_stats}, "
          f"launches={nve_counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    if not np.isfinite(e1) or drift >= NVE_DRIFT_MAX:
        raise RuntimeError(f"fused NVE: energy drift {drift:.3e} per "
                           f"particle per 1000 steps (bound {NVE_DRIFT_MAX})")
    if nve_counts['cell_step_plane_planes'] <= 0 or not fast['fused']:
        raise RuntimeError("the fused NVE continuation never ran the fused "
                           "step")
    if nve_counts['cell_megastep_planes']:
        raise RuntimeError("the fused NVE continuation ran the megastep")
    return counts


# the force path of each HOOMD_TPU_FAST_IMPL value this script runs, and
# the kernel of its steps
IMPL_KERNELS = {'planar_n3l': 'cell_pair_planar_n3l', 'pallas': 'cell_pair_lj',
                'pallas3d': 'cell_pair_lj_pallas3d',
                'row': 'cell_pair_lj_row'}


def lj_params(dev):
    """[rc2, e_shift, lj1, lj2, rcut] and [lj1, lj2, rc2, e_shift] of the
    bench job's shifted LJ."""
    import torch
    r6 = 1.0 / 2.5 ** 6
    es = r6 * (4.0 * r6 - 4.0)
    return (torch.tensor([2.5 ** 2, es, 4.0, 4.0, 2.5], dtype=torch.float32,
                         device=dev),
            torch.tensor([4.0, 4.0, 2.5 ** 2, es], dtype=torch.float32,
                         device=dev))


def impl_kernel_phases(dev):
    """Each force kernel of the other impls against its plain version at
    the bench shape, the ragged shape and a 2x2x2 grid (where one
    neighbour cell is reached under two image shifts; 'pallas' reads its
    neighbours from the adjacency table there), element by element; then
    the cross-kernel phase on the bench fill.  Returns the bench row of
    each kernel."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    pv, ljv = lj_params(dev)
    out = {}
    for tag_name, (dims, cdim, C) in SHAPES.items():
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        adj, sh = cp.build_cell_shifts(cdim, L)
        adj = torch.as_tensor(adj, dtype=torch.int32, device=dev)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag = carry.pos, carry.tag
        nc = pos.shape[0]
        calls = {
            'cell_pair_lj': ((pos, adj, sh, ljv), dict(ncells=nc)),
            'cell_pair_lj_pallas3d': ((pos, cdim, sh, ljv), {}),
            'cell_pair_lj_row': ((pos, cdim, sh, ljv), {}),
            'cell_pair_planar_n3l': ((pos, cdim, sh, pv), {}),
        }
        iters = 50 if tag_name == 'bench' else 5
        bounds = lj_bounds(pos, tag, cdim, sh, N, 4)
        for name, (args, kw) in calls.items():
            kern = getattr(cp, name)
            plain = getattr(cp, name + '_plain')
            got = kern(*args, C=C, cell_tag=tag, **kw)
            want = plain(*args, cell_tag=tag)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            ea, er = compare(f'{name}[{tag_name}]', [
                (lab, g, w, RTOL, ATOL)
                for lab, g, w in zip(('F', 'pe', 'virial'), got, want)])
            row = dict(max_abs_err=ea, bound_share=er,
                       ms=cuda_ms(lambda: kern(*args, C=C, cell_tag=tag,
                                               **kw), iters),
                       plain_ms=cuda_ms(lambda: plain(*args, cell_tag=tag),
                                        3 if tag_name == 'bench' else 1))
            row['bound_ms'], row['bound_by'] = bounds[name]
            print(f"phase {name} [{tag_name} cell_dim={cdim} C={C} N={N}]: "
                  f"max_abs_err={ea:.3e} bound_share={er:.3f} "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})",
                  flush=True)
            if tag_name == 'bench':
                out[name] = row
        if tag_name == 'bench':
            cross_kernel_phase(pos, tag, adj, cdim, sh, pv, ljv, C)
    return out


def cross_kernel_phase(pos, tag, adj, cdim, sh, pv, ljv, C):
    """On one state: the forces of the four force kernels of the other
    impls against cell_pair_plane's (exact divide), and 'pallas''s PE
    and virial against cell_pair_planar's: one function, five kernels."""
    from hoomd_tpu_torch.ops import cell_pair as cp
    ref = cp.cell_pair_plane(pos, cdim, sh, pv, C=C, cell_tag=tag)
    F4, pe4, vir4 = cp.cell_pair_lj(pos, adj, sh, ljv, ncells=pos.shape[0],
                                    C=C, cell_tag=tag)
    _, pe3, vir3 = cp.cell_pair_planar(pos, cdim, sh, pv, C=C, cell_tag=tag)
    outputs = [('pallas F', F4, ref, RTOL, ATOL),
               ('pallas pe vs planar', pe4, pe3, RTOL, ATOL),
               ('pallas virial vs planar', vir4, vir3, RTOL, ATOL)]
    for name in ('cell_pair_lj_pallas3d', 'cell_pair_lj_row'):
        outputs.append((name, getattr(cp, name)(pos, cdim, sh, ljv, C=C,
                                                cell_tag=tag), ref, RTOL,
                        ATOL))
    outputs.append(('planar_n3l', cp.cell_pair_planar_n3l(
        pos, cdim, sh, pv, C=C, cell_tag=tag), ref, RTOL, ATOL))
    compare('cross-kernel vs cell_pair_plane / cell_pair_planar', outputs)
    print("phase cross-kernel: the forces of cell_pair_lj, "
          "cell_pair_lj_pallas3d, cell_pair_lj_row, cell_pair_planar_n3l and "
          "cell_pair_plane agree, and cell_pair_lj's PE and virial "
          "cell_pair_planar's", flush=True)


# ---------------------------------------------------------------------------
# the rebin


def drifted(carry, amp, seed):
    """The carry with every live position moved by a uniform random
    amount of up to amp[a] along each axis a."""
    import torch
    dev = carry.pos.device
    amp = torch.as_tensor(amp, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = (torch.rand(carry.pos.shape, generator=gen, device=dev) * 2 - 1) * amp
    return carry.replace(pos=torch.where((carry.tag >= 0)[..., None],
                                         carry.pos + d, carry.pos))


def exact(name, got, want):
    """Kernel against plain: every tensor equal bit for bit (flags too).
    Returns the largest absolute difference (0.0 when they agree)."""
    import torch
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{name}: output {i} is {tuple(g.shape)} "
                               f"{g.dtype}, plain {tuple(w.shape)} {w.dtype}")
        if g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            worst = max(worst, float((g - w).abs().max()))
        else:
            same = torch.equal(g, w)
        if not same:
            raise RuntimeError(f"{name}: output {i} differs from the plain "
                               f"version (max |diff| {worst:.3e})")
    return worst


def rebin_bounds(cols, E):
    """Bound of each rebin kernel: every input read once and every output
    written once (the state's 14 columns, the z-emigrant buffers of 14*E
    entries per cell and direction); operations, 6 per slot and axis pass
    (origin, offset, two compares, rank) or per window candidate."""
    S = cols[0].numel()
    ncell = S // cols.shape[-1]
    state = cols.numel() * 4
    emz = 2 * ncell * 14 * E * 4
    return {
        'cell_rebin_select': bound(2 * state, 3 * 3 * S * 6),
        'cell_rebin_sweep': bound(2 * state + emz, 3 * S * 6),
        'cell_rebin_place': bound(2 * state + emz, S * 6),
        'cell_rebin_serial': bound(2 * state, 4 * S * 6),
    }


def rebin_kernel_phases(dev):
    """Each rebin kernel against its plain version on lattice fills
    drifted by up to 0.45 of a cell width per axis at the bench shape and
    at (5, 3, 4), C = 32, and on the overflowing fills.  At these
    densities such a drift may overflow the E = 8 emigrant buffers or a
    select window (the engine's drift is at most about half the skin,
    0.1-0.15 w here): the flags are compared like every other output.
    Returns the bench row of each kernel."""
    from hoomd_tpu_torch.ops import cell_rebin as cr
    E = 8
    rows = {}
    for tag_name, dims, cdim, C in (('bench', (40, 40, 40), (14, 14, 12), 40),
                                    ('ragged', (14, 9, 11), (5, 3, 4), 32)):
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        c = drifted(carry, 0.45 * L / np.asarray(cdim, float), 11)
        cols = cr.to_cols(c.pos, c.vel, c.frc, c.img, c.tag, c.mass, cdim, C)
        par = cr.rebin_params(L, cdim)
        swept, emz, _ = cr.cell_rebin_sweep_plain(cols, cdim, par, C=C, E=E)
        calls = {
            'cell_rebin_select': ((cols, cdim, par), dict(C=C)),
            'cell_rebin_sweep': ((cols, cdim, par), dict(C=C, E=E)),
            'cell_rebin_place': ((swept, emz, cdim, par), dict(C=C, E=E)),
            'cell_rebin_serial': ((cols, cdim, par), dict(C=C, E=E)),
        }
        iters = 50 if tag_name == 'bench' else 5
        bounds = rebin_bounds(cols, E)
        for name, (args, kw) in calls.items():
            kern = getattr(cr, name)
            plain = getattr(cr, name + '_plain')
            got, want = kern(*args, **kw), plain(*args, **kw)
            err = exact(f'{name}[{tag_name}]', got, want)
            row = dict(max_abs_err=err,
                       ms=cuda_ms(lambda: kern(*args, **kw), iters),
                       plain_ms=cuda_ms(lambda: plain(*args, **kw), 3))
            row['bound_ms'], row['bound_by'] = bounds[name]
            print(f"phase {name} [{tag_name} cell_dim={cdim} C={C} E={E} "
                  f"N={N}]: bit-exact, overflow flag {bool(got[-1])} in "
                  f"both, kernel_ms={row['ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})",
                  flush=True)
            if tag_name == 'bench':
                rows[name] = row
    rebin_overflow_phase(dev)
    return rows


def rebin_overflow_phase(dev):
    """Two overflowing fills on a (3, 3, 3) grid of 9-wide cells: 12
    particles of cell 0 past its +x face (sweep and serial flag with
    E = 8), and 16 claimants of one cell with C = 8 (select flags); the
    kernels drop the same particles as the plain versions."""
    import torch
    from hoomd_tpu_torch.ops import cell_rebin as cr
    cdim, L = (3, 3, 3), np.array([9.0, 9.0, 9.0])
    par = cr.rebin_params(L, cdim)

    def fill(C, cells):
        cols = torch.as_tensor(cr._FILLS, device=dev)[:, None].repeat(
            1, 27 * C).reshape(14, 3, 3, 3, C)
        flat = cols.reshape(14, 27, C)
        t = 0
        for cell, (x, n) in cells.items():
            flat[0, cell, :n] = x - 4.5
            flat[1, cell, :n] = flat[2, cell, :n] = 1.5 - 4.5
            flat[12, cell, :n] = torch.arange(t, t + n, device=dev,
                                              dtype=torch.float32)
            t += n
        return cols.contiguous()
    cols = fill(32, {0: (3.1, 12)})
    for name in ('cell_rebin_sweep', 'cell_rebin_serial'):
        got = getattr(cr, name)(cols, cdim, par, C=32, E=8)
        exact(f'{name}[overflow]', got,
              getattr(cr, name + '_plain')(cols, cdim, par, C=32, E=8))
        if not bool(got[-1]):
            raise RuntimeError(f"{name}: 12 emigrants through one face "
                               f"with E = 8 did not flag")
    cols = fill(8, {0: (3.1, 8), 1: (4.5, 8)})
    got = cr.cell_rebin_select(cols, cdim, par, C=8)
    exact('cell_rebin_select[overflow]', got,
          cr.cell_rebin_select_plain(cols, cdim, par, C=8))
    if not bool(got[-1]):
        raise RuntimeError("cell_rebin_select: 16 claimants with C = 8 did "
                           "not flag")
    print("phase rebin overflow: sweep, serial and select flag, bit-exact "
          "with their plain versions", flush=True)


# particles that two rebins may bin differently: one within a rounding of
# a cell face, where the decisions (a global floor, or an offset from the
# cell's own face) may round apart
MAX_BINNED_APART = 10


def cell_of(tag, N):
    """(N,) cell index of every tag of a cell-major tag array, -1 where a
    tag is missing."""
    import torch
    t = tag.reshape(tag.shape[0], -1)
    cells = torch.arange(t.shape[0], device=t.device)[:, None].expand_as(t)
    live = t >= 0
    out = torch.full((N,), -1, dtype=torch.long, device=t.device)
    out[t[live].long()] = cells[live]
    return out


def binned_apart(name, a, b):
    """Count the particles two rebins bin apart; fail past
    MAX_BINNED_APART or on a lost particle."""
    if bool((a < 0).any()) or bool((b < 0).any()):
        raise RuntimeError(f"{name}: a particle was lost")
    n = int((a != b).sum())
    if n > MAX_BINNED_APART:
        raise RuntimeError(f"{name}: {n} particles binned apart")
    return n


def device_ms(fn, iters, only=None):
    """Summed device kernel time per call of fn, by torch.profiler; with
    ``only``, of the kernels whose name holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or (only and only not in e.key):
            continue
        t = getattr(e, 'self_device_time_total', None)
        total += t if t is not None else getattr(e, 'self_cuda_time_total',
                                                  0.0)
    return total / 1e3 / iters


def rebuild_phase(system):
    """One rebuild of each rebin on a job's liquid: its live state
    advanced by one rebuild cadence (fast_m windows of k steps) past its
    last rebuild, on the job's plan.  CUDA-event time per call and device
    kernel time per call; none may flag, and all three give the same cell
    membership but for particles within a rounding of a face.  Then the
    megastep's candidate build of the job's live reference, timed the
    same way."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops.cell_pair import build_cell_shifts
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    fast = system._program['fast']
    cdim, C, k = fast['cell_dim'], fast['C'], fast['k_rebuild']
    m = max(int(system._grow.get('fast_m', 1)), 1)
    c = fast['run_chunk'].wins(system._fast_carry, system._dyn['fast'], m, k)
    st = system._state_raw
    N, box = st.N, st.box
    ref = None
    for impl in ('sort', 'xsel', 'pallas'):
        _, _, run, _ = build_fast_lj_chunk(
            N=N, box=box, cell_dim=cdim, C=C, r_buff=0.4, rcut=2.5,
            method_kind=fast['kind'], method_seed=0, rebin_impl=impl,
            rebin_E=8, mega=False, device=c.pos.device)
        out = run.rebuild(c)
        if bool(out.overflow) or bool(out.rebin_ovf) or bool(out.rebin_lost):
            raise RuntimeError(f"rebuild[{impl}] flagged on the job's "
                               f"liquid")
        cells = cell_of(out.tag, N)
        ref = cells if ref is None else ref
        apart = binned_apart(f'rebuild[{impl}] vs sort', cells, ref)
        ms = cuda_ms(lambda: run.rebuild(c), 20)
        dms = device_ms(lambda: run.rebuild(c), 10)
        print(f"rebuild[{impl}] of the job's liquid {m * k} steps after its "
              f"last rebuild, cell_dim={cdim} C={C} N={N}: {ms:.4f} ms per "
              f"call (CUDA events), device {dms:.4f} ms; {apart} particles "
              f"binned apart from the sort", flush=True)
    # and the megastep's candidate set of the new reference, which the
    # engine builds after each rebuild
    cyc = system._fast_carry.cycle
    cand = cyc.cand
    args = (cand.gr, cyc.gt, cdim, torch.as_tensor(
        build_cell_shifts(cdim, box.L.cpu().numpy())[1], dtype=torch.float32,
        device=c.pos.device), cand.pads, cand.rc2)
    ms = cuda_ms(lambda: cp.mega_candidates(*args, C=C), 20)
    dms = device_ms(lambda: cp.mega_candidates(*args, C=C), 10)
    per = int(cand.count.sum()) / int((cyc.gt >= 0).sum())
    print(f"mega_candidates of the job's liquid, cell_dim={cdim} C={C}: "
          f"{ms:.4f} ms per build (CUDA events), device {dms:.4f} ms; "
          f"{per:.1f} candidates per live slot of {27 * C} staged", flush=True)


def bench_job(t_start, nvt_steps=500, warmup=True):
    """bench.py's job script through hoomd_tpu_torch, up to the end of
    its warmup.  Returns the System and N."""
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    n = 40
    a = (1.0 / RHO) ** (1.0 / 3.0)
    hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=a), n=n)
    system = hoomd.context.current.system
    N = system.state.N
    rng = np.random.RandomState(1)
    snap = system.take_snapshot()
    v = rng.normal(0, np.sqrt(1.2), (N, 3))
    v -= v.mean(axis=0)
    snap.particles.velocity[:] = v
    system.restore_snapshot(snap)
    nl = md.nlist.cell(r_buff=0.4)
    lj = md.pair.lj(r_cut=2.5, nlist=nl)
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    mode = md.integrate.mode_standard(dt=0.001)
    lan = md.integrate.langevin(group=hoomd.group.all(), kT=1.2, seed=7)
    system.run(1000, quiet=True)
    lan.disable()
    mode.set_params(dt=0.005)
    md.integrate.nvt(group=hoomd.group.all(), kT=1.2, tau=0.5)
    system.run(nvt_steps, quiet=True)
    fast = system._program['fast']
    print(f"plan: cell_dim={fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']} megastep={fast['mega']}", flush=True)
    if not warmup:
        return system, N
    # the same cadence-controller warmup as bench.py, cut short if this
    # smoke run nears its time budget
    last_m, stable = -1, 0
    for i in range(16):
        if time.perf_counter() - t_start > 240:
            print(f"warmup cut after {i} of up to 16 runs of 1024 steps "
                  f"(time budget)", flush=True)
            break
        system.run(1024, quiet=True)
        m_now = int(system._grow.get('fast_m', 1))
        if m_now == last_m:
            stable += 1
            if stable >= 3:
                break
        else:
            stable, last_m = 0, m_now
    print(f"after the warmup: fast_m {int(system._grow.get('fast_m', 1))}, "
          f"k {system._program['fast']['k_rebuild']}, {system.fast_stats}, "
          f"grow {system._grow}", flush=True)
    return system, N


def reset_launch_counts():
    from hoomd_tpu_torch.hpmc import sweep as tsw
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    cp.reset_launch_counts()
    cr.reset_launch_counts()
    tsw.reset_launch_counts()


def launch_counts():
    from hoomd_tpu_torch.hpmc import sweep as tsw
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    return {**cp.launch_counts(), **cr.launch_counts(),
            **tsw.launch_counts()}


def check_lj_output(system, N, what):
    """Finite state, T = 1.2 +- 0.03, PE/N in PE_RANGE.  Returns the
    thermo quantities."""
    q = system.thermo_quantities()
    snapf = system.take_snapshot()
    if not (np.isfinite(snapf.particles.position).all()
            and np.isfinite(snapf.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError(f"{what}: non-finite state")
    if abs(q['temperature'] - TEMP_TARGET) > TEMP_TOL:
        raise RuntimeError(f"{what}: T = {q['temperature']:.4f} outside "
                           f"{TEMP_TARGET} +- {TEMP_TOL}")
    pe = q['potential_energy'] / N
    if not PE_RANGE[0] <= pe <= PE_RANGE[1]:
        raise RuntimeError(f"{what}: PE/N = {pe:.4f} outside {PE_RANGE}")
    return q


def rebin_job(env):
    """bench.py's script to the melt plus 1000 NVT steps with
    HOOMD_TPU_REBIN=env, with the output gates.  Returns (launch counts
    of the run, System)."""
    os.environ['HOOMD_TPU_REBIN'] = env
    try:
        reset_launch_counts()
        system, N = bench_job(time.perf_counter(), nvt_steps=1000,
                              warmup=False)
        counts = launch_counts()
    finally:
        os.environ.pop('HOOMD_TPU_REBIN')
    q = check_lj_output(system, N, f'HOOMD_TPU_REBIN={env} job')
    fast = system._program['fast']
    print(f"HOOMD_TPU_REBIN={env} job: rebin now {fast['rebin_impl']} "
          f"(E={fast['rebin_E']}), T={q['temperature']:.5f} "
          f"PE/N={q['potential_energy'] / N:.5f}, {system.fast_stats}, "
          f"launches={counts}", flush=True)
    check_rebin_lost(system, f'HOOMD_TPU_REBIN={env} job')
    if env == 'pallas':
        for name in ('cell_rebin_sweep', 'cell_rebin_place'):
            if counts[name] <= 0:
                raise RuntimeError(f"the pallas job never launched {name}")
        # every rebuild of the job on the kernels: no retry widened E or
        # fell back to the sort, so the gates above held their trajectory
        if (fast['rebin_impl'] != 'pallas'
                or system.fast_stats['rebin_retries']):
            raise RuntimeError(
                f"the pallas job left the migration rebin: now "
                f"{fast['rebin_impl']}, {system.fast_stats}")
    elif counts['cell_rebin_sweep'] or counts['cell_rebin_place']:
        raise RuntimeError(f"the {env} job launched the migration kernels")
    return counts, system


def impl_job(impl, mega=None):
    """bench.py's script to the melt plus 1000 NVT steps with
    HOOMD_TPU_FAST_IMPL=impl (and HOOMD_TPU_MEGA=mega), with the output
    gates; its kernel launched, the megastep not, the rebin of its gate
    (xsel for the planar family, else the sort); then a timed 500-step
    window and the device's busy share over 50 profiled steps.  Returns
    the launch counts of the run."""
    import torch
    t_job = time.perf_counter()
    env = {'HOOMD_TPU_FAST_IMPL': impl}
    if mega is not None:
        env['HOOMD_TPU_MEGA'] = mega
    what = ' '.join(f'{k}={v}' for k, v in env.items()) + ' job'
    os.environ.update(env)
    try:
        reset_launch_counts()
        system, N = bench_job(time.perf_counter(), nvt_steps=1000,
                              warmup=False)
        counts = launch_counts()
        q = check_lj_output(system, N, what)
        check_rebin_lost(system, what)
        fast = system._program['fast']
        kname = IMPL_KERNELS.get(impl, 'cell_pair_plane')
        if counts[kname] <= 0:
            raise RuntimeError(f"the {what} never launched {kname}")
        if counts['cell_megastep_planes'] or fast['mega']:
            raise RuntimeError(f"the {what} ran the megastep")
        gate = 'xsel' if impl in ('plane', 'planar_n3l') else 'sort'
        # an xsel strike sorts until 8 clean segments have passed
        if not (fast['rebin_impl'] == gate
                or (gate == 'xsel' and system._grow.get('fast_rebin_sort'))):
            raise RuntimeError(f"the {what} rebuilt on "
                               f"{fast['rebin_impl']}, its gate names {gate}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(500, quiet=True)
        ms = (time.perf_counter() - t0) * 2.0
        busy = device_profile(lambda: system.run(50, quiet=True),
                              f'50 steps of the {what}', top=4)
    finally:
        for k in env:
            os.environ.pop(k)
    print(f"{what}: T={q['temperature']:.5f} "
          f"PE/N={q['potential_energy'] / N:.5f}, {system.fast_stats}, "
          f"{ms:.4f} ms/step over 500 steps, busy share {busy:.4f}, "
          f"launches={counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    return counts


def check_rebin_lost(system, what):
    """An xsel rebuild that lost a particle is a fault of the rebin, not
    a transient: fail if any did in the job."""
    if system.fast_stats['rebin_lost']:
        raise RuntimeError(f"{what}: an xsel rebuild lost a particle "
                           f"({system.fast_stats})")


def variants_path(system):
    """cell_rebin_plane's three variants through the op's entry point on
    a job's live state: 'grid' and the serial program agree slot for
    slot, and 'select' puts every particle in the same cell.  Returns the
    launch counts of this path."""
    from hoomd_tpu_torch.ops import cell_rebin as cr
    fast = system._program['fast']
    c = system._fast_carry
    L = system._state_raw.box.L
    reset_launch_counts()
    outs = {v: cr.cell_rebin_plane(c.pos, c.vel, c.frc, c.img, c.tag,
                                   c.mass, fast['cell_dim'], L, C=fast['C'],
                                   E=fast['rebin_E'], variant=v)
            for v in ('select', 'grid', 'serial')}
    counts = cr.launch_counts()
    for v, out in outs.items():
        if bool(out[-1]):
            raise RuntimeError(f"cell_rebin_plane[{v}] flagged on the job's "
                               f"state")
    exact('cell_rebin_plane serial vs grid', outs['serial'][:6],
          outs['grid'][:6])
    N = system._state_raw.N
    apart = binned_apart('cell_rebin_plane select vs grid',
                         cell_of(outs['select'][4], N),
                         cell_of(outs['grid'][4], N))
    print(f"op variants on the job's state: serial == grid slot for slot, "
          f"select bins {apart} particles apart from grid; "
          f"launches={counts}", flush=True)
    return counts


def bench_script(card):
    """bench.py's job script through hoomd_tpu_torch: the warmup, one
    timed window, and the checks of its output."""
    import torch
    reset_launch_counts()
    system, N = bench_job(time.perf_counter())
    steps = 3000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(steps, quiet=True)
    elapsed = time.perf_counter() - t0
    q = system.thermo_quantities()
    pss = steps / elapsed * N
    # bench.py's run lengths are all multiples of the k = 4 kernel
    # window, so they leave no single steps; a run of any other length
    # does, and those steps go through cell_pair_plane (one_step)
    system.run(3, quiet=True)
    counts = launch_counts()
    fast = system._program['fast']
    print(f"bench job: rebin {fast['rebin_impl']}, {system.fast_stats}, "
          f"grow {system._grow}", flush=True)
    print(json.dumps({
        "metric": "lj_melt_64k_nvt_particle_steps_per_sec",
        "value": pss, "unit": "particle-steps/s/chip",
        "extra": {"N": N, "steps": steps, "elapsed_s": elapsed,
                  "temperature": q['temperature'],
                  "pe_per_particle": q['potential_energy'] / N,
                  "fast_m": int(system._grow.get('fast_m', 1)),
                  "card": card, "package": "torch"}}), flush=True)
    check_lj_output(system, N, 'bench job')
    check_rebin_lost(system, 'bench job')
    for name in ('cell_megastep_planes', 'cell_pair_plane',
                 'cell_pair_planar'):
        if counts[name] <= 0:
            raise RuntimeError(f"main path never launched {name}")
    pe = q['potential_energy'] / N
    print(f"main path: T={q['temperature']:.5f} PE/N={pe:.5f} "
          f"launches={counts}", flush=True)
    same = (q['temperature'], pe) == (PR6_BENCH_T, PR6_BENCH_PE)
    print(f"bench job: T={q['temperature']!r} PE/N={pe!r}; PR 6's "
          f"T={PR6_BENCH_T!r} PE/N={PR6_BENCH_PE!r}; equal bit for bit: "
          f"{same}", flush=True)
    if not same:
        raise RuntimeError("bench job: T and PE/N differ from PR 6's bits")
    if counts['mega_candidates'] <= 0:
        raise RuntimeError("main path never built a megastep candidate set")
    # where a step's time goes: the busy share of 1024 NVT steps, and one
    # megastep window of the live state by the profiler's device time
    device_profile(lambda: system.run(1024, quiet=True),
                   f"1024 NVT steps of the bench job (fast_m "
                   f"{int(system._grow.get('fast_m', 1))})")
    # the engine's windows from a fresh rebuild of the live state, as many
    # as its cadence chains (fast_m), and one rebuild cycle
    fast = system._program['fast']
    run, dyn = fast['run_chunk'], system._dyn['fast']
    c = run.rebuild(system._fast_carry)
    k, m = fast['k_rebuild'], int(system._grow.get('fast_m', 1))
    held = not bool(run.wins(c, dyn, m, k).danger)
    print(f"megastep windows of the bench job's state after a rebuild (k = "
          f"{k}, fast_m = {m}, the guard held: {held}): device "
          f"{device_ms(lambda: run.wins(c, dyn, 1, k), 20):.4f} ms for one "
          f"window, {device_ms(lambda: run.wins(c, dyn, m, k), 10) / m:.4f} "
          f"ms per window of {m} chained, "
          f"{cuda_ms(lambda: run.wins(c, dyn, m, k), 10) / m:.4f} ms per "
          f"window of {m} by CUDA events; one rebuild cycle ({m} windows, "
          f"the rebuild and its candidate set) "
          f"{cuda_ms(lambda: run.cycles(c, dyn, 1, m, k), 10):.4f} ms by CUDA "
          f"events, device "
          f"{device_ms(lambda: run.cycles(c, dyn, 1, m, k), 5):.4f} ms",
          flush=True)
    # bench.py's warmup stops before 16 clean segments: run on until the
    # probe amnesty has fired (at most 16 runs of 1024 steps, a segment
    # each), then time the same window again
    runs = 0
    while 'fast_m_probe_fails' in system._grow and runs < 16:
        system.run(1024, quiet=True)
        runs += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(steps, quiet=True)
    elapsed = time.perf_counter() - t0
    print(f"bench job after {runs} more runs of 1024 steps (the amnesty "
          f"{'fired' if 'fast_m_probe_fails' not in system._grow else 'not reached'}"
          f"): {steps / elapsed * N:.6g} particle-steps/s over {steps} steps, "
          f"fast_m {int(system._grow.get('fast_m', 1))}, {system.fast_stats}, "
          f"grow {system._grow}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# mixtures: the Kob-Andersen melt

# the Kob-Andersen 80:20 binary LJ mixture (W. Kob and H. C. Andersen,
# Phys. Rev. E 51, 4626 (1995)): (epsilon, sigma) of each pair, r_cut =
# 2.5 sigma, shift mode, rho = 1.2, equal masses; 64 000 particles (12 800
# of type B) on a 40^3 sc lattice at a = 0.94104 (L = 37.6416)
KA_PAIRS = {('A', 'A'): (1.0, 1.0), ('A', 'B'): (1.5, 0.8),
            ('B', 'B'): (0.5, 0.88)}
KA_N_SIDE, KA_A, KA_NB = 40, 0.94104, 12800
KA_TEMP, KA_TEMP_TOL = 1.0, 0.03


def ka_snapshot(data, n_side=KA_N_SIDE, seed=4):
    """The KA start: an n_side^3 sc lattice at a = KA_A, a fifth of the
    particles (a seeded numpy permutation) of type B, Maxwell velocities
    at kT = 1.  A snapshot of either package (``data``: its hoomd.data)."""
    N = n_side ** 3
    L = n_side * KA_A
    snap = data.make_snapshot(N, data.boxdim(L=L), particle_types=['A', 'B'])
    g = (np.arange(n_side) + 0.5) * KA_A - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(g, g, g, indexing='ij'),
                                          -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    tid = np.zeros(N, np.int32)
    tid[rng.permutation(N)[:N // 5]] = 1
    snap.particles.typeid[:] = tid
    v = rng.normal(0.0, np.sqrt(KA_TEMP), (N, 3))
    snap.particles.velocity[:] = v - v.mean(axis=0)
    return snap


def ka_setup(hoomd, n_side=KA_N_SIDE):
    """The KA system through the public API of ``hoomd`` (either package,
    its context initialized): the start of ka_snapshot, the mixture's
    pair coefficients and mode_standard at dt = 0.001.  Returns the
    System, the start's typeids and the integration mode."""
    md = hoomd.md
    snap = ka_snapshot(hoomd.data, n_side)
    hoomd.init.read_snapshot(snap)
    lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
    for (a, b), (eps, sig) in KA_PAIRS.items():
        lj.pair_coeff.set(a, b, epsilon=eps, sigma=sig, r_cut=2.5 * sig)
    lj.set_params(mode='shift')
    mode = md.integrate.mode_standard(dt=0.001)
    return hoomd.context.current.system, snap.particles.typeid.copy(), mode


def ka_script(hoomd, nvt_steps, n_side=KA_N_SIDE):
    """The KA job script (ka_setup): bench.py's pattern at the mixture's
    temperature, a 1000-step Langevin melt at dt = 0.001, kT = 1, 1000
    more Langevin steps at dt = 0.005, then Nose-Hoover NVT at kT = 1,
    tau = 0.5, dt = 0.005: 500 steps, then the window of nvt_steps steps
    in runs of 100 with the temperature read after each.  The second
    Langevin run takes up the heat that the lattice start keeps
    releasing as the mixture relaxes: a Nose-Hoover run started at the
    melt's end rings about kT for thousands of steps
    (profile_torch_bench.py ka-trace).  Returns the System, the start's
    typeids and the window's temperatures."""
    md = hoomd.md
    system, typeid0, mode = ka_setup(hoomd, n_side)
    lan = md.integrate.langevin(group=hoomd.group.all(), kT=KA_TEMP, seed=7)
    system.run(1000, quiet=True)
    mode.set_params(dt=0.005)
    system.run(1000, quiet=True)
    lan.disable()
    md.integrate.nvt(group=hoomd.group.all(), kT=KA_TEMP, tau=0.5)
    system.run(500, quiet=True)
    temps = []
    for _ in range(nvt_steps // 100):
        system.run(100, quiet=True)
        temps.append(system.thermo_quantities()['temperature'])
    return system, typeid0, temps


def check_ka(system, typeid0, temps, counts, kname, what):
    """The KA gates: finite state, the NVT window's mean T = 1 +- 0.03,
    51 200 / 12 800 particles per type with every tag's type its start's
    (in the snapshot and in every live slot of the engine's carry), the
    mixture's program (two types, the sort, no megastep, no fused step)
    and its step kernel ``kname`` launched, no single-type stencil.
    Returns the thermo quantities."""
    import torch
    q = system.thermo_quantities()
    snap = system.take_snapshot()
    if not (np.isfinite(snap.particles.position).all()
            and np.isfinite(snap.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError(f"{what}: non-finite state")
    t_mean = float(np.mean(temps))
    if abs(t_mean - KA_TEMP) > KA_TEMP_TOL:
        raise RuntimeError(f"{what}: mean T over the NVT window {t_mean:.4f} "
                           f"outside {KA_TEMP} +- {KA_TEMP_TOL}")
    tid = snap.particles.typeid
    per_type = np.bincount(tid, minlength=2).tolist()
    c = system._fast_carry
    live = c.tag >= 0
    tid0 = torch.as_tensor(typeid0, device=c.typ.device, dtype=c.typ.dtype)
    carried = bool(torch.equal(c.typ[live], tid0[c.tag[live].long()]))
    if (per_type != [len(tid) - KA_NB, KA_NB]
            or not np.array_equal(tid, typeid0) or not carried):
        raise RuntimeError(f"{what}: types per tag lost ({per_type}, the "
                           f"carry's types its tags': {carried})")
    fast = system._program['fast']
    if (fast['ntypes'], fast['rebin_impl'], fast['mega'], fast['fused']) != (
            2, 'sort', False, False):
        raise RuntimeError(f"{what}: not the mixture's program ({fast})")
    if counts[kname] <= 0:
        raise RuntimeError(f"{what} never launched {kname}")
    single = [k for k in ('cell_pair_plane', 'cell_megastep_planes',
                          'cell_step_plane_planes', 'cell_pair_planar',
                          'cell_pair_planar_n3l') if counts[k]]
    if single:
        raise RuntimeError(f"{what} launched single-type kernels {single}")
    check_rebin_lost(system, what)
    return q


def ka_job(card):
    """The KA job script at N = 64 000 on the card (ka_script, a window of
    1000 NVT steps): the gates of check_ka with the typed planar kernel
    on every step; a timed 500-step window, the device's busy share and
    the kernel's device time per launch over 50 profiled steps, its
    wrapper call's time on the end state and its F, PE and virial
    against the plain version's there; then a 1000-step NVE
    continuation, gated on its energy drift as the fused job.  Returns
    the launch counts of the script's run."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    from hoomd_tpu_torch.ops import cell_pair as cp
    t_job = time.perf_counter()
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    reset_launch_counts()
    system, typeid0, temps = ka_script(hoomd, nvt_steps=1000)
    counts = launch_counts()
    what = 'KA job'
    q = check_ka(system, typeid0, temps, counts, 'cell_pair_planar_typed',
                 what)
    N = system.state.N
    fast = system._program['fast']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(500, quiet=True)
    ms = (time.perf_counter() - t0) * 2.0
    busy, k_dev = device_profile(lambda: system.run(50, quiet=True),
                                 f'50 steps of the {what}', top=6,
                                 per_launch='cell_pair_typed_kernel')
    # the typed kernel on the end state, against its plain version
    c = system._fast_carry
    _, sh = cp.build_cell_shifts(fast['cell_dim'],
                                 system._state_raw.box.L.cpu().numpy())
    sh = torch.as_tensor(sh, dtype=torch.float32, device=c.pos.device)
    kw = dict(C=fast['C'], cell_tag=c.tag, pnames=fast['pnames'], ntypes=2,
              cell_typ=c.typ)
    pv = system._dyn['fast']['pv']

    def kern():
        return cp.cell_pair_planar(c.pos, fast['cell_dim'], sh, pv, **kw)
    want = cp.cell_pair_planar_plain(c.pos, fast['cell_dim'], sh, pv,
                                     cell_tag=c.tag, ntypes=2, cell_typ=c.typ)
    ea, _ = compare(f'cell_pair_planar typed [{what} end state]',
                    [(lab, g, w, RTOL, ATOL) for lab, g, w in
                     zip(('F', 'pe', 'virial'), kern(), want)])
    k_ms = cuda_ms(kern, 20)
    print(f"{what}: plan cell_dim={fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']}; NVT T over the window {np.mean(temps):.5f} "
          f"(reads {', '.join(f'{t:.4f}' for t in temps)}), "
          f"T={q['temperature']:.5f} PE/N={q['potential_energy'] / N:.5f} "
          f"P={q['pressure']:.4f}; {system.fast_stats}, grow {system._grow}; "
          f"{ms:.4f} ms/step over 500 steps, busy share {busy:.4f}; the typed "
          f"planar kernel {k_dev:.4f} ms per launch on the device in the "
          f"profiled steps, {k_ms:.4f} ms per wrapper call on the end state "
          f"(CUDA events), max_abs_err {ea:.3e} against its plain version "
          f"there; launches={counts}", flush=True)
    # NVE continuation
    for m in system.methods:
        m.disable()
    md.integrate.nve(group=hoomd.group.all())
    q0 = system.thermo_quantities()
    reset_launch_counts()
    system.run(1000, quiet=True)
    nve_counts = launch_counts()
    q1 = system.thermo_quantities()
    e0 = q0['kinetic_energy'] + q0['potential_energy']
    e1 = q1['kinetic_energy'] + q1['potential_energy']
    drift = abs(e1 - e0) / N
    print(f"{what} NVE continuation: E/N {e0 / N:.6f} -> {e1 / N:.6f}, drift "
          f"{drift:.3e} per particle over 1000 steps at dt = 0.005, "
          f"T={q1['temperature']:.5f}, {system.fast_stats}, "
          f"launches={nve_counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    if not np.isfinite(e1) or drift >= NVE_DRIFT_MAX:
        raise RuntimeError(f"{what} NVE: energy drift {drift:.3e} per "
                           f"particle per 1000 steps (bound {NVE_DRIFT_MAX})")
    if nve_counts['cell_pair_planar_typed'] <= 0:
        raise RuntimeError(f"the {what}'s NVE continuation never launched "
                           f"the typed planar kernel")
    return counts


def ka_n3l_job():
    """The KA job script with HOOMD_TPU_FAST_IMPL=planar_n3l at N = 64 000,
    a window of 300 NVT steps: the gates of check_ka with the typed half
    stencil on every step (the typed planar kernel at the PE and virial
    reads), and the ms per step of a timed 100-step window.  Returns the
    launch counts of the script's run."""
    import torch
    import hoomd_tpu_torch as hoomd
    t_job = time.perf_counter()
    what = 'HOOMD_TPU_FAST_IMPL=planar_n3l KA job'
    os.environ['HOOMD_TPU_FAST_IMPL'] = 'planar_n3l'
    try:
        hoomd.context.initialize("--mode=gpu --notice-level=0")
        reset_launch_counts()
        system, typeid0, temps = ka_script(hoomd, nvt_steps=300)
        counts = launch_counts()
        q = check_ka(system, typeid0, temps, counts,
                     'cell_pair_planar_n3l_typed', what)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(100, quiet=True)
        ms = (time.perf_counter() - t0) * 10.0
    finally:
        os.environ.pop('HOOMD_TPU_FAST_IMPL')
    N = system.state.N
    print(f"{what}: NVT T over the window {np.mean(temps):.5f}, "
          f"T={q['temperature']:.5f} PE/N={q['potential_energy'] / N:.5f}, "
          f"{system.fast_stats}, {ms:.4f} ms/step over 100 steps, "
          f"launches={counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    return counts


def ka_cells(dev, ntypes, jitter=0.05, seed=5):
    """The cell-major carry of the KA start (ka_snapshot), jittered by up
    to ``jitter`` lattice spacings, on the engine's plan of it: two types
    80:20, or for ntypes > 2 a type drawn uniformly per particle.
    Returns (carry, L, N, cell_dim, C)."""
    from hoomd_tpu_torch import data
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk, plan_fast_lj
    from hoomd_tpu_torch.state import state_from_snapshot
    snap = ka_snapshot(data, seed=seed)
    N = snap.particles.N
    rng = np.random.RandomState(seed + 1)
    snap.particles.position[:] += rng.uniform(-jitter, jitter, (N, 3)) * KA_A
    if ntypes > 2:
        snap.particles.types = ['A', 'B', 'C', 'D'][:ntypes]
        snap.particles.typeid[:] = rng.randint(0, ntypes, N)
    st = state_from_snapshot(snap, dev)
    L = st.box.L.cpu().numpy().astype(np.float64)
    frac = (snap.particles.position / L + 0.5) % 1.0
    cdim, _, C = plan_fast_lj(N, L, 2.5, 0.4, frac=frac)
    to_fast = build_fast_lj_chunk(
        N=N, box=st.box, cell_dim=cdim, C=C, r_buff=0.4, rcut=2.5,
        method_kind='nvt', method_seed=0, ntypes=ntypes, device=dev)[0]
    carry = to_fast(st, {})
    if bool(carry.overflow):
        raise RuntimeError(f"the KA fill overflows C={C} on {cdim}")
    return carry, L, N, tuple(cdim), C


def typed_table(name, ntypes, dev):
    """The (2 + NP, T, T) shift-mode table [rc2, e_shift, *pnames] of
    evaluator ``name``, derived in float32 as the System derives it: for
    lj with two types the KA mixture's; else the evaluator's job
    coefficients (EVAL_JOBS; lj at epsilon = sigma = 1, r_cut 2.5) with
    every coefficient and r_cut scaled per pair (a, b) by
    0.95 + 0.1 (a + b) / (2 T - 2).  Returns (table, pnames)."""
    import torch
    from hoomd_tpu_torch.ops import pair_eval
    ev = pair_eval.ALL_EVALUATORS[name]
    a = np.arange(ntypes)
    if name == 'lj' and ntypes == 2:
        eps = np.array([[1.0, 1.5], [1.5, 0.5]], np.float32)
        sig = np.array([[1.0, 0.8], [0.8, 0.88]], np.float32)
        raw = {'epsilon': eps, 'sigma': sig,
               'alpha': np.ones((2, 2), np.float32)}
        rc = (np.float32(2.5) * sig).astype(np.float32)
    else:
        coeffs, rc0 = EVAL_JOBS.get(name, (dict(epsilon=1.0, sigma=1.0), 2.5))
        f = (0.95 + 0.1 * (a[:, None] + a[None, :]) / (2 * ntypes - 2))
        raw = dict(ev.defaults)
        raw.update(coeffs)
        raw = {k: (np.float32(v) * f).astype(np.float32)
               for k, v in raw.items()}
        rc = (np.float32(rc0) * f).astype(np.float32)
    tab = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
           for k, v in ev.derive(raw).items()}
    tab['rcut'] = torch.as_tensor(rc, device=dev)
    rc2 = tab['rcut'] * tab['rcut']
    _, es = ev.energy_force(rc2, tab)
    pn = pair_eval.kernel_pnames(name)
    return torch.stack([rc2, es] + [tab[k] for k in pn]).float(), pn


def typed_pair_counts(pos, tag, typ, cdim, sh, rc2):
    """Candidate pairs (two live slots of the 27-cell stencil, not the
    same particle) and pairs inside their own r_cut (rc2 the (T, T)
    table), of a typed cell-major fill."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    adj = torch.as_tensor(cp._adjacency_np(tuple(cdim)), dtype=torch.int64,
                          device=pos.device)
    live = tag >= 0
    ti = typ.long()
    C = pos.shape[1]
    eye = torch.eye(C, dtype=torch.bool, device=pos.device)
    cand = inr = 0
    for o in range(27):
        nb = pos[adj[:, o]] + sh[:, o, None, :]
        d = pos[:, :, None, :] - nb[:, None, :, :]
        ok = live[:, :, None] & live[adj[:, o]][:, None, :]
        if o == 13:
            ok &= ~eye
        cand += int(ok.sum())
        cut = rc2[ti[:, :, None], ti[adj[:, o]][:, None, :]]
        inr += int((ok & ((d * d).sum(-1) < cut)).sum())
    return cand, inr


def typed_bounds(pos, tag, typ, cdim, sh, pv):
    """Bound of the two typed kernels at this fill, with the pairs inside
    each pair's own r_cut, and the type plane and the table among the
    bytes.  The function needs each unordered pair once: 8 operations
    per candidate, 15 more per pair inside its r_cut for the force and
    3 for the -F on j; the planar kernel's PE and virial 12 more per
    pair (half of each to each side).  The kernels' own work (the full
    stencil evaluates each pair from both sides) does not count; rows 2
    and 3 of lj_bounds still count ordered pairs."""
    cand, inr = typed_pair_counts(pos, tag, typ, cdim, sh, pv[0])
    slots = pos.shape[0] * pos.shape[1]
    P = slots * 4
    inb = 3 * P + P + P + sh.numel() * 4 + pv.numel() * 4
    return {
        'cell_pair_planar_typed': bound(inb + 10 * P,
                                        (8 * cand + 30 * inr) / 2),
        'cell_pair_planar_n3l_typed': bound(inb + 3 * P,
                                            (8 * cand + 18 * inr) / 2),
    }, cand, inr


def typed_kernel_phases(dev):
    """At the KA shape (ka_cells: 64 000 particles, the KA plan), for
    every evaluator: the typed planar kernel (T = 2, 4) and the half
    stencil (T = 1, 2, 4) against their plain versions, element by
    element (RTOL and the evaluator's ATOL), each with its CUDA-event
    time; for lj with two types, the KA mixture's own table, with the
    plain version's time, the device time and the bound.  Returns the
    rows of the two typed kernels and the times of every variant."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    rows, times = {}, {}
    for T in (1, 2, 4):
        carry, L, N, cdim, C = ka_cells(dev, max(T, 2))
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag, typ = carry.pos, carry.tag, carry.typ
        for name in ['lj'] + list(EVAL_JOBS):
            atol = EVAL_ATOL.get(name, ATOL)
            if T > 1:
                pv, pn = typed_table(name, T, dev)
            elif name == 'lj':
                pv, pn = lj_params(dev)[0], cp.LJ_PNAMES
            else:
                pv, pn = eval_params(name, dev)[:2]
            kw = dict(eval_name=name, pnames=pn, ntypes=T, cell_typ=typ)
            calls = {'cell_pair_planar_n3l': (
                lambda: cp.cell_pair_planar_n3l(pos, cdim, sh, pv, C=C,
                                                cell_tag=tag, **kw),
                lambda: cp.cell_pair_planar_n3l_plain(pos, cdim, sh, pv,
                                                      cell_tag=tag, **kw))}
            if T > 1:
                calls['cell_pair_planar'] = (
                    lambda: cp.cell_pair_planar(pos, cdim, sh, pv, C=C,
                                                cell_tag=tag, **kw),
                    lambda: cp.cell_pair_planar_plain(pos, cdim, sh, pv,
                                                      cell_tag=tag, **kw))
            for kname, (kern, plain) in calls.items():
                got, want = kern(), plain()
                if not isinstance(got, tuple):
                    got, want = (got,), (want,)
                label = f'{kname}[{name}, T={T}, KA shape]'
                ea, er = compare(label, [
                    (lab, g, w, RTOL, atol)
                    for lab, g, w in zip(('F', 'pe', 'virial'), got, want)])
                ka = name == 'lj' and T == 2
                ms = cuda_ms(kern, 50 if ka else 5)
                times.setdefault(kname, {}).setdefault(name, {})[T] = ms
                if ka:
                    key = kname + '_typed'
                    rows[key] = dict(max_abs_err=ea, bound_share=er, ms=ms,
                                     plain_ms=cuda_ms(plain, 3),
                                     device_ms=device_ms(kern, 10))
        if T == 2:
            b, cand, inr = typed_bounds(pos, tag, typ, cdim, sh,
                                        typed_table('lj', 2, dev)[0])
            for key, (b_ms, b_by) in b.items():
                rows[key].update(bound_ms=b_ms, bound_by=b_by)
                r = rows[key]
                print(f"phase {key} [KA lj, cell_dim={cdim} C={C} N={N}, "
                      f"{cand} candidate pairs, {inr} inside r_cut]: "
                      f"max_abs_err={r['max_abs_err']:.3e} "
                      f"kernel_ms={r['ms']:.4f} "
                      f"device_ms={r['device_ms']:.4f} "
                      f"plain_ms={r['plain_ms']:.4f} bound_ms={b_ms:.6f} "
                      f"({b_by})", flush=True)
        print(f"phase typed kernels T={T} [KA shape cell_dim={cdim} C={C}]: "
              + ', '.join(f"{k}[{n}] {t[n][T]:.4f} ms" for k, t in
                          times.items() for n in t if T in t[n]), flush=True)
    return rows, times


# ---------------------------------------------------------------------------
# HPMC


def mc_system(kind, dims=None, n=16, spacing=None, jitter=0.0, seed=0):
    """A fresh --mode=gpu context with the job script's integrator: 'cube'
    (config 5: convex_polyhedron(seed=11, d=0.15, a=0.2)), 'sphere'
    (sphere(seed=7, d=0.12), diameter 1) or 'mixture' (spheres of
    diameters 1.0 and 0.6 with d 0.12 and 0.2).  The particles sit on an
    sc lattice: n^3 of the job's spacing, or, with ``dims`` (a box of
    dims[i] * spacing) and a ``jitter``, a jittered, randomly rotated
    fill for the kernel phases."""
    import hoomd_tpu_torch as hoomd
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    a = ((1.0 / PHI_CUBES) ** (1.0 / 3.0) if kind == 'cube' else 1.05)
    if dims is None:
        hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=a), n=n)
    else:
        rng = np.random.RandomState(seed)
        L = np.asarray(dims, float)
        nl = np.floor(L / spacing).astype(int)
        g = [(np.arange(m) + 0.5) * (L[i] / m) - L[i] / 2
             for i, m in enumerate(nl)]
        pos = np.stack(np.meshgrid(*g, indexing='ij'), -1).reshape(-1, 3)
        N = len(pos)
        snap = hoomd.data.make_snapshot(
            N, hoomd.data.boxdim(Lx=L[0], Ly=L[1], Lz=L[2]),
            particle_types=['A', 'B'] if kind == 'mixture' else ['A'])
        snap.particles.position[:] = pos + rng.uniform(-jitter, jitter,
                                                       pos.shape)
        if kind == 'mixture':
            snap.particles.typeid[:] = np.arange(N) % 2
        axis = rng.normal(size=(N, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        half = rng.uniform(-0.1, 0.1, (N, 1)) if kind == 'cube' else \
            np.zeros((N, 1))
        snap.particles.orientation[:] = np.concatenate(
            [np.cos(half), np.sin(half) * axis], 1)
        hoomd.init.read_snapshot(snap)
    if kind == 'cube':
        mc = hoomd.hpmc.integrate.convex_polyhedron(seed=11, d=0.15, a=0.2)
        mc.shape_param.set('A', vertices=CUBE_VERTS)
    else:
        mc = hoomd.hpmc.integrate.sphere(seed=7, d=0.12)
        mc.shape_param.set('A', diameter=1.0)
        if kind == 'mixture':
            mc.shape_param.set('B', diameter=0.6)
            mc.set_params(d={'A': 0.12, 'B': 0.2})
    system = hoomd.context.current.system
    system._ensure_ready()
    return system, mc


def mc_inputs(system, mc, seed):
    """The planes one kernel call of the system's program takes, with
    class orders and uniforms from a seeded generator on the card."""
    import torch
    from hoomd_tpu_torch.hpmc import integrate as tint
    prog = system._program
    st = system.state
    cd, C = prog['cell_dim'], prog['C']
    poly = prog['shape'] == 'convex_polyhedron'
    idx, live, planes, ovf = tint.cell_planes(
        st.pos, st.box, cd, C, st.orientation if poly else None)
    if bool(ovf):
        raise RuntimeError(f"HPMC phase fill overflows C={C} on {cd}")
    kw = dict(cell_dim=cd, C=C, R=1, box_L=prog['box_L'])
    if poly:
        args = planes + [live]
        kw['tables'] = mc._fused_poly_tables(system)
    else:
        types = system.particle_types
        tc = torch.cat([st.typeid.long(), st.typeid.new_zeros(1).long()]
                       )[idx].reshape(live.shape)
        rad = torch.as_tensor(0.5 * mc._diameters(system),
                              dtype=torch.float32, device=live.device)
        dmv = torch.as_tensor([mc.get_d(t) for t in types],
                              dtype=torch.float32, device=live.device)
        args = planes + [rad[tc] * live, dmv[tc] * live, live]
    nx, ny, nz = cd
    gen = torch.Generator(device=live.device).manual_seed(seed)
    perms = torch.randperm(8, generator=torch.Generator().manual_seed(seed)
                           ).to(torch.int32)
    randu = torch.rand((8, 12 if poly else 6, nz, ny, nx), generator=gen,
                       device=live.device)
    extra = (tuple(np.float32(v) for v in (mc.get_d('A'), mc.get_a('A'),
                                           mc.move_ratio)),) if poly else ()
    return args, perms, randu, extra, kw, poly


def mc_compare(name, got, want, poly, cd, C, trials):
    """Kernel against plain: equal try counts; slots out of tolerance are
    flipped decisions, printed with their cells, at most one per
    FLIP_PER trials, and the accept counts differ by no more than they.
    Returns the largest error over the other slots."""
    import torch
    nplanes = 7 if poly else 3
    gc = [int(v) for v in (got[7] if poly else torch.stack(got[3:5]))]
    wc = [int(v) for v in (want[7] if poly else torch.stack(want[3:5]))]
    tries = (1, 3) if poly else (1,)
    if any(gc[i] != wc[i] for i in tries):
        raise RuntimeError(f"{name}: try counts differ, kernel {gc} plain "
                           f"{wc}")
    bad = torch.zeros_like(got[0], dtype=torch.bool)
    errs = []
    for k in range(nplanes):
        e = (got[k] - want[k]).abs()
        if not torch.isfinite(got[k]).all():
            raise RuntimeError(f"{name}: kernel plane {k} not finite")
        bad |= e > (MC_POS_TOL if k < 3 else MC_QUAT_TOL)
        errs.append(e)
    z, y, lane = torch.nonzero(bad, as_tuple=True)
    cells = sorted({(int(a), int(b), int(c) // C)
                    for a, b, c in zip(z, y, lane)})
    for cz, cy, cx in cells:
        print(f"  {name}: flipped decision in cell (z={cz}, y={cy}, "
              f"x={cx})", flush=True)
    acc = (0, 2) if poly else (0,)
    d_acc = sum(abs(gc[i] - wc[i]) for i in acc)
    if len(cells) > trials // FLIP_PER or d_acc > len(cells):
        raise RuntimeError(f"{name}: {len(cells)} flipped decisions in "
                           f"{trials} trials, accept counts {gc} vs {wc}")
    return max(float(e[~bad].max()) for e in errs)


def mc_bound(poly, stats, args, randu, nf):
    """Bytes: every input plane and the uniforms read once, every output
    plane written once.  Operations of the kernel's arithmetic for this
    data (transcendentals as one): per trial its proposal and commit
    (171 polyhedra, 60 spheres); per candidate pair its set-up (123:
    minimum image, relative rotation, edge images) or distance test
    (23); per SAT axis up to the pair's first separating one 78 (face)
    or 141 (edge x edge)."""
    plane = args[0].numel() * 4
    nbytes = (len(args) + (7 if poly else 3)) * plane + randu.numel() * 4
    if poly:
        ops = (171 * stats['trials'] + 123 * stats['pairs']
               + 78 * stats['face_axes'] + 141 * stats['edge_axes'])
    else:
        ops = 60 * stats['trials'] + 23 * stats['pairs']
    return bound(nbytes, ops)


def hpmc_kernel_phases():
    """Each sweep kernel against its plain version at the job's plan, a
    32^3-lattice fill and a ragged grid.  Returns the job-plan row of
    each kernel."""
    from hoomd_tpu_torch.hpmc import sweep as tsw
    shapes = {
        'fused_poly_sweep': [
            ('job', dict(kind='cube')),
            ('fill32', dict(kind='cube', n=32)),
            ('ragged', dict(kind='cube', dims=(4 * 2.1, 6 * 2.1, 8 * 2.1),
                            spacing=1.4, jitter=0.1, seed=1))],
        'fused_sphere_sweep': [
            ('job', dict(kind='sphere')),
            ('fill32', dict(kind='sphere', n=32)),
            ('ragged', dict(kind='mixture', dims=(4 * 1.45, 6 * 1.45,
                                                  8 * 1.45),
                            spacing=1.05, jitter=0.01, seed=2))],
    }
    out = {}
    for kname, cases in shapes.items():
        kern = getattr(tsw, kname)
        plain = getattr(tsw, kname + '_plain')
        for tag_name, spec in cases:
            system, mc = mc_system(**spec)
            cd, C = system._program['cell_dim'], system._program['C']
            N = system.state.N
            worst, trials, stats = 0.0, 0, {}
            for seed in (1, 2, 3):
                args, perms, randu, extra, kw, poly = mc_inputs(system, mc,
                                                                seed)
                got = kern(*args, perms, randu, *extra, **kw)
                want = plain(*args, perms, randu, *extra, stats=stats, **kw)
                trials = stats['trials']
                worst = max(worst, mc_compare(f'{kname}[{tag_name}]', got,
                                              want, poly, cd, C, trials))
            iters = 50 if tag_name != 'fill32' else 10

            def k_fn():
                return kern(*args, perms, randu, *extra, **kw)

            def p_fn():
                return plain(*args, perms, randu, *extra, **kw)
            row = dict(max_abs_err=worst, ms=cuda_ms(k_fn, iters),
                       plain_ms=cuda_ms(p_fn, 2))
            # the bound of one call, from the work of the three calls
            per_call = {k: v / 3 for k, v in stats.items()}
            row['bound_ms'], row['bound_by'] = mc_bound(
                poly, per_call, args, randu,
                len(kw['tables'][1]) if poly else 0)
            print(f"phase {kname} [{tag_name} cell_dim={cd} C={C} N={N}]: "
                  f"max_abs_err={worst:.3e} trials={trials} "
                  f"pairs/call={per_call['pairs']:.0f} "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})",
                  flush=True)
            if tag_name == 'job':
                out[kname] = row
    return out


def device_profile(run, what, top=8, per_launch=None):
    """torch.profiler over run(): wall time, summed device kernel time,
    their ratio (the device's busy share; the profiler inflates host
    time) and the device time of the top kernels.  Returns the busy
    share; with ``per_launch`` (a kernel name, or part of one) also the
    device ms per launch of the kernels so named."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats its kernels'
        t = getattr(e, 'self_device_time_total', None)
        if t is None:
            t = getattr(e, 'self_cuda_time_total', 0.0)
        if e.device_type == DeviceType.CUDA and t > 0:
            rows.append((t, e.count, e.key))
    dev = sum(r[0] for r in rows) / 1e3
    print(f"profile {what}: wall {wall * 1e3:.3f} ms, device kernel time "
          f"{dev:.3f} ms, busy share {dev / (wall * 1e3):.4f}", flush=True)
    for t, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {t / 1e3:9.3f} ms {count:6d}x  {key[:80]}", flush=True)
    if per_launch is None:
        return dev / (wall * 1e3)
    named = [(t, n) for t, n, key in rows if per_launch in key]
    return (dev / (wall * 1e3),
            sum(t for t, _ in named) / 1e3 / max(sum(n for _, n in named), 1))


def hpmc_job(kind, card):
    """One HPMC job script at full size on the card: 50 settle sweeps,
    then 200 timed ones.  Prints its metric line and checks zero
    overlaps, the translate acceptance against the JAX package's, and
    the launches of its kernel.  Returns the launch counts."""
    import torch
    system, mc = mc_system(kind)
    reset_launch_counts()
    N = system.state.N
    system.run(50, quiet=True)
    c0 = mc.get_counters()
    sweeps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(sweeps, quiet=True)
    elapsed = time.perf_counter() - t0
    c1 = mc.get_counters()
    counts = launch_counts()
    d = {k: c1[k] - c0[k] for k in ('translate_accept', 'translate_reject',
                                    'rotate_accept', 'rotate_reject')}
    moves = sum(d.values())
    t_acc = d['translate_accept'] / max(1, d['translate_accept']
                                        + d['translate_reject'])
    r_acc = (d['rotate_accept'] / max(1, d['rotate_accept']
                                      + d['rotate_reject']))
    name = ('hpmc_convex_polyhedra_4k' if kind == 'cube'
            else 'hpmc_hard_spheres_4k')
    prog = system._program
    print(json.dumps({
        "metric": f"{name}_trial_moves_per_sec", "value": moves / elapsed,
        "unit": "trial-moves/s/chip",
        "extra": {"N": N, "sweeps": sweeps, "elapsed_s": elapsed,
                  "trial_moves": moves, "translate_acceptance": t_acc,
                  "rotate_acceptance": r_acc,
                  "cell_dim": list(prog['cell_dim']), "C": prog['C'],
                  "card": card, "package": "torch"}}), flush=True)
    overlaps = mc.count_overlaps()
    ref = CUBE_TRANSLATE_ACC if kind == 'cube' else SPHERE_TRANSLATE_ACC
    kname = 'fused_poly_sweep' if kind == 'cube' else 'fused_sphere_sweep'
    print(f"{kind} job: translate acceptance {t_acc:.4f} (JAX package "
          f"{ref}), rotate {r_acc:.4f}, overlaps {overlaps}, "
          f"launches={counts}", flush=True)
    if overlaps != 0:
        raise RuntimeError(f"{kind} job: {overlaps} overlapping pairs")
    if abs(t_acc - ref) > ACC_BAND:
        raise RuntimeError(f"{kind} job: translate acceptance {t_acc:.4f} "
                           f"outside {ref} +- {ACC_BAND}")
    if counts[kname] <= 0:
        raise RuntimeError(f"{kind} job never launched {kname}")
    # where a sweep's time goes, after the checked window
    device_profile(lambda: system.run(50, quiet=True), f'50 {kind} sweeps')
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import hoomd_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hoomd_tpu_torch.ops import _build
    dev = torch.device('cuda', 0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc, all sources in parallel, {lib.build_seconds:.2f} s) -> "
          f"{', '.join(p.name for p in lib.paths)}", flush=True)
    for line in lib.build_log.splitlines():
        if ('registers' in line or 'spill' in line or 'error' in line
                or line.startswith('==')):
            print(f"  ptxas: {line.strip()}", flush=True)
    rows = kernel_phases(dev)
    rows['cell_megastep_planes'], mega_eval_ms = megastep_phases(dev)
    parent_megastep_phase(dev)
    window_torch_calls(dev)
    rows.update(step_plane_phases(dev))
    eval_rows = eval_kernel_phases(dev)
    for name, ms in mega_eval_ms.items():
        if name in eval_rows:
            eval_rows[name]['cell_megastep_planes'] = dict(ms=ms)
    rows.update(impl_kernel_phases(dev))
    typed_rows, typed_ms = typed_kernel_phases(dev)
    rows.update(typed_rows)
    rows.update(rebin_kernel_phases(dev))
    rows.update(hpmc_kernel_phases())
    print(f"kernel phases done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    # each path's own launches, read just after it ran
    launches = bench_script(card)
    counts, system = rebin_job('pallas')
    for name in ('cell_rebin_sweep', 'cell_rebin_place'):
        launches[name] = counts[name]
    rebin_job('off')
    counts = variants_path(system)
    rebuild_phase(system)
    for name in ('cell_rebin_select', 'cell_rebin_serial'):
        launches[name] = counts[name]
    for impl, kname in IMPL_KERNELS.items():
        launches[kname] = impl_job(impl)[kname]
    impl_job('plane', mega='off')
    launches['cell_step_plane_planes'] = fused_job()['cell_step_plane_planes']
    for name in EVAL_JOBS:
        eval_job(name)
    launches['cell_pair_planar_typed'] = ka_job(card)['cell_pair_planar_typed']
    launches['cell_pair_planar_n3l_typed'] = ka_n3l_job()[
        'cell_pair_planar_n3l_typed']
    print(f"MD jobs done at {time.perf_counter() - t0:.1f} s", flush=True)
    launches['fused_poly_sweep'] = hpmc_job('cube', card)['fused_poly_sweep']
    launches['fused_sphere_sweep'] = hpmc_job('sphere', card)[
        'fused_sphere_sweep']
    replaces = {
        'cell_megastep_planes': ('hoomd_tpu/ops/pallas_pair.py:1978',
                                 'cell_pair.cu'),
        'cell_pair_plane': ('hoomd_tpu/ops/pallas_pair.py:1173',
                            'cell_pair.cu'),
        'cell_pair_planar': ('hoomd_tpu/ops/pallas_pair.py:609',
                             'cell_pair.cu'),
        'cell_step_plane_planes': ('hoomd_tpu/ops/pallas_pair.py:1754',
                                   'cell_step.cu'),
        'cell_pair_lj': ('hoomd_tpu/ops/pallas_pair.py:43',
                         'cell_pair_impls.cu'),
        'cell_pair_lj_pallas3d': ('hoomd_tpu/ops/pallas_pair.py:332',
                                  'cell_pair_impls.cu'),
        'cell_pair_lj_row': ('hoomd_tpu/ops/pallas_pair.py:464',
                             'cell_pair_impls.cu'),
        'cell_pair_planar_n3l': ('hoomd_tpu/ops/pallas_pair.py:937',
                                 'cell_pair_impls.cu'),
        # the typed branches of the same two TPU kernels (pallas_pair.py
        # :666-691, :944-990)
        'cell_pair_planar_typed': ('hoomd_tpu/ops/pallas_pair.py:609',
                                   'cell_pair_typed.cu'),
        'cell_pair_planar_n3l_typed': ('hoomd_tpu/ops/pallas_pair.py:937',
                                       'cell_pair_impls.cu'),
        'fused_poly_sweep': ('hoomd_tpu/hpmc/pallas_sweep.py:293',
                             'hpmc_sweep.cu'),
        'fused_sphere_sweep': ('hoomd_tpu/hpmc/pallas_sweep.py:50',
                               'hpmc_sweep.cu'),
        'cell_rebin_select': ('hoomd_tpu/ops/pallas_rebin.py:358',
                              'cell_rebin.cu'),
        'cell_rebin_sweep': ('hoomd_tpu/ops/pallas_rebin.py:409',
                             'cell_rebin.cu'),
        'cell_rebin_place': ('hoomd_tpu/ops/pallas_rebin.py:455',
                             'cell_rebin.cu'),
        'cell_rebin_serial': ('hoomd_tpu/ops/pallas_rebin.py:210',
                              'cell_rebin.cu'),
    }
    # no single PyTorch call computes a cell-stencil LJ step, an HPMC
    # sweep or a cell rebin, so library_ms is null for every kernel here
    kernels = [{"name": name, "route": "cuda",
                "source": f"hoomd_tpu_torch/csrc/{src}", "replaces": rep,
                "launches": launches[name],
                "max_abs_err": rows[name]['max_abs_err'],
                "ms": rows[name]['ms'], "plain_ms": rows[name]['plain_ms'],
                "bound_ms": rows[name]['bound_ms'],
                "bound_by": rows[name]['bound_by'], "library_ms": None}
               for name, (rep, src) in replaces.items()]
    print(json.dumps({"evaluator_kernels_ms": {
        name: {k: r['ms'] for k, r in row.items()}
        for name, row in eval_rows.items()}}), flush=True)
    # the half stencil and the typed planar kernel at the KA shape, per
    # evaluator and number of types
    print(json.dumps({"typed_kernels_ms": typed_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
