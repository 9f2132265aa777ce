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
     failing past tolerance; cell_pair_plane and cell_pair_planar also
     on a 2x2x2 grid and against a second call bit for bit, with their
     device time and build at the bench shape; the fused step
     (cell_step_plane_planes) NVE and NVT also on a 2x2x2 grid, its
     drifted positions bit for bit;
  3a. per other pair evaluator (EVAL_JOBS), at the bench fill: the plane,
     planar and fused-step kernels against their plain versions with the
     evaluator's ATOL (EVAL_ATOL), the plane and planar kernels also
     against a second call bit for bit;
  3b. the megastep (megastep_phases) at the bench, ragged and 2x2x2
     shapes: its candidate set (counts, lists) against the plain
     builder bit for bit and two builds equal, with its build time (at
     the bench fill also its device time, bound and build); for LJ and each other
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
     shape and at (5, 3, 4), C = 32, and on two overflowing fills; at the
     bench shape each wrapper call's host time and device time per
     recorded launch with its share of the bound, and the sweep's and the
     place's builds;
  5. one phase per HPMC sweep kernel (fused_poly_sweep,
     fused_sphere_sweep): the kernel against its plain torch version on
     the same planes, class orders and uniforms at three shapes (the job
     script's plan, a 32^3-lattice fill, a ragged grid), with equal try
     counts, every slot within 1e-5 (positions) and 1e-6 (quaternions)
     but for at most 1 flipped decision per 10^4 trials (each printed
     with its cell), CUDA-event times, the device time and each
     kernel's build (registers, spills, shared memory, blocks per SM).
     Where a copy of the parent's csrc lies under
     scratch/parent/hoomd_tpu_torch/csrc, parent_sweep_lj_phase builds
     each stem of its table PARENT_KERNELS whose source or headers
     differ from this tree's (hpmc_sweep.cu: rows 13 and 14, planes and
     counts bit for bit on three seeds; cell_pair_impls.cu: rows 4, 5
     and 6, the parent's bits; cell_step.cu: row 8, every output the
     parent's bits; cell_pair.cu: the
     megastep's candidate build, the parent's counts and lists bit for
     bit, and rows 2 and 3, cell_pair_plane and cell_pair_planar, for
     every evaluator (plane's lj also with the fast reciprocal) on the
     ragged, 2x2x2 and bench fills, every output the parent's bits;
     cell_rebin.cu: rows 10 and 11, every output the parent's bits,
     each design through its own wrapper, also on the pallas job's live
     liquid in rebuild_phase) under another name and times both designs
     in turns, as wrapper calls and as device time per recorded launch,
     with the parent's builds as ptxas printed them.  A device time the profiler could not
     read (device_ms: no device kernel listed in three tries) prints as
     "not measured", with no share of the bound;
  4a. one phase per force kernel of the other HOOMD_TPU_FAST_IMPL paths
     (cell_pair_lj, cell_pair_lj_pallas3d, cell_pair_lj_row,
     cell_pair_planar_n3l): the kernel against its plain torch version at
     the bench shape, the ragged shape and a 2x2x2 grid, as in 3
     (cell_pair_lj_pallas3d also two calls bit for bit; cell_pair_lj
     and cell_pair_lj_pallas3d their device time and build); then
     the cross-kernel phase: on the bench fill the four kernels' forces
     and cell_pair_plane's agree, and cell_pair_lj's PE and virial
     cell_pair_planar's;
  4b. the mixtures' kernels (typed_kernel_phases) at the Kob-Andersen
     shape (64 000 particles at rho = 1.2 on the engine's plan of the
     KA start): for every evaluator the typed planar kernel (two and four
     types) and the half stencil (one, two and four types) against their
     plain versions with the evaluator's ATOL, each with its CUDA-event
     time; for the KA table also the device time (the half stencil's
     fold apart), the plain version's time, the bound, and the kernels'
     registers, spills, shared memory and blocks per SM;
  4c. the charged kernel (charged_kernel_phases) at config 4's shape
     (4096 ions of the rock-salt start jittered by 0.05 of the spacing,
     cell grid (8, 5, 4), C = 40): ewald and lj_ewald with one, two and
     four types, cell_pair_planar with cell_q against its plain version
     (RTOL, ATOL), with the wrapper call's CUDA-event time, the device
     time, the plain version's time, the bound, and the kernel's
     registers, spills, shared memory, blocks per SM and warps per
     block;
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
     profiler's device time, and the megastep's candidate set of the
     job's live reference equal to the plain builder's, a second
     build's and (with the parent's csrc, above) the parent design's,
     bit for bit; then the same script to the melt plus 1000
     NVT steps with HOOMD_TPU_FAST_IMPL = planar_n3l, pallas, pallas3d,
     row and planar, and with plane plus HOOMD_TPU_MEGA=off, each with the same
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
     single-type stencil launched, T and PE/N at the window's end equal
     to the parent design's bit for bit (KA_PARENT_T, KA_PARENT_PE), the
     kernel's F, PE and virial on the end state against its plain
     version's, ms per step, busy share, and a 1000-step NVE
     continuation gated on its drift; and the same script
     with HOOMD_TPU_FAST_IMPL=planar_n3l (300 NVT steps, the typed half
     stencil launched); then BASELINE config 4, the PPPM charged fluid
     (pppm_job: bench_all.py:158-217's script, 4096 ions, pair.lj and
     md.charge.pppm on a 32^3 mesh, Nose-Hoover NVT): its metric line
     pppm_fluid_4k_particle_steps_per_sec, finite state, the NVT window's
     T = 1 +- 0.05, the start's plan, every step on the charged typed kernel and no other kernel,
     the kernel equal to its plain version on the end state, its busy
     share, and 500 NVE steps on its mesh and 500 on a 64^3 mesh, the
     latter gated on the drift of the energy it conserves; the window's
     mean PE/N over four velocity seeds against the JAX package's; then
     the NaCl Madelung energy (madelung_job: 512 ions of one type, pppm
     alone, the one-type charged kernel held to its plain version at
     that job's plan) to rel 2e-3; then BASELINE config 3, the
     Kremer-Grest melt (kg_job: bench_all.py:80-155's script, 1024
     chains of 32 beads, WCA pairs, FENE bonds, harmonic angles, the
     default exclusions, Langevin at kT = 1): its metric line
     kremer_grest_32k_particle_steps_per_sec, a finite state with every
     tag kept, T = 1 +- 0.03 over the timed window, every bond shorter
     than r0 sqrt(0.99), the plane kernel on every step and the planar
     kernel at every thermo read, no megastep and no fused step, the
     rebin of its gate; the torch calls of a step, its busy share and the
     plane kernel's device time per recorded launch; the step's force
     (the plane kernel plus the bonded terms and the exclusion
     correction) against a float64 sum on the card; a 1000-step NVE
     continuation gated on its drift; and the mean PE/N of its window at
     4096 beads over four seeds against the JAX package's (KG_PE_JAX).
     The bench job's T and PE/N must equal the recorded PR6_BENCH_T and
     PR6_BENCH_PE bit for bit;
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
     fp32; its launches those of the path that runs the kernel, the
     plane and planar kernels' those of the plane + HOOMD_TPU_MEGA=off
     and planar jobs, which run them every step), the card line, and the
     final {"ok": true, "device": {...}} line.
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
from types import SimpleNamespace as types_ns

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
    """Bound of each LJ kernel at this fill.  The function needs each
    unordered pair once, whichever side a kernel evaluates it from: 8
    operations per candidate pair (the r^2 test), 15 more per pair
    inside r_cut for the force and 3 for its -F on the other particle,
    12 more for PE and virial (half of each to each side), so (8 cand +
    18 inr) / 2 for forces and (8 cand + 30 inr) / 2 with PE and virial
    (cand and inr count ordered pairs); and 30 per particle and step for
    a megastep window's or the fused step's kick, drift and thermostat
    sums."""
    cand, inr = lj_pair_counts(pos, tag, cdim, sh, 2.5)
    slots = pos.shape[0] * pos.shape[1]
    P = slots * 4                                  # one f32 per slot
    sh_bytes = sh.numel() * 4
    adj_bytes = sh.numel() // 3 * 4
    f_ops = (8 * cand + 18 * inr) / 2
    pv_ops = (8 * cand + 30 * inr) / 2
    force = bound(3 * P + P + sh_bytes + 3 * P, f_ops)
    return {
        'cell_pair_plane': force,
        'cell_pair_planar': bound(3 * P + P + sh_bytes + 10 * P, pv_ops),
        # in: pos, vel, frc, ref pos (3 planes each), 1/m, m, tags;
        # out: pos, vel, frc
        'cell_megastep_planes': bound(15 * P + sh_bytes + 9 * P,
                                      k * (f_ops + 30 * N)),
        # in: pos, vel, frc, ref pos (3 planes each), 1/m, tags; out:
        # pos, vel, frc, and per slot the drift, kick and sums (30 ops)
        'cell_step_plane_planes': bound(14 * P + sh_bytes + 9 * P,
                                        f_ops + 30 * N),
        'cell_pair_lj': bound(3 * P + P + adj_bytes + sh_bytes + 10 * P,
                              pv_ops),
        'cell_pair_lj_pallas3d': force,
        'cell_pair_lj_row': force,
        'cell_pair_planar_n3l': force,
    }


def kernel_phases(dev):
    """cell_pair_plane (fast reciprocal) and cell_pair_planar against
    their plain versions at the bench, ragged and 2x2x2 shapes, element
    by element, each also against a second call bit for bit (the ordered
    walk of csrc/cell_walk.cuh sums in a fixed order); at the bench shape
    each kernel's device time per recorded launch, its share of the
    bound and its build.  Returns the bench rows."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    results = {}
    pv, _ = lj_params(dev)
    for tag_name, (dims, cdim, C) in SHAPES.items():
        carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag = carry.pos, carry.tag
        bench = tag_name == 'bench'
        iters = 50 if bench else 5
        piters = 3 if bench else 1
        calls = {
            # the thermostat path: the fast reciprocal
            'cell_pair_plane': (
                lambda: cp.cell_pair_plane(pos, cdim, sh, pv, C=C,
                                           cell_tag=tag, recip='approx'),
                lambda: cp.cell_pair_plane_plain(pos, cdim, sh, pv,
                                                 cell_tag=tag)),
            'cell_pair_planar': (
                lambda: cp.cell_pair_planar(pos, cdim, sh, pv, C=C,
                                            cell_tag=tag),
                lambda: cp.cell_pair_planar_plain(pos, cdim, sh, pv,
                                                  cell_tag=tag))}
        bounds = lj_bounds(pos.reshape(-1, C, 3), tag.reshape(-1, C), cdim,
                           sh, N, 4)
        row = {}
        for kname, (kern, plain) in calls.items():
            got, want = kern(), plain()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            ea, er = compare(f'{kname}[{tag_name}]', [
                (lab, g, w, RTOL, ATOL)
                for lab, g, w in zip(('F', 'pe', 'virial'), got, want)])
            again = kern()
            if not same_bits(got, again if isinstance(again, tuple)
                             else (again,)):
                raise RuntimeError(f"{kname}[{tag_name}]: two calls differ")
            r = row[kname] = dict(max_abs_err=ea, bound_share=er,
                                  ms=cuda_ms(kern, iters),
                                  plain_ms=cuda_ms(plain, piters))
            r['bound_ms'], r['bound_by'] = bounds[kname]
            extra = ''
            if bench:
                kernels = device_kernels(kern, 20)
                r['device_ms'] = recorded_ms(kernels)[0]
                r['build'] = (
                    occ_build('hoomd_cell_pair_plane_occupancy', 0, 1,
                              cdim[0], C) if kname == 'cell_pair_plane' else
                    occ_build('hoomd_cell_pair_planar_occupancy', 0, cdim[0],
                              C))
                extra = (f" device_ms={dev_fmt(r['device_ms'])} "
                         f"({kernels_fmt(kernels)}), "
                         f"{share_fmt(r['bound_ms'], r['device_ms'])}; "
                         f"{sweep_build_line(r['build'])}")
            print(f"phase {kname} [{tag_name} cell_dim={cdim} C={C} N={N}]: "
                  f"max_abs_err={ea:.3e} bound_share={er:.3f} two calls "
                  f"bit-identical; kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})" + extra,
                  flush=True)
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
    the ragged shape and a 2x2x2 grid; at the bench shape the NVT
    variant's device time (per recorded launch) and build.  Returns the
    bench row (times of the NVT variant, the fused NVT job's)."""
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
        extra = ''
        if tag_name == 'bench':
            # the NVT kernel (lj, fast reciprocal) and the finishing pass
            kernels = device_kernels(k_step, 10)
            row['device_ms'] = recorded_ms(kernels)[0]
            row['build'] = occ_build('hoomd_step_plane_occupancy',
                                     cp.pair_eval.EVAL_IDS['lj'], 1,
                                     cdim[0], C)
            extra = (f"; device_ms={dev_fmt(row['device_ms'])} "
                     f"({kernels_fmt(kernels)}), "
                     f"{share_fmt(row['bound_ms'], row['device_ms'])}; "
                     f"{sweep_build_line(row['build'])}")
        print(f"phase cell_step_plane_planes [{tag_name} cell_dim={cdim} "
              f"C={C} N={N}]: positions bit-exact, max_abs_err={worst[0]:.3e} "
              f"bound_share={worst[1]:.3f} kernel_ms={row['ms']:.4f} (nvt) "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']})" + extra, flush=True)
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
    versions, element by element with the evaluator's ATOL (the plane
    and planar kernels also against a second call bit for bit), and each
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
                again = kern()
                if not same_bits(got, again if isinstance(again, tuple)
                                 else (again,)):
                    raise RuntimeError(f"{label}: two calls differ")
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


def written(cand):
    """(count, listed) of a candidate set, each row of listed as far as it
    is written and zero after, as the plain version gives it."""
    import torch
    n = torch.clamp(cand.count, max=cand.cap).long()
    used = torch.arange(cand.cap, device=n.device)[None, :] < n[:, None]
    return cand.count, torch.where(used, cand.listed, 0)


def same_candidates(name, cand, plain, what="the plain version's"):
    """The kernel's candidate set against another's (count, listed, as
    ``written`` gives them): the counts equal, and each slot's list equal
    as far as it is written."""
    import torch
    count, listed = plain
    got = written(cand)
    if not torch.equal(got[0], count):
        raise RuntimeError(f"{name}: the kernel's counts differ from {what}")
    if not torch.equal(got[1], listed):
        raise RuntimeError(f"{name}: the kernel's candidate lists differ from "
                           f"{what}")


def candidates_bound(cand, pos, tag, cdim, sh):
    """Bound of one candidate build: 12 operations per pair the answer
    needs tested (each live slot against every other live slot of its 27
    cells, as lj_pair_counts counts them: three differences, magnitudes,
    skins subtracted, clamps, squares and sums, one compare; padding
    slots need no test) against the bytes of the reference planes, tags
    and shifts in and of the written list entries and the counts out."""
    pairs, _ = lj_pair_counts(pos, tag, cdim, sh, 2.5)
    M = cand.count.numel()
    written = int(cand.count.clamp(max=cand.cap).sum())
    nbytes = (3 * M + M) * 4 + sh.numel() * 4 + written * 2 + M * 4
    return bound(nbytes, 12 * pairs)


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
    bit, and two builds equal (at the bench fill also its time, device
    time, bound and build); per pair evaluator, method (nve, nvt, langevin) and k in (1, 4),
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
    bound of the candidates visited), each evaluator's wrapper ms of
    that window and the candidate build's row at the bench fill."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    row, eval_ms, cand_row = None, {}, None
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
                    same_candidates(f'mega_candidates[{tag_name},{label}] '
                                    f'built twice', cp.mega_candidates(
                                        gr, gt, cdim, sh, s_pads, rc2, C=C),
                                    written(cand), 'the first build')
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
                        cand_ms = build_times(lambda: cp.mega_candidates(
                            gr, gt, cdim, sh, pads, rc2, C=C))
                        cand_ms['plain_ms'] = cuda_ms(
                            lambda: cp.mega_candidates_plain(
                                gr, gt, cdim, sh, pads, rc2, C=C), 3)
                        cand_ms['per_slot'] = per
                        cand_ms['bound_ms'], cand_ms['bound_by'] = \
                            candidates_bound(cand, carry.pos, carry.tag,
                                             cdim, sh)
                        cand_ms['build'] = occ_build(
                            'hoomd_mega_candidates_occupancy', cdim[0], C)
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
                  f"per build (CUDA events; host {cand_ms['host_ms']:.4f} ms "
                  f"per call), device {dev_fmt(cand_ms['device_ms'])} "
                  f"ms per call from the recorded launches "
                  f"({kernels_fmt(cand_ms['kernels'])}), plain "
                  f"{cand_ms['plain_ms']:.4f} ms, bound "
                  f"{cand_ms['bound_ms']:.6f} ms ({cand_ms['bound_by']}), "
                  f"{share_fmt(cand_ms['bound_ms'], cand_ms['device_ms'])}; "
                  f"{cand_ms['per_slot']:.1f} candidates per live slot; "
                  f"{sweep_build_line(cand_ms['build'])}", flush=True)
            cand_row = dict(max_abs_err=0.0, **{
                key: cand_ms[key] for key in ('ms', 'plain_ms', 'bound_ms',
                                              'bound_by')})
    return row, eval_ms, cand_row


def same_bits(a, b):
    """Every tensor of a equal to b's, bit for bit."""
    import torch
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def ptxas_build(log, kernel):
    """The lines ptxas -v printed for each entry function whose name holds
    ``kernel``: its registers, spills and static shared memory."""
    out, cur = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            cur = kernel in line
        elif cur and ('registers' in line or 'spill' in line):
            out.append(line.split(':', 1)[-1].strip())
    return '; '.join(out) or 'no ptxas lines'


def on_parent(mod, lib, call, attrs=None):
    """call, run with ``lib`` (parent_sweep_lj_phase's library of the
    parent design) as mod's kernel library and with mod's attributes
    ``attrs`` (name: value) replaced, mod's own put back after."""
    def run():
        own = mod._kernel_lib()
        kept = {k: getattr(mod, k) for k in attrs or {}}
        mod._LIB[0] = lib
        for k, v in (attrs or {}).items():
            setattr(mod, k, v)
        try:
            return call()
        finally:
            mod._LIB[0] = own
            for k, v in kept.items():
                setattr(mod, k, v)
    return run


def parent_module(src, name):
    """The parent's copy of hoomd_tpu_torch/ops/{name}.py, beside its csrc
    under ``src``, loaded as parent_pkg.ops.{name} (parent_pkg and
    parent_pkg.ops stand for the parent's package and its ops, without
    running their __init__), so that a case can take a host-side rule of
    the parent's wrapper (row 6: its tile width) or the parent's wrapper
    itself (rows 10 and 11), and the phase the parent's signatures
    (_build).  The parent's ops modules launch on parent_sweep_lj_phase's
    library: it puts that library in the parent's cell_pair._LIB."""
    import importlib
    import types
    from pathlib import Path
    root = Path(src).parent
    for pkg, path in (('parent_pkg', root), ('parent_pkg.ops', root / 'ops')):
        if pkg not in sys.modules:
            mod = types.ModuleType(pkg)
            mod.__path__ = [str(path)]
            sys.modules[pkg] = mod
    return importlib.import_module(f'parent_pkg.ops.{name}')


def csrc_changed(stem, src):
    """Whether csrc/{stem}.cu, or a header it includes, differs byte for
    byte from the parent's copy under ``src``."""
    import re
    from pathlib import Path
    here = Path(__file__).resolve().parent / 'hoomd_tpu_torch' / 'csrc'
    todo, seen = [f'{stem}.cu'], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        ours, theirs = here / name, Path(src) / name
        if not theirs.exists() or ours.read_bytes() != theirs.read_bytes():
            return True
        todo += re.findall(r'#include "([^"]+)"', ours.read_text())
    return False


def sweep_cases(dev):
    """parent_sweep_lj_phase's cases of the HPMC sweeps, each on three
    seeds, planes and counts bit for bit: row 13 (fused_sphere_sweep) at
    the sphere job's plan and at a ragged two-radius mixture, row 14
    (fused_poly_sweep) at the cube job's plan."""
    from hoomd_tpu_torch.hpmc import sweep as tsw

    def bits(got, want):
        if not same_bits(got, want):
            raise RuntimeError(
                f"planes or counts differ from the parent's (counts "
                f"{[t.tolist() for t in got if t.numel() <= 8]} against "
                f"{[t.tolist() for t in want if t.numel() <= 8]})")
        return "planes and counts equal to the parent's bit for bit"

    def calls(system, mc, sweep, poly):
        out = []
        for seed in (1, 2, 3):
            args, perms, randu, extra, kw, _ = mc_inputs(system, mc, seed)
            args = (*args, perms, randu, *(extra if poly else ()))
            out.append(lambda args=args, kw=kw: sweep(*args, **kw))
        return out, kw
    cases = []
    for tag, spec in {'job': dict(kind='sphere'),
                      'ragged': dict(kind='mixture',
                                     dims=(4 * 1.45, 6 * 1.45, 8 * 1.45),
                                     spacing=1.05, jitter=0.01,
                                     seed=2)}.items():
        fns, kw = calls(*mc_system(**spec), tsw.fused_sphere_sweep, False)
        cases.append((f'13 {tag}', f"row 13 (fused_sphere_sweep, {tag} plan "
                      f"cell_dim={kw['cell_dim']} C={kw['C']})", tsw, fns,
                      bits))
    fns, kw = calls(*mc_system('cube'), tsw.fused_poly_sweep, True)
    cases.append(('14 job', f"row 14 (fused_poly_sweep, cube job plan "
                  f"cell_dim={kw['cell_dim']} C={kw['C']})", tsw, fns, bits))
    return cases


def bench_fill(dev):
    """The bench shape's lattice fill as the parent cases take it: the
    cell-major carry, its plan, shifts (adjacency and table), the plane
    state's reference planes and tags, the candidate pads and the LJ
    vector of cell_pair_lj."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    dims, cdim, C = SHAPES['bench']
    carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    adj, sh = cp.build_cell_shifts(cdim, L)
    sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
    skin = np.maximum(L / np.asarray(cdim) - 2.5, 0.4).astype(np.float32)
    st = plane_state(carry, cdim, C, sh, lj_params(dev)[0])
    return types_ns(
        carry=carry, cdim=cdim, C=C, sh=sh,
        adj=torch.as_tensor(adj, dtype=torch.int32, device=dev),
        gr=st['gr'].contiguous(), gt=st['gt'].to(torch.int32).contiguous(),
        pads=cp.candidate_pads(skin, L), ljv=lj_params(dev)[1],
        where=f"bench cell_dim={cdim} C={C}")


def lj_cases(dev):
    """parent_sweep_lj_phase's cases of cell_pair_impls.cu at the bench
    shape: rows 4 (cell_pair_lj), 5 (cell_pair_lj_pallas3d) and 6
    (cell_pair_lj_row, the parent's kernel at its own wrapper's tile
    width) the parent's bits, row 6 also two calls with equal bits."""
    from hoomd_tpu_torch.ops import cell_pair as cp
    b = bench_fill(dev)
    pos, tag = b.carry.pos, b.carry.tag

    def bits(call=None):
        def check(got, want):
            got, want = (x if isinstance(x, tuple) else (x,)
                         for x in (got, want))
            if not same_bits(got, want):
                raise RuntimeError("the new design differs from the parent's")
            if call is not None and not same_bits(got, (call(),)):
                raise RuntimeError("two calls differ")
            return "the parent's bits" + (
                "; two calls with equal bits" if call else "")
        return check

    def row6():
        return cp.cell_pair_lj_row(pos, b.cdim, b.sh, b.ljv, C=b.C,
                                   cell_tag=tag)
    return [
        ('4 bench', f"row 4 (cell_pair_lj, {b.where})", cp,
         [lambda: cp.cell_pair_lj(pos, b.adj, b.sh, b.ljv,
                                  ncells=pos.shape[0], C=b.C, cell_tag=tag)],
         bits()),
        ('5 bench', f"row 5 (cell_pair_lj_pallas3d, {b.where})", cp,
         [lambda: cp.cell_pair_lj_pallas3d(pos, b.cdim, b.sh, b.ljv, C=b.C,
                                           cell_tag=tag)],
         bits()),
        ('6 bench', f"row 6 (cell_pair_lj_row, {b.where}, tiles of "
         f"{cp.row_tile(b.cdim[0], b.C)} cells)", cp, [row6], bits(row6),
         ('row_tile',))]


def step_cases(dev):
    """parent_sweep_lj_phase's cases of cell_step.cu: the fused step
    (cell_step_plane_planes) at the bench fill, LJ NVT (fast reciprocal),
    LJ NVE (exact divide) and mie: positions, velocities, forces, ke2
    and md2 the parent's bits."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    b = bench_fill(dev)

    def check(got, want):
        if not same_bits(got, want):
            raise RuntimeError("an output differs from the parent's")
        return ("positions, velocities, forces, ke2 and md2 the parent's "
                "bits")
    out = []
    for key, name, recip, s in (
            ('nvt', 'lj', 'approx', float(np.exp(-0.0025 * 0.2))),
            ('nve', 'lj', 'div', 1.0), ('mie', 'mie', 'div', 1.0)):
        if name == 'lj':
            pv, ek = lj_params(dev)[0], {}
        else:
            pv, pn, _ = eval_params(name, dev)
            ek = dict(eval_name=name, pnames=pn)
        st = plane_state(b.carry, b.cdim, b.C, b.sh, pv, ek)
        args = (st['gp'], st['gv'], st['gf'], st['gw'], st['gr'], b.cdim,
                b.sh, pv, 0.005,
                torch.tensor(s, dtype=torch.float32, device=dev))
        out.append((
            f'8 bench {key}', f"row 8 (cell_step_plane_planes {name} "
            f"recip={recip}, {b.where})", cp,
            [lambda args=args, st=st, ek=ek, recip=recip:
             cp.cell_step_plane_planes(*args, C=b.C, gt=st['gt'],
                                       recip=recip, **ek)], check))
    return out


def candidate_cases(dev):
    """parent_sweep_lj_phase's case of cell_pair.cu: the megastep's
    candidate build (mega_candidates) at the bench fill, the parent's
    counts and written lists bit for bit."""
    from hoomd_tpu_torch.ops import cell_pair as cp
    b = bench_fill(dev)

    def lists(got, want):
        same_candidates('mega_candidates', got, written(want),
                        "the parent's")
        return (f"the parent's counts and written lists bit for bit "
                f"({int(got.count.sum())} candidates)")
    return [('candidates bench', f"mega_candidates ({b.where})", cp,
             [lambda: cp.mega_candidates(b.gr, b.gt, b.cdim, b.sh, b.pads,
                                         float(b.ljv[2]), C=b.C)],
             lists)]


def pair_cases(dev):
    """parent_sweep_lj_phase's cases of cell_pair.cu beside the candidate
    build: rows 3 (cell_pair_planar: F, PE and virial) and 2
    (cell_pair_plane: F; lj also with the fast reciprocal) for every
    evaluator, each on the ragged, 2x2x2 and bench fills, every output
    the parent's bits; each case's last call (the bench fill) is timed
    in turns."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    fills = []
    for shape in ('ragged', '2x2x2', 'bench'):
        dims, cdim, C = SHAPES[shape]
        carry, L, _, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        sh = torch.as_tensor(cp.build_cell_shifts(cdim, L)[1],
                             dtype=torch.float32, device=dev)
        fills.append((carry.pos, cdim, sh, C, carry.tag))

    def bits(got, want):
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        if not same_bits(got, want):
            n = [int((g.view(torch.int32) != w.view(torch.int32)).sum())
                 for g, w in zip(got, want)]
            raise RuntimeError("differs from the parent's in " + ', '.join(
                f"{k} elements of {lab}"
                for k, lab in zip(n, ('F', 'PE', 'the virial'))))
        return "every output the parent's bits"
    cases = []
    for name in ('lj',) + tuple(EVAL_JOBS):
        if name == 'lj':
            pv, ek = lj_params(dev)[0], {}
        else:
            pv, pn, _ = eval_params(name, dev)
            ek = dict(eval_name=name, pnames=pn)
        rows = [('3', cp.cell_pair_planar, {}), ('2', cp.cell_pair_plane, {})]
        if name == 'lj':
            rows.append(('2', cp.cell_pair_plane, dict(recip='approx')))
        for row, fn, kw in rows:
            calls = [lambda f=f, fn=fn, kw=kw, pv=pv, ek=ek:
                     fn(*f[:3], pv, C=f[3], cell_tag=f[4], **ek, **kw)
                     for f in fills]
            what = f"{name}{' ' + kw['recip'] if kw else ''}"
            cases.append((f'{row} {what}', f"row {row} ({fn.__name__} "
                          f"{what}; ragged, 2x2x2, bench fills)", cp, calls,
                          bits))
    return cases


def cell_pair_cases(dev):
    """parent_sweep_lj_phase's cases of cell_pair.cu: the candidate build
    (candidate_cases), then rows 2 and 3 (pair_cases)."""
    return candidate_cases(dev) + pair_cases(dev)


def rebin_cases(dev):
    """parent_sweep_lj_phase's cases of cell_rebin.cu: rows 10
    (cell_rebin_sweep) and 11 (cell_rebin_place) on the bench fill drifted
    by up to 0.45 w (rebin_kernel_phases' fill), every output the
    parent's bits (rebin_pair_cases)."""
    from hoomd_tpu_torch.ops import cell_rebin as cr
    dims, cdim, C = SHAPES['bench']
    carry, L, _, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    c = drifted(carry, 0.45 * L / np.asarray(cdim, float), 11)
    cols = cr.to_cols(c.pos, c.vel, c.frc, c.img, c.tag, c.mass, cdim, C)
    return rebin_pair_cases('bench', f"the bench fill drifted by up to 0.45 "
                            f"w, cell_dim={cdim} C={C} E=8", cols, cdim,
                            cr.rebin_params(L, cdim), C, 8)


def rebin_pair_cases(key, where, cols, cdim, par, C, E):
    """Cases of rows 10 and 11 on cols: the sweep, and the place on the
    plain sweep's output, each a pair (new wrapper, the parent's wrapper
    from its copy of ops/cell_rebin.py); every output, flags included,
    the parent's bits."""
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    pcr = parent_module(PARENT_SRC, 'cell_rebin')
    swept, emz, _ = cr.cell_rebin_sweep_plain(cols, cdim, par, C=C, E=E)

    def bits(got, want):
        exact("the new design against the parent's", got, want)
        return "every output, flags included, the parent's bits"
    sweep_args, place_args = (cols, cdim, par), (swept, emz, cdim, par)
    return [
        (f'10 {key}', f"row 10 (cell_rebin_sweep, {where})", cp,
         [(lambda: cr.cell_rebin_sweep(*sweep_args, C=C, E=E),
           lambda: pcr.cell_rebin_sweep(*sweep_args, C=C, E=E))], bits),
        (f'11 {key}', f"row 11 (cell_rebin_place, {where})", cp,
         [(lambda: cr.cell_rebin_place(*place_args, C=C, E=E),
           lambda: pcr.cell_rebin_place(*place_args, C=C, E=E))], bits)]


# the kernels parent_sweep_lj_phase holds to the parent design's: per
# csrc stem, its library entries, the kernels whose builds it prints
# and the function giving its cases as (key, label, module, calls,
# check[, names]); check(new, parent) raises where they disagree, and
# the parent's calls take the module attributes ``names`` from the
# parent's copy of that module (parent_module)
PARENT_KERNELS = (
    ('hpmc_sweep', ('hoomd_hpmc_sphere_sweep', 'hoomd_hpmc_poly_sweep'),
     ('sphere_sweep_kernel', 'poly_sweep_kernel'), sweep_cases),
    ('cell_pair_impls', ('hoomd_cell_pair_lj', 'hoomd_cell_pair_lj3d',
                         'hoomd_cell_pair_lj_row'),
     ('lj_adj_kernel', 'lj_row_kernel'), lj_cases),
    ('cell_pair', ('hoomd_mega_candidates', 'hoomd_cell_pair_plane',
                   'hoomd_cell_pair_planar'),
     ('mega_candidates_kernel', 'pair_walk_kernel'), cell_pair_cases),
    ('cell_step', ('hoomd_step_plane',), ('step_plane_kernel', 'step_finish'),
     step_cases),
    ('cell_rebin', ('hoomd_rebin_sweep', 'hoomd_rebin_place'),
     ('compact_pass', 'place_compact_pass', 'place_pass'), rebin_cases),
)
# where parent_sweep_lj_phase looks for the parent's csrc
PARENT_SRC = 'scratch/parent/hoomd_tpu_torch/csrc'


def parent_sweep_lj_phase(dev, src=PARENT_SRC):
    """Where a copy of the parent's csrc lies in ``src`` (an ignored
    directory; the checkout has none): build each stem of PARENT_KERNELS
    whose source or headers differ from this tree's (csrc_changed; an
    unchanged stem is neither built nor timed against itself) under
    another library name, its entry points bound with the parent's
    signatures, and run each of its cases (run_parent_cases).  Prints the
    parent's builds as ptxas gave them.  Returns the parent's library
    (None where nothing was built; its ``stems`` the stems built), whose
    candidate build and rebin kernels rebuild_phase holds the live state
    of a job to."""
    import ctypes
    from pathlib import Path
    from hoomd_tpu_torch.ops import _build
    from hoomd_tpu_torch.ops import cell_pair as cp
    d = Path(src)
    if not d.is_dir():
        print(f"parent kernels: no copy of the parent's csrc under {src}; "
              f"skipped", flush=True)
        return None
    todo = []
    for row in PARENT_KERNELS:
        if csrc_changed(row[0], d):
            todo.append(row)
        else:
            print(f"parent {row[0]}.cu: equal to this tree's with its "
                  f"headers, byte for byte; not built or timed", flush=True)
    if not todo:
        return None
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-I', str(d), '-o',
         str(d / f'libparent_{stem}.so'), str(d / f'{stem}.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for stem, *_ in todo]
    logs, entries = {}, {}
    signatures = parent_module(d, '_build')._SIGNATURES
    for (stem, names, _, _), proc in zip(todo, procs):
        out, _ = proc.communicate(timeout=600)
        logs[stem] = out.decode()
        if proc.returncode:
            raise RuntimeError(f"parent {stem}.cu: nvcc failed\n"
                               f"{logs[stem][-2000:]}")
        lib = ctypes.CDLL(str(d / f'libparent_{stem}.so'))
        for entry in names:
            fn = getattr(lib, entry)
            fn.argtypes = signatures[entry]
            fn.restype = ctypes.c_int
            entries[entry] = fn
    new_lib = cp._kernel_lib()
    parent_lib = _build.KernelLibrary(
        types_ns(**{**vars(new_lib.lib), **entries}), new_lib.paths, 0.0, '')
    print(f"parent kernels built in {time.perf_counter() - t0:.1f} s; the "
          f"parent's builds: " + ' | '.join(
              f"{k} {ptxas_build(logs[stem], k)}"
              for stem, _, kernels, _ in todo for k in kernels), flush=True)
    parent_lib.stems = {stem for stem, *_ in todo}
    parent_module(d, 'cell_pair')._LIB[:] = [parent_lib]
    out = {}
    for _, _, _, cases in todo:
        out.update(run_parent_cases(cases(dev), parent_lib, d))
    print(json.dumps({"parent_sweep_lj_ms": out}), flush=True)
    return parent_lib


def run_parent_cases(cases, parent_lib, d):
    """Each case (key, label, mod, calls, check[, names]): the new design
    against the parent's on each of its calls, then its last call in
    turns (parent, new, new, parent), by CUDA events per wrapper call,
    by the host's time per call (host_ms) and by device time per
    recorded launch (torch.profiler, recorded_ms).  A call is the wrapper's call run on either library
    (on_parent, with mod's attributes ``names`` taken from the parent's
    copy of mod), or a pair (new call, parent's call) where the parent's
    wrapper itself differs.  Returns {key: times}."""
    out = {}
    for key, label, mod, calls, check, *names in cases:
        pmod = (parent_module(d, mod.__name__.rsplit('.', 1)[-1])
                if names else None)
        attrs = {k: getattr(pmod, k) for k in (names[0] if names else ())}
        for i, call in enumerate(calls):
            fn, pf = call if isinstance(call, tuple) else (call, call)
            try:
                msg = check(fn(), on_parent(mod, parent_lib, pf, attrs)())
            except RuntimeError as e:
                raise RuntimeError(f"{label}, input {i + 1} of "
                                   f"{len(calls)}: {e}") from None
        fp = on_parent(mod, parent_lib, pf, attrs)
        turns = [cuda_ms(f, 50) for f in (fp, fn, fn, fp)]
        host_turns = [host_ms(f) for f in (fp, fn, fn, fp)]
        dev_turns = [recorded_ms(device_kernels(f, 20)) for f in (fp, fn, fn,
                                                                  fp)]
        r = out[key] = dict(parent_ms=turns[::3], ms=turns[1:3],
                            parent_host_ms=host_turns[::3],
                            host_ms=host_turns[1:3],
                            parent_device_ms=[t[0] for t in dev_turns[::3]],
                            device_ms=[t[0] for t in dev_turns[1:3]])
        print(f"{label}: {msg} on {len(calls)} input(s); in turns parent, "
              f"new, new, parent: {', '.join(f'{t:.4f}' for t in turns)} ms "
              f"per wrapper call (CUDA events); host "
              f"{', '.join(f'{t:.4f}' for t in host_turns)} ms per call; device "
              f"{', '.join(dev_fmt(t[0]) for t in dev_turns)} ms per call "
              f"from the recorded launches (the profiler recorded "
              f"{', '.join(f'{t[1] or 0:.2f}' for t in dev_turns)} of them)",
              flush=True)
    return out


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
    """Where a copy of the parent's cell_pair.cu and the headers it
    includes lies in ``src`` (an ignored directory; the checkout has
    none): build it under another library name and hold the parent's
    megastep against the new one at the bench fill, each run through
    megastep_window on its own library (on_parent) from the same prepared
    buffers and candidate set: their bits for every pair evaluator,
    method and k in (1, 4) on windows within the guard, and the time of
    an LJ NVT k = 4 window (restore the start state, launch) in turns,
    parent, new, new, parent.  One more LJ window trips the guard in its
    first step: past the trip both walk every staged slot."""
    import ctypes
    import torch
    from pathlib import Path
    from hoomd_tpu_torch.ops import _build
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
    fn = ctypes.CDLL(str(lib_path)).hoomd_megastep
    fn.argtypes = _build._SIGNATURES['hoomd_megastep']
    fn.restype = ctypes.c_int
    own = cp._kernel_lib()
    parent_lib = _build.KernelLibrary(
        types_ns(**{**vars(own.lib), 'hoomd_megastep': fn}), own.paths, 0.0,
        '')
    print(f"parent megastep built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dims, cdim, C = SHAPES['bench']
    carry, L, N, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    _, sh = cp.build_cell_shifts(cdim, L)
    sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
    skin = torch.as_tensor(np.maximum(L / np.asarray(cdim) - 2.5, 0.4),
                           dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    sc0 = torch.tensor([0.1, 0.0, 0.0, 0.0], device=dev)
    result, same, differ = {}, 0, []
    for name in ('lj',) + tuple(EVAL_JOBS):
        if name == 'lj':
            pv, ek = lj_params(dev)[0], {}
        else:
            pv, pn, _ = eval_params(name, dev)
            ek = dict(eval_name=name, pnames=pn)
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

            def window(who):
                restore(who)
                p, v, f, sc = bufs[who]
                cp.megastep_window(p, v, f, gw, gm, gt, cand, ws, sc, kt,
                                   noise)

            parent = on_parent(cp, parent_lib, lambda: window('parent'))

            def new():
                window('new')
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
                'row': 'cell_pair_lj_row', 'planar': 'cell_pair_planar'}
# the other impls' kernels whose build impl_kernel_phases reads, by the
# occupancy entry point of their library (called with C, and the row
# kernel's with its tile width too)
OCC_ENTRY = {'cell_pair_lj': 'hoomd_cell_pair_lj_occupancy',
             'cell_pair_lj_pallas3d': 'hoomd_cell_pair_lj3d_occupancy',
             'cell_pair_lj_row': 'hoomd_cell_pair_lj_row_occupancy'}


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
    neighbours from the adjacency table there), element by element, and
    'pallas3d' and 'row' also against a second call bit for bit; at the
    bench shape the device time and build of 'pallas', 'pallas3d' and
    'row'; then the
    cross-kernel phase on the bench fill.  Returns the bench row of each
    kernel."""
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
            extra = ''
            if name in ('cell_pair_lj_pallas3d', 'cell_pair_lj_row'):
                # a warp per home, summed in a fixed order
                if not same_bits(got, (kern(*args, C=C, cell_tag=tag, **kw),)):
                    raise RuntimeError(f"{name}[{tag_name}]: two calls differ")
                extra = ' two calls bit-identical;'
            if name in OCC_ENTRY and tag_name == 'bench':
                call = lambda: kern(*args, C=C, cell_tag=tag, **kw)
                row['device_ms'] = device_ms(call, 10)
                row['build'] = occ_build(
                    OCC_ENTRY[name], C,
                    *((cp.row_tile(cdim[0], C),)
                      if name == 'cell_pair_lj_row' else ()))
                extra += (f" device_ms={dev_fmt(row['device_ms'])}, "
                          f"{share_fmt(row['bound_ms'], row['device_ms'])}; "
                          f"{sweep_build_line(row['build'])}")
            if name == 'cell_pair_planar_n3l' and tag_name == 'bench':
                call = lambda: kern(*args, C=C, cell_tag=tag, **kw)
                row['device_ms'] = device_ms(call, 10)
                row['fold_ms'] = device_ms(call, 10, only='n3l_fold')
                row['build'] = tile_build(name, 'lj', C, cdim[0], 1)
                extra = (f" device_ms={dev_fmt(row['device_ms'])}, the fold "
                         f"{dev_fmt(row['fold_ms'])}; "
                         f"{build_line(row['build'])}")
            print(f"phase {name} [{tag_name} cell_dim={cdim} C={C} N={N}]: "
                  f"max_abs_err={ea:.3e} bound_share={er:.3f} "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})"
                  + extra, flush=True)
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
    At the bench shape each kernel's wrapper call is also timed by the
    host's clock and its device time per recorded launch read
    (build_times), with its share of the bound; the sweep's and the
    place's builds (registers, spills, shared memory, blocks per SM)
    are printed.  Returns the bench row of each kernel."""
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
                t = build_times(lambda: kern(*args, **kw))
                print(f"  {name} at the bench shape: {t['ms']:.4f} ms per "
                      f"wrapper call (CUDA events), host {t['host_ms']:.4f} "
                      f"ms per call, device {dev_fmt(t['device_ms'])} ms "
                      f"per call from the recorded launches "
                      f"({kernels_fmt(t['kernels'])}), bound "
                      f"{share_fmt(row['bound_ms'], t['device_ms'])}",
                      flush=True)
        if tag_name == 'bench':
            for name, entry, args in (
                    ('cell_rebin_sweep', 'hoomd_rebin_sweep_occupancy',
                     (C, E, cdim[0], cdim[1], *cr.SWEEP_TILE)),
                    ('cell_rebin_place', 'hoomd_rebin_place_occupancy',
                     (C, cr.PLACE_CELLS))):
                b = sweep_build_line(occ_build(entry, *args))
                print(f"  {name} build: {b} (sweep tile {cr.SWEEP_TILE}, "
                      f"place {cr.PLACE_CELLS} cells per block)", flush=True)
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


def device_kernels(fn, iters, attempts=3):
    """The device kernels of fn by torch.profiler: {name: (ms per call,
    launches per call)}.  A profile that lists no device kernel at all is
    taken again, up to ``attempts`` times; {} if none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = getattr(e, 'self_device_time_total', None)
            t = t if t is not None else getattr(e, 'self_cuda_time_total',
                                                 0.0)
            ms, n = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + t / 1e3 / iters, n + e.count / iters)
        if out:
            return out
    return {}


def device_ms(fn, iters, only=None, attempts=3):
    """Summed device kernel time per call of fn, by torch.profiler; with
    ``only``, of the kernels whose name holds it.  None where the profile
    listed no device kernel in ``attempts`` tries (see dev_fmt), never 0
    for want of a profile."""
    out = device_kernels(fn, iters, attempts)
    if not out:
        return None
    return sum(ms for name, (ms, _) in out.items() if not only or only in name)


def recorded_ms(kernels):
    """Device ms per call from device_kernels' {name: (ms, launches)}:
    each kernel's time per recorded launch times its launches per call,
    rounded, at least 1, so that launches the profiler did not record
    (it has listed 0.55 launches per call of a one-launch wrapper) do not
    read as time saved; and the least share of its launches recorded.
    (None, None) where no kernel was listed."""
    if not kernels:
        return None, None
    total, share = 0.0, 1.0
    for ms, n in kernels.values():
        per = max(1, round(n))
        total += ms / n * per
        share = min(share, n / per)
    return total, share


def host_ms(call, iters=50):
    """A call's host time: the host's perf_counter over ``iters`` calls
    back to back with no synchronisation between them (ms per call; where
    it reaches the CUDA-event time, the events time the host)."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def build_times(call, iters=20):
    """A wrapper call's times by each of the script's means: CUDA events
    over ``iters`` calls back to back (ms), the host's perf_counter over
    as many calls with no synchronisation between them (host_ms: where it
    reaches ms, the events time the host), and the profiler's device time
    per call (device_ms, from its time per recorded launch: recorded_ms)
    with its kernels (kernels: {name: (ms, launches)} per call)."""
    ms = cuda_ms(call, iters)
    host = host_ms(call, iters)
    kernels = device_kernels(call, iters)
    return dict(ms=ms, host_ms=host, kernels=kernels,
                device_ms=recorded_ms(kernels)[0])


def kernels_fmt(kernels):
    """The profiler's kernels of build_times as printed, names cut at 48
    characters."""
    if not kernels:
        return 'the profiler listed no device kernel'
    return ', '.join(f"{name[:48]} {ms:.4f} ms and {n:g} launches per call"
                     for name, (ms, n) in sorted(kernels.items(),
                                                 key=lambda kv: -kv[1][0]))


def dev_fmt(ms):
    """A device time as printed: 'not measured' where the profiler listed
    no device kernel (device_ms gave None)."""
    return 'not measured' if ms is None else f'{ms:.4f}'


def share_fmt(bound_ms, ms, digits=5):
    """The bound's share of a device time, as printed; none where the
    device time was not measured."""
    if ms is None:
        return 'no share (device time not measured)'
    return f'{bound_ms / ms:.{digits}f} of the device time'


def rebuild_phase(system, parent_lib=None):
    """One rebuild of each rebin on a job's liquid: its live state
    advanced by one rebuild cadence (fast_m windows of k steps) past its
    last rebuild, on the job's plan.  CUDA-event time per call and device
    kernel time per call; none may flag, and all three give the same cell
    membership but for particles within a rounding of a face.  Then the
    megastep's candidate set of the job's live reference: the engine's
    equal to the plain version's, a second build's and (with
    ``parent_lib``, parent_sweep_lj_phase's library of the parent design)
    the parent design's, counts and written lists bit for bit, and the
    build timed the same way.  Where the parent's cell_rebin.cu was built,
    the sweep and the place on this liquid are held to the parent
    design's bits and timed in turns (rebin_pair_cases)."""
    from pathlib import Path

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
        dms = recorded_ms(device_kernels(lambda: run.rebuild(c), 10))[0]
        print(f"rebuild[{impl}] of the job's liquid {m * k} steps after its "
              f"last rebuild, cell_dim={cdim} C={C} N={N}: {ms:.4f} ms per "
              f"call (CUDA events), device {dev_fmt(dms)} ms per call from "
              f"the recorded launches; {apart} particles binned apart from "
              f"the sort", flush=True)
    if parent_lib is not None and 'cell_rebin' in parent_lib.stems:
        # the migration kernels on this liquid: the parent design's bits
        # and both designs in turns
        from hoomd_tpu_torch.ops import cell_rebin as cr
        cols = cr.to_cols(c.pos, c.vel, c.frc, c.img, c.tag, c.mass, cdim, C)
        print(json.dumps({"parent_rebin_live_ms": run_parent_cases(
            rebin_pair_cases('live', f"the job's liquid {m * k} steps after "
                             f"its last rebuild, cell_dim={cdim} C={C} "
                             f"E={fast['rebin_E']}", cols, cdim,
                             cr.rebin_params(box.L, cdim), C,
                             fast['rebin_E']),
            parent_lib, Path(PARENT_SRC))}), flush=True)
    # and the megastep's candidate set of the new reference, which the
    # engine builds after each rebuild
    cyc = system._fast_carry.cycle
    cand = cyc.cand
    args = (cand.gr, cyc.gt, cdim, torch.as_tensor(
        build_cell_shifts(cdim, box.L.cpu().numpy())[1], dtype=torch.float32,
        device=c.pos.device), cand.pads, cand.rc2)
    # the engine's set of its live reference: the plain version's, a
    # second build's and, where the parent's library was built, the
    # parent design's counts and lists bit for bit
    what = "mega_candidates of the job's live reference"
    same_candidates(what, cand, cp.mega_candidates_plain(*args, C=C))
    same_candidates(what, cp.mega_candidates(*args, C=C), written(cand),
                    "the engine's build")
    held = "the plain version's and a second build's"
    if parent_lib is not None:
        parent = on_parent(cp, parent_lib,
                           lambda: cp.mega_candidates(*args, C=C))()
        same_candidates(what, cand, written(parent), "the parent's")
        held += " and the parent design's"
    t = build_times(lambda: cp.mega_candidates(*args, C=C))
    per = int(cand.count.sum()) / int((cyc.gt >= 0).sum())
    print(f"{what}, cell_dim={cdim} C={C}: counts and lists equal to "
          f"{held}, bit for bit; {t['ms']:.4f} ms per build (CUDA events; "
          f"host {t['host_ms']:.4f} ms per call), device "
          f"{dev_fmt(t['device_ms'])} ms per call from the recorded launches "
          f"({kernels_fmt(t['kernels'])}); "
          f"{per:.1f} candidates per live slot of {27 * C} staged",
          flush=True)


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
        gate = 'xsel' if impl in ('plane', 'planar', 'planar_n3l') else 'sort'
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
    wins_ms = device_ms(lambda: run.wins(c, dyn, m, k), 10)
    print(f"megastep windows of the bench job's state after a rebuild (k = "
          f"{k}, fast_m = {m}, the guard held: {held}): device "
          f"{dev_fmt(device_ms(lambda: run.wins(c, dyn, 1, k), 20))} ms for one "
          f"window, {dev_fmt(wins_ms and wins_ms / m)} "
          f"ms per window of {m} chained, "
          f"{cuda_ms(lambda: run.wins(c, dyn, m, k), 10) / m:.4f} ms per "
          f"window of {m} by CUDA events; one rebuild cycle ({m} windows, "
          f"the rebuild and its candidate set) "
          f"{cuda_ms(lambda: run.cycles(c, dyn, 1, m, k), 10):.4f} ms by CUDA "
          f"events, device "
          f"{dev_fmt(device_ms(lambda: run.cycles(c, dyn, 1, m, k), 5))} ms",
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
# the KA job's T and PE/N at the end of its NVT window with the typed
# planar kernel of the parent design (a block per cell walking all 27 C
# slots), from `python3 profile_torch_bench.py ka-bits TREE` on the
# parent's tree (NVIDIA H100 80GB HBM3, 700 W).  The tile design sums
# every slot's pairs in the same order with the same arithmetic, and the
# job's trajectory depends on the data alone, so the job must give them
# bit for bit
KA_PARENT_T, KA_PARENT_PE = 0.9968360608824806, -6.018988774813159


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
                                 per_launch='planar_typed_kernel')
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
    t_end, pe_end = q['temperature'], q['potential_energy'] / N
    print(f"{what}: end of the NVT window T={t_end!r} PE/N={pe_end!r}; the "
          f"parent design's T={KA_PARENT_T!r} PE/N={KA_PARENT_PE!r}",
          flush=True)
    if (t_end, pe_end) != (KA_PARENT_T, KA_PARENT_PE):
        raise RuntimeError(f"{what}: T and PE/N at the end of the window are "
                           f"not the parent design's bits")
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


# ---------------------------------------------------------------------------
# the PPPM charged fluid (BASELINE config 4, bench_all.py:158-217)

PPPM_N_SIDE, PPPM_A, PPPM_MESH = 16, 1.6, 32
PPPM_TEMP, PPPM_TEMP_TOL = 1.0, 0.05
# the engine's plan of its lattice start (conservative, as for every
# charged job): the shape of the charged kernel phases
PPPM_SHAPE = ((8, 5, 4), 40)
# kappa of md.charge.pppm's default, 3.2 / r_cut, as float32
PPPM_KAPPA = float(np.float32(3.2 / 2.5))
# config 4's mean PE/N over pppm_job's NVT window through the JAX
# package's fast engine on the CPU, per velocity seed (`PYTHONPATH=.
# python tests/test_torch_charged.py pppm-trace SEED`; 9 is the
# config's).  A window's reads are correlated (one seed's PE/N moves by
# up to 0.09 across its window), so the samples are whole-window means
# of independent seeds (their sd 0.0183): the port's mean over the same
# seeds must lie within PPPM_PE_BAND (0.0388) of theirs, 3 standard
# deviations of the difference of two such means as that spread
# estimates it.
# Leaving out the mesh or the real-space Ewald term moves PE/N by far
# more
PPPM_PE_JAX = {9: -2.468142104148865, 10: -2.431856894493103,
               11: -2.440688943862915, 12: -2.466552734375}
PPPM_PE_BAND = 3.0 * float(np.std(list(PPPM_PE_JAX.values()), ddof=1)
                           * np.sqrt(2.0 / len(PPPM_PE_JAX)))


def pppm_snapshot(data, n_side=PPPM_N_SIDE, seed=9):
    """Config 4's start: n_side^3 ions of charge +1 (type A) and -1 (type
    B) alternating on a simple cubic lattice of spacing 1.6, Maxwell
    velocities at kT = 1 (numpy ``seed``, 9 in the config).  A snapshot
    of either package (``data``: its hoomd.data)."""
    N = n_side ** 3
    L = n_side * PPPM_A
    snap = data.make_snapshot(N, data.boxdim(L=L), particle_types=['A', 'B'])
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    snap.particles.position[:] = (ijk + 0.5) * PPPM_A - L / 2
    s = np.where(ijk.sum(1) % 2 == 0, 1.0, -1.0)
    snap.particles.charge[:] = s
    snap.particles.typeid[:] = np.where(s > 0, 0, 1)
    v = np.random.RandomState(seed).normal(0, 1.0, (N, 3))
    snap.particles.velocity[:] = v - v.mean(axis=0)
    return snap


def pppm_script(hoomd, n_side=PPPM_N_SIDE, mesh=PPPM_MESH, seed=9):
    """Config 4's job script through the public API of ``hoomd`` (either
    package, its context initialized): pair.lj (epsilon = sigma = 1,
    r_cut 2.5, no shift) and md.charge.pppm (a mesh^3 mesh, 32^3 in the
    config, order 5, r_cut 2.5) on one cell list, Nose-Hoover NVT at
    kT = 1, tau = 0.5, dt = 0.005; ``seed`` draws the velocities.
    Returns the System."""
    md = hoomd.md
    hoomd.init.read_snapshot(pppm_snapshot(hoomd.data, n_side, seed))
    nl = md.nlist.cell()
    lj = md.pair.lj(r_cut=2.5, nlist=nl)
    for t1, t2 in [('A', 'A'), ('A', 'B'), ('B', 'B')]:
        lj.pair_coeff.set(t1, t2, epsilon=1.0, sigma=1.0)
    p = md.charge.pppm(group=hoomd.group.all(), nlist=nl)
    p.set_params(Nx=mesh, Ny=mesh, Nz=mesh, order=5, rcut=2.5)
    md.integrate.mode_standard(dt=0.005)
    md.integrate.nvt(group=hoomd.group.all(), kT=PPPM_TEMP, tau=0.5)
    return hoomd.context.current.system


def pppm_warmup(system):
    """bench_all.py's 300 steps and four cadence-warmup runs of 512."""
    system.run(300, quiet=True)
    for _ in range(4):
        system.run(512, quiet=True)


def pppm_window(system, steps=1000):
    """The NVT window: T and PE/N read after every 100 of ``steps``
    steps."""
    N = system.state.N
    temps, pes = [], []
    for _ in range(steps // 100):
        system.run(100, quiet=True)
        q = system.thermo_quantities()
        temps.append(q['temperature'])
        pes.append(q['potential_energy'] / N)
    return temps, pes


# operations per pair inside r_cut of each charged evaluator, counting
# exp, erfc, sqrt and a divide as one each: lj_ewald the LJ terms (11),
# r, kappa r and 1/r (3), the A&S polynomial and its exp (16), the energy
# (3) and the force (10); ewald r, kappa r, erfc, the energy (2) and the
# force (9) with its exp
CHARGED_EVAL_OPS = {'ewald': 14, 'lj_ewald': 43}


def pppm_cells(dev, ntypes, jitter=0.05, seed=5):
    """The cell-major carry of config 4's start (pppm_snapshot), jittered
    by up to ``jitter`` lattice spacings, at PPPM_SHAPE, and its slots'
    charges: one type (all A), the two types of the job, or for ntypes = 4
    a type drawn uniformly per ion.  Returns (carry, q_cells, L, N,
    cell_dim, C)."""
    import torch
    from hoomd_tpu_torch import data
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    from hoomd_tpu_torch.state import state_from_snapshot
    snap = pppm_snapshot(data)
    N = snap.particles.N
    rng = np.random.RandomState(seed)
    snap.particles.position[:] += rng.uniform(-jitter, jitter,
                                              (N, 3)) * PPPM_A
    if ntypes != 2:
        snap.particles.types = ['A', 'B', 'C', 'D'][:ntypes]
        snap.particles.typeid[:] = rng.randint(0, ntypes, N)
    st = state_from_snapshot(snap, dev)
    L = st.box.L.cpu().numpy().astype(np.float64)
    cdim, C = PPPM_SHAPE
    to_fast = build_fast_lj_chunk(
        N=N, box=st.box, cell_dim=cdim, C=C, r_buff=0.4, rcut=2.5,
        method_kind='nvt', method_seed=0, ntypes=ntypes, device=dev)[0]
    carry = to_fast(st, {})
    if bool(carry.overflow):
        raise RuntimeError(f"the config-4 fill overflows C={C} on {cdim}")
    q = torch.as_tensor(snap.particles.charge, dtype=torch.float32,
                        device=dev)
    qc = torch.where(carry.tag >= 0, q[carry.tag.long().clamp(min=0)], 0.0)
    return carry, qc, L, N, cdim, C


def charged_table(name, ntypes, dev, rc=2.5):
    """[rc2, 0, *pnames] of a charged evaluator as a charged job packs it
    (r_cut rc, kappa 3.2 / 2.5, no shift); for ntypes > 1 the (2 + NP,
    T, T) table with lj1 = lj2 = 4 scaled per pair (a, b) by
    0.95 + 0.1 (a + b) / (2 T - 2).  Returns (table, pnames)."""
    import torch
    from hoomd_tpu_torch.ops import pair_eval
    a = np.arange(ntypes)
    f = (0.95 + 0.1 * (a[:, None] + a[None, :]) / max(2 * ntypes - 2, 1)
         if ntypes > 1 else np.ones((1, 1)))
    tab = {'kappa': np.full((ntypes, ntypes), PPPM_KAPPA),
           'lj1': 4.0 * f, 'lj2': 4.0 * f,
           'rcut': np.full((ntypes, ntypes), rc)}
    tab = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
           for k, v in tab.items()}
    rc2 = tab['rcut'] * tab['rcut']
    pn = pair_eval.kernel_pnames(name)
    pv = torch.stack([rc2, torch.zeros_like(rc2)] + [tab[k] for k in pn])
    return (pv[:, 0, 0] if ntypes == 1 else pv).contiguous(), pn


def charged_bounds(name, pos, tag, typ, cdim, sh, pv, ntypes):
    """Bound of the charged kernel at this fill, counted as typed_bounds
    counts a mixture's: each unordered pair once, 8 operations per
    candidate for the r^2 test, and per pair inside r_cut the charge
    product (1), the evaluator (CHARGED_EVAL_OPS), the force (6) and the
    -F on j (3), PE and virial (12); the bytes of positions, tags,
    charges (and types), shifts and table in, F, PE and virial out."""
    rc2 = pv[0].reshape(1, 1) if ntypes == 1 else pv[0]
    cand, inr = typed_pair_counts(pos, tag, typ, cdim, sh, rc2)
    P = pos.shape[0] * pos.shape[1] * 4
    inb = (3 + 1 + 1 + (ntypes > 1)) * P + sh.numel() * 4 + pv.numel() * 4
    per_pair = 1 + CHARGED_EVAL_OPS[name] + 6 + 3 + 12
    return bound(inb + 10 * P, (8 * cand + per_pair * inr) / 2), cand, inr


# the Madelung job's plan (madelung_job: 512 ions in a box of 8, r_cut 3)
MADELUNG_SHAPE = ((2, 2, 2), 88)


def madelung_cells(dev, jitter=0.2, seed=3):
    """The cell-major carry of the Madelung job's rock-salt lattice (512
    ions of one type, charges +-1, spacing 1, box 8) jittered by up to
    ``jitter``, at MADELUNG_SHAPE, and its slots' charges.  Returns
    (carry, q_cells, L, N, cell_dim, C)."""
    import torch
    from hoomd_tpu_torch import data
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk
    from hoomd_tpu_torch.state import state_from_snapshot
    n = 4
    N = (2 * n) ** 3
    snap = data.make_snapshot(N, data.boxdim(L=2.0 * n))
    ijk = np.stack(np.meshgrid(*[np.arange(2 * n)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    snap.particles.position[:] = (ijk - n + 0.5
                                  + rng.uniform(-jitter, jitter, (N, 3)))
    snap.particles.charge[:] = (-1.0) ** ijk.sum(1)
    st = state_from_snapshot(snap, dev)
    L = st.box.L.cpu().numpy().astype(np.float64)
    cdim, C = MADELUNG_SHAPE
    to_fast = build_fast_lj_chunk(
        N=N, box=st.box, cell_dim=cdim, C=C, r_buff=0.4, rcut=3.0,
        method_kind='nvt', method_seed=0, ntypes=1, device=dev)[0]
    carry = to_fast(st, {})
    if bool(carry.overflow):
        raise RuntimeError(f"the Madelung fill overflows C={C} on {cdim}")
    q = torch.as_tensor(snap.particles.charge, dtype=torch.float32,
                        device=dev)
    qc = torch.where(carry.tag >= 0, q[carry.tag.long().clamp(min=0)], 0.0)
    return carry, qc, L, N, cdim, C


def q_build(name, ntypes, nc, C):
    """What the build gave the charged kernel of evaluator ``name`` (PE
    and virial) for ntypes types on nc cells of capacity C, and its
    occupancy: registers and spilled bytes per thread, shared memory per
    block, blocks per SM, and the warps (homes) per block and dz planes
    staged at once it launches with."""
    import ctypes
    from hoomd_tpu_torch.ops import _build, pair_eval
    lib = _build.load()
    out = (ctypes.c_int * 7)()
    ntab = (2 + len(pair_eval.kernel_pnames(name))) * ntypes ** 2
    err = lib.lib.hoomd_planar_q_occupancy(
        pair_eval.EVAL_IDS[name], 1, int(ntypes > 1), nc, C,
        ntab if ntypes > 1 else 0, out)
    lib.check(err, 'charged kernel occupancy')
    return dict(registers=out[0], spill_bytes=out[1],
                smem_bytes=out[2] + out[3], blocks_per_sm=out[4],
                warps=out[5], planes=out[6])


def q_build_line(b):
    return (f"{b['registers']} registers, {b['spill_bytes']} B spilled per "
            f"thread, {b['smem_bytes']} B shared memory per block, "
            f"{b['blocks_per_sm']} blocks per SM, {b['warps']} warps "
            f"(homes) per block, {b['planes']} dz planes staged at once")


def charged_kernel_phases(dev):
    """At config 4's shape (pppm_cells: 4096 ions jittered by 0.05 of the
    spacing, PPPM_SHAPE): both charged evaluators with one, two and four
    types, the charged kernel (cell_pair_planar with cell_q) against its
    plain version element by element (RTOL and the evaluator's ATOL),
    with the wrapper call's time (CUDA events), the device time, the plain
    version's time and the bound.  Returns the row of the two-type
    lj_ewald variant (config 4's), cell_pair_planar_q_typed, and every
    variant's times (the one-type ewald variant's row, cell_pair_planar_q,
    comes from madelung_job, at the plan of the job that launches it)."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    rows, times = {}, {}
    for T in (1, 2, 4):
        carry, qc, L, N, cdim, C = pppm_cells(dev, T)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag, typ = carry.pos, carry.tag, carry.typ
        for name in ('ewald', 'lj_ewald'):
            pv, pn = charged_table(name, T, dev)
            kw = dict(eval_name=name, pnames=pn, ntypes=T, cell_q=qc,
                      cell_typ=typ if T > 1 else None)

            def kern():
                return cp.cell_pair_planar(pos, cdim, sh, pv, C=C,
                                           cell_tag=tag, **kw)

            def plain():
                return cp.cell_pair_planar_plain(pos, cdim, sh, pv,
                                                 cell_tag=tag, **kw)
            label = f'cell_pair_planar charged[{name}, T={T}, config 4]'
            ea, er = compare(label, [
                (lab, g, w, RTOL, EVAL_ATOL.get(name, ATOL))
                for lab, g, w in zip(('F', 'pe', 'virial'), kern(), plain())])
            (b_ms, b_by), cand, inr = charged_bounds(name, pos, tag, typ,
                                                     cdim, sh, pv, T)
            r = dict(max_abs_err=ea, bound_share=er, ms=cuda_ms(kern, 50),
                     plain_ms=cuda_ms(plain, 3), device_ms=device_ms(kern, 10),
                     bound_ms=b_ms, bound_by=b_by)
            r['build'] = q_build(name, T, pos.shape[0], C)
            times.setdefault(name, {})[T] = r
            print(f"phase charged kernel [{name}, T={T}, cell_dim={cdim} "
                  f"C={C} N={N}, {cand} candidate pairs, {inr} inside "
                  f"r_cut]: max_abs_err={ea:.3e} kernel_ms={r['ms']:.4f} "
                  f"device_ms={dev_fmt(r['device_ms'])} "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={b_ms:.6f} "
                  f"({b_by}), {share_fmt(b_ms, r['device_ms'])}; {q_build_line(r['build'])}", flush=True)
    rows['cell_pair_planar_q_typed'] = times['lj_ewald'][2]
    return rows, times


def check_charged_counts(counts, kname, what):
    """The charged job launched ``kname`` and no other kernel: no
    uncharged pair kernel, no rebin kernel (a mixture sorts)."""
    if counts[kname] <= 0:
        raise RuntimeError(f"{what} never launched {kname}")
    other = {k: n for k, n in counts.items() if n and k != kname}
    if other:
        raise RuntimeError(f"{what} launched other kernels: {other}")


def pppm_job(card):
    """Config 4's job script (pppm_script) at 4096 ions on the card:
    bench_all.py's warmup and timed 1000-step window (its metric line),
    then the NVT window (pppm_window) and the gates: finite state, the
    window's mean T = 1 +- 0.05, the start's plan PPPM_SHAPE, every step
    on the charged typed kernel and no other kernel launched, the kernel
    equal to its plain version on the end state; the busy share and the
    kernel's device time per launch over 100 profiled steps; two 500-step
    NVE continuations, with the drift of the energy they conserve
    (nve_drift): on config 4's 32^3 mesh, whose PPPM force error heats
    the liquid (the JAX package's fast engine heats the same way, and a
    64^3 mesh does not: PERF.md), printed; then on a 64^3 mesh, gated
    below NVE_DRIFT_MAX.  Last, the script again from the other seeds of
    PPPM_PE_JAX (pppm_seed_window), and the mean PE/N of the port's
    windows over those seeds within PPPM_PE_BAND of the JAX package's.
    Returns the launch counts of the script's run through the timed
    window."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    from hoomd_tpu_torch.ops import cell_pair as cp
    what = 'config-4 job'
    t_job = time.perf_counter()
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    reset_launch_counts()
    system = pppm_script(hoomd)
    N = system.state.N
    system._ensure_ready()
    plan0 = (system._program['fast']['cell_dim'], system._program['fast']['C'])
    if plan0 != PPPM_SHAPE:
        raise RuntimeError(f"{what}: the plan of the lattice start {plan0}, "
                           f"not {PPPM_SHAPE}")
    pppm_warmup(system)
    steps = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(steps, quiet=True)
    el = time.perf_counter() - t0
    counts = launch_counts()
    fast = system._program['fast']
    print(json.dumps({
        "metric": "pppm_fluid_4k_particle_steps_per_sec",
        "value": steps * N / el, "unit": "particle-steps/s/chip",
        "extra": {"N": N, "steps": steps, "elapsed_s": el,
                  "ms_per_step": el / steps * 1e3,
                  "cell_dim": list(fast['cell_dim']), "C": fast['C'],
                  "eval": fast['eval_name'], "card": card,
                  "package": "torch"}}), flush=True)
    check_charged_counts(counts, 'cell_pair_planar_q_typed', what)
    # one launch per step and one per thermo read at least
    if counts['cell_pair_planar_q_typed'] < 300 + 4 * 512 + steps:
        raise RuntimeError(f"{what}: the charged kernel ran on fewer steps "
                           f"than the script's ({counts})")
    if (fast['ntypes'], fast['rebin_impl'], fast['mega'], fast['fused'],
            fast['eval_name']) != (2, 'sort', False, False, 'lj_ewald'):
        raise RuntimeError(f"{what}: not config 4's program ({fast})")
    temps, pes = pppm_window(system)
    busy, k_dev = device_profile(lambda: system.run(100, quiet=True),
                                 f'100 steps of the {what}', top=10,
                                 per_launch='cell_pair_q_kernel')
    q = system.thermo_quantities()
    snap = system.take_snapshot()
    if not (np.isfinite(snap.particles.position).all()
            and np.isfinite(snap.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError(f"{what}: non-finite state")
    t_mean, pe_mean = float(np.mean(temps)), float(np.mean(pes))
    # the kernel on the end state, against its plain version
    c = system._fast_carry
    _, sh = cp.build_cell_shifts(fast['cell_dim'],
                                 system._state_raw.box.L.cpu().numpy())
    sh = torch.as_tensor(sh, dtype=torch.float32, device=c.pos.device)
    qt = torch.as_tensor(snap.particles.charge, dtype=torch.float32,
                         device=c.pos.device)
    qc = torch.where(c.tag >= 0, qt[c.tag.long().clamp(min=0)], 0.0)
    kw = dict(cell_tag=c.tag, eval_name='lj_ewald', pnames=fast['pnames'],
              ntypes=2, cell_typ=c.typ, cell_q=qc)
    pv = system._dyn['fast']['pv']
    got = cp.cell_pair_planar(c.pos, fast['cell_dim'], sh, pv, C=fast['C'],
                              **kw)
    want = cp.cell_pair_planar_plain(c.pos, fast['cell_dim'], sh, pv, **kw)
    ea, _ = compare(f'cell_pair_planar charged [{what} end state]',
                    [(lab, g, w, RTOL, EVAL_ATOL.get('lj_ewald', ATOL))
                     for lab, g, w in zip(('F', 'pe', 'virial'), got, want)])
    print(f"{what}: plan cell_dim={fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']} eval={fast['eval_name']}; "
          f"{el / steps * 1e3:.4f} ms/step over the timed {steps} steps, "
          f"{steps * N / el:.6g} particle-steps/s; NVT window mean T "
          f"{t_mean!r} (reads {', '.join(f'{t:.4f}' for t in temps)}), "
          f"mean PE/N {pe_mean!r} (JAX package {PPPM_PE_JAX[9]}); busy "
          f"share {busy:.4f}, the charged kernel "
          f"{k_dev:.4f} ms per launch on the device; max_abs_err {ea:.3e} "
          f"against its plain version on the end state; "
          f"{system.fast_stats}, grow {system._grow}; launches={counts}; "
          f"{card}", flush=True)
    if abs(t_mean - PPPM_TEMP) > PPPM_TEMP_TOL:
        raise RuntimeError(f"{what}: mean T over the NVT window {t_mean:.4f} "
                           f"outside {PPPM_TEMP} +- {PPPM_TEMP_TOL}")
    # NVE continuations: on config 4's mesh, and on a mesh of twice its
    # resolution, gated
    for m in system.methods:
        m.disable()
    md.integrate.nve(group=hoomd.group.all())
    pppm = next(f for f in system.forces if type(f).__name__ == 'pppm')
    reset_launch_counts()
    drift32 = nve_drift(system, f'{what} NVE continuation, 32^3 mesh')
    pppm.set_params(Nx=2 * PPPM_MESH, Ny=2 * PPPM_MESH, Nz=2 * PPPM_MESH,
                    order=5, rcut=2.5)
    drift = nve_drift(system, f'{what} NVE continuation, 64^3 mesh')
    nve_counts = launch_counts()
    print(f"{what} NVE: drift {drift32:.3e} per particle over 500 steps on "
          f"the 32^3 mesh (the PPPM discretization's heating, as the JAX "
          f"package's), {drift:.3e} on the 64^3 mesh (gated below "
          f"{NVE_DRIFT_MAX}); launches={nve_counts}; the job took "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    if not np.isfinite(drift) or abs(drift) >= NVE_DRIFT_MAX:
        raise RuntimeError(f"{what} NVE: energy drift {drift:.3e} per "
                           f"particle over 500 steps on the 64^3 mesh "
                           f"(bound {NVE_DRIFT_MAX})")
    check_charged_counts(nve_counts, 'cell_pair_planar_q_typed',
                         f'{what} NVE continuations')
    pes = {9: pe_mean}
    for seed in PPPM_PE_JAX:
        if seed not in pes:
            pes[seed] = pppm_seed_window(hoomd, seed)
    port = float(np.mean(list(pes.values())))
    jax = float(np.mean(list(PPPM_PE_JAX.values())))
    print(f"{what}: the NVT window's mean PE/N per velocity seed, port "
          f"{pes}, JAX package {PPPM_PE_JAX}; means {port!r} and {jax!r}, "
          f"apart {port - jax:.4e} (band {PPPM_PE_BAND:.4e}); the job "
          f"took {time.perf_counter() - t_job:.1f} s", flush=True)
    if not abs(port - jax) <= PPPM_PE_BAND:
        raise RuntimeError(f"{what}: mean PE/N over seeds {sorted(pes)} "
                           f"{port:.4f}, the JAX package's {jax:.4f} +- "
                           f"{PPPM_PE_BAND:.4f}")
    return counts


def pppm_seed_window(hoomd, seed):
    """Config 4's script on the card with velocities from ``seed``:
    bench_all.py's warmup and timed window, then the NVT window.  Returns
    the window's mean PE/N; its mean T must be 1 +- 0.05."""
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    system = pppm_script(hoomd, seed=seed)
    pppm_warmup(system)
    system.run(1000, quiet=True)
    temps, pes = pppm_window(system)
    if abs(np.mean(temps) - PPPM_TEMP) > PPPM_TEMP_TOL:
        raise RuntimeError(f"config-4 job, seed {seed}: mean T over the "
                           f"NVT window {np.mean(temps):.4f}")
    return float(np.mean(pes))


def nve_drift(system, what):
    """500 NVE steps of pppm_script's job (either package), read every 50:
    the drift per particle of the energy the dynamics conserves (KE + PE +
    lj_cut_energy), the slope of a least-squares line through the reads
    times 500.  Prints the reads and the raw KE + PE's change."""
    N = system.state.N
    e_raw, e_cons = [], []
    for i in range(11):
        if i:
            system.run(50, quiet=True)
        q = system.thermo_quantities()
        e_raw.append((q['kinetic_energy'] + q['potential_energy']) / N)
        e_cons.append(e_raw[-1] + lj_cut_energy(system) / N)
    drift = float(np.polyfit(50 * np.arange(11), e_cons, 1)[0]) * 500
    print(f"{what}: E/N {e_raw[0]:.6f} -> {e_raw[-1]:.6f} "
          f"({e_raw[-1] - e_raw[0]:.3e}, with the pairs crossing the "
          f"unshifted r_cut); the conserved E/N {e_cons[0]:.6f} -> "
          f"{e_cons[-1]:.6f}, reads every 50 steps "
          f"{', '.join(f'{e - e_cons[0]:.2e}' for e in e_cons)}, drift "
          f"{drift:.3e} per particle over 500 steps at dt = 0.005, "
          f"T={q['temperature']:.5f}", flush=True)
    return drift


def lj_cut_energy(system, rc=2.5):
    """-V_LJ(r_cut) times the number of pairs closer than r_cut in the
    current state of pppm_script's job (either package; epsilon = sigma =
    1 for every type pair).  Its pair.lj runs unshifted (mode 'none', as
    pppm requires), so KE + PE jumps by V_LJ(r_cut) whenever a pair
    crosses r_cut; the forces are those of the shifted potential, whose
    energy, KE + PE + this sum, the dynamics conserves.  Counted over all
    pairs of the snapshot under the minimum image in float64 torch (on the
    card when there is one), apart from the kernels under test."""
    import torch
    snap = system.take_snapshot()
    dev = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    pos = torch.as_tensor(snap.particles.position, dtype=torch.float64,
                          device=dev)
    L = torch.tensor([snap.box.Lx, snap.box.Ly, snap.box.Lz],
                     dtype=torch.float64, device=dev)
    n = 0
    for i in range(0, pos.shape[0], 256):
        d = pos[i:i + 256, None, :] - pos[None]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        n += int(((r2 > 0) & (r2 < rc * rc)).sum())
    return -4.0 * (rc ** -12 - rc ** -6) * (n // 2)


def madelung_job():
    """The NaCl Madelung energy on the card (tests/test_pppm.py): 512 ions
    of one type with charges +-1 on a rock-salt lattice of spacing 1 in a
    box of 8, md.charge.pppm alone (32^3, order 5, r_cut 3), one NVE step
    at dt = 0: PE per ion -1.747565 / 2 to rel 2e-3, every force below
    5e-2, the one-type charged kernel (ewald) launched and no other.  Then
    that kernel against its plain version at the job's own plan (a few
    cells per axis, so the 27-cell stencil visits a neighbour cell more
    than once): on the end state, and on it jittered by up to 0.2, whose
    forces do not cancel by symmetry, with the times and the bound there.
    Returns the launch counts and the one-type kernel's row."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch.ops import cell_pair as cp
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    n, a = 4, 1.0
    N = (2 * n) ** 3
    snap = hoomd.data.make_snapshot(N, hoomd.data.boxdim(L=2 * n * a))
    ijk = np.stack(np.meshgrid(*[np.arange(2 * n)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    snap.particles.position[:] = ijk * a - n * a + a / 2
    snap.particles.charge[:] = (-1.0) ** ijk.sum(1)
    hoomd.init.read_snapshot(snap)
    system = hoomd.context.current.system
    p = hoomd.md.charge.pppm(group=hoomd.group.all(),
                             nlist=hoomd.md.nlist.cell())
    p.set_params(Nx=32, Ny=32, Nz=32, order=5, rcut=3.0)
    hoomd.md.integrate.mode_standard(dt=0.0)
    hoomd.md.integrate.nve(group=hoomd.group.all())
    reset_launch_counts()
    system.run(1, quiet=True)
    pe = system.thermo_quantities()['potential_energy'] / N
    counts = launch_counts()
    fmax = float(system.state.net_force.abs().max())
    fast = system._program['fast']
    cdim, C = fast['cell_dim'], fast['C']
    want = -1.747565 / 2
    print(f"Madelung job: PE per ion {pe!r} (want {want}, rel "
          f"{abs(pe / want - 1):.3e}), max |F| {fmax:.3e}, eval "
          f"{fast['eval_name']}, plan cell_dim={cdim} C={C}, "
          f"launches={counts}", flush=True)
    check_charged_counts(counts, 'cell_pair_planar_q', 'Madelung job')
    if abs(pe / want - 1) > 2e-3 or not fmax < 5e-2:
        raise RuntimeError(f"Madelung job: PE per ion {pe:.6f} (want "
                           f"{want} to rel 2e-3), max |F| {fmax:.3e}")
    c = system._fast_carry
    _, sh = cp.build_cell_shifts(cdim, system._state_raw.box.L.cpu().numpy())
    sh = torch.as_tensor(sh, dtype=torch.float32, device=c.pos.device)
    qt = torch.as_tensor(snap.particles.charge, dtype=torch.float32,
                         device=c.pos.device)
    qc = torch.where(c.tag >= 0, qt[c.tag.long().clamp(min=0)], 0.0)
    pv = system._dyn['fast']['pv']
    kw = dict(cell_tag=c.tag, eval_name=fast['eval_name'],
              pnames=fast['pnames'], ntypes=1, cell_q=qc)
    g = torch.Generator(device=c.pos.device).manual_seed(3)
    jit = (torch.rand(c.pos.shape, generator=g, device=c.pos.device)
           - 0.5) * 0.4
    for label, pos in (('end state', c.pos),
                       ('end state jittered', c.pos + jit * (c.tag >= 0)
                        .unsqueeze(-1))):
        def kern(pos=pos):
            return cp.cell_pair_planar(pos, cdim, sh, pv, C=C, **kw)

        def plain(pos=pos):
            return cp.cell_pair_planar_plain(pos, cdim, sh, pv, **kw)
        ea, er = compare(f'cell_pair_planar charged [Madelung job {label}]',
                         [(lab, g_, w, RTOL, EVAL_ATOL.get('ewald', ATOL))
                          for lab, g_, w in zip(('F', 'pe', 'virial'),
                                                kern(), plain())])
    (b_ms, b_by), cand, inr = charged_bounds('ewald', pos, c.tag, c.typ,
                                             cdim, sh, pv, 1)
    row = dict(max_abs_err=ea, bound_share=er, ms=cuda_ms(kern, 50),
               plain_ms=cuda_ms(plain, 3), device_ms=device_ms(kern, 10),
               bound_ms=b_ms, bound_by=b_by,
               build=q_build('ewald', 1, c.pos.shape[0], C))
    print(f"phase charged kernel [ewald, T=1, the Madelung job's plan "
          f"cell_dim={cdim} C={C} N={N}, jittered, {cand} candidate pairs, "
          f"{inr} inside r_cut]: max_abs_err={ea:.3e} "
          f"kernel_ms={row['ms']:.4f} device_ms={dev_fmt(row['device_ms'])} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.6f} ({b_by}); "
          f"{q_build_line(row['build'])}", flush=True)
    return counts, row


# ---------------------------------------------------------------------------
# the Kremer-Grest melt (BASELINE config 3, bench_all.py:80-155)

KG_CHAINS, KG_LEN, KG_BOND, KG_RHO = 1024, 32, 0.97, 0.85
KG_TEMP, KG_TEMP_TOL = 1.0, 0.03
# the FENE bond's reach: past r0 sqrt(0.99) its force is clipped to zero
KG_R0 = 1.5
# the PE/N check's job: the config's script at 128 chains of 32 beads
# (4096 beads at the same density), kg_warmup with KG_SEED_EQ runs of
# 1024 steps (the config's six cut to one, for the run's time), then the
# window of kg_window
KG_SEED_CHAINS, KG_SEED_EQ = 128, 1
# that job's mean PE/N over the window through the JAX package's fast
# engine on the CPU, per seed of the start's random numbers (`PYTHONPATH=.
# python tests/test_torch_bonded.py kg-trace SEED`; 3 is the config's).
# The port's mean over the same seeds must lie within KG_PE_BAND of
# theirs: 3 standard deviations of the difference of two such means, as
# the seeds' spread estimates it (PPPM_PE_BAND's rule)
KG_PE_JAX = {3: 20.575480461120605, 4: 20.566978454589844,
             5: 20.57136688232422, 6: 20.577934646606444}
KG_PE_BAND = 3.0 * float(np.std(list(KG_PE_JAX.values()), ddof=1)
                         * np.sqrt(2.0 / len(KG_PE_JAX)))


def kg_snapshot(data, n_chains=KG_CHAINS, seed=3):
    """Config 3's start: n_chains straight chains of KG_LEN beads 0.97
    apart along z, one column per site of a square lattice at rho = 0.85,
    each chain shifted along z by a uniform draw; bonds between neighbours
    along a chain and angles between consecutive triples; Gaussian
    velocities of variance 1 less their mean.  The draws come from one
    numpy RandomState(seed), 3 in the config.  A snapshot of either
    package (``data``: its hoomd.data)."""
    N = n_chains * KG_LEN
    Lz = KG_LEN * KG_BOND
    area = N / KG_RHO / Lz
    side = int(np.ceil(np.sqrt(n_chains)))
    dxy = np.sqrt(area) / side
    box_L = side * dxy
    snap = data.make_snapshot(
        N, data.boxdim(Lx=box_L, Ly=box_L, Lz=Lz), particle_types=['A'],
        bond_types=['polymer'], angle_types=['backbone'])
    idx = 0
    bonds, angles = [], []
    rng = np.random.RandomState(seed)
    for c in range(n_chains):
        cx = (c % side + 0.5) * dxy - box_L / 2
        cy = (c // side + 0.5) * dxy - box_L / 2
        z0 = rng.uniform(0, KG_BOND)
        for m in range(KG_LEN):
            z = (z0 + m * KG_BOND) % Lz - Lz / 2
            snap.particles.position[idx] = [cx, cy, z]
            if m > 0:
                bonds.append([idx - 1, idx])
            if m > 1:
                angles.append([idx - 2, idx - 1, idx])
            idx += 1
    v = rng.normal(0, 1.0, (N, 3))
    v -= v.mean(axis=0)
    snap.particles.velocity[:] = v
    snap.bonds.resize(len(bonds))
    snap.bonds.group[:] = bonds
    snap.angles.resize(len(angles))
    snap.angles.group[:] = angles
    return snap


def kg_script(hoomd, n_chains=KG_CHAINS, seed=3):
    """Config 3's job script through the public API of ``hoomd`` (either
    package, its context initialized), up to its first run: the WCA pair
    (pair.lj, r_cut 2^(1/6), shift mode) on a cell list with the default
    exclusions, bond.fene (k = 30, r0 = 1.5, sigma = epsilon = 1),
    angle.harmonic (k = 1.5, t0 = pi), Langevin at kT = 1 (seed 17), dt =
    0.001.  Returns (System, the integration mode)."""
    md = hoomd.md
    hoomd.init.read_snapshot(kg_snapshot(hoomd.data, n_chains, seed))
    nl = md.nlist.cell()
    wca = md.pair.lj(r_cut=2 ** (1 / 6), nlist=nl)
    wca.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    wca.set_params(mode='shift')
    fene = md.bond.fene()
    fene.bond_coeff.set('polymer', k=30.0, r0=KG_R0, sigma=1.0, epsilon=1.0)
    ang = md.angle.harmonic()
    ang.angle_coeff.set('backbone', k=1.5, t0=np.pi)
    mode = md.integrate.mode_standard(dt=0.001)
    md.integrate.langevin(group=hoomd.group.all(), kT=KG_TEMP, seed=17)
    return hoomd.context.current.system, mode


def kg_warmup(system, mode, eq_runs):
    """The script's melt: 1000 steps at dt = 0.001, then 500 at dt = 0.005
    and eq_runs runs of 1024 (six in the config)."""
    system.run(1000, quiet=True)
    mode.set_params(dt=0.005)
    system.run(500, quiet=True)
    for _ in range(eq_runs):
        system.run(1024, quiet=True)


def kg_window(system):
    """T and PE/N read after every 100 of 1000 steps."""
    N = system.state.N
    temps, pes = [], []
    for _ in range(10):
        system.run(100, quiet=True)
        q = system.thermo_quantities()
        temps.append(q['temperature'])
        pes.append(q['potential_energy'] / N)
    return temps, pes


# the equilibration runs of 1024 steps at full width: the config's six
# cut to one, for this run's time (the host takes ~13 ms per step)
KG_EQ = 1
# the timed window: bench_all.py's 2000 steps, in KG_READS runs with T and
# PE/N read after each (outside the timing)
KG_STEPS, KG_READS = 2000, 10


def kg_main(card):
    """Config 3's job script at full width (kg_script: 1024 chains of 32
    beads, N = 32 768) on the card: kg_warmup with KG_EQ runs of 1024
    steps, then the timed window of KG_STEPS steps in KG_READS runs, T
    and PE/N read after each outside the timing; its metric line
    kremer_grest_32k_particle_steps_per_sec, then the gates of check_kg.
    Returns (System, the launch counts of the script's run, the window's T
    and PE/N reads, ms per step)."""
    import torch
    import hoomd_tpu_torch as hoomd
    what = 'KG job'
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    reset_launch_counts()
    system, mode = kg_script(hoomd)
    N = system.state.N
    t0 = time.perf_counter()
    kg_warmup(system, mode, KG_EQ)
    t_warm = time.perf_counter() - t0
    print(f"{what}: the melt and {KG_EQ} equilibration runs took "
          f"{t_warm:.1f} s, {system.fast_stats}", flush=True)
    temps, pes, el = [], [], 0.0
    steps = KG_STEPS
    for _ in range(KG_READS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(steps // KG_READS, quiet=True)  # ends in a synchronize
        el += time.perf_counter() - t0
        q = system.thermo_quantities()
        temps.append(q['temperature'])
        pes.append(q['potential_energy'] / N)
    counts = launch_counts()
    fast = system._program['fast']
    ms = el / steps * 1e3
    print(json.dumps({
        "metric": "kremer_grest_32k_particle_steps_per_sec",
        "value": steps * N / el, "unit": "particle-steps/s/chip",
        "extra": {"N": N, "steps": steps, "elapsed_s": el,
                  "ms_per_step": ms, "warmup_s": t_warm,
                  "equilibration_runs": KG_EQ,
                  "cell_dim": list(fast['cell_dim']), "C": fast['C'],
                  "rebin": fast['rebin_impl'],
                  "temperature": float(np.mean(temps)),
                  "pe_per_particle": float(np.mean(pes)), "card": card,
                  "package": "torch"}}), flush=True)
    check_kg(system, temps, counts, 1500 + 1024 * KG_EQ + steps, KG_READS,
             what)
    return system, counts, temps, pes, ms


def check_kg(system, temps, counts, script_steps, reads, what):
    """The KG job's gates: a finite state with every tag in one slot; the
    window's mean T = 1 +- 0.03; every bond shorter than r0 sqrt(0.99),
    past which FENE has no force; the program the JAX fast engine runs
    (the plane kernel, Langevin, no megastep, no fused step) on the rebin
    its gate chose (xsel at this N; an xsel strike sorts until 8 clean
    segments have passed); the plane kernel (row 2) launched on every
    step, the planar kernel (row 3) at every thermo read, neither the
    megastep, its candidate build nor the fused step."""
    import torch
    N = system.state.N
    q = system.thermo_quantities()
    snap = system.take_snapshot()
    if not (np.isfinite(snap.particles.position).all()
            and np.isfinite(snap.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError(f"{what}: non-finite state")
    tag = system._fast_carry.tag
    kept = torch.sort(tag[tag >= 0]).values
    if kept.numel() != N or not torch.equal(
            kept.long(), torch.arange(N, device=kept.device)):
        raise RuntimeError(f"{what}: the carry does not hold every tag once")
    t_mean = float(np.mean(temps))
    if abs(t_mean - KG_TEMP) > KG_TEMP_TOL:
        raise RuntimeError(f"{what}: mean T over the window {t_mean:.4f} "
                           f"outside {KG_TEMP} +- {KG_TEMP_TOL}")
    blen = kg_bond_lengths(snap)
    if not blen.max() < KG_R0 * np.sqrt(0.99):
        raise RuntimeError(f"{what}: a bond of {blen.max():.4f}, past the "
                           f"FENE clip {KG_R0 * np.sqrt(0.99):.4f}")
    fast = system._program['fast']
    prog = (fast['impl'], fast['kind'], fast['mega'], fast['fused'],
            fast['ntypes'], fast['eval_name'])
    if prog != ('plane', 'langevin', False, False, 1, 'lj'):
        raise RuntimeError(f"{what}: not config 3's program {prog}")
    if not (fast['rebin_impl'] == 'xsel'
            or system._grow.get('fast_rebin_sort')):
        raise RuntimeError(f"{what}: rebuilt on {fast['rebin_impl']}, its "
                           f"gate names xsel")
    check_rebin_lost(system, what)
    if counts['cell_pair_plane'] < script_steps:
        raise RuntimeError(f"{what}: the plane kernel ran on fewer steps "
                           f"than the script's {script_steps} ({counts})")
    if counts['cell_pair_planar'] < reads:
        raise RuntimeError(f"{what}: the planar kernel missed a thermo read "
                           f"({counts})")
    for name in ('cell_megastep_planes', 'mega_candidates',
                 'cell_step_plane_planes'):
        if counts[name]:
            raise RuntimeError(f"{what}: launched {name} ({counts})")
    print(f"{what}: the gates held: T over the window {t_mean:.5f} (reads "
          f"{', '.join(f'{t:.4f}' for t in temps)}), the longest bond "
          f"{blen.max():.4f}, every tag kept, rebin {fast['rebin_impl']}, "
          f"{system.fast_stats}, grow {system._grow}; launches={counts}",
          flush=True)


def kg_bond_lengths(snap):
    """Each bond's length in a snapshot (float64, minimum image)."""
    pos = np.asarray(snap.particles.position, np.float64)
    L = np.array([snap.box.Lx, snap.box.Ly, snap.box.Lz])
    b = np.asarray(snap.bonds.group)
    d = pos[b[:, 1]] - pos[b[:, 0]]
    d -= L * np.round(d / L)
    return np.sqrt((d * d).sum(1))


def kg_reference(pos, L, bonds, angles, excl):
    """Config 3's forces in float64 on pos's device, apart from the port's
    code: every pair closer than r_cut but the excluded ones (excl, the
    (N, E) table of each tag's excluded tags, N padding) by the WCA force
    24 (2 r^-14 - r^-8) r_ij; the FENE + WCA bonds and the harmonic angles
    (k = 1.5, t0 = pi, their cosine clipped at 1 - 1e-7) as -grad of their
    energies by autograd.  pos (N, 3) by tag.  Returns (F (N, 3), S (N,)):
    S per bead sums the magnitudes of every term on it, the excluded
    pairs' WCA forces included (the stencil sums them and the exclusion
    correction takes them away)."""
    import torch
    N = pos.shape[0]
    rc2 = 2.0 ** (1.0 / 3.0)
    F = torch.zeros_like(pos)
    S = torch.zeros(N, dtype=pos.dtype, device=pos.device)
    et = torch.as_tensor(excl, dtype=torch.int64, device=pos.device)
    for i0 in range(0, N, 256):
        i1 = min(i0 + 256, N)
        d = pos[i0:i1, None, :] - pos[None]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        rows = torch.arange(i1 - i0, device=pos.device)
        r2[rows, rows + i0] = 1e30
        near = r2 < rc2
        ex = torch.zeros_like(near)
        part = et[i0:i1]
        ok = part < N
        ex[rows[:, None].expand_as(part)[ok], part[ok]] = True
        inv2 = torch.where(near, 1.0 / r2, 0.0)
        inv6 = inv2 * inv2 * inv2
        coef = 24.0 * inv2 * inv6 * (2.0 * inv6 - 1.0)
        F[i0:i1] = (torch.where(ex, 0.0, coef)[..., None] * d).sum(1)
        S[i0:i1] = (coef.abs() * torch.sqrt(torch.where(near, r2, 0.0))
                    ).sum(1)
    x = pos.clone().requires_grad_(True)
    b = torch.as_tensor(bonds, dtype=torch.int64, device=pos.device)
    db = x[b[:, 1]] - x[b[:, 0]]
    db = db - L * torch.round(db.detach() / L)
    r = torch.sqrt((db * db).sum(-1))
    xx = torch.clamp((r / KG_R0) ** 2, 0.0, 0.99)
    s6 = r ** -6
    wca = torch.where(r ** -2 > 2.0 ** (-1.0 / 3.0),
                      4.0 * (s6 * s6 - s6) + 1.0, 0.0)
    e_b = -0.5 * 30.0 * KG_R0 ** 2 * torch.log1p(-xx) + wca
    a = torch.as_tensor(angles, dtype=torch.int64, device=pos.device)
    d1 = x[a[:, 1]] - x[a[:, 0]]
    d1 = d1 - L * torch.round(d1.detach() / L)
    d2 = x[a[:, 2]] - x[a[:, 1]]
    d2 = d2 - L * torch.round(d2.detach() / L)
    n1 = torch.sqrt((d1 * d1).sum(-1))
    n2 = torch.sqrt((d2 * d2).sum(-1))
    c = torch.clamp((-d1 * d2).sum(-1) / (n1 * n2), -1.0 + 1e-7, 1.0 - 1e-7)
    th = torch.arccos(c)
    e_a = 0.5 * 1.5 * (th - np.pi) ** 2
    gb, = torch.autograd.grad(e_b.sum() + e_a.sum(), x)
    F = F - gb
    # the bonded terms' magnitudes: |dV/dr| per bond on both ends, and
    # |dV/dtheta| / min(|d1|, |d2|) per angle on its three beads
    rd, xd = r.detach(), xx.detach()
    fb = torch.where(xd < 0.99, 30.0 * rd / (1.0 - xd), 0.0)
    fw = torch.where(wca.detach() > 0, 24.0 * (2.0 * rd ** -13 - rd ** -7),
                     0.0)
    mb = fb.abs() + fw.abs()
    S = S.index_add(0, b[:, 0], mb).index_add(0, b[:, 1], mb)
    ma = (1.5 * (th.detach() - np.pi).abs()
          / torch.minimum(n1, n2).detach())
    for k in range(3):
        S = S.index_add(0, a[:, k], ma)
    return F.detach(), S


def kg_exactness(system, what):
    """The port's force of a step on the job's state, the plane kernel
    plus the tag-space terms (the bonds, the angles and the exclusion
    correction: the engine's step force, run.force), against kg_reference
    in float64 on the card, bead by bead: |port - reference| <= ATOL +
    RTOL S.  S sums the magnitudes of the terms on the bead; RTOL of it
    covers the float32 sums and, on each excluded pair, the residual the
    correction leaves where the plane kernel takes the fast reciprocal
    (__fdividef, under a thermostat) and the correction divides exactly:
    a relative error of the WCA force, about 40 at r = 0.97.  A stale
    slot table puts a bond's force on another bead, an error of ~10-100.
    Returns (largest error, largest error / S)."""
    import torch
    fast = system._program['fast']
    run, dyn = fast['run_chunk'], system._dyn['fast']
    c = system._fast_carry
    F = run.force(c, dyn).reshape(-1, 3)
    tag = c.tag.reshape(-1).long()
    live = tag >= 0
    N = system.state.N
    dev = c.pos.device
    Ft = torch.zeros((N, 3), dtype=torch.float64, device=dev)
    Ft[tag[live]] = F[live].double()
    pos = torch.zeros((N, 3), dtype=torch.float64, device=dev)
    pos[tag[live]] = c.pos.reshape(-1, 3)[live].double()
    L = system._state_raw.box.L.double().to(dev)
    snap = system.snapshot_template
    nl = system._program['fast']['pair_force']._nlist
    Fr, S = kg_reference(pos, L, snap.bonds.group, snap.angles.group,
                         nl._build_exclusion_table(snap))
    err = (Ft - Fr).abs()
    allowed = ATOL + RTOL * S[:, None]
    worst = float((err / S[:, None].clamp(min=1e-30)).max())
    print(f"{what}: the step's force (plane kernel, recip "
          f"{'approx' if fast['kind'] != 'nve' else 'div'}, plus the "
          f"bonds, angles and exclusion correction) against the float64 "
          f"sum on {N} beads: largest error {float(err.max()):.3e}, largest "
          f"error / S {worst:.3e}, largest |F| {float(Fr.abs().max()):.3e}, "
          f"largest S {float(S.max()):.3e}", flush=True)
    if not bool((err <= allowed).all()):
        i = int((err - allowed).max(1).values.argmax())
        raise RuntimeError(f"{what}: bead {i}'s force {Ft[i].tolist()} "
                           f"against the float64 sum's {Fr[i].tolist()} "
                           f"(S {float(S[i]):.3e})")
    return float(err.max()), worst


def kg_seed_window(seed):
    """The PE/N check's job on the card (that of tests/test_torch_bonded.py
    kg-trace through the JAX package): the config's script
    at KG_SEED_CHAINS chains, its start drawn from ``seed``, kg_warmup with
    KG_SEED_EQ runs, then the window (kg_window).  Prints the window's
    mean PE/N as the last line, a JSON object; its mean T must be 1 +-
    0.03."""
    import hoomd_tpu_torch as hoomd
    hoomd.context.initialize("--mode=gpu --notice-level=0")
    system, mode = kg_script(hoomd, KG_SEED_CHAINS, seed)
    kg_warmup(system, mode, KG_SEED_EQ)
    temps, pes = kg_window(system)
    if abs(np.mean(temps) - KG_TEMP) > KG_TEMP_TOL:
        raise RuntimeError(f"KG PE/N job, seed {seed}: mean T over the "
                           f"window {np.mean(temps):.4f}")
    print(json.dumps({"seed": seed, "pe": float(np.mean(pes)),
                      "T": float(np.mean(temps)),
                      "fast_stats": system.fast_stats}), flush=True)


def kg_seed_processes():
    """kg_seed_window for every seed of KG_PE_JAX, each in a process of its
    own (the jobs are host-bound: they run side by side on the host's
    cores and share the card), started here and read by kg_seed_results."""
    here = os.path.dirname(os.path.abspath(__file__))
    return {seed: subprocess.Popen(
        [sys.executable, '-c', f'import chip_smoke; '
         f'chip_smoke.kg_seed_window({seed})'], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for seed in KG_PE_JAX}


def kg_seed_results(procs, timeout=900):
    """Wait for kg_seed_processes' processes (killing all of them if one
    fails or the time runs out); returns {seed: the window's mean PE/N}."""
    out = {}
    try:
        for seed, p in procs.items():
            so, se = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"KG PE/N job, seed {seed}, failed: "
                                   f"{se[-3000:]}")
            res = json.loads(so.strip().splitlines()[-1])
            print(f"KG PE/N job, seed {seed}: {res}", flush=True)
            out[seed] = res['pe']
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def kg_job(card):
    """BASELINE config 3 on the card: kg_main (the script at N = 32 768,
    its metric line and gates); the torch calls of one step and per step
    of 100; the busy share and the plane kernel's device time per recorded
    launch over 50 profiled steps; kg_exactness on the end state; a
    1000-step NVE continuation on the exact divide, gated on its drift,
    while the PE/N check's job runs from each seed of KG_PE_JAX in
    processes of its own (kg_seed_processes); the mean of the windows'
    PE/N within KG_PE_BAND of the JAX package's.  Returns the
    launch counts of the script's run."""
    import torch
    import hoomd_tpu_torch as hoomd
    from hoomd_tpu_torch import md
    what = 'KG job'
    t_job = time.perf_counter()
    system, counts, temps, pes, ms = kg_main(card)
    t_main = time.perf_counter() - t_job
    N = system.state.N
    fast = system._program['fast']
    run, dyn = fast['run_chunk'], system._dyn['fast']
    c = system._fast_carry
    calls_step = torch_calls(lambda: run.steps(c, dyn, 1))
    calls_run = torch_calls(lambda: system.run(100, quiet=True)) / 100
    busy, k_dev = device_profile(lambda: system.run(50, quiet=True),
                                 f'50 steps of the {what}', top=8,
                                 per_launch='pair_walk_kernel')
    system.thermo_quantities()
    err, rel = kg_exactness(system, what)
    print(f"{what}: plan cell_dim={fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']}; {ms:.4f} ms/step over the timed "
          f"{KG_STEPS} steps; window mean PE/N {float(np.mean(pes))!r}; "
          f"{calls_step} torch calls in one step (one_step), "
          f"{calls_run:.1f} per step over 100 (the run loop and its "
          f"rebuilds); busy share {busy:.4f}; the plane kernel (row 2) "
          f"{dev_fmt(k_dev)} ms per recorded launch on the device at this "
          f"plan; {card}", flush=True)
    # the PE/N check's jobs run beside the NVE continuation
    t0 = time.perf_counter()
    procs = kg_seed_processes()
    try:
        # NVE continuation, on the exact divide
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
        kind = system._program['fast']['kind']
        print(f"{what} NVE continuation ({kind}): E/N {e0 / N:.6f} -> "
              f"{e1 / N:.6f}, drift {drift:.3e} per particle over 1000 "
              f"steps at dt = 0.005, T={q1['temperature']:.5f}, "
              f"{system.fast_stats}, launches={nve_counts}", flush=True)
        if not np.isfinite(e1) or drift >= NVE_DRIFT_MAX or kind != 'nve':
            raise RuntimeError(f"{what} NVE: energy drift {drift:.3e} per "
                               f"particle per 1000 steps (bound "
                               f"{NVE_DRIFT_MAX})")
        if nve_counts['cell_pair_plane'] < 1000 or nve_counts[
                'cell_megastep_planes']:
            raise RuntimeError(f"{what} NVE: not every step on the plane "
                               f"kernel ({nve_counts})")
        # PE/N against the JAX package's, over seeds at 4096 beads
        pes_s = kg_seed_results(procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    port = float(np.mean(list(pes_s.values())))
    jax = float(np.mean(list(KG_PE_JAX.values())))
    print(f"{what}: PE/N over the window at {KG_SEED_CHAINS * KG_LEN} beads "
          f"per seed, port {pes_s}, JAX package {KG_PE_JAX}; means {port!r} "
          f"and {jax!r}, apart {port - jax:.4e} (band {KG_PE_BAND:.4e}); "
          f"the script to its window's end took {t_main:.1f} s, the NVE "
          f"continuation and the seeds' processes beside it "
          f"{time.perf_counter() - t0:.1f} s, the job "
          f"{time.perf_counter() - t_job:.1f} s", flush=True)
    if not abs(port - jax) <= KG_PE_BAND:
        raise RuntimeError(f"{what}: mean PE/N over seeds {sorted(pes_s)} "
                           f"{port:.4f}, the JAX package's {jax:.4f} +- "
                           f"{KG_PE_BAND:.4f}")
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
    stencil evaluates each pair from both sides) does not count, as in
    lj_bounds."""
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


def tile_build(kname, name, C, nx, ntypes):
    """What the build gave the tile kernel of ``kname`` (cell_pair_planar,
    typed with PE and virial, or cell_pair_planar_n3l) for evaluator
    ``name`` and ntypes types at capacity C on an x-row of nx cells, and
    its occupancy (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor): registers per
    thread, spilled bytes per thread, shared memory per block, blocks
    per SM, and the tile's cells."""
    import ctypes
    from hoomd_tpu_torch.ops import _build, pair_eval
    from hoomd_tpu_torch.ops import cell_pair as cp
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    ntab = (2 + len(pair_eval.kernel_pnames(name))) * ntypes ** 2
    tx = cp.pair_tile(nx, C, cp.PLANAR_TILE_SLOTS if kname == 'cell_pair_planar'
                      else cp.N3L_TILE_SLOTS)
    if kname == 'cell_pair_planar':
        err = lib.lib.hoomd_planar_typed_occupancy(
            pair_eval.EVAL_IDS[name], 1, C, tx, ntab, out)
    else:
        err = lib.lib.hoomd_n3l_occupancy(pair_eval.EVAL_IDS[name],
                                          int(ntypes > 1), C, tx,
                                          ntab if ntypes > 1 else 0, out)
    lib.check(err, f'{kname} occupancy')
    return dict(registers=out[0], spill_bytes=out[1],
                smem_bytes=out[2] + out[3], blocks_per_sm=out[4], tile=tx)


def build_line(b):
    return (f"{b['registers']} registers, {b['spill_bytes']} B spilled per "
            f"thread, {b['smem_bytes']} B shared memory per block, "
            f"{b['blocks_per_sm']} blocks per SM, tiles of {b['tile']} cells")


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
                                     device_ms=device_ms(kern, 10),
                                     build=tile_build(kname, name, C,
                                                      cdim[0], T))
                    if kname == 'cell_pair_planar_n3l':
                        rows[key]['fold_ms'] = device_ms(kern, 10,
                                                         only='n3l_fold')
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
                      f"device_ms={dev_fmt(r['device_ms'])} "
                      f"plain_ms={r['plain_ms']:.4f} bound_ms={b_ms:.6f} "
                      f"({b_by}), {share_fmt(b_ms, r['device_ms'], 4)}"
                      + (f", the fold {dev_fmt(r['fold_ms'])} ms on the device"
                         if 'fold_ms' in r else '') + f"; "
                      f"{build_line(r['build'])}", flush=True)
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
                       device_ms=device_ms(k_fn, iters),
                       plain_ms=cuda_ms(p_fn, 2))
            # the bound of one call, from the work of the three calls
            per_call = {k: v / 3 for k, v in stats.items()}
            row['bound_ms'], row['bound_by'] = mc_bound(
                poly, per_call, args, randu,
                len(kw['tables'][1]) if poly else 0)
            print(f"phase {kname} [{tag_name} cell_dim={cd} C={C} N={N}]: "
                  f"max_abs_err={worst:.3e} trials={trials} "
                  f"pairs/call={per_call['pairs']:.0f} "
                  f"kernel_ms={row['ms']:.4f} "
                  f"device_ms={dev_fmt(row['device_ms'])} "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}), "
                  f"{share_fmt(row['bound_ms'], row['device_ms'])}",
                  flush=True)
            if tag_name == 'job':
                out[kname] = row
                row['build'] = sweep_build(kname, C)
                print(f"  {kname} build at C={C}: "
                      f"{sweep_build_line(row['build'])}", flush=True)
    return out


def sweep_build(kname, C):
    """What the build gave a sweep kernel at capacity C, and its
    occupancy: registers and spilled bytes per thread, shared memory and
    threads per block, blocks per SM."""
    import ctypes
    from hoomd_tpu_torch.ops import _build
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    fn = (lib.lib.hoomd_hpmc_poly_occupancy if kname == 'fused_poly_sweep'
          else lib.lib.hoomd_hpmc_sphere_occupancy)
    lib.check(fn(C, out), f'{kname} occupancy')
    return dict(registers=out[0], spill_bytes=out[1],
                smem_bytes=out[2] + out[3], blocks_per_sm=out[4],
                threads=out[5])


def sweep_build_line(b):
    return (f"{b['registers']} registers, {b['spill_bytes']} B spilled per "
            f"thread, {b['smem_bytes']} B shared memory per block, "
            f"{b['blocks_per_sm']} blocks per SM, {b['threads']} threads per "
            f"block")


def occ_build(entry, *args):
    """What the build gave a kernel and its occupancy (as sweep_build),
    from its library's occupancy entry point called with args: the
    adjacency-listed LJ kernel (hoomd_cell_pair_lj_occupancy, C), the
    modular-indexed one (hoomd_cell_pair_lj3d_occupancy, C), the row
    kernel (hoomd_cell_pair_lj_row_occupancy, C, tile width), the
    candidate build (hoomd_mega_candidates_occupancy, nx, C), the fused
    step (hoomd_step_plane_occupancy, evaluator id, approx, nx, C), the
    plane kernel (hoomd_cell_pair_plane_occupancy, evaluator id, approx,
    nx, C) and the planar kernel (hoomd_cell_pair_planar_occupancy,
    evaluator id, nx, C)."""
    import ctypes
    from hoomd_tpu_torch.ops import _build
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    lib.check(getattr(lib.lib, entry)(*args, out), entry)
    return dict(registers=out[0], spill_bytes=out[1],
                smem_bytes=out[2] + out[3], blocks_per_sm=out[4],
                threads=out[5])


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
    rows['cell_megastep_planes'], mega_eval_ms, \
        rows['mega_candidates'] = megastep_phases(dev)
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
    charged_rows, charged_ms = charged_kernel_phases(dev)
    rows.update(charged_rows)
    rows.update(rebin_kernel_phases(dev))
    rows.update(hpmc_kernel_phases())
    parent_lib = parent_sweep_lj_phase(dev)
    print(f"kernel phases done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    # each path's own launches, read just after it ran
    launches = bench_script(card)
    counts, system = rebin_job('pallas')
    for name in ('cell_rebin_sweep', 'cell_rebin_place'):
        launches[name] = counts[name]
    rebin_job('off')
    counts = variants_path(system)
    rebuild_phase(system, parent_lib)
    for name in ('cell_rebin_select', 'cell_rebin_serial'):
        launches[name] = counts[name]
    # the plane and planar kernels' launches: the jobs that run them every
    # step (the bench job launches them at thermo reads and single steps)
    for impl, kname in IMPL_KERNELS.items():
        launches[kname] = impl_job(impl)[kname]
    launches['cell_pair_plane'] = impl_job('plane', mega='off')[
        'cell_pair_plane']
    launches['cell_step_plane_planes'] = fused_job()['cell_step_plane_planes']
    for name in EVAL_JOBS:
        eval_job(name)
    launches['cell_pair_planar_typed'] = ka_job(card)['cell_pair_planar_typed']
    launches['cell_pair_planar_n3l_typed'] = ka_n3l_job()[
        'cell_pair_planar_n3l_typed']
    launches['cell_pair_planar_q_typed'] = pppm_job(card)[
        'cell_pair_planar_q_typed']
    counts, rows['cell_pair_planar_q'] = madelung_job()
    launches['cell_pair_planar_q'] = counts['cell_pair_planar_q']
    kg_job(card)
    print(f"MD jobs done at {time.perf_counter() - t0:.1f} s", flush=True)
    launches['fused_poly_sweep'] = hpmc_job('cube', card)['fused_poly_sweep']
    launches['fused_sphere_sweep'] = hpmc_job('sphere', card)[
        'fused_sphere_sweep']
    replaces = {
        'cell_megastep_planes': ('hoomd_tpu/ops/pallas_pair.py:1978',
                                 'cell_pair.cu'),
        # the TPU megastep tests its candidates inside the kernel; the
        # port builds them in a launch of their own, once per rebuild
        'mega_candidates': ('hoomd_tpu/ops/pallas_pair.py:1978',
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
        # the charge channel of _kernel_planar (needs_q, :692-697), one
        # type and a mixture
        'cell_pair_planar_q': ('hoomd_tpu/ops/pallas_pair.py:609',
                               'cell_pair_charged.cu'),
        'cell_pair_planar_q_typed': ('hoomd_tpu/ops/pallas_pair.py:609',
                                     'cell_pair_charged.cu'),
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
    # the charged kernel at config 4's shape, per evaluator and number of
    # types: wrapper ms, device ms, plain ms, bound
    print(json.dumps({"charged_kernels": charged_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
