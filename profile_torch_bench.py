#!/usr/bin/env python3
"""Where the time goes in the 64k LJ NVT job of hoomd_tpu_torch on one
NVIDIA GPU.

    python3 profile_torch_bench.py           # the default rebin
    python3 profile_torch_bench.py rebins    # each rebin in turn
    python3 profile_torch_bench.py rebins on on off   # the turns given
    python3 profile_torch_bench.py cadence 1 2 4      # pinned cadences
    python3 profile_torch_bench.py ka        # the Kob-Andersen mixture
    python3 profile_torch_bench.py ka-trace  # its T and PE/N from the start
    python3 profile_torch_bench.py ka-trace 16   # the same at 16^3 = 4096
    python3 profile_torch_bench.py pppm      # the PPPM charged fluid
    python3 profile_torch_bench.py pppm-trace    # its T and PE/N window
    python3 profile_torch_bench.py pppm-nve 16 32 [cpu]  # its NVE drift
    python3 profile_torch_bench.py pppm-mesh # the mesh's two formulations
    python3 profile_torch_bench.py tiles     # the tile kernels' tile widths
    python3 profile_torch_bench.py tiles union   # those on a tile's union
    python3 profile_torch_bench.py rebin     # the migration kernels' tiles
    python3 profile_torch_bench.py designs   # rows 2 and 3: walk, typed kernel
    python3 profile_torch_bench.py ka-bits [TREE]  # the KA job's end bits
    python3 profile_torch_bench.py sweeps [TREE]   # the HPMC sweeps' times
    python3 profile_torch_bench.py jobs [TREE] [JOB ...]  # jobs through TREE
    python3 profile_torch_bench.py sweep-parts [poly] [sphere]  # a sweep's parts
    python3 profile_torch_bench.py profiler  # what torch.profiler sees

from the root of the repository.  It runs chip_smoke.py's bench job
(bench.py's script: Langevin melt, Nose-Hoover NVT, cadence warmup) and
then prints:
  1. the card (nvidia-smi name, power limit, SM clock);
  2. two timed 3000-step windows: particle-steps/s, ms per step, and the
     rebuilds and windows per rebuild (fast_m) in each;
  3. a torch.profiler trace of 1024 steps: wall time, the summed device
     time of all kernels, their ratio (the device's busy share; the
     profiler inflates host time), and the device time per kernel;
  4. CUDA-event times, from a fresh rebuild of the steady state, of one
     k-step kernel window, the fast_m windows of a rebuild cycle, one
     rebuild (the program's rebin and, on the megastep, its candidate
     set), one single step and one rebuild cycle;
  5. the launch counts of the stencil and rebin kernels.
With ``cadence`` (and windows per rebuild, by default 1 2 4) it then
pins the cadence at each in turn and repeats steps 2 and 4 (one timed
window).  With ``rebins`` it does all of this once per rebin of the rebuild, in
the turns given as HOOMD_TPU_REBIN values, by default on (xsel, the
default at this N), off (the sort), pallas (the migration kernels),
pallas, off, on, so that two runs of each bracket the others on one
card; step 4 then also times one rebuild cycle (the pinned windows and
a rebuild, as the run loop chains them).  After the warmup it re-arms the rebin (a strike
or an overflow in the lattice melt may have fallen back to the sort) and
pins the cadence at PIN_M windows per rebuild, so that the runs differ
in the rebin alone; the System's retry counters and growth table are
printed after each timed window.  With ``ka`` it runs chip_smoke.py's
Kob-Andersen job instead (ka_script: 64 000 particles of a two-type LJ
mixture, every step a one_step on the typed planar kernel) to its NVT
steady state and prints steps 1-3 and 5, and step 4 without the kernel
window (it has none).  With ``ka-trace`` it prints the KA job's
temperature and PE/N every 100 steps from the lattice start, twice: the
1000-step Langevin melt then 3000 Nose-Hoover steps, and the same with
ka_script's second Langevin run of 1000 steps at dt = 0.005 between
them; a number after it is the lattice's side (by default 40, the
job's 64 000 particles; tests/test_torch_types.py runs the same trace
through the JAX package on the CPU).  With ``pppm`` it runs
chip_smoke.py's config-4 job (pppm_script: 4096 ions, pair.lj and
md.charge.pppm, every step a one_step on the charged kernel and the
mesh) through bench_all.py's warmup and prints steps 1-3 and 5, and one
step split between the charged kernel, the mesh and the rest, by CUDA
events and device time; with ``pppm-trace`` the script's T and PE/N
over chip_smoke.py's NVT window (tests/test_torch_charged.py runs the
same trace through the JAX package on the CPU); with ``pppm-nve
[n_side [mesh [cpu]]]`` the energy of 500 NVE steps after 300 NVT steps
from the lattice, at n_side^3 ions on a mesh^3 mesh, on the card or with
``cpu`` through the plain versions (tests/test_torch_charged.py
pppm-nve runs it through the JAX package); with ``pppm-mesh`` the PPPM
mesh (md/charge.py mesh_compute) in its dense and its scatter
formulation on random neutral clouds at config 4's density, at config
4's size and past the dense gate, by CUDA events.  With ``tiles`` it
times the typed planar kernel and the half stencil (csrc/cell_tile.cuh)
at tile widths of 1 to 6 cells: rows 3t and 7t at the KA shape with the
KA table, row 7 at the bench shape; then the kernels on a tile's union
at the bench shape, 1 to 7 cells: the planar and plane kernels (rows 3
and 2), the row-blocked LJ kernel (row 6) and the fused step (row 8);
with ``tiles union`` only the latter.  With
``designs`` it times the two designs that sum rows 2 and 3 in their
first design's order, the ordered warp walk and the typed tile kernel at
one type, in turns at the bench fill (ordered_designs).  With
``rebin`` it times the migration sweep (row 10) at each tile of
REBIN_TILES and the z place (row 11) at each of REBIN_PLACE_CELLS cells per
block, on the bench fill drifted by up to 0.45 w and by up to 0.1 w, by
CUDA events per wrapper call and by device time per recorded launch.  With ``ka-bits [TREE]`` it runs
chip_smoke.py's KA job script through the hoomd_tpu_torch of TREE (by
default this checkout) and prints T and PE/N at the end of its NVT
window exactly; chip_smoke.py's KA_PARENT_T and KA_PARENT_PE come from
it on the tree of the parent design.  With ``jobs [TREE] [JOB ...]`` it
runs chip_smoke.py's jobs named (JOBS: ``sphere`` and ``cube``, the HPMC
jobs; ``pallas``, ``pallas3d``, ``row``, ``planar_n3l``, ``planar``, the
impl jobs' HOOMD_TPU_FAST_IMPL paths; ``plane_mega_off``, plane with
HOOMD_TPU_MEGA=off, every step a single step on the plane kernel;
``fused``, the HOOMD_TPU_FUSED=on NVT job and its NVE continuation;
``bench``, the bench job with its warmup and one timed 3000-step window;
``migration``, the HOOMD_TPU_REBIN=pallas job (chip_smoke.py rebin_job)
and a timed 1000-step window on the migration
rebin; ``kg``, config 3's job through its timed window and gates
(chip_smoke.py kg_main) and the torch calls of one step; by default
sphere, cube, pallas) through the
hoomd_tpu_torch of TREE, with their gates; run on two trees in turns, in
separate processes, it compares their end-to-end numbers on one card.  With ``sweeps [TREE]`` it times
each HPMC sweep (fused_sphere_sweep, fused_poly_sweep) at its job
script's plan through the hoomd_tpu_torch of TREE: ms per wrapper call
by CUDA events and device ms per call by torch.profiler; with
``sweep-parts [poly] [sphere]`` the polyhedron (by default) or the
sphere sweep built as it is, without its overlap tests and without any
per-cell work (csrc/hpmc_sweep.cu's profiling switches), each timed the
same way.  With ``profiler`` it probes whether torch.profiler lists short calls'
kernels (chip_smoke.py device_ms).  Beyond those holds it checks
nothing; chip_smoke.py is the check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import bench_job, cuda_ms

# windows per rebuild in the rebins comparison: the cadence the sort runs
# settle at in this job (8 steps at k = 4)
PIN_M = 2


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def rearm(system, m):
    """The rebin the environment chooses, again, and a cadence of m
    windows per rebuild that the controller neither grows nor probes."""
    for key in ('fast_rebin_sort', 'fast_xsel_retry', 'fast_xsel_fails',
                'fast_rebin_E'):
        system._grow.pop(key, None)
    system._grow.update(fast_m=m, fast_m_ceil=m, fast_m_pinned=True,
                        fast_m_probe_fails=2)
    system._rebuild_program()
    system._pack_dyn()


def timed_windows(system, N, steps=3000, reps=2):
    for _ in range(reps):
        torch.cuda.synchronize()
        nr0 = system.fast_stats['rebuilds']
        t0 = time.perf_counter()
        system.run(steps, quiet=True)
        el = time.perf_counter() - t0
        nr = system.fast_stats['rebuilds'] - nr0
        print(f"timed {steps}: {el:.4f} s = {steps * N / el:.6g} "
              f"particle-steps/s, {el / steps * 1e3:.4f} ms/step, "
              f"rebuilds {nr}, fast_m {system._grow.get('fast_m')}, rebin "
              f"{system._program['fast']['rebin_impl']}, "
              f"{system.fast_stats}, grow {system._grow}", flush=True)


def profile_steps(system, steps=1024, top=25):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.run(steps, quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, dev_total = [], 0.0
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats its kernels'
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, 'self_device_time_total', None)
        if t is None:
            t = getattr(e, 'self_cuda_time_total', 0.0)
        if t > 0:
            rows.append((t, e.key, e.count))
            dev_total += t
    rows.sort(reverse=True)
    print(f"profile {steps} steps: wall {wall * 1e3:.3f} ms, device kernel "
          f"time {dev_total / 1e3:.3f} ms, busy share "
          f"{dev_total / 1e3 / (wall * 1e3):.4f}", flush=True)
    for t, key, count in rows[:top]:
        print(f"  {t / 1e3:10.3f} ms  {count:6d}x  {key[:90]}", flush=True)


def component_times(system):
    """CUDA-event times from a fresh rebuild of the live state: one
    window, the fast_m windows of one rebuild cycle, one rebuild, one
    single step and one rebuild cycle."""
    fast = system._program['fast']
    carry = system._fast_carry
    if carry is None:                   # a retry rebuilt the program
        carry = system._fresh_carry()
    dyn, run = system._dyn['fast'], fast['run_chunk']
    k = fast['k_rebuild']
    carry = run.rebuild(carry)
    m = max(int(system._grow.get('fast_m', 1)), 1)
    t_win = cuda_ms(lambda: run.wins(carry, dyn, 1, k), 50)
    t_winm = cuda_ms(lambda: run.wins(carry, dyn, m, k), 10)
    t_reb = cuda_ms(lambda: run.rebuild(carry), 50)
    t_step = cuda_ms(lambda: run.steps(carry, dyn, 1), 20)
    t_cyc = cuda_ms(lambda: run.cycles(carry, dyn, 1, m, k), 50)
    print(f"one window (k={k}): {t_win:.4f} ms; {m} windows {t_winm:.4f} "
          f"ms; rebuild {t_reb:.4f} ms; one step {t_step:.4f} ms; one "
          f"rebuild cycle of {m} windows {t_cyc:.4f} ms", flush=True)


def profile_ka():
    """The KA mixture's NVT steady state: timed windows, the profile, a
    single step, a rebuild and a rebuild cycle by CUDA events."""
    import hoomd_tpu_torch as hoomd
    from chip_smoke import ka_script
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    cp.reset_launch_counts()
    cr.reset_launch_counts()
    print('card:', card(), flush=True)
    hoomd.context.initialize('--mode=gpu --notice-level=0')
    system, _, temps = ka_script(hoomd, nvt_steps=500)
    N = system.state.N
    fast = system._program['fast']
    print(f"KA job at its NVT steady state: plan {fast['cell_dim']} "
          f"C={fast['C']} k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']}, T over the window "
          f"{sum(temps) / len(temps):.5f}, "
          f"grow {system._grow}, {system.fast_stats}", flush=True)
    timed_windows(system, N)
    profile_steps(system)
    carry = system._fast_carry
    dyn, run = system._dyn['fast'], fast['run_chunk']
    m = max(int(system._grow.get('fast_m', 1)), 1)
    k = fast['k_rebuild']
    carry = run.rebuild(carry)
    t_step = cuda_ms(lambda: run.steps(carry, dyn, 1), 50)
    t_reb = cuda_ms(lambda: run.rebuild(carry), 50)
    t_cyc = cuda_ms(lambda: run.cycles(carry, dyn, 1, m, k), 10)
    print(f"one step {t_step:.4f} ms; rebuild {t_reb:.4f} ms; one rebuild "
          f"cycle of {m * k} steps {t_cyc:.4f} ms (CUDA events)", flush=True)
    print(json.dumps({'launches': {**cp.launch_counts(),
                                   **cr.launch_counts()}}), flush=True)


def ka_trace(settle, n_side=None, hoomd=None,
             args='--mode=gpu --notice-level=0'):
    """T and PE/N every 100 steps of the KA job (n_side^3 particles, by
    default the job's) from its lattice start: the melt, with ``settle``
    1000 Langevin steps at dt = 0.005, then 3000 Nose-Hoover steps.
    ``hoomd`` is the package that runs it (by default hoomd_tpu_torch),
    its context initialized with ``args``."""
    from chip_smoke import KA_N_SIDE, KA_TEMP, ka_setup
    if hoomd is None:
        import hoomd_tpu_torch as hoomd
    md = hoomd.md
    hoomd.context.initialize(args)
    system, _, mode = ka_setup(hoomd, n_side or KA_N_SIDE)
    N = system.state.N
    what = (f'ka-trace {hoomd.__name__} N={N} '
            + ('with' if settle else 'without') + ' the settle')

    def reads(phase, steps):
        for i in range(steps // 100):
            system.run(100, quiet=True)
            q = system.thermo_quantities()
            print(f"{what}: {phase} {100 * (i + 1)} T {q['temperature']:.4f} "
                  f"PE/N {q['potential_energy'] / N:.4f}", flush=True)
    lan = md.integrate.langevin(group=hoomd.group.all(), kT=KA_TEMP, seed=7)
    reads('melt', 1000)
    mode.set_params(dt=0.005)
    if settle:
        reads('settle', 1000)
    lan.disable()
    md.integrate.nvt(group=hoomd.group.all(), kT=KA_TEMP, tau=0.5)
    reads('nvt', 3000)


def profile_pppm():
    """Config 4 (the PPPM charged fluid) after bench_all.py's warmup:
    timed windows, the profile, and one step split by CUDA events and by
    device time into the charged pair kernel, the PPPM mesh (as one_step
    calls them, on the steady state) and the rest: the integrator's
    elementwise ops, the drift monitor and the host."""
    import hoomd_tpu_torch as hoomd
    from chip_smoke import device_ms, pppm_script, pppm_warmup
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    cp.reset_launch_counts()
    cr.reset_launch_counts()
    print('card:', card(), flush=True)
    hoomd.context.initialize('--mode=gpu --notice-level=0')
    system = pppm_script(hoomd)
    pppm_warmup(system)
    N = system.state.N
    fast = system._program['fast']
    cdim, C = fast['cell_dim'], fast['C']
    print(f"config 4 after the warmup: plan {cdim} C={C} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']} "
          f"impl={fast['impl']} eval={fast['eval_name']}, grow "
          f"{system._grow}, {system.fast_stats}", flush=True)
    timed_windows(system, N, steps=1000)
    profile_steps(system, steps=1000)
    carry = system._fast_carry
    dyn, run = system._dyn['fast'], fast['run_chunk']
    dev = carry.pos.device
    _, sh = cp.build_cell_shifts(cdim, system._state_raw.box.L.cpu().numpy())
    sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
    q = torch.as_tensor(system.snapshot_template.particles.charge,
                        dtype=torch.float32, device=dev)
    qc = torch.where(carry.tag >= 0, q[carry.tag.long().clamp(min=0)], 0.0)
    mesh_fn = fast['charged']['mesh']._mesh_compute
    box = system._state_raw.box
    M = qc.numel()

    def kern():
        return cp.cell_pair_planar(
            carry.pos, cdim, sh, dyn['pv'], C=C, cell_tag=carry.tag,
            eval_name=fast['eval_name'], pnames=fast['pnames'],
            ntypes=fast['ntypes'], cell_typ=carry.typ, cell_q=qc,
            want_pv=False)

    def mesh():
        return mesh_fn(carry.pos.reshape(M, 3), qc.reshape(M), box,
                       dyn['mesh'], want_pv=False)

    def step():
        return run.steps(carry, dyn, 1)
    t = {n: cuda_ms(f, 100) for n, f in (('step', step), ('kernel', kern),
                                         ('mesh', mesh))}
    d = {n: device_ms(f, 50) for n, f in (('step', step), ('kernel', kern),
                                          ('mesh', mesh))}
    print(f"one step {t['step']:.4f} ms (device {d['step']:.4f}): the "
          f"charged kernel call {t['kernel']:.4f} (device "
          f"{d['kernel']:.4f}), the mesh {t['mesh']:.4f} (device "
          f"{d['mesh']:.4f}), the rest "
          f"{t['step'] - t['kernel'] - t['mesh']:.4f} (device "
          f"{d['step'] - d['kernel'] - d['mesh']:.4f}); the device busy "
          f"{d['step'] / t['step']:.4f} of a step (CUDA events, "
          f"torch.profiler)", flush=True)
    print(json.dumps({'pppm_step_ms': t, 'pppm_step_device_ms': d,
                      'launches': {**cp.launch_counts(),
                                   **cr.launch_counts()}}), flush=True)


def pppm_nve(n_side, mesh, hoomd=None, args='--mode=gpu --notice-level=0',
             nvt_steps=300):
    """Config 4's job script at n_side^3 ions on a mesh^3 mesh through
    ``hoomd`` (by default hoomd_tpu_torch), its context initialized with
    ``args``: nvt_steps Nose-Hoover steps from the lattice, then 500 NVE
    steps read every 50: KE + PE per particle and the energy the dynamics
    conserves (chip_smoke.py nve_drift)."""
    from chip_smoke import nve_drift, pppm_script
    if hoomd is None:
        import hoomd_tpu_torch as hoomd
    hoomd.context.initialize(args)
    system = pppm_script(hoomd, n_side, mesh)
    system.run(nvt_steps, quiet=True)
    for m in system.methods:
        m.disable()
    hoomd.md.integrate.nve(group=hoomd.group.all())
    nve_drift(system, f'pppm-nve {hoomd.__name__} N={n_side ** 3} '
                      f'mesh {mesh}^3')


def pppm_trace(hoomd=None, args='--mode=gpu --notice-level=0', seed=9):
    """Config 4's job script (chip_smoke.py pppm_script, velocities from
    ``seed``) through ``hoomd`` (by default hoomd_tpu_torch), its context
    initialized with ``args``: bench_all.py's warmup, its 1000-step timed
    window, then the NVT window of chip_smoke.py's pppm_job, T and PE/N
    every 100 steps and their means."""
    from chip_smoke import pppm_script, pppm_warmup, pppm_window
    if hoomd is None:
        import hoomd_tpu_torch as hoomd
    hoomd.context.initialize(args)
    system = pppm_script(hoomd, seed=seed)
    t0 = time.perf_counter()
    pppm_warmup(system)
    system.run(1000, quiet=True)
    what = f'pppm-trace {hoomd.__name__} seed {seed}'
    print(f"{what}: warmup and timed window "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    temps, pes = pppm_window(system)
    for i, (t, pe) in enumerate(zip(temps, pes)):
        print(f"{what}: window {100 * (i + 1)} T {t:.5f} PE/N {pe:.5f}",
              flush=True)
    print(f"{what}: mean T {float(np.mean(temps))!r} "
          f"mean PE/N {float(np.mean(pes))!r}", flush=True)


# (ions, mesh points per axis) of pppm-mesh: config 4, config 4 at the
# dense gate's N Nx Ny = 2^25, past it on the same mesh, and past it with
# the mesh spacing kept
MESH_SIZES = ((4096, 32), (32768, 32), (65536, 32), (65536, 64))


def profile_mesh(sizes=MESH_SIZES, dev=torch.device('cuda', 0)):
    """The PPPM mesh's dense (one-hot matrix products) and scatter
    (index_add_) formulations on one card: random neutral clouds of N
    ions at config 4's density (4096 in 25.6^3), order 5, with and
    without the energy and virial; each side's ms per call by CUDA
    events, and how far apart their forces are."""
    from hoomd_tpu_torch.box import Box
    from hoomd_tpu_torch.md import charge
    gate = charge.DENSE_MAX
    res = []
    for n, k in sizes:
        L = 25.6 * (n / 4096) ** (1 / 3)
        rng = np.random.RandomState(3)
        pos = torch.as_tensor(rng.uniform(-L / 2, L / 2, (n, 3)),
                              dtype=torch.float32, device=dev)
        q = rng.choice([-1.0, 1.0], n)
        q[-1] = -q[:-1].sum()
        q = torch.as_tensor(q, dtype=torch.float32, device=dev)
        box = Box.create(L, device=dev)
        params = {'kappa': torch.tensor(3.2 / 2.5, dtype=torch.float32,
                                        device=dev),
                  'bmod': tuple(torch.as_tensor(
                      charge._bspline_moduli(k, 5), dtype=torch.float32,
                      device=dev) for _ in range(3)),
                  'mvec': tuple(torch.as_tensor(
                      np.fft.fftfreq(k) * k, dtype=torch.float32,
                      device=dev) for _ in range(3))}
        row = {'N': n, 'mesh': k, 'gate_side': ('dense' if n * k * k <= gate
                                                else 'scatter')}
        F = {}
        for side, dmax in (('dense', 1 << 62), ('scatter', -1)):
            charge.DENSE_MAX = dmax
            try:
                for pv in (False, True):
                    def call(pv=pv):
                        return charge.mesh_compute(pos, q, box, params,
                                                   want_pv=pv, mesh=(k,) * 3,
                                                   order=5)
                    F[side] = call()[0]
                    row[f'{side}_ms{"_pv" if pv else ""}'] = cuda_ms(call, 20)
            finally:
                charge.DENSE_MAX = gate
        row['max_abs_dF'] = float((F['dense'] - F['scatter']).abs().max())
        row['max_abs_F'] = float(F['dense'].abs().max())
        res.append(row)
        print(f"pppm-mesh N={n} mesh {k}^3 (the gate picks "
              f"{row['gate_side']}): dense {row['dense_ms']:.4f} ms "
              f"({row['dense_ms_pv']:.4f} with PE and virial), scatter "
              f"{row['scatter_ms']:.4f} ms ({row['scatter_ms_pv']:.4f}); "
              f"max |F_dense - F_scatter| {row['max_abs_dF']:.3e} of max "
              f"|F| {row['max_abs_F']:.4g}", flush=True)
    print(json.dumps({'pppm_mesh_ms': res}), flush=True)


def ordered_designs(dev=torch.device('cuda', 0), names=('lj', 'mie')):
    """The two designs that sum rows 2 and 3 in their first design's order,
    at the bench fill: the ordered warp walk (cell_pair_plane and
    cell_pair_planar, csrc/cell_pair.cu) and the typed tile kernel at one
    type (csrc/cell_pair_typed.cu with a (2 + np, 1, 1) table, its tiles
    by cell_pair.pair_tile), in turns (walk, typed, typed, walk): ms per
    wrapper call by CUDA events and device ms per recorded launch; F
    alone (the plane kernel's exact divide: the typed kernel has no fast
    reciprocal) and F, PE and virial; and whether the typed kernel gives
    the walk's bits."""
    import ctypes
    from chip_smoke import (SHAPES, dev_fmt, device_kernels, eval_params,
                            lattice_cells, lj_params, recorded_ms, same_bits)
    from hoomd_tpu_torch.ops import cell_pair as cp
    dims, cdim, C = SHAPES['bench']
    carry, L, _, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    sh = torch.as_tensor(cp.build_cell_shifts(cdim, L)[1], dtype=torch.float32,
                         device=dev)
    pos, tag = carry.pos, carry.tag
    typ = torch.zeros_like(tag, dtype=torch.int32)
    nc = pos.shape[0]
    lib = cp._kernel_lib()
    res = {}
    for name in names:
        if name == 'lj':
            pv, ek = lj_params(dev)[0], {}
            pn = cp.LJ_PNAMES
        else:
            pv, pn, _ = eval_params(name, dev)
            ek = dict(eval_name=name, pnames=pn)
        ev = cp.pair_eval.EVAL_IDS[name]
        tx = cp.pair_tile(cdim[0], C, cp.PLANAR_TILE_SLOTS)
        for pv_on in (False, True):
            F = torch.empty_like(pos)
            pe = torch.empty((nc, C), device=dev) if pv_on else None
            vir = torch.empty((nc, C, 6), device=dev) if pv_on else None

            def typed():
                lib.check(lib.lib.hoomd_cell_pair_planar_typed(
                    pos.data_ptr(), tag.data_ptr(), typ.data_ptr(),
                    sh.data_ptr(), pv.data_ptr(), len(pn), 1, F.data_ptr(),
                    pe.data_ptr() if pv_on else None,
                    vir.data_ptr() if pv_on else None, *cdim, C, ev,
                    int(pv_on), tx, torch.cuda.current_stream().cuda_stream),
                    'typed kernel at T = 1')
                return (F, pe, vir) if pv_on else (F,)
            if pv_on:
                walk = lambda: cp.cell_pair_planar(pos, cdim, sh, pv, C=C,
                                                   cell_tag=tag, **ek)
            else:
                walk = lambda: (cp.cell_pair_plane(pos, cdim, sh, pv, C=C,
                                                   cell_tag=tag, **ek),)
            bits = same_bits(walk(), typed())
            order = (walk, typed, typed, walk)
            ms = [cuda_ms(f, 50) for f in order]
            dv = [recorded_ms(device_kernels(f, 20))[0] for f in order]
            key = f"{name} {'F, PE, virial' if pv_on else 'F'}"
            res[key] = dict(walk_ms=ms[::3], typed_ms=ms[1:3],
                            walk_device_ms=dv[::3], typed_device_ms=dv[1:3],
                            typed_tile=tx, same_bits=bits)
            print(f"ordered designs, {key} [bench cell_dim={cdim} C={C}]: "
                  f"in turns walk, typed, typed, walk "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms per call, device "
                  f"{', '.join(dev_fmt(t) for t in dv)}"
                  f"; the typed kernel (tiles of {tx}) "
                  f"{'gives' if bits else 'does not give'} the walk's bits",
                  flush=True)
    print(json.dumps({'ordered_designs': res}), flush=True)


def profile_tiles(widths=(1, 2, 3, 4, 5, 6), dev=torch.device('cuda', 0)):
    """The typed planar kernel and the half stencil (csrc/cell_tile.cuh)
    at each tile width: rows 3t and 7t at the KA shape with the KA table,
    row 7 at the bench shape, ms per wrapper call by CUDA events; the
    width the wrappers take (cell_pair.pair_tile) marked.  Then rows 6
    and 8 (union_tiles)."""
    from chip_smoke import (SHAPES, ka_cells, lattice_cells, lj_params,
                            typed_table)
    from hoomd_tpu_torch.ops import cell_pair as cp
    chosen = cp.pair_tile
    carry, L, _, cdim, C = ka_cells(dev, 2)
    sh = torch.as_tensor(cp.build_cell_shifts(cdim, L)[1], dtype=torch.float32,
                         device=dev)
    tab, pn = typed_table('lj', 2, dev)
    kw = dict(C=C, cell_tag=carry.tag, pnames=pn, ntypes=2,
              cell_typ=carry.typ)
    dims, cdim_b, C_b = SHAPES['bench']
    bench, L_b, _, _ = lattice_cells(dims, cdim_b, C_b, 0.1, 3, dev)
    sh_b = torch.as_tensor(cp.build_cell_shifts(cdim_b, L_b)[1],
                           dtype=torch.float32, device=dev)
    pv = lj_params(dev)[0]
    rows = {'3t': (cdim, C, cp.PLANAR_TILE_SLOTS, lambda: cp.cell_pair_planar(
                carry.pos, cdim, sh, tab, **kw)),
            '7t': (cdim, C, cp.N3L_TILE_SLOTS, lambda: cp.cell_pair_planar_n3l(
                carry.pos, cdim, sh, tab, **kw)),
            '7': (cdim_b, C_b, cp.N3L_TILE_SLOTS, lambda: cp.cell_pair_planar_n3l(
                bench.pos, cdim_b, sh_b, pv, C=C_b, cell_tag=bench.tag))}
    res = {}
    try:
        for row, (cd, c, slots, call) in rows.items():
            res[row] = {}
            for tx in widths:
                cp.pair_tile = lambda nx, C, slots, tx=tx: min(tx, nx)
                res[row][tx] = cuda_ms(call, 50)
            mark = chosen(cd[0], c, slots)
            print(f"row {row} (cell_dim={cd} C={c}): "
                  + ', '.join(f"{tx} cells {t:.4f} ms"
                              + (' (taken)' if tx == mark else '')
                              for tx, t in res[row].items()), flush=True)
    finally:
        cp.pair_tile = chosen
    res.update(union_tiles(dev))
    print(json.dumps({'tile_ms': res}), flush=True)


def union_tiles(dev, widths=(1, 2, 3, 4, 5, 7)):
    """The kernels on a tile's union (csrc/cell_walk.cuh): the planar
    kernel (row 3, LJ), the plane kernel (row 2, LJ, fast reciprocal),
    the row-blocked LJ kernel (row 6) and the fused step (row 8, LJ NVT),
    at the bench shape and each tile width (1: the 27 cells of one cell):
    ms per wrapper call by CUDA events and device ms (per recorded
    launch, chip_smoke.py recorded_ms); rows 2 and 3 built once per width
    with -DPAIR_TILE (csrc/cell_pair.cu), row 6 through cell_pair.ROW_TILE,
    row 8 built once per width with -DSTEP_TILE (csrc/cell_step.cu).  The
    widths taken marked."""
    from chip_smoke import (SHAPES, device_kernels, lattice_cells, lj_params,
                            plane_state, recorded_ms)
    from hoomd_tpu_torch.ops import cell_pair as cp
    dims, cdim, C = SHAPES['bench']
    carry, L, _, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    sh = torch.as_tensor(cp.build_cell_shifts(cdim, L)[1], dtype=torch.float32,
                         device=dev)
    pv, ljv = lj_params(dev)
    st = plane_state(carry, cdim, C, sh, pv)
    s = torch.tensor(float(np.exp(-0.0025 * 0.2)), dtype=torch.float32,
                     device=dev)
    step = lambda: cp.cell_step_plane_planes(
        st['gp'], st['gv'], st['gf'], st['gw'], st['gr'], cdim, sh, pv,
        0.005, s, C=C, gt=st['gt'])
    row = lambda: cp.cell_pair_lj_row(carry.pos, cdim, sh, ljv, C=C,
                                      cell_tag=carry.tag)
    planar = lambda: cp.cell_pair_planar(carry.pos, cdim, sh, pv, C=C,
                                         cell_tag=carry.tag)
    plane = lambda: cp.cell_pair_plane(carry.pos, cdim, sh, pv, C=C,
                                       cell_tag=carry.tag, recip='approx')
    on = variant_calls('cell_step.cu', 'hoomd_step_plane',
                       {tx: [f'-DSTEP_TILE={tx}'] for tx in widths}, cp)
    on_pair = variant_calls(
        'cell_pair.cu', ('hoomd_cell_pair_plane', 'hoomd_cell_pair_planar'),
        {tx: [f'-DPAIR_TILE={tx}'] for tx in widths}, cp)
    chosen = cp.ROW_TILE
    res = {'3': {}, '2': {}, '6': {}, '8': {}}
    for tx in widths:
        for r, fn in (('3', planar), ('2', plane)):
            call = on_pair[tx](fn)
            res[r][tx] = (cuda_ms(call, 50),
                          recorded_ms(device_kernels(call, 20))[0])
    try:
        for tx in widths:
            cp.ROW_TILE = tx
            res['6'][tx] = (cuda_ms(row, 50),
                            recorded_ms(device_kernels(row, 20))[0])
    finally:
        cp.ROW_TILE = chosen
    for tx in widths:
        call = on[tx](step)
        res['8'][tx] = (cuda_ms(call, 50),
                        recorded_ms(device_kernels(call, 20))[0])
    taken = {'3': _step_tile('cell_pair.cu', 'PAIR_TILE'),
             '2': _step_tile('cell_pair.cu', 'PAIR_TILE'), '6': chosen,
             '8': _step_tile()}
    for r, times in res.items():
        print(f"row {r} (cell_dim={cdim} C={C}): " + ', '.join(
            f"{tx} cells {ms:.4f} ms, device "
            f"{'not measured' if d is None else f'{d:.4f}'}"
            + (' (taken)' if tx == taken[r] else '')
            for tx, (ms, d) in times.items()), flush=True)
    return res


# the migration sweep's tiles (TX, TY) and the z place's cells per block
# that ``rebin`` times
REBIN_TILES = ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2))
REBIN_PLACE_CELLS = (4, 8, 16)


def rebin_tiles(dev=torch.device('cuda', 0)):
    """Rows 10 and 11 at each tile (REBIN_TILES) and cells per block
    (REBIN_PLACE_CELLS) on the bench fill drifted by up to 0.45 w and 0.1 w:
    ms per wrapper call by CUDA events and device ms per call from the
    recorded launches, each kernel held to its plain version bit for
    bit; the wrappers' own choice marked."""
    from chip_smoke import (SHAPES, device_kernels, drifted, exact,
                            lattice_cells, recorded_ms)
    from hoomd_tpu_torch.ops import cell_rebin as cr
    dims, cdim, C = SHAPES['bench']
    carry, L, _, _ = lattice_cells(dims, cdim, C, 0.1, 3, dev)
    par = cr.rebin_params(L, cdim)
    taken = cr.SWEEP_TILE, cr.PLACE_CELLS
    res = {}
    try:
        for amp in (0.45, 0.1):
            c = drifted(carry, amp * L / np.asarray(cdim, float), 11)
            cols = cr.to_cols(c.pos, c.vel, c.frc, c.img, c.tag, c.mass,
                              cdim, C)
            want = {'sweep': cr.cell_rebin_sweep_plain(cols, cdim, par, C=C,
                                                       E=8)}
            swept, emz, _ = want['sweep']
            want['place'] = cr.cell_rebin_place_plain(swept, emz, cdim, par,
                                                      C=C, E=8)
            runs = [('sweep', t, lambda: cr.cell_rebin_sweep(
                        cols, cdim, par, C=C, E=8)) for t in REBIN_TILES]
            runs += [('place', pc, lambda: cr.cell_rebin_place(
                        swept, emz, cdim, par, C=C, E=8))
                     for pc in REBIN_PLACE_CELLS]
            for kind, opt, call in runs:
                if kind == 'sweep':
                    cr.SWEEP_TILE = opt
                else:
                    cr.PLACE_CELLS = opt
                exact(f'{kind} {opt}', call(), want[kind])
                ms = cuda_ms(call, 50)
                dms = recorded_ms(device_kernels(call, 20))[0]
                res[f'{kind} {opt} drift {amp}'] = dict(ms=ms, device_ms=dms)
                mark = ' (taken)' if opt in taken else ''
                print(f"rebin {kind} {opt}{mark}, drift {amp} w: {ms:.4f} ms "
                      f"per wrapper call, device "
                      f"{'not measured' if dms is None else f'{dms:.4f}'} ms",
                      flush=True)
    finally:
        cr.SWEEP_TILE, cr.PLACE_CELLS = taken
    print(json.dumps({'rebin_tile_ms': res}), flush=True)
    rebin_host(cols, cdim, par, C, swept, emz)


def rebin_host(cols, cdim, par, C, swept, emz, E=8):
    """The host's time per call (chip_smoke.py host_ms) of the sweep's and
    the place's wrappers and of each step of the sweep's: the shape
    checks, the outputs' allocations, the memoised
    arguments, the stream, the bare ctypes call of its C entry point;
    then the wrappers again after one torch.profiler run."""
    from chip_smoke import device_kernels, host_ms
    from hoomd_tpu_torch.ops import cell_rebin as cr
    shp, eshp = cr._shapes(cdim, C, E)
    sw, ez, fl = cr._outputs(cols, shp, eshp)
    lib = cr._kernel_lib().lib
    args = (cols.data_ptr(), sw.data_ptr(), ez.data_ptr(), fl.data_ptr(),
            *cr._geom(cdim, par, C, E), *cr.SWEEP_TILE, cr._stream(cols))

    def sweep():
        return cr.cell_rebin_sweep(cols, cdim, par, C=C, E=E)

    def place():
        return cr.cell_rebin_place(swept, emz, cdim, par, C=C, E=E)
    parts = {'sweep wrapper': sweep, 'place wrapper': place,
             '_check': lambda: cr._check(C, E, cols=(cols, shp)),
             'contiguous': cols.contiguous,
             '_outputs': lambda: cr._outputs(cols, shp, eshp),
             '_geom': lambda: cr._geom(cdim, par, C, E),
             '_stream': lambda: cr._stream(cols),
             'ctypes call of hoomd_rebin_sweep':
                 lambda: lib.hoomd_rebin_sweep(*args)}
    res = {k: host_ms(f, 200) for k, f in parts.items()}
    device_kernels(sweep, 20)
    res['sweep wrapper after a profiler run'] = host_ms(sweep, 200)
    res['place wrapper after a profiler run'] = host_ms(place, 200)
    for k, v in res.items():
        print(f"host {k}: {v * 1e3:.2f} us per call", flush=True)
    print(json.dumps({'rebin_host_ms': res}), flush=True)


def _step_tile(source='cell_step.cu', name='STEP_TILE'):
    """The tile width csrc/<source> defines as ``name`` (STEP_TILE of
    cell_step.cu, PAIR_TILE of cell_pair.cu)."""
    import re
    from hoomd_tpu_torch.ops import _build
    src = (_build.SRC_DIR / source).read_text()
    return int(re.search(rf'#define {name} (\d+)', src).group(1))


def ka_bits(tree=None):
    """The KA job script (chip_smoke.py ka_script, a 1000-step NVT window)
    through the hoomd_tpu_torch of ``tree`` (by default this checkout):
    T and PE/N at the end of the window, exactly."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    import hoomd_tpu_torch as hoomd
    from chip_smoke import ka_script
    hoomd.context.initialize('--mode=gpu --notice-level=0')
    system, _, _ = ka_script(hoomd, nvt_steps=1000)
    q = system.thermo_quantities()
    print(json.dumps({'ka_bits': {
        'package': os.path.dirname(hoomd.__file__), 'T': q['temperature'],
        'PE_N': q['potential_energy'] / system.state.N}}), flush=True)


# the jobs of ``jobs``: the HPMC jobs, the impl jobs' force paths (and
# plane with HOOMD_TPU_MEGA=off), the fused NVT + NVE job
# (HOOMD_TPU_FUSED=on), the bench job, the migration rebin's job
# (HOOMD_TPU_REBIN=pallas), the Kremer-Grest job (config 3)
JOBS = ('sphere', 'cube', 'pallas', 'pallas3d', 'row', 'planar_n3l', 'planar',
        'plane_mega_off', 'fused', 'bench', 'migration', 'kg')


def bench_turn(card_name):
    """chip_smoke.py's bench job (bench.py's script and warmup) and one
    timed 3000-step window, as bench_script times it: particle-steps/s,
    ms per step, the cadence, and T and PE/N after the window, exactly
    (bench_script gates them on its recorded bits)."""
    system, N = bench_job(time.perf_counter())
    steps = 3000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(steps, quiet=True)
    elapsed = time.perf_counter() - t0
    q = system.thermo_quantities()
    pe = q['potential_energy'] / N
    print(json.dumps({'bench_job': {
        'particle_steps_per_sec': steps * N / elapsed,
        'ms_per_step': elapsed / steps * 1e3,
        'fast_m': int(system._grow.get('fast_m', 1)),
        'T': q['temperature'], 'PE_N': pe,
        'fast_stats': system.fast_stats, 'card': card_name}}), flush=True)


def migration_turn(card_name, steps=1000):
    """chip_smoke.py's HOOMD_TPU_REBIN=pallas job (rebin_job: the bench
    script to the melt plus 1000 NVT steps, with its gates), then a timed
    window of ``steps`` steps that must stay on the migration rebin: ms
    per step, the rebuilds in the window, and T and PE/N after it."""
    from chip_smoke import rebin_job
    counts, system = rebin_job('pallas')
    N = system.state.N
    r0 = system.fast_stats['rebuilds']
    os.environ['HOOMD_TPU_REBIN'] = 'pallas'
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(steps, quiet=True)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        os.environ.pop('HOOMD_TPU_REBIN')
    fast = system._program['fast']
    if fast['rebin_impl'] != 'pallas' or system.fast_stats['rebin_retries']:
        raise RuntimeError(f"the migration job left the migration rebin: "
                           f"now {fast['rebin_impl']}, {system.fast_stats}")
    q = system.thermo_quantities()
    print(json.dumps({'migration_job': {
        'ms_per_step': elapsed / steps * 1e3, 'steps': steps,
        'rebuilds': system.fast_stats['rebuilds'] - r0,
        'fast_m': int(system._grow.get('fast_m', 1)),
        'T': q['temperature'], 'PE_N': q['potential_energy'] / N,
        'launches': {k: counts[k] for k in ('cell_rebin_sweep',
                                            'cell_rebin_place')},
        'fast_stats': system.fast_stats, 'card': card_name}}), flush=True)


def kg_turn(card_name):
    """chip_smoke.py's Kremer-Grest job through its timed window and gates
    (kg_main: config 3's script at N = 32 768), then the torch calls of
    one step: particle-steps/s, ms per step, and T and PE/N over the
    window."""
    from chip_smoke import kg_main, torch_calls
    system, counts, temps, pes, ms = kg_main(card_name)
    fast = system._program['fast']
    c = system._fast_carry
    calls = torch_calls(lambda: fast['run_chunk'].steps(
        c, system._dyn['fast'], 1))
    print(json.dumps({'kg_job': {
        'particle_steps_per_sec': system.state.N / ms * 1e3,
        'ms_per_step': ms, 'T': float(np.mean(temps)),
        'PE_N': float(np.mean(pes)), 'torch_calls_per_step': calls,
        'fast_stats': system.fast_stats, 'card': card_name}}), flush=True)


def job_times(tree=None, jobs=('sphere', 'cube', 'pallas')):
    """chip_smoke.py's jobs named in ``jobs`` (JOBS) through the
    hoomd_tpu_torch of ``tree`` (by default this checkout), with their
    gates: each prints its metric line (trial moves/s; ms per step;
    particle-steps/s)."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    from chip_smoke import card_line, fused_job, hpmc_job, impl_job
    import hoomd_tpu_torch
    print(f"package: {os.path.dirname(hoomd_tpu_torch.__file__)}", flush=True)
    c = card_line()
    for job in jobs:
        if job in ('sphere', 'cube'):
            hpmc_job(job, c)
        elif job == 'bench':
            bench_turn(c)
        elif job == 'fused':
            fused_job()
        elif job == 'migration':
            migration_turn(c)
        elif job == 'kg':
            kg_turn(c)
        elif job == 'plane_mega_off':
            impl_job('plane', mega='off')
        else:
            impl_job(job)


def sweep_times(tree=None, iters=50):
    """Each HPMC sweep kernel (rows 13 and 14) at its job script's plan,
    through the hoomd_tpu_torch of ``tree`` (by default this checkout):
    ms per wrapper call by CUDA events and device ms per call by
    torch.profiler, on chip_smoke.py's seeded inputs (mc_inputs)."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    from chip_smoke import device_ms, mc_inputs, mc_system
    from hoomd_tpu_torch.hpmc import sweep as tsw
    out = {}
    for kind, kname in (('sphere', 'fused_sphere_sweep'),
                        ('cube', 'fused_poly_sweep')):
        system, mc = mc_system(kind)
        args, perms, randu, extra, kw, _ = mc_inputs(system, mc, 1)
        kern = getattr(tsw, kname)

        def call():
            return kern(*args, perms, randu, *extra, **kw)
        out[kname] = dict(ms=cuda_ms(call, iters),
                          device_ms=device_ms(call, iters))
        print(f"{kname} [{kind} job plan cell_dim={kw['cell_dim']} "
              f"C={kw['C']}]: {out[kname]['ms']:.4f} ms per call, device "
              f"{out[kname]['device_ms']:.4f}", flush=True)
    import hoomd_tpu_torch
    print(json.dumps({'sweep_ms': out, 'package': os.path.dirname(
        hoomd_tpu_torch.__file__)}), flush=True)


# The profiling builds of csrc/hpmc_sweep.cu for `sweep-parts`: per sweep,
# its C entry point and the switches that leave parts out
SWEEP_PARTS = {
    'poly': ('hoomd_hpmc_poly_sweep', {
        'as built': [], 'no SAT': ['-DPOLY_SWEEP_NO_SAT'],
        'no cells': ['-DPOLY_SWEEP_NO_SAT', '-DPOLY_SWEEP_NO_CELLS']}),
    'sphere': ('hoomd_hpmc_sphere_sweep', {
        'as built': [], 'no tests': ['-DSPHERE_SWEEP_NO_TESTS'],
        'no cells': ['-DSPHERE_SWEEP_NO_TESTS', '-DSPHERE_SWEEP_NO_CELLS']}),
}


def variant_calls(source, entry, variants, mod):
    """csrc/<source> built once per variant (name -> nvcc -D switches),
    all in parallel, into the ignored build directory; returns, per
    variant, a function that runs a call with the wrapper module `mod`
    bound to that build's C entry point `entry` (a name, or a tuple of
    names)."""
    import ctypes
    from types import SimpleNamespace
    from hoomd_tpu_torch.ops import _build
    entries = (entry,) if isinstance(entry, str) else tuple(entry)
    out_dir = _build.BUILD_DIR / f'variants_{entries[0]}'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, '-o',
         str(out_dir / f'lib{i}.so'), str(_build.SRC_DIR / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i, (k, flags) in
        enumerate(variants.items())}
    for k, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{text.decode()}")
    lib = mod._kernel_lib()
    libs = {}
    for i, k in enumerate(variants):
        so = ctypes.CDLL(str(out_dir / f'lib{i}.so'))
        fns = {}
        for e in entries:
            fns[e] = getattr(so, e)
            fns[e].argtypes = _build._SIGNATURES[e]
            fns[e].restype = ctypes.c_int
        libs[k] = _build.KernelLibrary(
            SimpleNamespace(**{**vars(lib.lib), **fns}), lib.paths, 0.0, '')

    def on(k, call):
        def run():
            mod._LIB[0] = libs[k]
            try:
                return call()
            finally:
                mod._LIB[0] = lib
        return run
    return {k: (lambda call, k=k: on(k, call)) for k in variants}


def sweep_parts(kind='poly', iters=50):
    """Where a sweep call's device time goes at its job script's plan
    (config 5's cubes, or the hard spheres): csrc/hpmc_sweep.cu built as
    it is, without its overlap tests (POLY_SWEEP_NO_SAT /
    SPHERE_SWEEP_NO_TESTS: every trial accepted) and without any
    per-cell work too (POLY_SWEEP_NO_CELLS / SPHERE_SWEEP_NO_CELLS: no
    draws, trials or commits; the prologue, the barriers and the tallies
    alone), each timed through the sweep's wrapper on
    chip_smoke.py's seeded inputs (ms per call by CUDA events, device ms
    by torch.profiler)."""
    from chip_smoke import device_ms, dev_fmt, mc_inputs, mc_system
    from hoomd_tpu_torch.hpmc import sweep as tsw
    entry, variants = SWEEP_PARTS[kind]
    kname = 'fused_poly_sweep' if kind == 'poly' else 'fused_sphere_sweep'
    builds = variant_calls('hpmc_sweep.cu', entry, variants, tsw)
    system, mc = mc_system('cube' if kind == 'poly' else 'sphere')
    args, perms, randu, extra, kw, _ = mc_inputs(system, mc, 1)
    res = {}
    for k, bind in builds.items():
        call = bind(lambda: getattr(tsw, kname)(*args, perms, randu, *extra,
                                                **kw))
        res[k] = dict(ms=cuda_ms(call, iters),
                      device_ms=device_ms(call, iters))
        print(f"{kname} {k} [{kind} job plan cell_dim={kw['cell_dim']} "
              f"C={kw['C']}]: {res[k]['ms']:.4f} ms per call, device "
              f"{dev_fmt(res[k]['device_ms'])}", flush=True)
    print(json.dumps({'sweep_parts_ms': {kind: res}}), flush=True)


def profiler_probe(profiles=12, iters=10):
    """Whether torch.profiler sees a short call's kernels: for each of a
    few kernel calls (the one-type charged kernel at the Madelung plan and
    the four-type lj_ewald one at config 4's shape, where chip_smoke.py
    once read no device time; the sphere sweep), `profiles` profiles of
    `iters` calls as chip_smoke.py device_ms takes them, and the same
    with the card kept busy (torch.cuda._sleep) around the calls inside
    the profile; per profile the launches of the kernel the profiler
    listed and their device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import (charged_table, madelung_cells, mc_inputs,
                            mc_system, pppm_cells)
    from hoomd_tpu_torch.hpmc import sweep as tsw
    from hoomd_tpu_torch.ops import cell_pair as cp
    dev = torch.device('cuda', 0)
    calls = {}
    for label, (name, T, cells, rc) in {
            'charged ewald T=1 Madelung plan': ('ewald', 1, madelung_cells, 3.0),
            'charged lj_ewald T=4 config 4': ('lj_ewald', 4, pppm_cells, 2.5)
    }.items():
        carry, qc, L, N, cdim, C = (cells(dev) if T == 1 else cells(dev, T))
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pv, pn = charged_table(name, T, dev, rc)
        kw = dict(eval_name=name, pnames=pn, ntypes=T, cell_q=qc,
                  cell_typ=carry.typ if T > 1 else None, C=C,
                  cell_tag=carry.tag)
        calls[label] = ('cell_pair_q_kernel', lambda pos=carry.pos, sh=sh,
                        pv=pv, cdim=cdim, kw=kw:
                        cp.cell_pair_planar(pos, cdim, sh, pv, **kw))
    system, mc = mc_system('sphere')
    args, perms, randu, extra, kw, _ = mc_inputs(system, mc, 1)
    calls['sphere sweep'] = ('sphere_sweep_kernel', lambda: tsw.fused_sphere_sweep(
        *args, perms, randu, **kw))
    res = {}
    for label, (kname, fn) in calls.items():
        for pad in (False, True):
            seen = []
            for _ in range(profiles):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    if pad:
                        torch.cuda._sleep(200000)
                    for _ in range(iters):
                        fn()
                    if pad:
                        torch.cuda._sleep(200000)
                    torch.cuda.synchronize()
                n = t = 0
                kinds = set()
                for e in prof.key_averages():
                    if kname in e.key:
                        kinds.add(str(e.device_type))
                        if e.device_type == DeviceType.CUDA:
                            n += e.count
                            t += getattr(e, 'self_device_time_total', 0.0)
                seen.append((n, round(t / 1e3 / iters, 5), sorted(kinds)))
            res[f'{label}{" padded" if pad else ""}'] = seen
            print(f"profiler [{label}{', padded' if pad else ''}]: kernel "
                  f"launches seen per profile of {iters} calls "
                  f"{[s[0] for s in seen]}; device ms per call "
                  f"{[s[1] for s in seen]}; device types listed "
                  f"{sorted({k for s in seen for k in s[2]})}", flush=True)
    print(json.dumps({'profiler_probe': res}), flush=True)


def main(argv):
    if argv[1:2] == ['sweep-parts']:
        print('card:', card(), flush=True)
        for kind in argv[2:] or ['poly']:
            sweep_parts(kind)
        return
    if argv[1:2] == ['profiler']:
        print('card:', card(), flush=True)
        profiler_probe()
        return
    if argv[1:2] == ['jobs']:
        # jobs [TREE] [JOB ...]
        print('card:', card(), flush=True)
        args = argv[2:]
        tree = args.pop(0) if args and args[0] not in JOBS else None
        bad = [a for a in args if a not in JOBS]
        if bad:
            raise SystemExit(f"unknown jobs {bad}; the jobs are {JOBS}")
        job_times(tree, tuple(args) or ('sphere', 'cube', 'pallas'))
        return
    if argv[1:2] == ['sweeps']:
        print('card:', card(), flush=True)
        sweep_times(argv[2] if len(argv) > 2 else None)
        return
    if argv[1:2] == ['tiles']:
        # tiles [union]: every tile kernel, or those on a tile's union
        print('card:', card(), flush=True)
        if argv[2:3] == ['union']:
            res = union_tiles(torch.device('cuda', 0))
            print(json.dumps({'tile_ms': res}), flush=True)
        else:
            profile_tiles()
        return
    if argv[1:2] == ['designs']:
        print('card:', card(), flush=True)
        ordered_designs()
        return
    if argv[1:2] == ['rebin']:
        print('card:', card(), flush=True)
        rebin_tiles()
        return
    if argv[1:2] == ['ka-bits']:
        print('card:', card(), flush=True)
        ka_bits(argv[2] if len(argv) > 2 else None)
        return
    if argv[1:2] == ['pppm-mesh']:
        print('card:', card(), flush=True)
        profile_mesh()
        return
    if argv[1:2] == ['pppm']:
        profile_pppm()
        return
    if argv[1:2] == ['pppm-nve']:
        # pppm-nve [n_side [mesh [cpu]]]
        n_side = int(argv[2]) if len(argv) > 2 else 16
        mesh = int(argv[3]) if len(argv) > 3 else 32
        mode = 'cpu' if argv[4:5] == ['cpu'] else 'gpu'
        if mode == 'gpu':
            print('card:', card(), flush=True)
        pppm_nve(n_side, mesh, args=f'--mode={mode} --notice-level=0')
        return
    if argv[1:2] == ['pppm-trace']:
        # pppm-trace [seed ...]
        print('card:', card(), flush=True)
        for seed in argv[2:] or ['9']:
            pppm_trace(seed=int(seed))
        return
    if argv[1:2] == ['ka']:
        profile_ka()
        return
    if argv[1:2] == ['ka-trace']:
        print('card:', card(), flush=True)
        n_side = int(argv[2]) if len(argv) > 2 else None
        ka_trace(False, n_side)
        ka_trace(True, n_side)
        return
    if argv[1:2] == ['rebins']:
        turns = argv[2:] or ['on', 'off', 'pallas', 'pallas', 'off', 'on']
        for env in turns:
            print(f"== HOOMD_TPU_REBIN={env}", flush=True)
            os.environ['HOOMD_TPU_REBIN'] = env
            profile_job(pin_m=PIN_M)
        return
    if argv[1:2] == ['cadence']:
        profile_job(cadences=[int(m) for m in argv[2:]] or [1, 2, 4])
        return
    profile_job()


def profile_job(pin_m=None, cadences=()):
    from hoomd_tpu_torch.ops import cell_pair as cp
    from hoomd_tpu_torch.ops import cell_rebin as cr
    cp.reset_launch_counts()
    cr.reset_launch_counts()
    print('card:', card(), flush=True)
    system, N = bench_job(time.perf_counter())
    fast = system._program['fast']
    print(f"warmup done: plan {fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']} rebin={fast['rebin_impl']}, grow "
          f"{system._grow}, {system.fast_stats}", flush=True)
    if pin_m is not None:
        rearm(system, pin_m)
        print(f"re-armed: rebin {system._program['fast']['rebin_impl']}, "
              f"fast_m pinned at {pin_m}", flush=True)
    timed_windows(system, N)
    profile_steps(system)
    component_times(system)
    for m in cadences:
        rearm(system, m)
        print(f"== the cadence pinned at {m} windows per rebuild", flush=True)
        timed_windows(system, N, reps=1)
        component_times(system)
    print(f"fast_stats {system.fast_stats}", flush=True)
    print(json.dumps({'launches': {**cp.launch_counts(),
                                   **cr.launch_counts()}}), flush=True)


if __name__ == '__main__':
    main(sys.argv)
