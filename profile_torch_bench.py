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
    python3 profile_torch_bench.py ka-bits [TREE]  # the KA job's end bits

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
KA table, row 7 at the bench shape.  With ``ka-bits [TREE]`` it runs
chip_smoke.py's KA job script through the hoomd_tpu_torch of TREE (by
default this checkout) and prints T and PE/N at the end of its NVT
window exactly; chip_smoke.py's KA_PARENT_T and KA_PARENT_PE come from
it on the tree of the parent design.  It checks nothing; chip_smoke.py
is the check.
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


def profile_tiles(widths=(1, 2, 3, 4, 5, 6), dev=torch.device('cuda', 0)):
    """The typed planar kernel and the half stencil (csrc/cell_tile.cuh)
    at each tile width: rows 3t and 7t at the KA shape with the KA table,
    row 7 at the bench shape, ms per wrapper call by CUDA events; the
    width the wrappers take (cell_pair.pair_tile) marked."""
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
    print(json.dumps({'tile_ms': res}), flush=True)


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


def main(argv):
    if argv[1:2] == ['tiles']:
        print('card:', card(), flush=True)
        profile_tiles()
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
