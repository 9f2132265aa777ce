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
through the JAX package on the CPU).  It checks nothing; chip_smoke.py
is the check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def main(argv):
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
