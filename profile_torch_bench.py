#!/usr/bin/env python3
"""Where the time goes in the 64k LJ NVT job of hoomd_tpu_torch on one
NVIDIA GPU.

    python3 profile_torch_bench.py

from the root of the repository.  It runs chip_smoke.py's bench job
(bench.py's script: Langevin melt, Nose-Hoover NVT, cadence warmup) and
then prints:
  1. the card (nvidia-smi name, power limit, SM clock);
  2. two timed 3000-step windows: particle-steps/s, ms per step, and the
     rebuilds and windows per rebuild (fast_m) in each;
  3. a torch.profiler trace of 1024 steps: wall time, the summed device
     time of all kernels, their ratio (the device's busy share; the
     profiler inflates host time), and the device time per kernel;
  4. CUDA-event times at the steady state of one k-step kernel window,
     eight windows, one rebuild (sort rebin) and one single step;
  5. the launch counts of the three stencil kernels.
It checks nothing; chip_smoke.py is the check.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from chip_smoke import bench_job, cuda_ms


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def timed_windows(system, N, steps=3000, reps=2):
    for _ in range(reps):
        torch.cuda.synchronize()
        nr0 = system._fast_carry.n_rebuilds
        t0 = time.perf_counter()
        system.run(steps, quiet=True)
        el = time.perf_counter() - t0
        nr = system._fast_carry.n_rebuilds - nr0
        print(f"timed {steps}: {el:.4f} s = {steps * N / el:.6g} "
              f"particle-steps/s, {el / steps * 1e3:.4f} ms/step, "
              f"rebuilds {nr}, fast_m {system._grow.get('fast_m')}",
              flush=True)


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
    fast = system._program['fast']
    carry, dyn, run = system._fast_carry, system._dyn['fast'], \
        fast['run_chunk']
    k = fast['k_rebuild']
    t_win = cuda_ms(lambda: run.wins(carry, dyn, 1, k), 50)
    t_win8 = cuda_ms(lambda: run.wins(carry, dyn, 8, k), 10)
    t_reb = cuda_ms(lambda: run.rebuild(carry), 50)
    t_step = cuda_ms(lambda: run.steps(carry, dyn, 1), 20)
    print(f"one window (k={k}): {t_win:.4f} ms; 8 windows {t_win8:.4f} ms; "
          f"rebuild {t_reb:.4f} ms; one step {t_step:.4f} ms", flush=True)


def main():
    from hoomd_tpu_torch.ops import cell_pair as cp
    print('card:', card(), flush=True)
    system, N = bench_job(time.perf_counter())
    fast = system._program['fast']
    print(f"warmup done: plan {fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']}, grow {system._grow}", flush=True)
    timed_windows(system, N)
    profile_steps(system)
    component_times(system)
    print(json.dumps({'launches': cp.launch_counts()}), flush=True)


if __name__ == '__main__':
    main()
