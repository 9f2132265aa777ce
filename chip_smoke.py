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
     failing past tolerance;
  4. the bench.py job script (64k LJ, Langevin melt then Nose-Hoover NVT)
     through ``import hoomd_tpu_torch as hoomd`` on --mode=gpu, with all
     three launch counters > 0, finite output, T = 1.2 +- 0.03 and
     PE/N in [-4.80, -4.60];
  5. the kernels' JSON line, the card line, and the final
     {"ok": true, "device": {...}} line.
It exits non-zero without a CUDA device, outside a checkout, or when any
phase fails.
"""

from __future__ import annotations

import json
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
TEMP_TARGET, TEMP_TOL = 1.2, 0.03
PE_RANGE = (-4.80, -4.60)


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
    return carry, L, N


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


def kernel_phases(dev):
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    results = {}
    shapes = [('bench', (40, 40, 40), (14, 14, 12), 40),
              ('ragged', (9, 11, 14), (3, 4, 5), 37)]
    pv = torch.tensor([2.5 ** 2, 0.0, 4.0, 4.0, 2.5], dtype=torch.float32,
                      device=dev)
    r6 = 1.0 / 2.5 ** 6
    pv[1] = r6 * (4.0 * r6 - 4.0)                   # shift-mode e_shift
    for tag_name, dims, cdim, C in shapes:
        carry, L, N = lattice_cells(dims, cdim, C, 0.1, 3, dev)
        _, sh = cp.build_cell_shifts(cdim, L)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        pos, tag = carry.pos, carry.tag
        nx, ny, nz = cdim
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
        # ---- cell_megastep_planes: NVT and Langevin windows of one
        # step and of k = 4 steps, the main path's window
        plane4 = (nz, ny, nx, C)

        def planes(a):
            return a.reshape(nz, ny, nx, C, 3).permute(4, 0, 1, 2,
                                                       3).contiguous()

        def plain_force_planes(gpos):
            cells = gpos.permute(1, 2, 3, 4, 0).reshape(-1, C, 3)
            return planes(cp.cell_pair_plane_plain(cells, cdim, sh, pv,
                                                   cell_tag=tag))
        frc = cp.cell_pair_plane_plain(pos, cdim, sh, pv, cell_tag=tag)
        gp, gv, gf = planes(pos), planes(carry.vel), planes(frc)
        gm = carry.mass.reshape(plane4)
        gw = 1.0 / gm
        gt = tag.reshape(plane4)
        skin = torch.as_tensor(np.maximum(L / np.asarray(cdim) - 2.5, 0.4),
                               dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        gn = (torch.rand((4, 3) + plane4, generator=gen, device=dev) * 2
              - 1) * 8.0 * (gt >= 0)
        xi0 = torch.tensor(0.1, device=dev)
        eta0 = torch.tensor(0.0, device=dev)
        worst = (0.0, 0.0)
        for k in (1, 4):
            args = (gp, gv, gf, gw, gm, gp, cdim, sh, pv, 0.005,
                    torch.full((k,), 1.2, device=dev), xi0, eta0, skin)
            for method in ('nvt', 'langevin'):
                kw = dict(C=C, k=k, method=method, gt=gt, ndof=3.0 * N,
                          tau_inv2=4.0, gamma=GAMMA,
                          gn=gn[:k] if method == 'langevin' else None)

                def k_mega():
                    return cp.cell_megastep_planes(*args, recip='approx',
                                                   **kw)

                def p_mega():
                    return cp.cell_megastep_planes_plain(*args, **kw)
                got, want = k_mega(), p_mega()
                name = f'cell_megastep_planes[{tag_name},{method},k={k}]'
                if bool(got[5]) != bool(want[5]):
                    raise RuntimeError(f"{name}: danger flags differ")
                # the stencil part of the last step's force: Langevin
                # adds the noise and the drag on the half-kicked velocity
                f_stencil = got[2]
                if method == 'langevin':
                    v_half = got[1] - 0.5 * 0.005 * got[2] * gw
                    f_stencil = got[2] - gn[k - 1] + GAMMA * v_half
                ea, er = compare(name, [
                    ('pos', got[0], want[0], 0.0, POS_TOL),
                    ('frc at its own positions', f_stencil,
                     plain_force_planes(got[0]), RTOL, ATOL)] + [
                    (lab, got[i], want[i], RTOL, ATOL) for i, lab in
                    ((1, 'vel'), (3, 'xi'), (4, 'eta'), (6, 'ke2'),
                     (7, 'mdmax'))])
                worst = (max(worst[0], ea), max(worst[1], er))
                if method == 'nvt' and k == 4:
                    t_k = cuda_ms(k_mega, max(iters // 5, 2))
                    t_p = cuda_ms(p_mega, 1)
        row['cell_megastep_planes'] = dict(max_abs_err=worst[0],
                                           bound_share=worst[1], ms=t_k,
                                           plain_ms=t_p)
        for kname, r in row.items():
            print(f"phase {kname} [{tag_name} cell_dim={cdim} C={C} N={N}]: "
                  f"max_abs_err={r['max_abs_err']:.3e} "
                  f"bound_share={r['bound_share']:.3f} "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}",
                  flush=True)
        results[tag_name] = row
    return results['bench']


def bench_job(t_start):
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
    system.run(500, quiet=True)
    fast = system._program['fast']
    print(f"plan: cell_dim={fast['cell_dim']} C={fast['C']} "
          f"k={fast['k_rebuild']}", flush=True)
    # the same cadence-controller warmup as bench.py, cut short if this
    # smoke run nears its time budget
    last_m, stable = -1, 0
    for i in range(16):
        if time.perf_counter() - t_start > 600:
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
    return system, N


def bench_script(card):
    """bench.py's job script through hoomd_tpu_torch: the warmup, one
    timed window, and the checks of its output."""
    import torch
    from hoomd_tpu_torch.ops import cell_pair as cp
    cp.reset_launch_counts()
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
    counts = cp.launch_counts()
    print(json.dumps({
        "metric": "lj_melt_64k_nvt_particle_steps_per_sec",
        "value": pss, "unit": "particle-steps/s/chip",
        "extra": {"N": N, "steps": steps, "elapsed_s": elapsed,
                  "temperature": q['temperature'],
                  "pe_per_particle": q['potential_energy'] / N,
                  "fast_m": int(system._grow.get('fast_m', 1)),
                  "card": card, "package": "torch"}}), flush=True)
    snapf = system.take_snapshot()
    if not (np.isfinite(snapf.particles.position).all()
            and np.isfinite(snapf.particles.velocity).all()
            and np.isfinite(q['potential_energy'])):
        raise RuntimeError("non-finite state after the bench script")
    for name, c in counts.items():
        if c <= 0:
            raise RuntimeError(f"main path never launched {name}")
    if abs(q['temperature'] - TEMP_TARGET) > TEMP_TOL:
        raise RuntimeError(f"T = {q['temperature']:.4f} outside "
                           f"{TEMP_TARGET} +- {TEMP_TOL}")
    pe = q['potential_energy'] / N
    if not PE_RANGE[0] <= pe <= PE_RANGE[1]:
        raise RuntimeError(f"PE/N = {pe:.4f} outside {PE_RANGE}")
    print(f"main path: T={q['temperature']:.5f} PE/N={pe:.5f} "
          f"launches={counts}", flush=True)
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
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}", flush=True)
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    bench = kernel_phases(dev)
    counts = bench_script(card)
    replaces = {
        'cell_pair_plane': 'hoomd_tpu/ops/pallas_pair.py:1173',
        'cell_pair_planar': 'hoomd_tpu/ops/pallas_pair.py:609',
        'cell_megastep_planes': 'hoomd_tpu/ops/pallas_pair.py:1978',
    }
    kernels = [{"name": name, "route": "cuda",
                "source": "hoomd_tpu_torch/csrc/cell_pair.cu",
                "replaces": replaces[name], "launches": counts[name],
                "max_abs_err": bench[name]['max_abs_err'],
                "ms": bench[name]['ms'], "plain_ms": bench[name]['plain_ms']}
               for name in ('cell_megastep_planes', 'cell_pair_plane',
                            'cell_pair_planar')]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
