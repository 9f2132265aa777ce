"""System orchestration: the run loop (counterpart of hoomd_tpu/system.py).

The port runs two engines: the cell-major pair engine of ops/fast_lj.py
for MD (one to four particle types, one of the ten stencil evaluators of
ops/pair_eval.py), and the fused checkerboard sweep of hpmc/ for
hard-particle MC
(an HPMC integrator replaces the MD pipeline, as in the JAX package).  A
configuration outside them raises NotImplementedError naming the first
gate it failed; there is no general engine to fall back to yet.

An HPMC run is one chunk: its sweeps queue on the device, and ONE
device->host read of the cell-overflow flag ends it.  On overflow the
capacity grows to int(1.5 C) + 4 and the chunk reruns from its start,
at most 8 times (hoomd_tpu/system.py:1818-1847).

Between runs the authoritative particle data lives in the engine's carry;
``state`` is materialized lazily when a host op reads it.  A chunk runs
in segments, each followed by ONE packed device->host fetch of the
control flags:
  * capacity overflow  -> conservative replan, then larger C; retry;
  * danger (a pair may have been missed) -> shorter rebuild cadence, or
    a smaller kernel window k; retry from the segment's start;
  * rebin overflow (an xsel or migration rebuild failed) -> for xsel a
    strike: the sort rebuild, and xsel again after 8 clean segments, at
    most 3 times; for the migration rebin the emigrant buffers widen from
    E = 8 to 16, then the sort; retry;
  * clean -> accept, and double the window count per rebuild cycle
    (fast_m) up to 64, fast-tracked by the measured drift; after 16
    clean segments forgive the probe and xsel strikes (the amnesty), and
    grow a kernel window k < 4 to 4 once fast_m >= 4 shows the headroom
    (a danger at one window per cycle reverts that growth for good).

Left out of the JAX package's protocol: the lifetime cap on xsel
re-enables and the memo of built programs (hoomd_tpu/system.py:1349-1355,
747-783), both there to bound Mosaic recompiles, which the port does not
have.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .state import snapshot_from_state, state_from_snapshot


class System:
    """Holds the device state and the registered operations, and runs
    them on the cell-major engine."""

    def __init__(self, snapshot, device='cpu'):
        self.device = torch.device(device)
        self.snapshot_template = snapshot
        self._fast_carry = None
        self._fast_state_stale = False
        self.state = state_from_snapshot(snapshot, self.device)
        self.particle_types = list(snapshot.particles.types)
        self.forces = []
        self.nlists = []
        self.methods = []
        self.integrator_mode = None
        self._program = None
        self._dirty_flag = True
        self._params_dirty = True
        self._dyn = None
        self._method_aux_by_obj = {}
        self._grow = {}
        self._forces_fresh = False
        self.hpmc_integrator = None
        self._hpmc_counters = None
        # host counters of the MD run loop: segments run, their retries
        # (of which for a failed rebin, and of those the ones in which an
        # xsel rebuild lost a particle), and the rebuilds of accepted ones
        self.fast_stats = dict(segments=0, retries=0, rebin_retries=0,
                               rebin_lost=0, rebuilds=0)

    # -- state residency -----------------------------------------------------
    @property
    def state(self):
        if self._fast_state_stale:
            self._sync_fast_state()
        return self._state_raw

    @state.setter
    def state(self, value):
        self._state_raw = value
        self._fast_carry = None
        self._fast_state_stale = False

    def _sync_fast_state(self):
        self._fast_state_stale = False
        fast = self._program['fast']
        # the hot loop computes forces only; fill pe/virial first
        self._fast_carry = fast['refresh'](self._fast_carry,
                                           self._dyn['fast'])
        self._state_raw = fast['to_state'](self._fast_carry,
                                           self._state_raw)
        self._method_aux_by_obj[fast['method']] = self._fast_carry.aux
        self._forces_fresh = True

    # -- registration ------------------------------------------------------
    def add_force(self, f):
        self.forces.append(f)
        self._dirty()

    def add_nlist(self, nl):
        self.nlists.append(nl)
        self._dirty()

    def add_integration_method(self, m):
        self.methods.append(m)
        self._dirty()

    def set_integrator_mode(self, mode):
        self.integrator_mode = mode
        self._dirty()

    def set_hpmc_integrator(self, mc):
        """An HPMC integrator replaces the MD pipeline entirely."""
        self.hpmc_integrator = mc
        self._dirty()

    def _dirty(self):
        self._dirty_flag = True
        self._params_dirty = True
        self._forces_fresh = False

    def _refresh_params(self):
        self._params_dirty = True

    @property
    def timestep(self):
        if self._fast_state_stale:
            return self._fast_carry.timestep
        return self._state_raw.timestep

    # -- program construction ------------------------------------------------
    def _active(self):
        forces = [f for f in self.forces if f.enabled]
        methods = [m for m in self.methods if m.enabled]
        return forces, methods

    def _rebuild_program(self):
        # a new plan may change the layout: materialize the carry first
        if self._fast_state_stale:
            self._sync_fast_state()
        self._fast_carry = None
        if self.hpmc_integrator is not None:
            self._program = self.hpmc_integrator._build_program(self)
            self._program['kind'] = 'hpmc'
            self._hpmc_counters = self._program['init_counters']()
            self._dyn = {}
            self._dirty_flag = False
            self._params_dirty = False
            self._forces_fresh = True       # no forces in pure HPMC
            return
        forces, methods = self._active()
        fast = self._build_fast(forces, methods)
        self._program = {'kind': 'md', 'fast': fast, 'forces': forces,
                         'methods': methods}
        for m in methods:
            if m not in self._method_aux_by_obj:
                self._method_aux_by_obj[m] = m._init_aux(self.device)
        self._dirty_flag = False
        self._params_dirty = True

    def _build_fast(self, forces, methods):
        """Gates + construction of the cell-major pair engine."""
        from .ops import pair_eval
        from .ops.cell_pair import MAX_C, MAX_TYPES
        from .ops.fast_lj import build_fast_lj_chunk, plan_fast_lj

        def _decline(why):
            raise NotImplementedError(
                f"hoomd_tpu_torch runs the cell-major LJ engine only, and "
                f"this configuration is outside it: {why}")
        if len(forces) != 1:
            _decline(f'{len(forces)} pair forces (need exactly 1)')
        if len(methods) != 1:
            _decline(f'{len(methods)} integration methods (need 1)')
        if self.integrator_mode is None:
            _decline('no integration mode (md.integrate.mode_standard)')
        if self.integrator_mode.aniso:
            _decline('anisotropic integration')
        ntypes = len(self.particle_types)
        if ntypes > MAX_TYPES:
            # (hoomd_tpu/system.py:463; the JAX package leaves for its
            # general engine)
            _decline(f'{ntypes} particle types (at most {MAX_TYPES})')
        snap = self.snapshot_template
        for name in ('bonds', 'angles', 'dihedrals', 'impropers',
                     'constraints', 'pairs'):
            if getattr(snap, name).N:
                _decline(f'bonded topology ({name})')
        if np.any(np.asarray(snap.particles.charge) != 0):
            _decline('particle charges')
        f = forces[0]
        # any charge/diameter-free evaluator rides the stencil kernels
        # (hoomd_tpu/system.py FAST_EVALS)
        eval_name = getattr(getattr(f, '_evaluator', None), '__name__', None)
        if eval_name not in pair_eval.FAST_EVALS:
            _decline(f'pair evaluator {eval_name!r} not stencil-eligible '
                     f'(need one of {", ".join(pair_eval.FAST_EVALS)})')
        if f.mode not in ('none', 'shift'):
            _decline(f'pair shift mode {f.mode!r} (need none/shift)')
        nl = f._nlist
        if nl is None:
            _decline('no neighbor list attached')
        if (np.asarray(snap.particles.body) >= 0).any():
            _decline('rigid/floppy body particles')
        if np.any(np.asarray(snap.particles.moment_inertia) > 0):
            _decline('rotational degrees of freedom (moment_inertia)')
        m = methods[0]
        kind = type(m).__name__
        if kind not in ('nve', 'langevin', 'nvt'):
            _decline(f'integration method {kind!r}')
        if kind == 'nve' and (m.limit is not None or m.zero_force):
            _decline('nve limit/zero_force options')
        if kind == 'langevin' and (m.dscale or m.noiseless_t):
            _decline('langevin dscale/noiseless options')
        if len(m.group.member_tags) != self.state.N:
            _decline('method group is not group.all()')
        box = self._state_raw.box
        L_np, tilt_np, _ = box.to_numpy()
        if box.dimensions != 3 or np.abs(tilt_np).max() > 1e-12:
            _decline('non-orthorhombic or 2D box')
        N = self._state_raw.N
        rcut = float(np.max(f._rcut_matrix(self.particle_types)))
        r_buff = nl.r_buff
        L = np.asarray(L_np, np.float64)
        # small systems plan conservatively from the start, as the JAX
        # package does; the planner sizes C from the real occupancy too
        conservative = bool(self._grow.get('fast_plan_conservative')) \
            or N < 4096
        pos_h = self._state_raw.pos.cpu().numpy()
        frac = (pos_h / L_np + 0.5) % 1.0
        cell_dim, ncells, C = plan_fast_lj(N, L, rcut, r_buff,
                                           conservative=conservative,
                                           frac=frac)
        if min(L / np.array(cell_dim)) < rcut + r_buff - 1e-9:
            _decline('box too small for the 27-cell stencil')
        C = max(C, self._grow.get('fast_C', 0))
        if C > MAX_C:
            _decline(f'cell capacity {C} above the kernels\' {MAX_C}')
        # rebuild window k: steps for the fastest particle to cross half
        # the skin, capped at 4; the danger retry makes any estimate safe
        skin = max(float(min(L / np.asarray(cell_dim)) - rcut), r_buff)
        vmax = float(torch.linalg.norm(self._state_raw.vel, dim=-1).max())
        dt = float(self.integrator_mode.dt or 0.005)
        k_dt = getattr(self, '_fast_k_dt', dt)
        if abs(dt - k_dt) > 0.25 * max(k_dt, 1e-12):
            self._reset_cadence()
        k_est = int(0.55 * (0.5 * skin) / max(vmax * dt, 1e-12))
        k_rebuild = next(q for q in (4, 3, 2, 1) if q <= max(k_est, 1))
        if self._grow.get('fast_k_grown'):
            # the measured drift cleared 4x the planned cadence
            # (_grow_cadence): the ballistic estimate was conservative
            k_rebuild = 4
        cap = self._grow.get('fast_k_cap')
        if cap:
            k_rebuild = min(k_rebuild, cap)
        self._fast_k_dt = dt
        # the force path (hoomd_tpu/system.py:614-641): unset means 'plane',
        # the JAX package's default on its accelerator; a value that is
        # not a path raises in build_fast_lj_chunk rather than running the
        # XLA formulation as the JAX package does.  Its switch to 'xla'
        # when 3C > 128 is a limit of the TPU's lane tile and is not
        # copied: the kernels here take C up to MAX_C (at the bench plan
        # C = 40, 3C = 120, so no path differs).  The megastep runs only
        # with 'plane' and HOOMD_TPU_MEGA unset or not 'off'
        # (hoomd_tpu/ops/fast_lj.py:704-707).  HOOMD_TPU_FUSED=on runs
        # single steps as fused steps on 'plane' with nve or nvt
        # (fast_lj.py:692-695); with the megastep on, only the head and
        # tail steps of a run.
        impl = os.environ.get('HOOMD_TPU_FAST_IMPL') or 'plane'
        mega = os.environ.get('HOOMD_TPU_MEGA', 'on') != 'off'
        fused = os.environ.get('HOOMD_TPU_FUSED') == 'on'
        # the LJ-only kernels host no other evaluator and no mixture; the
        # JAX package leaves its fast engine there (hoomd_tpu/system.py:
        # 614-617, 634-635)
        if eval_name != 'lj' and impl in ('pallas', 'pallas3d', 'row'):
            _decline(f'HOOMD_TPU_FAST_IMPL={impl} runs the lj evaluator only '
                     f'(pair evaluator {eval_name!r})')
        if ntypes > 1 and impl in ('pallas', 'pallas3d', 'row'):
            _decline(f'HOOMD_TPU_FAST_IMPL={impl} runs one particle type '
                     f'only ({ntypes} particle types)')
        # rebuild implementation, by the JAX package's gates
        # (hoomd_tpu/system.py:702-726): below 4096 particles the sort
        # costs next to nothing; the int payload rides the migration and
        # xsel rebins as float32 values, exact below 2^24; only the planar
        # family of force paths takes them, and one type only (they move no
        # type column).  HOOMD_TPU_REBIN=off keeps the sort, =pallas takes
        # the migration sweep and place, and anything else the staged
        # select (xsel)
        rebin_impl = 'sort'
        env_rebin = os.environ.get('HOOMD_TPU_REBIN', 'on')
        if (ntypes == 1 and (1 << 12) <= N < (1 << 23) and min(cell_dim) >= 3
                and impl in ('plane', 'planar', 'planar_n3l')
                and not self._grow.get('fast_rebin_sort')
                and env_rebin != 'off'):
            rebin_impl = 'pallas' if env_rebin == 'pallas' else 'xsel'
        # emigrant slots per cell face of the migration rebin: 8, widened
        # to 16 by the rebin-overflow retry
        rebin_E = int(self._grow.get('fast_rebin_E', 8))
        # the kernels' parameter order: the derived tables sorted, then
        # rcut, as _fast_dyn packs them
        pnames = pair_eval.kernel_pnames(eval_name)
        to_fast, refresh, run_chunk, to_state = build_fast_lj_chunk(
            N=N, box=box, cell_dim=tuple(cell_dim), C=C, r_buff=r_buff,
            rcut=rcut, method_kind=kind, method_seed=getattr(m, 'seed', 0),
            k_rebuild=k_rebuild, rebin_impl=rebin_impl, rebin_E=rebin_E,
            impl=impl, mega=mega, fused=fused, eval_name=eval_name,
            pnames=pnames, ntypes=ntypes, device=self.device)
        return {'to_fast': to_fast, 'refresh': refresh,
                'run_chunk': run_chunk, 'to_state': to_state,
                'C': C, 'cell_dim': tuple(cell_dim), 'method': m,
                'kind': kind, 'rcut': rcut, 'k_rebuild': k_rebuild,
                'skin': skin, 'rebin_impl': rebin_impl, 'rebin_E': rebin_E,
                'impl': impl, 'mega': run_chunk.mega,
                'fused': run_chunk.fused, 'eval_name': eval_name,
                'pnames': pnames, 'ntypes': ntypes, 'pair_force': f}

    def _reset_cadence(self):
        for key in ('fast_m', 'fast_m_ceil', 'fast_m_pinned', 'fast_k_cap',
                    'fast_m_probe_fails', 'fast_k_grown', 'fast_k_grow_block',
                    'fast_clean_segs'):
            self._grow.pop(key, None)

    def _pack_dyn(self):
        p = self._program
        dt_val = self.integrator_mode.dt if self.integrator_mode else 0.0
        self._dyn = {
            'dt': float(dt_val),
            'forces': tuple(f._pack_params(self) for f in p['forces']),
            'methods': tuple(m._pack_params(self) for m in p['methods']),
        }
        self._dyn['fast'] = self._fast_dyn()
        self._params_dirty = False

    def _fast_dyn(self):
        fast = self._program['fast']
        f = fast['pair_force']
        fp = self._dyn['forces'][self._program['forces'].index(f)]
        dev = self.device

        def T(x):
            return torch.as_tensor(np.float32(x), device=dev)
        if fast['ntypes'] == 1:
            rc = T(fp['rcut'][0, 0])
            scal = {k: T(v[0, 0]) for k, v in fp['tables'].items()}
        else:
            # a mixture: (T, T) tables, each pair's own r_cut and shift
            # (hoomd_tpu/system.py:1112-1122)
            rc = T(fp['rcut'])
            scal = {k: T(v) for k, v in fp['tables'].items()}
        rc2 = rc * rc
        scal['rcut'] = rc
        if f.mode == 'shift':
            _, e_shift = f._evaluator.energy_force(rc2, scal)
        else:
            e_shift = torch.zeros_like(rc2)
        # (2 + NP,) for one type, (2 + NP, T, T) for a mixture
        pv = torch.stack([rc2, e_shift] + [scal[k] for k in fast['pnames']])
        mp = self._dyn['methods'][0]
        out = {'pv': pv, 'dt': self._dyn['dt']}
        if fast['eval_name'] == 'lj' and fast['ntypes'] == 1:
            # the LJ-only kernels' parameter order
            out['lj'] = torch.stack([scal['lj1'], scal['lj2'], rc2, e_shift])
        if fast['kind'] in ('langevin', 'nvt'):
            out['kT'] = mp['kT']
        else:
            out['kT'] = (torch.zeros((1,), device=dev),
                         torch.ones((1,), device=dev))
        out['tau'] = float(mp.get('tau', 1.0))
        gam = mp.get('gamma')
        out['gamma'] = float(np.float32(gam[0])) if gam is not None else 1.0
        # every type's friction, which a mixture's one_step reads per slot
        out['gamma_t'] = (T(gam) if gam is not None
                          else torch.ones(fast['ntypes'], device=dev))
        return out

    def _ensure_ready(self):
        if self._program is None or self._dirty_flag:
            self._rebuild_program()
        if self._program['kind'] == 'md' and (self._params_dirty
                                              or self._dyn is None):
            self._pack_dyn()

    # -- the engine's retry protocol -------------------------------------------
    def _grow_capacity(self):
        """A cell held more than C: replan with the conservative margin
        first, then grow C."""
        if not self._grow.get('fast_plan_conservative'):
            self._grow['fast_plan_conservative'] = True
        else:
            self._grow['fast_C'] = int(self._program['fast']['C'] * 1.5) + 8

    def _fresh_carry(self):
        fast = self._program['fast']
        m = fast['method']
        aux = self._method_aux_by_obj.get(m) or m._init_aux(self.device)
        carry = fast['to_fast'](self._state_raw, dict(aux))
        return fast['refresh'](carry, self._dyn['fast'])

    def _run_fast_chunk(self, chunk):
        """Run ``chunk`` steps in segments with the retry protocol."""
        dt_now = float(self.integrator_mode.dt or 0.005)
        k_dt = getattr(self, '_fast_k_dt', dt_now)
        if abs(dt_now - k_dt) > 0.25 * max(k_dt, 1e-12):
            # the kernel window was sized for another dt: replan
            self._reset_cadence()
            self._rebuild_program()
            self._pack_dyn()
        done = 0
        seg_cap = getattr(self, '_fast_seg_cap', 512)
        while done < chunk:
            seg = min(seg_cap, chunk - done)
            for _attempt in range(6):
                m_now = max(int(self._grow.get('fast_m', 1)), 1)
                fast = self._program['fast']
                carry0 = self._fast_carry
                if carry0 is None:
                    carry0 = self._fresh_carry()
                carry = fast['run_chunk'](carry0, self._dyn['fast'], seg,
                                          m_now)
                # ONE packed device->host fetch for all control flags
                fl = torch.stack([carry.overflow.float(),
                                  carry.danger.float(),
                                  carry.rebin_ovf.float(),
                                  carry.rebin_lost.float(),
                                  carry.wmax.float()]).cpu().numpy()
                ovf, dng = bool(fl[0] > 0.5), bool(fl[1] > 0.5)
                lost = bool(fl[3] > 0.5)
                rbo = bool(fl[2] > 0.5) or lost
                self.fast_stats['segments'] += 1
                if not (ovf or dng or rbo):
                    self.fast_stats['rebuilds'] += (carry.n_rebuilds
                                                    - carry0.n_rebuilds)
                    self._fast_carry = carry
                    self._fast_state_stale = True
                    seg_cap = min(seg_cap * 2, 8192)
                    self._fast_seg_cap = seg_cap
                    self._grow_cadence(carry, seg, fast['k_rebuild'], m_now,
                                       float(fl[4]))
                    seg_cap = self._fast_seg_cap
                    break
                self.fast_stats['retries'] += 1
                self.fast_stats['rebin_retries'] += int(rbo)
                self.fast_stats['rebin_lost'] += int(lost)
                # restore the segment's start, adjust, retry
                seg_cap = 512
                self._fast_seg_cap = seg_cap
                seg = min(seg, seg_cap)
                if not bool(carry0.overflow):
                    self._state_raw = fast['to_state'](carry0,
                                                       self._state_raw)
                # the thermostat state rewinds with the particles (the
                # JAX package keeps the aux of the last state sync here)
                self._method_aux_by_obj[fast['method']] = carry0.aux
                self._fast_carry = None
                self._fast_state_stale = False
                need_rebuild = False
                if ovf:
                    self._grow_capacity()
                    need_rebuild = True
                if rbo and not ovf:
                    # (with a capacity overflow the rebin overflow is a
                    # symptom of the same event: the replan covers it, and
                    # no xsel strike is burnt)
                    self._rebin_fallback(fast)
                    need_rebuild = True
                if dng:
                    if m_now > 1:
                        # back off one window when the edge was barely
                        # crossed, proportionally when far past it
                        wm = max(float(fl[4]), 1.0)
                        m_tgt = (max(int(m_now * 0.8 / math.sqrt(wm)), 1)
                                 if math.isfinite(wm) else 1)
                        m_tgt = max(min(m_tgt, m_now - 1), 1)
                        if self._grow.get('fast_m_pinned'):
                            self._grow['fast_m_probe_fails'] = \
                                self._grow.get('fast_m_probe_fails', 0) + 1
                        self._grow['fast_m'] = m_tgt
                        self._grow['fast_m_ceil'] = m_tgt
                        self._grow['fast_m_pinned'] = True
                        self._grow['fast_clean_segs'] = 0
                    elif self._grow.get('fast_k_grown'):
                        # undo the kernel window's growth first, for good
                        self._grow.pop('fast_k_grown')
                        self._grow['fast_k_grow_block'] = True
                        self._grow['fast_clean_segs'] = 0
                        need_rebuild = True
                    else:
                        k_now = fast['k_rebuild']
                        self._grow['fast_k_cap'] = next(
                            (q for q in (8, 6, 4, 3, 2, 1) if q < k_now), 1)
                        need_rebuild = True
                if need_rebuild:
                    self._rebuild_program()
                    self._pack_dyn()
            else:
                raise RuntimeError(
                    "fast LJ engine: capacity overflow or dangerous "
                    "rebuild persists after repeated adjustment — this "
                    "usually means the dynamics diverged (NaN "
                    "positions); check dt and the initial configuration")
            done += seg

    def _rebin_fallback(self, fast):
        """A rebuild of the xsel or migration rebin failed.  xsel: a
        strike, the sort rebuild, and xsel again after 8 clean segments
        for the first 3 strikes.  Migration: E 8 -> 16, then the sort."""
        if fast['rebin_impl'] == 'xsel':
            fails = self._grow.get('fast_xsel_fails', 0) + 1
            self._grow['fast_xsel_fails'] = fails
            self._grow['fast_rebin_sort'] = True
            self._grow.pop('fast_xsel_retry', None)
            if fails <= 3:
                self._grow['fast_xsel_retry'] = 8
        elif fast['rebin_E'] < 16:
            self._grow['fast_rebin_E'] = 16
        else:
            self._grow['fast_rebin_sort'] = True

    def _xsel_reenable(self):
        """After a clean segment: count down an xsel strike's sort
        fallback, and at its end rebuild the program with xsel."""
        xr = self._grow.get('fast_xsel_retry')
        if not xr:
            return
        if xr > 1:
            self._grow['fast_xsel_retry'] = xr - 1
            return
        self._grow.pop('fast_xsel_retry', None)
        self._grow.pop('fast_rebin_sort', None)
        self._rebuild_program()
        self._pack_dyn()

    def _grow_cadence(self, carry, seg, k_now, m_now, wmax):
        """After a clean segment of the program with kernel window k_now,
        in the JAX package's order (hoomd_tpu/system.py:1284-1419):
          * after 16 clean segments, forgive the probe and xsel strikes
            (the amnesty: strikes earned in a melt must not bind at
            steady state; the pin itself stays);
          * count down an xsel strike's sort fallback;
          * re-probe a ceiling that danger pinned after 4 clean segments
            at it: one window higher (twice as high if not pinned), until
            two probes of the same edge have failed;
          * double fast_m (the windows per rebuild cycle) up to its
            ceiling, or further when the measured drift ratio wmax says a
            longer cadence is safe;
          * grow a kernel window k < 4 to 4 once fast_m >= 4 ran clean,
            unless danger capped k or reverted such a growth before."""
        cadence = k_now * m_now
        ceil_m = int(self._grow.get('fast_m_ceil', 64))
        clean = self._grow.get('fast_clean_segs', 0) + 1
        self._grow['fast_clean_segs'] = clean
        if clean == 16 and (self._grow.get('fast_m_probe_fails')
                            or self._grow.get('fast_xsel_fails')):
            self._grow.pop('fast_m_probe_fails', None)
            self._grow.pop('fast_xsel_fails', None)
            self._grow['fast_clean_segs'] = 0
        self._xsel_reenable()
        if (ceil_m < 64 and m_now >= ceil_m and clean >= 4
                and self._grow.get('fast_m_probe_fails', 0) < 2):
            ceil_m = (ceil_m + 1 if self._grow.get('fast_m_pinned')
                      else min(ceil_m * 2, 64))
            self._grow['fast_m_ceil'] = ceil_m
            self._grow['fast_clean_segs'] = 0
            self._fast_seg_cap = 512      # a failed probe redoes little
        m_next = m_now
        if seg >= 2 * cadence and m_now < ceil_m:
            m_next = m_now * 2
            if wmax > 0.0:
                cad_max = cadence * 0.7 / max(math.sqrt(wmax), 1e-9)
                m_next = max(m_next, int(cad_max // k_now))
            m_next = min(m_next, ceil_m, max(seg // (2 * k_now), 1))
            if m_next > m_now:
                self._grow['fast_m'] = m_next
                # (a program rebuilt by the xsel re-enable starts from the
                # state, with wmax 0, and may have planned another layout)
                if self._fast_carry is not None:
                    self._fast_carry = carry.replace(wmax=torch.zeros_like(
                        carry.wmax))
        if (k_now < 4 and m_now >= 4 and 'fast_k_cap' not in self._grow
                and not self._grow.get('fast_k_grow_block')
                and not self._grow.get('fast_k_grown')):
            self._grow['fast_k_grown'] = True
            self._grow['fast_m'] = max(k_now * max(m_next, m_now) // 4, 1)
            self._rebuild_program()
            self._pack_dyn()

    def _prep_forces(self):
        """Forces, PE and virial at the current positions."""
        self._ensure_ready()
        for _ in range(6):
            carry = self._fresh_carry()
            if not bool(carry.overflow):
                break
            self._grow_capacity()
            self._rebuild_program()
            self._pack_dyn()
        else:
            raise RuntimeError("cell capacity still overflowing after "
                               "repeated growth")
        self._state_raw = self._program['fast']['to_state'](
            carry, self._state_raw)
        self._forces_fresh = True

    def _run_hpmc(self, nsweeps):
        """Run ``nsweeps`` sweeps as one chunk with the grow-and-retry
        protocol; the counters before the chunk survive a retry."""
        state0 = self._state_raw
        moves0 = self._hpmc_counters['moves']
        for _ in range(8):
            prog = self._program
            state, moves = state0, moves0
            mp = prog['pack']()
            ovf = torch.zeros((), dtype=torch.bool, device=self.device)
            for _s in range(nsweeps):
                state, moves, o = prog['sweep'](state, moves, mp)
                ovf = ovf | o
            if not bool(ovf):
                break
            self._grow['hpmc_cell_cap'] = int(prog['C'] * 1.5) + 4
            self._rebuild_program()
        else:
            raise RuntimeError("hpmc cell capacity still overflowing after "
                               "growth")
        self.state = state
        self._hpmc_counters = {'moves': moves, 'cell_overflow': ovf}

    # -- run loop ---------------------------------------------------------------
    def run(self, nsteps, quiet=False):
        """Advance the simulation by nsteps."""
        nsteps = int(nsteps)
        self._ensure_ready()
        start = self.timestep
        t0 = time.perf_counter()
        if not quiet:
            print(f"** starting run at step {start} **")
        if nsteps > 0 and self._program['kind'] == 'hpmc':
            self._run_hpmc(nsteps)
        elif nsteps > 0:
            self._run_fast_chunk(nsteps)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        done = self.timestep - start
        if not quiet:
            tps = done / elapsed if elapsed > 0 else 0.0
            print(f"** run complete: {done} steps in {elapsed:.3f} s = "
                  f"{tps:.1f} TPS **")

    # -- observables -------------------------------------------------------------
    def take_snapshot(self):
        return snapshot_from_state(self.state, self.snapshot_template)

    def restore_snapshot(self, snap):
        self.state = state_from_snapshot(snap, self.device)
        self.snapshot_template = snap
        self.particle_types = list(snap.particles.types)
        self._dirty()

    def thermo_quantities(self):
        """Kinetic/potential energy, temperature and pressure (with its
        tensor) of all particles, summed in float64."""
        st = self.state          # materializes a resident carry first
        if not self._forces_fresh and self.forces:
            self._prep_forces()
            st = self.state
        n = st.N
        dim = st.box.dimensions
        m = st.mass.double()
        v = st.vel.double()
        ke = 0.5 * float((m * (v * v).sum(-1)).sum())
        pe = float(st.net_pe.double().sum())
        ndof = dim * n
        T = 2.0 * ke / ndof if ndof else 0.0
        vol = float(st.box.volume())
        w_sum = st.net_virial.double().sum(0).cpu().numpy()
        P = (2.0 * ke + w_sum[0] + w_sum[3] + w_sum[5]) / (dim * vol)
        mom = (m[:, None] * v).sum(0).cpu().numpy()
        mvv = (m[:, None, None] * v[:, :, None]
               * v[:, None, :]).sum(0).cpu().numpy()
        out = {
            'temperature': T, 'pressure': float(P),
            'kinetic_energy': ke, 'potential_energy': pe,
            'ndof': float(ndof), 'num_particles': float(n),
            'volume': vol, 'momentum': float(np.linalg.norm(mom)),
        }
        names = ('xx', 'xy', 'xz', 'yy', 'yz', 'zz')
        idx = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
        for c, (nm, (a, b)) in enumerate(zip(names, idx)):
            out[f'pressure_{nm}'] = float((mvv[a, b] + w_sum[c]) / vol)
        return out
