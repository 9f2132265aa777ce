"""The fast engine's cadence controller, through both packages.

hoomd_tpu and hoomd_tpu_torch run the same job script (tests/
test_torch_slice.py's 7^3 shifted-LJ liquid under Nose-Hoover NVT) with
the segment outcomes scripted: each package's build_fast_lj_chunk hands
out a run_chunk that advances the timestep and reports the flags the
script gives it (clean by default) without moving a particle, so both
controllers see the same danger flags and drift ratios.  After every
scripted run the two growth tables (the 'fast_*' entries of
System._grow) and kernel windows agree.  The sequences: two failed
probes, then 16 clean segments (the probe amnesty); a start whose
kernel window is below 4 reaching 4 windows per rebuild (k grows), then
a danger at one window per rebuild (the growth reverts and is blocked);
a dt change (the cadence keys are cleared).

Apart from that: the megastep windows of the port write their planes in
place, so a danger retry must still restart from the segment's start
carry bit for bit.
"""

import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from test_torch_slice import _start_snapshot

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _scripted(module, monkeypatch, outcomes, flags):
    """Make module.build_fast_lj_chunk's run_chunk report the next entry
    of ``outcomes`` (a dict of flags; clean when the list is empty)
    through ``flags(carry, outcome, nsteps)``."""
    real = module.build_fast_lj_chunk

    def build(*args, **kwargs):
        to_fast, refresh, run, to_state = real(*args, **kwargs)

        def scripted(carry, dyn, nsteps, nwin=1):
            return flags(carry, outcomes.pop(0) if outcomes else {}, nsteps)
        scripted.__dict__.update(getattr(run, '__dict__', {}))
        return to_fast, refresh, scripted, to_state
    monkeypatch.setattr(module, 'build_fast_lj_chunk', build)


def _jax_flags(carry, out, nsteps):
    import jax.numpy as jnp
    return carry.replace(
        danger=jnp.asarray(out.get('danger', False)),
        wmax=jnp.asarray(out.get('wmax', 0.0), jnp.float32),
        timestep=carry.timestep + nsteps)


def _torch_flags(carry, out, nsteps):
    return carry.replace(
        danger=torch.tensor(out.get('danger', False)),
        wmax=torch.tensor(out.get('wmax', 0.0), dtype=torch.float32),
        timestep=carry.timestep + nsteps)


class _Pair:
    """The job in both packages, with scripted segment outcomes."""

    def __init__(self, monkeypatch, vscale, dt):
        import hoomd_tpu as jh
        import hoomd_tpu.ops.fast_lj as jfl
        import hoomd_tpu_torch.ops.fast_lj as tfl
        monkeypatch.setenv('HOOMD_TPU_FAST', 'on')
        snap = _start_snapshot(vscale=vscale)
        self.jout, self.tout = [], []
        _scripted(jfl, monkeypatch, self.jout, _jax_flags)
        _scripted(tfl, monkeypatch, self.tout, _torch_flags)
        jh.context.initialize('--notice-level=0')
        self.js, self.jmode = self._job(jh, snap, dt)
        th.context.initialize('--mode=cpu --notice-level=0')
        self.ts, self.tmode = self._job(th, interop.snapshot_from_numpy(snap),
                                        dt)

    @staticmethod
    def _job(hoomd, snap, dt):
        md = hoomd.md
        hoomd.init.read_snapshot(snap)
        lj = md.pair.lj(r_cut=2.5, nlist=md.nlist.cell(r_buff=0.4))
        lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
        lj.set_params(mode='shift')
        mode = md.integrate.mode_standard(dt=dt)
        md.integrate.nvt(group=hoomd.group.all(), kT=1.0, tau=0.5)
        return hoomd.context.current.system, mode

    def run(self, nsteps, **outcome):
        """One run of both systems whose first segment reports
        ``outcome``; returns the port's growth table after it, once it
        equals the JAX package's."""
        for system, outs in ((self.js, self.jout), (self.ts, self.tout)):
            outs[:] = [outcome] if outcome else []
            system.run(nsteps, quiet=True)
        jg, tg = (self._fast_keys(s._grow) for s in (self.js, self.ts))
        assert jg == tg, (outcome, jg, tg)
        assert (self.js._program['fast']['k_rebuild']
                == self.ts._program['fast']['k_rebuild'])
        return tg

    @staticmethod
    def _fast_keys(grow):
        return {k: v for k, v in grow.items()
                if isinstance(k, str) and k.startswith('fast_')}

    def k(self):
        self.ts._ensure_ready()
        return self.ts._program['fast']['k_rebuild']


def test_two_failed_probes_then_amnesty(torch_ctx, monkeypatch):
    pair = _Pair(monkeypatch, vscale=1.0, dt=0.005)
    pair.ts._grow['fast_m'] = pair.js._grow['fast_m'] = 8
    assert pair.k() == 4
    # danger at 8 windows per rebuild pins the ceiling at 6
    g = pair.run(16, danger=True)
    assert g['fast_m'] == g['fast_m_ceil'] == 6 and g['fast_m_pinned']
    for strike in (1, 2):
        for _ in range(3):
            g = pair.run(8)
        # the fourth clean segment at the ceiling re-probes one higher
        assert g['fast_m_ceil'] == g['fast_m'] + 1
        g = pair.run(64)                  # fast_m grows to the probe
        assert g['fast_m'] == g['fast_m_ceil']
        g = pair.run(64, danger=True)     # and the probe fails
        assert g['fast_m_probe_fails'] == strike
    for _ in range(3):
        g = pair.run(8)
    # two strikes: no more probes
    assert g['fast_m_ceil'] == g['fast_m'] and g['fast_clean_segs'] == 4
    pair.ts._grow['fast_xsel_fails'] = pair.js._grow['fast_xsel_fails'] = 2
    for _ in range(11):
        g = pair.run(8)
    assert g['fast_clean_segs'] == 15 and g['fast_m_probe_fails'] == 2
    g = pair.run(8)
    # the 16th clean segment forgives both strikes, keeps the pin, and
    # re-probes at once
    assert 'fast_m_probe_fails' not in g and 'fast_xsel_fails' not in g
    assert g['fast_m_pinned'] and g['fast_m_ceil'] == g['fast_m'] + 1
    assert g['fast_clean_segs'] == 0


def test_k_grows_then_reverts_on_danger_and_dt_change_clears(torch_ctx,
                                                             monkeypatch):
    # a hot start at a long dt: the ballistic estimate plans k = 2
    pair = _Pair(monkeypatch, vscale=1.0, dt=0.015)
    assert pair.k() == 2
    m_before, g = 1, pair.run(64)
    while not g.get('fast_k_grown'):
        assert pair.k() == 2 and g['fast_m'] == 2 * m_before
        m_before, g = g['fast_m'], pair.run(64)
    # the clean segment at 4 windows per rebuild (doubling fast_m to 8)
    # grew k to 4, with fast_m scaled to keep the cadence
    assert m_before == 4 and pair.k() == 4
    assert g['fast_m'] == 2 * 8 // 4
    # a far-past-the-edge danger drops to one window per rebuild ...
    g = pair.run(64, danger=True, wmax=100.0)
    assert g['fast_m'] == 1 and pair.k() == 4
    # ... and a danger there reverts the growth, for good
    g = pair.run(64, danger=True)
    assert 'fast_k_grown' not in g and g['fast_k_grow_block']
    assert pair.k() == 2 and 'fast_k_cap' not in g
    for _ in range(4):
        g = pair.run(64)
    assert pair.k() == 2 and 'fast_k_grown' not in g
    # a danger at one window per rebuild now caps k
    pair.ts._grow['fast_m'] = pair.js._grow['fast_m'] = 1
    g = pair.run(8, danger=True)
    assert g['fast_k_cap'] == 1 and pair.k() == 1
    # a dt change clears every cadence key, the block and the cap
    for mode in (pair.jmode, pair.tmode):
        mode.set_params(dt=0.005)
    g = pair.run(8)
    for key in ('fast_k_cap', 'fast_k_grown', 'fast_k_grow_block',
                'fast_m_pinned', 'fast_m_ceil'):
        assert key not in g
    assert pair.k() == 4


def test_inplace_windows_leave_the_retry_carry_intact(torch_ctx):
    """The megastep windows write their planes in place.  A segment that
    ends in windows leaves a carry whose positions are views of those
    planes; the next segment starts from it, and a danger retry restores
    it.  Its state must come through bit for bit."""
    snap = interop.snapshot_from_numpy(_start_snapshot(vscale=1.0))
    system, _ = _Pair._job(th, snap, 0.005)
    system._grow['fast_m'] = 4
    system.run(12, quiet=True)            # three windows, no rebuild
    c0 = system._fast_carry
    assert c0.since == 12 and c0.pos._base is not None   # views of planes
    saved = {name: getattr(c0, name).clone()
             for name in ('pos', 'vel', 'frc', 'ref_pos')}
    xi0 = c0.aux['xi'].clone()
    fast, dyn = system._program['fast'], system._dyn['fast']
    out = fast['run_chunk'](c0, dyn, 8, 4)
    assert not torch.equal(out.pos, c0.pos)
    for name, t in saved.items():
        assert torch.equal(getattr(c0, name), t), name
    assert torch.equal(c0.aux['xi'], xi0)

    # through the run loop: a forced danger in the next segment
    real = fast['run_chunk']

    def danger_once(carry, *args):
        out = real(carry, *args)
        fast['run_chunk'] = real
        return out.replace(danger=torch.ones_like(out.danger))
    fast['run_chunk'] = danger_once
    system.run(4, quiet=True)
    assert system.fast_stats['retries'] == 1
    for name, t in saved.items():
        assert torch.equal(getattr(c0, name), t), name
    assert torch.equal(c0.aux['xi'], xi0)
