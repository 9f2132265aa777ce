"""hoomd_tpu_torch's run-loop host operations and I/O against the JAX
package: dump.gsd / init.read_gsd, analyze.log and the README example.

* GSD files: frames the port writes (dump.gsd every 10 steps of an NVT
  job on the fast engine, with the thermostat's xi and eta) read back
  through hoomd_tpu.io.frames.FrameReader equal the port's snapshots at
  those steps bit for bit, and the port reads a file the JAX package
  wrote (with bonds and angles) bit for bit.
* The restart flow of .claude/skills/verify/SKILL.md on both engines:
  write_restart after a Langevin run and an NVT leg, init.read_gsd in a
  fresh context, nvt.restore_state(): the same step, xi and eta bit for
  bit, PE within 2e-6 relative (the same positions summed in another
  order), and the two continuations within float32 round-off.
* analyze.log's file (period 100) for one 200-step Langevin script, run
  as two runs, through both packages' general engines (the port under
  HOOMD_TPU_FAST=off): the same header and steps, every value within
  1e-5 relative plus 1e-5 of the column's largest |value|, pressure_xy
  (a sum of pair terms that cancel) plus 2e-4 of it: float32 round-off
  that the liquid's chaos grows over 200 steps to ~4e-5 in position
  (measured: T 3e-6, PE 7e-8, pressure_xy 6e-5 of the column's largest
  |value|); the Langevin noise bits are equal.
* examples/lj_liquid.py with its import lines changed, the CPU mode and
  paths in a temporary directory, and a run of 101 steps: the fast
  engine runs it, the log has its header and a row per 100 steps whose
  values are thermo_quantities() at that step, the GSD file's frame
  reads through the JAX package equal to the snapshot of its step, and
  log.query('pair_lj_energy') equals the potential energy.
"""

import os

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.io.frames import FrameReader

from test_torch_bonded import _kg_script
from test_torch_general import _lattice_snapshot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def _lj_script(h, snap, method, dt=0.005):
    h.init.read_snapshot(snap)
    lj = h.md.pair.lj(r_cut=2.5, nlist=h.md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    mode = h.md.integrate.mode_standard(dt=dt)
    if method == 'langevin':
        m = h.md.integrate.langevin(group=h.group.all(), kT=1.2, seed=7)
    else:
        m = h.md.integrate.nvt(group=h.group.all(), kT=1.2, tau=0.5)
    return h.context.current.system, mode, m


SNAP_FIELDS = ('position', 'velocity', 'image', 'typeid', 'mass', 'charge',
               'diameter', 'body', 'orientation')


def _same_snapshot(a, b, what):
    for name in SNAP_FIELDS:
        assert np.array_equal(getattr(a.particles, name),
                              getattr(b.particles, name)), (what, name)
    assert list(a.particles.types) == list(b.particles.types), what
    for k in ('Lx', 'Ly', 'Lz', 'xy', 'xz', 'yz', 'dimensions'):
        assert np.float32(getattr(a.box, k)) == np.float32(
            getattr(b.box, k)), (what, k)


def test_gsd_files_read_in_both_packages(torch_ctx, tmp_path):
    from hoomd_tpu.io.frames import FrameReader as JReader
    import hoomd_tpu as jh
    snap = _lattice_snapshot(jh, 6, 1.09, 'A', seed=5)
    system, _, nvt = _lj_script(th, interop.snapshot_from_numpy(snap), 'nvt')
    fn = str(tmp_path / 'port.gsd')
    th.dump.gsd(fn, period=10, overwrite=True)
    seen = {}
    th.analyze.callback(lambda ts: seen.__setitem__(ts, (
        system.take_snapshot(), {k: float(v) for k, v in
                                 system._method_aux_by_obj[nvt].items()})),
        period=10)
    th.run(30, quiet=True)
    assert system._program['fast'] is not None
    r = JReader(fn)
    assert len(r) == 3
    for i, ts in enumerate((0, 10, 20)):
        s, step, op = r.read(i)
        assert step == ts
        _same_snapshot(s, seen[ts][0], f'frame {i}')
        assert {k: float(v) for k, v in op.items()} == {
            f'nvt/{k}': v for k, v in seen[ts][1].items()}
    assert seen[20][1]['xi'] != 0.0
    # and a file the JAX package wrote, topology included
    js = _kg_script(jh, 'nvt')
    jfn = str(tmp_path / 'jax.gsd')
    jh.dump.gsd(jfn, period=None, overwrite=True)
    s, step, _ = FrameReader(jfn).read(-1)
    want = js.take_snapshot()
    assert step == 0
    _same_snapshot(s, want, 'the JAX package\'s frame')
    for kind in ('bonds', 'angles'):
        a, b = getattr(s, kind), getattr(want, kind)
        assert a.N == b.N > 0 and list(a.types) == list(b.types)
        assert np.array_equal(a.group, b.group)
        assert np.array_equal(a.typeid, b.typeid)


@pytest.mark.parametrize('engine', ['fast', 'general'])
def test_restart_round_trip(torch_ctx, tmp_path, monkeypatch, engine):
    import hoomd_tpu as jh
    if engine == 'general':
        monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    snap = interop.snapshot_from_numpy(_lattice_snapshot(jh, 6, 1.09, 'A',
                                                         seed=6))
    fn = str(tmp_path / 'restart.gsd')

    def setup(snap_or_restart):
        th.context.initialize('--mode=cpu --notice-level=0')
        if isinstance(snap_or_restart, str):
            th.init.read_gsd(str(tmp_path / 'absent.gsd'),
                             restart=snap_or_restart)
        else:
            th.init.read_snapshot(snap_or_restart)
        lj = th.md.pair.lj(r_cut=2.5, nlist=th.md.nlist.cell(r_buff=0.4))
        lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
        lj.set_params(mode='shift')
        return th.context.current.system, th.md.integrate.mode_standard(
            dt=0.005)

    system, _ = setup(snap)
    lan = th.md.integrate.langevin(group=th.group.all(), kT=1.2, seed=7)
    th.run(20, quiet=True)
    lan.disable()
    nvt = th.md.integrate.nvt(group=th.group.all(), kT=1.2, tau=0.5)
    th.run(20, quiet=True)
    assert (system._program['fast'] is None) == (engine == 'general')
    th.dump.gsd(fn, period=None, overwrite=True).write_restart()
    pe0 = system.thermo_quantities()['potential_energy']
    aux0 = {k: float(v) for k, v in system._method_aux_by_obj[nvt].items()}
    assert aux0['xi'] != 0.0
    th.run(10, quiet=True)
    end0 = system.take_snapshot()

    system, _ = setup(fn)
    assert system.timestep == 40
    nvt = th.md.integrate.nvt(group=th.group.all(), kT=1.2, tau=0.5)
    nvt.restore_state()
    aux1 = {k: float(v) for k, v in system._method_aux_by_obj[nvt].items()}
    assert aux1 == aux0
    pe1 = system.thermo_quantities()['potential_energy']
    assert abs(pe1 - pe0) <= 2e-6 * abs(pe0)
    th.run(10, quiet=True)
    end1 = system.take_snapshot()
    np.testing.assert_allclose(end1.particles.position,
                               end0.particles.position, rtol=0, atol=2e-5)
    np.testing.assert_allclose(end1.particles.velocity,
                               end0.particles.velocity, rtol=0, atol=2e-4)


def _read_log(fn):
    with open(fn) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(x) for x in ln.split('\t')]
                               for ln in lines[1:]])


LOG_QUANTITIES = ['temperature', 'potential_energy', 'pressure_xy',
                  'pair_lj_energy']


def test_log_matches_jax(torch_ctx, tmp_path, monkeypatch):
    import hoomd_tpu as jh
    monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    snap = _lattice_snapshot(jh, 6, 1.09, 'A', seed=7, v_sigma=1.2)
    out = {}
    for h in (jh, th):
        if h is th:
            th.context.initialize('--mode=cpu --notice-level=0')
            snap = interop.snapshot_from_numpy(snap)
        _lj_script(h, snap, 'langevin')
        fn = str(tmp_path / f'{h.__name__}.log')
        h.analyze.log(filename=fn, quantities=LOG_QUANTITIES, period=100,
                      header_prefix='# ', overwrite=True)
        h.run(150, quiet=True)
        h.run(51, quiet=True)
        out[h.__name__] = _read_log(fn)
    (hj, vj), (ht, vt) = out['hoomd_tpu'], out['hoomd_tpu_torch']
    assert ht == hj == '# timestep\t' + '\t'.join(LOG_QUANTITIES)
    assert np.array_equal(vt[:, 0], [0, 100, 200])
    assert np.array_equal(vt[:, 0], vj[:, 0])
    for k, name in enumerate(LOG_QUANTITIES, 1):
        tol = 2e-4 if name == 'pressure_xy' else 1e-5
        np.testing.assert_allclose(vt[:, k], vj[:, k], rtol=1e-5,
                                   atol=tol * np.abs(vj[:, k]).max(),
                                   err_msg=name)
    # the pair's energy is the whole potential energy here
    np.testing.assert_allclose(vt[:, 4], vt[:, 2], rtol=1e-6)


def test_readme_example_runs(torch_ctx, tmp_path):
    from hoomd_tpu.io.frames import FrameReader as JReader
    with open(os.path.join(REPO, 'examples', 'lj_liquid.py')) as f:
        src = f.read()
    log_fn, gsd_fn = str(tmp_path / 'log-output.log'), str(tmp_path / 't.gsd')
    edits = (('import hoomd_tpu as hoomd', 'import hoomd_tpu_torch as hoomd'),
             ('from hoomd_tpu import md', 'from hoomd_tpu_torch import md'),
             ('hoomd.context.initialize("")',
              'hoomd.context.initialize("--mode=cpu --notice-level=0")'),
             ('"log-output.log"', repr(log_fn)),
             ('"trajectory.htpf"', repr(gsd_fn)),
             ('hoomd.run(10_000)',
              'hoomd.analyze.callback(_probe, period=100)\n'
              'hoomd.run(101, quiet=True)'))
    for a, b in edits:
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    seen = {}

    def _probe(ts):
        s = th.context.current.system
        seen[ts] = (s.thermo_quantities(), s.take_snapshot())
    exec(compile(src, 'lj_liquid.py', 'exec'), {'_probe': _probe})
    system = th.context.current.system
    assert system._program['fast'] is not None
    assert system.timestep == 101
    with open(log_fn) as f:
        lines = [ln.split('\t') for ln in f.read().splitlines()]
    assert lines[0] == ['timestep', 'potential_energy', 'temperature']
    assert [ln[0] for ln in lines[1:]] == ['0', '100']
    for ts, pe, T in lines[1:]:
        q = seen[int(ts)][0]
        assert [pe, T] == [f"{q['potential_energy']:.9g}",
                           f"{q['temperature']:.9g}"]
    r = JReader(gsd_fn)
    assert len(r) == 1
    s, step, _ = r.read(0)
    assert step == 0
    _same_snapshot(s, seen[0][1], 'frame 0')
    log = system.analyzers[0]
    assert abs(log.query('pair_lj_energy')
               - system.thermo_quantities()['potential_energy']) <= 1e-5 * \
        abs(system.thermo_quantities()['potential_energy'])
