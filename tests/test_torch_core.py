"""hoomd_tpu_torch core state against the JAX package.

Box.wrap is bit-exact (the cases of tests/test_box_wrap_exact.py),
create_lattice snapshots are equal, plan_fast_lj gives the identical
(cell_dim, nc, C), and the sort rebin gives the same per-tag cell, wrapped
position and image, and the same overflow flag.  The rebin is compared by
tag, not by slot: jax.lax.sort is not stable, so the order within a cell
may differ."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch import interop
from hoomd_tpu_torch.box import Box as TBox

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)


@pytest.fixture
def torch_ctx():
    th.context.initialize('--mode=cpu --notice-level=0')
    yield
    th.context.current = None


def test_wrap_exact_subtraction():
    L = (34.7315, 34.7315, 31.04)
    b = TBox.create(*L)
    rng = np.random.RandomState(0)
    pos = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    pos *= np.asarray(L, np.float32)
    w, im = b.wrap(torch.from_numpy(pos), torch.zeros((256, 3),
                                                      dtype=torch.int32))
    Lf = np.asarray(L, np.float32)
    f = pos / Lf + np.float32(0.5)
    shift = np.floor(f).astype(np.float32)
    assert np.array_equal(w.numpy(), pos - shift * Lf)
    assert np.array_equal(im.numpy(), shift.astype(np.int32))
    # and bit-equal to the JAX package
    import jax.numpy as jnp
    from hoomd_tpu.box import Box as JBox
    wj, imj = JBox.create(*L).wrap(jnp.asarray(pos),
                                   jnp.zeros((256, 3), jnp.int32))
    assert np.array_equal(w.numpy(), np.asarray(wj))
    assert np.array_equal(im.numpy(), np.asarray(imj))


def test_from_fraction_roundtrip_exact():
    b = TBox.create(17.25, 9.5, 31.0)
    f = np.random.RandomState(1).rand(128, 3).astype(np.float32)
    pos = b.from_fraction(torch.from_numpy(f)).numpy()
    Lf = np.asarray([17.25, 9.5, 31.0], np.float32)
    assert np.array_equal(pos, (f - np.float32(0.5)) * Lf)


@pytest.mark.parametrize('lat,n', [('sc', 5), ('fcc', 3), ('bcc', (2, 3, 4))])
def test_create_lattice_snapshots_equal(torch_ctx, lat, n):
    import hoomd_tpu as jh
    jh.context.initialize('--notice-level=0')
    jh.init.create_lattice(unitcell=getattr(jh.lattice, lat)(a=1.3), n=n)
    th.init.create_lattice(unitcell=getattr(th.lattice, lat)(a=1.3), n=n)
    sj = jh.context.current.system.take_snapshot()
    st = th.context.current.system.take_snapshot()
    for name in ('position', 'velocity', 'typeid', 'mass', 'image'):
        assert np.array_equal(getattr(sj.particles, name),
                              getattr(st.particles, name)), name
    assert (sj.box.Lx, sj.box.Ly, sj.box.Lz) == (st.box.Lx, st.box.Ly,
                                                 st.box.Lz)


PLAN_CASES = [(N, L, rb, cons)
              for N, L in ((1000, 10.77), (4096, 16.9), (16000, 26.66),
                           (32000, (33.6, 33.6, 30.0)))
              for rb in (0.3, 0.4)
              for cons in (False, True)]


@pytest.mark.parametrize('N,L,rb,cons', PLAN_CASES)
def test_plan_fast_lj_identical(N, L, rb, cons):
    from hoomd_tpu.ops.fast_lj import plan_fast_lj as jplan
    from hoomd_tpu_torch.ops.fast_lj import plan_fast_lj as tplan
    L3 = np.broadcast_to(np.asarray(L, float), (3,))
    frac = np.random.RandomState(N % 97).rand(N, 3)
    for fr in (None, frac):
        assert tplan(N, L3, 2.5, rb, conservative=cons, frac=fr) == \
            jplan(N, L3, 2.5, rb, conservative=cons, frac=fr)


def test_plan_fast_lj_bench_point():
    """The 64k bench lattice plans as cell_dim (14, 14, 12), C = 40."""
    from hoomd_tpu_torch.ops.fast_lj import plan_fast_lj
    a = (1.0 / 0.8442) ** (1.0 / 3.0)
    g = (np.arange(40) + 0.5) / 40
    frac = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    cdim, nc, C = plan_fast_lj(64000, np.full(3, 40 * a), 2.5, 0.4,
                               frac=frac)
    assert (tuple(cdim), nc, C) == ((14, 14, 12), 2352, 40)


def _rebin_both(C, seed, box_L=(9.1, 9.1, 9.1), cell_dim=(3, 3, 3), N=300):
    import jax.numpy as jnp
    from hoomd_tpu.ops.fast_lj import build_fast_lj_chunk as jbuild
    from hoomd_tpu.snapshot import Snapshot as JSnap, BoxSnapshot
    from hoomd_tpu.state import state_from_snapshot as jstate
    from hoomd_tpu_torch.ops.fast_lj import build_fast_lj_chunk as tbuild
    from hoomd_tpu_torch.state import state_from_snapshot as tstate
    rng = np.random.RandomState(seed)
    snap = JSnap(N, BoxSnapshot(*box_L))
    # positions partly outside the box, so the wrap and images matter
    snap.particles.position[:] = (rng.rand(N, 3) - 0.5) * 1.3 \
        * np.asarray(box_L)
    snap.particles.velocity[:] = rng.normal(0, 1, (N, 3))
    js = jstate(snap)
    ts_ = tstate(interop.snapshot_from_numpy(snap))
    jf = jbuild(N=N, box=js.box, cell_dim=cell_dim, C=C, r_buff=0.4,
                rcut=2.5, method_kind='nve', method_seed=0,
                dtype=jnp.float32)[0](js, {})
    tf = tbuild(N=N, box=ts_.box, cell_dim=cell_dim, C=C, r_buff=0.4,
                rcut=2.5, method_kind='nve', method_seed=0)[0](ts_, {})
    return jf, tf, N


def _by_tag(tag, *arrays):
    tag = np.asarray(tag).reshape(-1)
    slots = np.nonzero(tag >= 0)[0]
    order = np.argsort(tag[slots])
    out = [slots[order]]
    for a in arrays:
        a = np.asarray(a)
        out.append(a.reshape(tag.size, -1)[slots[order]])
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_sort_rebin_same_cells_per_tag(seed):
    C = 32
    jf, tf, N = _rebin_both(C, seed)
    assert not bool(jf.overflow) and not bool(tf.overflow)
    js, jp, jim, jv = _by_tag(jf.tag, jf.pos, jf.img, jf.vel)
    ts, tp, tim, tv = _by_tag(tf.tag.numpy(), tf.pos.numpy(), tf.img.numpy(),
                              tf.vel.numpy())
    assert len(js) == len(ts) == N
    assert np.array_equal(js // C, ts // C)          # the same cell per tag
    assert np.array_equal(jp, tp) and np.array_equal(jim, tim)
    assert np.array_equal(jv, tv)
    # padding slots are inert
    pad = tf.tag.numpy() < 0
    assert np.all(tf.pos.numpy()[pad] == 1e9) and not tf.vel.numpy()[pad].any()


def test_sort_rebin_overflow_flag_equal():
    jf, tf, _ = _rebin_both(12, 5)      # 27 cells x 12 slots, N = 300
    assert bool(jf.overflow) and bool(tf.overflow)
    jf, tf, _ = _rebin_both(32, 5)
    assert not bool(jf.overflow) and not bool(tf.overflow)


def test_eval_packed_matches_jnp_interp():
    import jax.numpy as jnp
    from hoomd_tpu import variant as jv
    from hoomd_tpu_torch import variant as tv
    xs = np.array([0.0, 100.0, 250.0], np.float32)
    ys = np.array([0.5, 1.5, 1.2], np.float32)
    steps = np.array([-5, 0, 1, 37, 100, 101, 249, 250, 400], np.int32)
    want = np.asarray(jv.eval_packed((jnp.asarray(xs), jnp.asarray(ys)),
                                     jnp.asarray(steps)))
    got = tv.eval_packed((torch.from_numpy(xs), torch.from_numpy(ys)),
                         torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    c = tv.constant(1.2).pack(torch.float32)
    assert float(tv.eval_packed(c, 77)) == np.float32(1.2)


def test_port_imports_no_jax():
    code = ("import sys, hoomd_tpu_torch, hoomd_tpu_torch.ops.fast_lj, "
            "hoomd_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'hoomd_tpu.')) or m == 'hoomd_tpu']; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, '-c', code],
                          timeout=120).returncode == 0


def _lj_script(types=('A',), charge=0.0, mode='shift', tilt=0.0,
               group='all', pair='lj'):
    snap = th.data.make_snapshot(64, th.data.boxdim(Lx=8.0, Ly=8.0, Lz=8.0,
                                                    xy=tilt),
                                 particle_types=list(types))
    g = (np.arange(4) + 0.5) * 2.0 - 4.0
    snap.particles.position[:] = np.stack(
        np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    snap.particles.typeid[:] = np.arange(64) % len(types)
    snap.particles.charge[:] = charge
    th.init.read_snapshot(snap)
    nl = th.md.nlist.cell(r_buff=0.4)
    lj = getattr(th.md.pair, pair)(r_cut=2.5, nlist=nl)
    lj.pair_coeff.set(list(types), list(types), epsilon=1.0, sigma=1.0)
    lj.set_params(mode=mode)
    th.md.integrate.mode_standard(dt=0.005)
    grp = th.group.all() if group == 'all' else th.group.tags(0, 9)
    th.md.integrate.nve(group=grp)


@pytest.mark.parametrize('kw,gate', [
    (dict(types=('A', 'B'), impl='row'), '2 particle types'),
    (dict(charge=0.5), 'particle charges'),
    (dict(mode='xplor'), "shift mode 'xplor'"),
    (dict(tilt=0.1), 'non-orthorhombic'),
    (dict(group='tags'), 'group.all()'),
] + [(dict(pair='gauss', impl=impl),
      f"HOOMD_TPU_FAST_IMPL={impl} runs the lj evaluator only")
     for impl in ('row', 'pallas', 'pallas3d')]
   + [(dict(types=tuple('ABCDE')), '5 particle types')])
def test_configs_outside_the_slice_raise(torch_ctx, monkeypatch, kw, gate):
    kw = dict(kw)
    impl = kw.pop('impl', None)
    if impl is not None:
        monkeypatch.setenv('HOOMD_TPU_FAST_IMPL', impl)
    _lj_script(**kw)
    with pytest.raises(NotImplementedError, match=gate.replace('(', r'\(')
                       .replace(')', r'\)')):
        th.run(1, quiet=True)


def test_langevin_windows_match_single_steps(torch_ctx):
    """The megastep windows and one_step share one Langevin bath: from the
    same carry, 2 windows of k steps equal 2k single steps."""
    snap = th.data.make_snapshot(343, th.data.boxdim(L=9.1))
    g = (np.arange(7) + 0.5) * 1.3 - 4.55
    rng = np.random.RandomState(4)
    snap.particles.position[:] = np.stack(
        np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3) \
        + rng.uniform(-0.1, 0.1, (343, 3))
    snap.particles.velocity[:] = rng.normal(0, 1.0, (343, 3))
    th.init.read_snapshot(snap)
    system = th.context.current.system
    lj = th.md.pair.lj(r_cut=2.5, nlist=th.md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    th.md.integrate.mode_standard(dt=0.004)
    th.md.integrate.langevin(group=th.group.all(), kT=1.0, seed=5)
    system._ensure_ready()
    carry = system._fresh_carry()
    fast, dyn = system._program['fast'], system._dyn['fast']
    k = fast['k_rebuild']
    a = fast['run_chunk'].wins(carry, dyn, 2, k)
    b = fast['run_chunk'].steps(carry, dyn, 2 * k)
    assert a.timestep == b.timestep == 2 * k
    valid = (carry.tag >= 0)[..., None].expand_as(a.pos)
    torch.testing.assert_close(a.pos[valid], b.pos[valid], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(a.vel[valid], b.vel[valid], rtol=0,
                               atol=1e-4)


def _nvt_system(seed=6):
    snap = th.data.make_snapshot(343, th.data.boxdim(L=9.1))
    g = (np.arange(7) + 0.5) * 1.3 - 4.55
    rng = np.random.RandomState(seed)
    snap.particles.position[:] = np.stack(
        np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3) \
        + rng.uniform(-0.1, 0.1, (343, 3))
    snap.particles.velocity[:] = rng.normal(0, 1.6, (343, 3))
    th.init.read_snapshot(snap)
    lj = th.md.pair.lj(r_cut=2.5, nlist=th.md.nlist.cell(r_buff=0.4))
    lj.pair_coeff.set('A', 'A', epsilon=1.0, sigma=1.0)
    lj.set_params(mode='shift')
    th.md.integrate.mode_standard(dt=0.004)
    th.md.integrate.nvt(group=th.group.all(), kT=1.0, tau=0.3)
    return th.context.current.system


def test_danger_retry_rewinds_the_thermostat_with_the_particles(torch_ctx):
    """A retried segment starts from its carry's positions AND its
    Nose-Hoover xi/eta: forcing a danger retry after an accepted run
    leaves the trajectory on the retry-free one."""
    ref = _nvt_system()
    ref.run(20, quiet=True)
    ref.run(28, quiet=True)
    th.context.initialize('--mode=cpu --notice-level=0')
    s = _nvt_system()
    s.run(20, quiet=True)
    s._grow['fast_m'] = 16         # 64-step cadence: the next run retries
    s.run(28, quiet=True)
    assert s._grow.get('fast_m_pinned')
    a, b = ref.take_snapshot(), s.take_snapshot()
    np.testing.assert_allclose(b.particles.velocity, a.particles.velocity,
                               rtol=0, atol=1e-4)
    assert s.thermo_quantities()['temperature'] == pytest.approx(
        ref.thermo_quantities()['temperature'], rel=1e-5)
