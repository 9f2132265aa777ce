"""The ten stencil pair evaluators against the JAX package.

For each of lj, gauss, yukawa, morse, mie, buckingham, lj1208,
force_shifted_lj, dpd_conservative and moliere (the JAX engine's
FAST_EVALS), on identical numpy inputs made from a seed:

  * hoomd_tpu_torch.ops.pair_eval against hoomd_tpu.ops.pair_eval
    elementwise: derive on float32 coefficient tables, then
    energy_force on r^2 in [0.3, 6.25] and the shift energy at r_cut,
    to rel 2e-6 (one or two f32 roundings of exp, pow or sqrt apart);
  * the plain plane and planar stencils (cell_pair_plane_plain,
    cell_pair_planar_plain) against the JAX package's cell_pair_xla: a
    jittered 6^3 lattice (L = 8.4, r_cut = 2, C = 24); forces, per-slot
    PE and virial to atol 5e-4 of max(1, max|F|) (the XLA form's
    expanded r^2 loses ~1e-5 in r^2 at |x| ~ 4, as in
    tests/test_torch_cell_pair.py) and rtol 1e-4;
  * a single force evaluation through the job-script API of both
    packages, hoomd_tpu on its general neighbour-list engine
    (HOOMD_TPU_FAST=off) and hoomd_tpu_torch on --mode=cpu, on the
    pattern of tests/test_fast_engine.py: per-tag forces to 2e-4 of
    max(1, max|F|), total PE to 1e-2 absolute or 1e-4 relative.

Two evaluators (mie, morse) also run a k = 4 Nose-Hoover megastep
window against the JAX megastep in interpret mode (positions to 1e-5,
velocities to 1e-4).  The kernel parameter layout documented in
csrc/cell_stencil.cuh is held to pair_eval.kernel_pnames.

The cases marked ``gpu`` hold each kernel's evaluator variant against
its plain version on the card (python -m pytest
tests/test_torch_evaluators.py -m gpu --noconftest); they skip where
torch sees no CUDA device.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import hoomd_tpu_torch as th
from hoomd_tpu_torch.ops import cell_pair as tcp
from hoomd_tpu_torch.ops import pair_eval as tpe

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PAD = 1.0e9
RCUT = 2.0
# coefficients of each evaluator: the JAX package's fast-engine tests'
# where they have them; mie off the LJ point (sigma 1.05, 14-7) so a
# swapped exponent or prefactor shows; buckingham the exp-6 form with
# alpha = 13 fitted to LJ's minimum (barrier ~7000 kT at r ~ 0.28);
# moliere with every coefficient away from 1
COEFFS = {
    'lj': dict(epsilon=1.0, sigma=1.0),
    'gauss': dict(epsilon=1.0, sigma=0.8),
    'yukawa': dict(epsilon=1.5, kappa=1.0),
    'morse': dict(D0=0.5, alpha=3.0, r0=1.0),
    'mie': dict(epsilon=1.0, sigma=1.05, n=14.0, m=7.0),
    'buckingham': dict(A=3.8e5, rho=0.0863, C=3.71),
    'lj1208': dict(epsilon=1.0, sigma=1.0),
    'force_shifted_lj': dict(epsilon=1.0, sigma=1.0),
    'dpd_conservative': dict(A=25.0),
    'moliere': dict(Z_i=2.0, Z_j=3.0, elementary_charge=1.2, a_0=0.9),
}
EVALS = list(tpe.FAST_EVALS)


def test_every_fast_evaluator_has_coefficients():
    assert sorted(COEFFS) == sorted(EVALS)
    classes = {n: getattr(getattr(th.md.pair, n), '_evaluator', None)
               for n in dir(th.md.pair)}
    # the ten stencil evaluators and ewald, the charged kernel's
    # real-space pair (lj_ewald is the fusion of pair.lj with it)
    assert sorted(tpe.FAST_EVALS + ('ewald',)) == sorted(
        n for n, ev in classes.items() if ev is not None and ev.__name__ == n)


def test_kernel_layout_matches_kernel_pnames():
    """csrc/cell_stencil.cuh's enum lists the evaluators in EVAL_IDS
    order, the charged ones last, each with the parameter order
    kernel_pnames gives."""
    src = (Path(tpe.__file__).resolve().parent.parent / 'csrc'
           / 'cell_stencil.cuh').read_text()
    rows = re.findall(r'EV_\w+ = (\d+),\s*// pv (\w+): ([\w ]+)', src)
    assert [(int(i), name) for i, name, _ in rows] == [
        (tpe.EVAL_IDS[n], n) for n in tpe.FAST_EVALS + tpe.CHARGED_EVALS]
    for _, name, layout in rows:
        assert tuple(layout.split()) == tpe.kernel_pnames(name), name


def _raw(name):
    ev = tpe.ALL_EVALUATORS[name]
    raw = dict(ev.defaults)
    raw.update(COEFFS[name])
    return {k: np.full((1, 1), v, np.float32) for k, v in raw.items()}


def _tables(name, rcut):
    """Derived tables (float32, port side) with rcut, as torch scalars."""
    ev = tpe.ALL_EVALUATORS[name]
    tab = {k: torch.tensor(np.float32(np.asarray(v).reshape(-1)[0]))
           for k, v in ev.derive(_raw(name)).items()}
    tab['rcut'] = torch.tensor(np.float32(rcut))
    return tab


def _params(name, rcut=RCUT):
    """[rc2, e_shift, *pnames] (shift mode) and pnames."""
    ev = tpe.ALL_EVALUATORS[name]
    tab = _tables(name, rcut)
    rc2 = tab['rcut'] * tab['rcut']
    _, es = ev.energy_force(rc2, tab)
    pn = tpe.kernel_pnames(name)
    return (np.array([float(rc2), float(es)] + [float(tab[k]) for k in pn],
                     np.float32), pn)


@pytest.mark.parametrize('name', EVALS)
def test_pair_eval_matches_jax(name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pair_eval as jpe
    jev, tev = jpe.ALL_EVALUATORS[name], tpe.ALL_EVALUATORS[name]
    assert tev.coeff_names == jev.coeff_names
    assert tev.defaults == jev.defaults
    raw = _raw(name)
    jd = jev.derive({k: jnp.asarray(v) for k, v in raw.items()})
    td = tev.derive(raw)
    assert sorted(jd) == sorted(td)
    for k in td:
        np.testing.assert_allclose(np.asarray(td[k], np.float32),
                                   np.asarray(jd[k]), rtol=2e-6, err_msg=k)
    r2 = np.linspace(0.3, RCUT ** 2 * 1.5625, 401, dtype=np.float32)
    jp = {k: jnp.asarray(v).reshape(()) for k, v in jd.items()}
    jp['rcut'] = jnp.float32(RCUT)
    tp = _tables(name, RCUT)
    fj, ej = (np.asarray(x) for x in jev.energy_force(jnp.asarray(r2), jp))
    ft, et = (x.numpy() for x in tev.energy_force(torch.from_numpy(r2), tp))
    scale_f, scale_e = np.abs(fj).max(), np.abs(ej).max()
    np.testing.assert_allclose(ft, fj, rtol=2e-6, atol=2e-6 * scale_f)
    np.testing.assert_allclose(et, ej, rtol=2e-6, atol=2e-6 * scale_e)
    _, es_j = jev.energy_force(jnp.float32(RCUT * RCUT), jp)
    pv, _ = _params(name)
    np.testing.assert_allclose(pv[1], np.asarray(es_j), rtol=2e-6,
                               atol=1e-7)


def _fill(n, a, cell_dim, C, seed, jitter):
    """A jittered n^3 sc lattice of spacing a, binned into (nc, C, 3)
    cell-major slots with padding (tag -1, PAD coordinates)."""
    rng = np.random.RandomState(seed)
    L = n * a
    g = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    pos = pos + rng.uniform(-jitter, jitter, pos.shape)
    cdim = np.asarray(cell_dim)
    c3 = np.minimum(((pos / L + 0.5) % 1.0 * cdim).astype(int), cdim - 1)
    cid = c3[:, 0] + cdim[0] * (c3[:, 1] + cdim[1] * c3[:, 2])
    nc = int(np.prod(cdim))
    cell_pos = np.full((nc, C, 3), PAD, np.float32)
    cell_tag = np.full((nc, C), -1, np.int32)
    fill = np.zeros(nc, int)
    for t, c in enumerate(cid):
        cell_pos[c, fill[c]] = pos[t]
        cell_tag[c, fill[c]] = t
        fill[c] += 1
    assert (fill < C).all()
    _, shift = tcp.build_cell_shifts(cell_dim, (L, L, L))
    return cell_pos, cell_tag, shift.astype(np.float32)


@pytest.mark.parametrize('name', EVALS)
def test_plain_stencils_match_jax_xla(name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    cell_dim, C = (3, 3, 3), 24
    pos, tag, sh = _fill(6, 1.4, cell_dim, C, 3, 0.15)
    pv, pn = _params(name)
    Fj, pej, virj = (np.asarray(o) for o in jp.cell_pair_xla(
        jnp.asarray(pos), cell_dim, jnp.asarray(sh), jnp.asarray(pv),
        eval_name=name, pnames=pn))
    args = (torch.from_numpy(pos), cell_dim, torch.from_numpy(sh),
            torch.from_numpy(pv))
    kw = dict(cell_tag=torch.from_numpy(tag), eval_name=name, pnames=pn)
    Fp = tcp.cell_pair_plane_plain(*args, **kw).numpy()
    F, pe, vir = (o.numpy() for o in tcp.cell_pair_planar_plain(*args, **kw))
    valid = tag >= 0
    atol = 5e-4 * max(1.0, float(np.abs(Fj[valid]).max()))
    for got, want in ((Fp, Fj), (F, Fj), (pe, pej), (vir, virj)):
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4,
                                   atol=atol)
    assert not F[~valid].any() and not pe[~valid].any()
    # the port's own XLA formulation takes the evaluator too
    Fx = tcp.cell_pair_xla(*args, eval_name=name, pnames=pn)[0].numpy()
    np.testing.assert_allclose(Fx[valid], Fj[valid], rtol=1e-4, atol=atol)


def _job(hoomd, name, snap=None):
    """One force evaluation (dt = 0, NVE) of a jittered 4^3 lattice."""
    md = hoomd.md
    hoomd.context.initialize('--notice-level=0' if snap is None
                             else '--mode=cpu --notice-level=0')
    if snap is None:
        hoomd.init.create_lattice(unitcell=hoomd.lattice.sc(a=1.3), n=4)
        system = hoomd.context.current.system
        s = system.take_snapshot()
        rng = np.random.RandomState(7)
        s.particles.position[:] += rng.uniform(-0.05, 0.05,
                                               s.particles.position.shape)
        system.restore_snapshot(s)
    else:
        hoomd.init.read_snapshot(snap)
        system = hoomd.context.current.system
    p = getattr(md.pair, name)(r_cut=RCUT, nlist=md.nlist.cell(r_buff=0.4))
    p.pair_coeff.set('A', 'A', **COEFFS[name])
    p.set_params(mode='shift')
    md.integrate.mode_standard(dt=0.0)
    md.integrate.nve(group=hoomd.group.all())
    hoomd.run(1, quiet=True)
    return system


@pytest.mark.parametrize('name', EVALS)
def test_single_eval_job_matches_jax(name, monkeypatch):
    import hoomd_tpu as jh
    from hoomd_tpu_torch import interop
    monkeypatch.setenv('HOOMD_TPU_FAST', 'off')
    js = _job(jh, name)
    assert not js._program.get('fast')
    snap = js.take_snapshot()
    jf = np.asarray(js.state.net_force)[np.asarray(js.state.rtag)]
    jpe = float(np.asarray(js.state.net_pe).sum())
    # the port honours HOOMD_TPU_FAST=off too: its side runs without it
    monkeypatch.delenv('HOOMD_TPU_FAST')
    try:
        ts = _job(th, name, interop.snapshot_from_numpy(snap))
        assert ts._program['fast']['eval_name'] == name
        st = ts.state
        tf = st.net_force.numpy()[st.rtag.numpy()]
        tpe_sum = float(st.net_pe.double().sum())
    finally:
        th.context.current = None
    scale = max(np.abs(jf).max(), 1.0)
    assert np.abs(tf - jf).max() < 2e-4 * scale
    assert tpe_sum == pytest.approx(jpe, abs=1e-2, rel=1e-4)


def _mega_inputs(name, cell_dim, C, seed):
    cell_pos, cell_tag, sh = _fill(6, 1.4, cell_dim, C, seed, 0.12)
    rng = np.random.RandomState(seed + 50)
    nx, ny, nz = cell_dim
    valid = cell_tag >= 0
    vel = np.where(valid[..., None], rng.normal(0, 1.0, cell_pos.shape),
                   0.0).astype(np.float32)
    mass = np.where(valid, rng.uniform(0.8, 1.2, valid.shape),
                    1.0).astype(np.float32)
    pv, pn = _params(name)
    frc = tcp.cell_pair_plane_plain(
        torch.from_numpy(cell_pos), cell_dim, torch.from_numpy(sh),
        torch.from_numpy(pv), cell_tag=torch.from_numpy(cell_tag),
        eval_name=name, pnames=pn).numpy()

    def planes(a):
        return np.ascontiguousarray(
            a.reshape(nz, ny, nx, C, 3).transpose(4, 0, 1, 2, 3))
    p4 = (nz, ny, nx, C)
    return dict(gp=planes(cell_pos), gv=planes(vel), gf=planes(frc),
                gw=(1.0 / mass).reshape(p4), gm=mass.reshape(p4),
                gt=cell_tag.reshape(p4), shift=sh, pv=pv, pn=pn,
                N=int(valid.sum()))


@pytest.mark.parametrize('name', ['mie', 'morse'])
def test_plain_megastep_matches_jax(name):
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_pair as jp
    cell_dim, C, k = (3, 3, 3), 24, 4
    d = _mega_inputs(name, cell_dim, C, 5)
    kt = np.full((k,), 1.1, np.float32)
    skin = np.full(3, 0.6, np.float32)
    kw = dict(k=k, method='nvt', ndof=3.0 * d['N'], tau_inv2=4.0)
    J = jnp.asarray
    j = [np.asarray(o) for o in jp.cell_megastep_planes(
        J(d['gp']), J(d['gv']), J(d['gf']), J(d['gw']), J(d['gm']),
        J(d['gp']), cell_dim, J(d['shift']), J(d['pv']), 0.004, J(kt), 0.05,
        0.0, skin, C=C, eval_name=name, pnames=d['pn'], interpret=True,
        **kw)]
    T = torch.as_tensor
    t = [o.numpy() for o in tcp.cell_megastep_planes(
        T(d['gp']), T(d['gv']), T(d['gf']), T(d['gw']), T(d['gm']),
        T(d['gp']), cell_dim, T(d['shift']), T(d['pv']), 0.004, T(kt),
        0.05, 0.0, T(skin), C=C, gt=T(d['gt']), eval_name=name,
        pnames=d['pn'], **kw)]
    valid = np.broadcast_to(d['gt'] >= 0, d['gp'].shape)
    np.testing.assert_allclose(t[0][valid], j[0][valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-4)
    for i in (3, 4, 6, 7):          # xi, eta, ke2, mdmax
        np.testing.assert_allclose(t[i], j[i], rtol=1e-4, atol=1e-6)
    assert bool(t[5]) == bool(j[5]) is False


# ---------------------------------------------------------------------------
# the CUDA kernels' evaluator variants against their plain versions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('name', EVALS)
def test_cuda_evaluator_kernels_match_plain(cuda, name):
    cell_dim, C = (3, 3, 3), 24
    d = _mega_inputs(name, cell_dim, C, 8)
    T = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    cells = (T(d['gp']).permute(1, 2, 3, 4, 0).reshape(-1, C, 3)
             .contiguous())
    tag = T(d['gt']).reshape(-1, C)
    args = (cells, cell_dim, T(d['shift']), T(d['pv']))
    ev = dict(eval_name=name, pnames=d['pn'])
    want = tcp.cell_pair_planar_plain(*args, cell_tag=tag, **ev)
    got = tcp.cell_pair_planar(*args, C=C, cell_tag=tag, **ev)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    got = tcp.cell_pair_plane(*args, C=C, cell_tag=tag, **ev)
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)
    mk = dict(k=2, method='nvt', ndof=3.0 * d['N'], tau_inv2=4.0,
              gt=T(d['gt']), C=C, **ev)
    margs = (T(d['gp']), T(d['gv']), T(d['gf']), T(d['gw']), T(d['gm']),
             T(d['gp']), cell_dim, T(d['shift']), T(d['pv']), 0.004,
             torch.full((2,), 1.1, device=cuda), 0.05, 0.0,
             torch.full((3,), 0.6, device=cuda))
    cand = tcp.mega_candidates(
        margs[5], mk['gt'].to(torch.int32), cell_dim, margs[7],
        tcp.candidate_pads(0.6, np.abs(d['shift']).max()),
        float(d['pv'][0]), C=C)
    got = tcp.cell_megastep_planes(*margs, recip='div', cand=cand, **mk)
    want = tcp.cell_megastep_planes_plain(*margs, **mk)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    sargs = (T(d['gp']), T(d['gv']), T(d['gf']), T(d['gw']), T(d['gp']),
             cell_dim, T(d['shift']), T(d['pv']), 0.004,
             torch.tensor(0.999, device=cuda))
    got = tcp.cell_step_plane_planes(*sargs, C=C, gt=T(d['gt']),
                                     recip='div', **ev)
    want = tcp.cell_step_plane_planes_plain(*sargs, C=C, gt=T(d['gt']), **ev)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for i in (1, 2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-4)
