"""hoomd_tpu_torch cell rebin against the JAX package.

The port's plain versions of the plane-local rebin (cell_rebin_plane with
variants 'select', 'grid' and the serial program) and of the staged
xsel rebin (cell_rebin_xsel, cell_rebin_xsel_planes) are held against
the JAX package's functions on identical numpy inputs: the three shapes
and the drifted fill of tests/test_rebin.py.  The JAX side runs its
Pallas kernels in interpret mode.  Agreement is exact, slot for slot, on
all 14 columns (value equality, so a zero's sign is not compared), with
equal overflow flags: slot order decides the summation order of the next
force evaluation, so the port must reproduce the JAX layout, not only the
per-tag result.  A numpy oracle (each particle in the cell of its wrapped
position, payload unchanged) checks the port on its own as well.

The cases marked ``gpu`` hold each CUDA kernel (select, sweep, place,
serial) against its plain version on the card, bit for bit with equal
flags; they skip where torch sees no CUDA device.  This file imports jax
only inside the JAX-side helper, so they also run where jax is missing:

    python -m pytest tests/test_torch_rebin.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from hoomd_tpu_torch.ops import cell_rebin as tr

# the suite runs several pytest workers at once; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

PAD = 1.0e9
# tests/test_rebin.py's grids, capacities and fills
SHAPES = [((4, 4, 4), 24, (6, 10)), ((5, 3, 4), 32, (10, 14)),
          ((3, 3, 3), 24, (4, 8))]
SHAPE_IDS = ['4x4x4', '5x3x4', '3x3x3']


def _mkconfig(rng, cell_dim, C, L, fill_lo, fill_hi, margin=0.45):
    """tests/test_rebin.py's generator, draw for draw: binned interior
    points, then a drift of up to margin * w per axis."""
    nx, ny, nz = cell_dim
    nc = nx * ny * nz
    w = np.array([L[0] / nx, L[1] / ny, L[2] / nz])
    pos = np.full((nc, C, 3), PAD, np.float32)
    vel = np.zeros((nc, C, 3), np.float32)
    frc = np.zeros((nc, C, 3), np.float32)
    img = np.zeros((nc, C, 3), np.int32)
    tag = np.full((nc, C), -1, np.int32)
    mass = np.ones((nc, C), np.float32)
    t = 0
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                c = ix + nx * (iy + ny * iz)
                k = rng.randint(fill_lo, fill_hi + 1)
                org = np.array([ix, iy, iz]) * w - np.array(L) / 2
                u = rng.uniform(0.02, 0.98, (k, 3))
                pos[c, :k] = (org + u * w).astype(np.float32)
                vel[c, :k] = rng.randn(k, 3)
                frc[c, :k] = rng.randn(k, 3)
                img[c, :k] = rng.randint(-3, 4, (k, 3))
                tag[c, :k] = np.arange(t, t + k)
                mass[c, :k] = rng.uniform(0.5, 2.0, k)
                t += k
    drift = rng.uniform(-margin, margin, (nc, C, 3)) * w
    live = tag >= 0
    pos[live] = pos[live] + drift[live].astype(np.float32)
    return pos, vel, frc, img, tag, mass, t


def _case(i):
    """(inputs, cell_dim, C, L) of shape i, as tests/test_rebin.py."""
    cell_dim, C, fill = SHAPES[i]
    rng = np.random.RandomState(7)
    L = (float(cell_dim[0]) * 3.1, float(cell_dim[1]) * 3.3,
         float(cell_dim[2]) * 2.9)
    return _mkconfig(rng, cell_dim, C, L, *fill)[:6], cell_dim, C, L


def _port(variant, arrays, cell_dim, C, L, E=8, device='cpu'):
    """The port's op on numpy inputs; numpy outputs, bool flag(s)."""
    ts = [torch.as_tensor(a, device=device) for a in arrays]
    Lf = np.asarray(L, np.float32)
    if variant == 'xsel':
        out = tr.cell_rebin_xsel(*ts, cell_dim, Lf, C=C)
    elif variant == 'xsel_planes':
        out = _planes_call(tr.cell_rebin_xsel_planes, ts, cell_dim, C, Lf,
                           torch)
    else:
        out = tr.cell_rebin_plane(*ts, cell_dim, Lf, C=C, E=E,
                                  variant=variant)
    return [o.cpu().numpy() for o in out]


def _planes_call(fn, arrays, cell_dim, C, L, xp):
    """Call a plane-layout xsel entry (xp: torch or jax.numpy) with
    cell-major arrays and bring its outputs back to cell-major."""
    nx, ny, nz = cell_dim
    nc = nx * ny * nz

    def to_p(a):
        return xp.moveaxis(a.reshape(nz, ny, nx, C, 3), -1, 0)

    def from_p(a):
        return xp.moveaxis(a, 0, -1).reshape(nc, C, 3)
    pos, vel, frc, img, tag, mass = arrays
    gp, gv, gf, gim, gtag, gmass, cap_ovf, lost = fn(
        to_p(pos), to_p(vel), to_p(frc), to_p(img),
        tag.reshape(nz, ny, nx, C), mass.reshape(nz, ny, nx, C), cell_dim,
        L, C=C)
    return (from_p(gp), from_p(gv), from_p(gf), from_p(gim),
            gtag.reshape(nc, C), gmass.reshape(nc, C), cap_ovf, lost)


_JAX_CACHE = {}


def _jax(variant, arrays, cell_dim, C, L, E=8, key=None):
    """The JAX package's function (Pallas in interpret mode) on the same
    inputs; numpy outputs.  Results are cached by ``key``."""
    if key is not None and (key, variant) in _JAX_CACHE:
        return _JAX_CACHE[key, variant]
    import jax.numpy as jnp
    from hoomd_tpu.ops import pallas_rebin as jr
    js = [jnp.asarray(a) for a in arrays]
    Lj = jnp.asarray(L, jnp.float32)
    if variant == 'xsel':
        out = jr.cell_rebin_xsel(*js, cell_dim, Lj, C=C)
    elif variant == 'xsel_planes':
        out = _planes_call(jr.cell_rebin_xsel_planes, js, cell_dim, C, Lj,
                           jnp)
    else:
        out = jr.cell_rebin_plane(*js, cell_dim, Lj, C=C, E=E,
                                  interpret=True, variant=variant)
    out = [np.asarray(o) for o in out]
    if key is not None:
        _JAX_CACHE[key, variant] = out
    return out


def _assert_same_slots(got, want):
    names = ('pos', 'vel', 'frc', 'img', 'tag', 'mass')
    for name, g, w in zip(names, got[:6], want[:6]):
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert [bool(f) for f in got[6:]] == [bool(f) for f in want[6:]]


def _oracle_check(out, arrays, cell_dim, L):
    """Every live particle sits in the cell of its wrapped position (one
    crossing per axis at most), shifted by -+L with its image counted,
    its payload unchanged; padding slots carry the fill."""
    pos, vel, frc, img, tag, mass = arrays
    p2, v2, f2, i2, t2, m2 = out[:6]
    nx, ny, nz = cell_dim
    w = np.array([L[0] / nx, L[1] / ny, L[2] / nz], np.float32)
    src = {int(tag[c, s]): (c, s) for c, s in zip(*np.nonzero(tag >= 0))}
    live = t2 >= 0
    assert sorted(t2[live].tolist()) == sorted(src)
    for c, s in zip(*np.nonzero(live)):
        c0, s0 = src[int(t2[c, s])]
        p = pos[c0, s0].copy()
        im = img[c0, s0].copy()
        cid3 = np.floor((p + np.asarray(L, np.float32) / 2) / w).astype(int)
        for a, n in enumerate((nx, ny, nz)):
            if cid3[a] >= n:
                cid3[a] -= n
                p[a] = np.float32(p[a] - np.float32(L[a]))
                im[a] += 1
            elif cid3[a] < 0:
                cid3[a] += n
                p[a] = np.float32(p[a] + np.float32(L[a]))
                im[a] -= 1
        assert c == cid3[0] + nx * (cid3[1] + ny * cid3[2])
        np.testing.assert_array_equal(p2[c, s], p)
        np.testing.assert_array_equal(i2[c, s], im)
        np.testing.assert_array_equal(v2[c, s], vel[c0, s0])
        np.testing.assert_array_equal(f2[c, s], frc[c0, s0])
        assert m2[c, s] == mass[c0, s0]
    assert np.all(p2[~live] == PAD) and np.all(m2[~live] == 1.0)


# ---------------------------------------------------------------------------
# the port's plain versions against the JAX package, on the CPU


@pytest.mark.parametrize('variant', ['select', 'grid', 'serial'])
@pytest.mark.parametrize('shape', range(3), ids=SHAPE_IDS)
def test_plane_rebin_matches_jax(shape, variant):
    """The serial program is the 'grid' function as one kernel (its
    sweep1/z_place bodies are the sweep and place kernels'): the JAX
    serial variant runs at the 3x3x3 shape and, to keep this file's
    interpret-mode compiles few, the JAX 'grid' result stands in for it
    at the other two."""
    arrays, cell_dim, C, L = _case(shape)
    got = _port(variant, arrays, cell_dim, C, L)
    jvariant = 'grid' if variant == 'serial' and shape != 2 else variant
    want = _jax(jvariant, arrays, cell_dim, C, L, key=shape)
    _assert_same_slots(got, want)
    assert not bool(got[6])


@pytest.mark.parametrize('variant', ['xsel', 'xsel_planes'])
@pytest.mark.parametrize('shape', range(3), ids=SHAPE_IDS)
def test_xsel_matches_jax(shape, variant):
    arrays, cell_dim, C, L = _case(shape)
    got = _port(variant, arrays, cell_dim, C, L)
    want = _jax(variant, arrays, cell_dim, C, L)
    _assert_same_slots(got, want)
    assert not (bool(got[6]) or bool(got[7]))


@pytest.mark.parametrize('variant', ['select', 'grid', 'serial', 'xsel'])
@pytest.mark.parametrize('shape', range(3), ids=SHAPE_IDS)
def test_rebin_matches_oracle(shape, variant):
    arrays, cell_dim, C, L = _case(shape)
    _oracle_check(_port(variant, arrays, cell_dim, C, L), arrays, cell_dim,
                  L)


def _overflow_case():
    """tests/test_rebin.py's overflow input: 12 particles of cell 0 all
    past its +x face, with E = 8."""
    cell_dim, C, nc = (3, 3, 3), 32, 27
    L = (9.0, 9.0, 9.0)
    pos = np.full((nc, C, 3), PAD, np.float32)
    tag = np.full((nc, C), -1, np.int32)
    pos[0, :12] = np.array([3.1, 1.5, 1.5], np.float32) - 4.5
    tag[0, :12] = np.arange(12)
    z3 = np.zeros((nc, C, 3), np.float32)
    arrays = (pos, z3, z3, np.zeros((nc, C, 3), np.int32), tag,
              np.ones((nc, C), np.float32))
    return arrays, cell_dim, C, L


def _crowded_case():
    """A select window with more claimants than C = 8: cell 1 keeps its 8
    particles and receives cell 0's 8, all past cell 0's +x face."""
    cell_dim, C, nc = (3, 3, 3), 8, 27
    L = (9.0, 9.0, 9.0)
    pos = np.full((nc, C, 3), PAD, np.float32)
    tag = np.full((nc, C), -1, np.int32)
    pos[0] = np.array([3.1, 1.5, 1.5], np.float32) - 4.5
    pos[1] = np.array([4.5, 1.5, 1.5], np.float32) - 4.5
    tag[0] = np.arange(C)
    tag[1] = np.arange(C, 2 * C)
    z3 = np.zeros((nc, C, 3), np.float32)
    arrays = (pos, z3, z3, np.zeros((nc, C, 3), np.int32), tag,
              np.ones((nc, C), np.float32))
    return arrays, cell_dim, C, L


def test_emigrant_overflow_flags_in_both():
    """More than E emigrants through one face flags in the JAX package
    and in the port's sweep and serial program, with the same slots
    (the 4 emigrants past E are dropped in both)."""
    arrays, cell_dim, C, L = _overflow_case()
    want = _jax('grid', arrays, cell_dim, C, L)
    assert bool(want[6])
    for variant in ('grid', 'serial'):
        got = _port(variant, arrays, cell_dim, C, L)
        _assert_same_slots(got, want)
    # the select variant has no emigrant buffer: 12 claimants fit C = 32
    assert not bool(_port('select', arrays, cell_dim, C, L)[6])


def test_select_overflow_flags_in_both():
    """More than C claimants of one cell flags the select variant in the
    JAX package and the port, with the same slots (the excess dropped)."""
    arrays, cell_dim, C, L = _crowded_case()
    want = _jax('select', arrays, cell_dim, C, L)
    assert bool(want[6])
    _assert_same_slots(_port('select', arrays, cell_dim, C, L), want)


def test_idempotent_when_binned_matches_jax():
    """A binned configuration with zero drift passes through with every
    cell's tags kept, and the port's slots equal the JAX package's."""
    rng = np.random.RandomState(3)
    # the 4x4x4 shape's capacity, whose JAX 'grid' program is compiled
    cell_dim, C, L = (4, 4, 4), 24, (12.0, 12.0, 12.0)
    arrays = _mkconfig(rng, cell_dim, C, L, 5, 9, margin=0.0)[:6]
    want = _jax('grid', arrays, cell_dim, C, L)
    tag = arrays[4]
    for variant in ('grid', 'serial', 'select'):
        got = _port(variant, arrays, cell_dim, C, L)
        assert not bool(got[6])
        if variant != 'select':
            _assert_same_slots(got, want)
        t2 = got[4]
        for c in range(tag.shape[0]):
            assert (set(t2[c][t2[c] >= 0].tolist())
                    == set(tag[c][tag[c] >= 0].tolist()))


def test_place_counts_free_slots_in_both():
    """More immigrants than free slots flags: cell 0 full (C slots) and
    its +x neighbour's emigrants arriving, in the JAX package and the
    port alike, with the same slots."""
    cell_dim, C, nc = (3, 3, 3), 32, 27       # the overflow case's plan
    L = (9.0, 9.0, 9.0)
    pos = np.full((nc, C, 3), PAD, np.float32)
    tag = np.full((nc, C), -1, np.int32)
    rng = np.random.RandomState(5)
    pos[0] = (rng.uniform(0.1, 2.9, (C, 3)) - 4.5).astype(np.float32)
    tag[0] = np.arange(C)
    # three particles of cell 1 (ix = 1) past its -x face, into cell 0
    pos[1, :3] = np.array([2.9, 1.5, 1.5], np.float32) - 4.5
    tag[1, :3] = np.arange(C, C + 3)
    z3 = np.zeros((nc, C, 3), np.float32)
    arrays = (pos, z3, z3, np.zeros((nc, C, 3), np.int32), tag,
              np.ones((nc, C), np.float32))
    want = _jax('grid', arrays, cell_dim, C, L)
    assert bool(want[6])
    _assert_same_slots(_port('serial', arrays, cell_dim, C, L), want)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "on the card)")
    return torch.device('cuda', 0)


def _cols(arrays, cell_dim, C, dev):
    return tr.to_cols(*[torch.as_tensor(a, device=dev) for a in arrays],
                      cell_dim, C)


def _kernel_vs_plain(kernel, plain, args, kw):
    n0 = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    assert kernel.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize('E', [8, 16])
@pytest.mark.parametrize('shape', range(3), ids=SHAPE_IDS)
def test_cuda_rebin_kernels_match_plain(cuda, shape, E):
    arrays, cell_dim, C, L = _case(shape)
    cols = _cols(arrays, cell_dim, C, cuda)
    par = tr.rebin_params(L, cell_dim)
    _kernel_vs_plain(tr.cell_rebin_select, tr.cell_rebin_select_plain,
                     (cols, cell_dim, par), dict(C=C))
    swept, emz, _ = _kernel_vs_plain(
        tr.cell_rebin_sweep, tr.cell_rebin_sweep_plain,
        (cols, cell_dim, par), dict(C=C, E=E))
    _kernel_vs_plain(tr.cell_rebin_place, tr.cell_rebin_place_plain,
                     (swept, emz, cell_dim, par), dict(C=C, E=E))
    _kernel_vs_plain(tr.cell_rebin_serial, tr.cell_rebin_serial_plain,
                     (cols, cell_dim, par), dict(C=C, E=E))


@pytest.mark.gpu
def test_cuda_rebin_kernels_flag_overflow(cuda):
    arrays, cell_dim, C, L = _overflow_case()
    cols = _cols(arrays, cell_dim, C, cuda)
    par = tr.rebin_params(L, cell_dim)
    swept, emz, o = _kernel_vs_plain(
        tr.cell_rebin_sweep, tr.cell_rebin_sweep_plain,
        (cols, cell_dim, par), dict(C=C, E=8))
    assert bool(o)
    _, o = _kernel_vs_plain(tr.cell_rebin_serial, tr.cell_rebin_serial_plain,
                            (cols, cell_dim, par), dict(C=C, E=8))
    assert bool(o)
    arrays, cell_dim, C, L = _crowded_case()
    _, o = _kernel_vs_plain(tr.cell_rebin_select, tr.cell_rebin_select_plain,
                            (_cols(arrays, cell_dim, C, cuda), cell_dim,
                             tr.rebin_params(L, cell_dim)), dict(C=C))
    assert bool(o)
