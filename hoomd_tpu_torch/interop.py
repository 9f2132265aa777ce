"""numpy arrays from the JAX package -> the port's objects (snapshots,
fast-engine carries, pair parameter tables, PPPM parameters, bonded group
tables and their parameters, hull tables, cell planes).

The parity tests feed both packages identical inputs through these
functions: the JAX side's arrays go through numpy, never as JAX arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .snapshot import Snapshot


def snapshot_from_numpy(snap, particle_types=None):
    """A hoomd_tpu Snapshot (or any object with the same particle and box
    attributes) -> a hoomd_tpu_torch Snapshot with copied arrays."""
    p = snap.particles
    out = Snapshot(p.N, particle_types=particle_types or list(p.types))
    b = snap.box
    out.box.Lx, out.box.Ly, out.box.Lz = float(b.Lx), float(b.Ly), float(b.Lz)
    out.box.xy, out.box.xz, out.box.yz = float(b.xy), float(b.xz), float(b.yz)
    out.box.dimensions = int(b.dimensions)
    q = out.particles
    for name in ('position', 'velocity', 'acceleration', 'typeid', 'mass',
                 'charge', 'diameter', 'image', 'body', 'orientation',
                 'angmom', 'moment_inertia'):
        getattr(q, name)[:] = np.asarray(getattr(p, name))
    return out


_CARRY_DTYPES = {'img': torch.int32, 'tag': torch.int32, 'typ': torch.int32}


def carry_from_numpy(fields, device='cpu'):
    """{name: array} of a JAX FastCarry's array fields (pos, vel, frc, pe,
    vir, img, tag, typ, mass, ref_pos, ...) -> {name: tensor} with the
    port's dtypes, on ``device``."""
    out = {}
    for k, v in fields.items():
        dt = _CARRY_DTYPES.get(k, torch.float32)
        out[k] = torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    return out


def pair_tables_from_numpy(pv, ntypes, device='cpu', eval_name='lj'):
    """The JAX package's fast-engine parameter array (its ``_fast_dyn()
    ['pv']``: [rc2, e_shift, *pnames], (2 + NP,) for one type or the
    (2 + NP, T, T) per-pair table of a mixture; for a charged job, eval_name
    'ewald' or 'lj_ewald', the merged table of its charged branch) -> the
    float32 tensor the port's kernels take, after checking its shape
    against ``ntypes`` and the kernel parameter order of ``eval_name``
    (pair_eval.kernel_pnames)."""
    from .ops import pair_eval
    pv = np.array(pv, np.float32)
    n = 2 + len(pair_eval.kernel_pnames(eval_name))
    want = (n,) if ntypes == 1 else (n, ntypes, ntypes)
    if pv.shape != want:
        raise ValueError(f"{eval_name} with {ntypes} type(s) takes a table of "
                         f"shape {want}, got {pv.shape}")
    return torch.as_tensor(pv, device=device)


def pppm_params_from_numpy(params, device='cpu'):
    """The JAX package's pppm._pack_params dict ({'kappa', 'bmod': three
    arrays, 'mvec': three arrays}) -> the float32 tensors of the port's
    md.charge.mesh_compute, on ``device``."""
    def T(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    return {'kappa': T(params['kappa']),
            'bmod': tuple(T(b) for b in params['bmod']),
            'mvec': tuple(T(m) for m in params['mvec'])}


def lj_params_from_numpy(pv, device='cpu'):
    """Packed [rc2, e_shift, lj1, lj2, rcut] -> float32 tensor."""
    return torch.as_tensor(np.asarray(pv, np.float32), device=device)


def poly_tables_from_numpy(tables):
    """The JAX package's fused-sweep hull tables (V, F, E), as nested
    tuples or arrays -> the nested tuples of floats the port's
    fused_poly_sweep takes."""
    return tuple(tuple(tuple(float(x) for x in row) for row in np.asarray(t))
                 for t in tables)


def planes_from_numpy(planes, device='cpu'):
    """Cell planes (or any float arrays: randu, positions) -> float32
    tensors on ``device``."""
    return [torch.as_tensor(np.asarray(p, np.float32), device=device)
            for p in planes]


def bonded_groups_from_numpy(groups, device='cpu'):
    """A JAX package's bonded group table ((M, arity) tags or slots: a
    snapshot's bonds.group, angles.group, or a fast program's excl_pairs)
    -> the int64 tensor ops.bonded takes, on ``device``."""
    return torch.as_tensor(np.array(groups, np.int64), device=device)


def bonded_params_from_numpy(params, device='cpu'):
    """A JAX package's per-group parameter dict (a bonded force's
    _pack_params, or an entry of its fast engine's dyn['bonded']: name ->
    (M,) array) -> name -> float32 tensor on ``device``, as ops.bonded's
    terms and the port's dyn['bonded'] take it."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in params.items()}
