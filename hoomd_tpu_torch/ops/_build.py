"""Build and load the CUDA kernels of hoomd_tpu_torch/csrc.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for sm_90a into a
shared library with a plain C interface, all sources at once in
parallel, at first use, into ``hoomd_tpu_torch/_build/`` (listed in
.gitignore).  A library is keyed by a hash of its source, the shared
headers and the flags, so an edit rebuilds only what it touches and an
unchanged tree reuses every library.  They are loaded with ctypes: every
pointer and the stream go over as ``c_void_p``, and every C entry point
returns ``cudaGetLastError()``, which ``check`` turns into an exception.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '--ptxas-options=-v']

P = ctypes.c_void_p
LL = ctypes.c_longlong
I = ctypes.c_int
F = ctypes.c_float
_SIGNATURES = {
    'hoomd_cell_pair_plane': [P, LL, LL, P, P, P, I, P, LL, LL, I, I, I, I,
                              I, I, P],
    'hoomd_cell_pair_planar': [P, LL, LL, P, P, P, I, P, P, P, I, I, I, I, I,
                               P],
    'hoomd_cell_pair_plane_occupancy': [I, I, I, I, P],
    'hoomd_cell_pair_planar_occupancy': [I, I, I, P],
    'hoomd_megastep': [P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, I, P,
                       P, I, I, I, I, I, I, I, I, P],
    'hoomd_mega_candidates': [P, P, P, F, F, F, F, P, P, I, I, I, I, I, P],
    'hoomd_mega_candidates_occupancy': [I, I, P],
    'hoomd_step_plane': [P, P, P, P, P, P, P, P, I, P, F, P, P, P, P, P,
                         I, I, I, I, I, I, P],
    'hoomd_step_plane_occupancy': [I, I, I, I, P],
    'hoomd_cell_pair_lj': [P, P, P, P, P, P, P, P, I, I, P],
    'hoomd_cell_pair_lj_occupancy': [I, P],
    'hoomd_cell_pair_lj3d': [P, P, P, P, P, I, I, I, I, P],
    'hoomd_cell_pair_lj3d_occupancy': [I, P],
    'hoomd_cell_pair_lj_row': [P, P, P, P, P, I, I, I, I, I, P],
    'hoomd_cell_pair_lj_row_occupancy': [I, I, P],
    'hoomd_cell_pair_n3l': [P, P, P, P, P, I, I, P, P, I, I, I, I, I, I, P],
    'hoomd_cell_pair_planar_typed': [P, P, P, P, P, I, I, P, P, P, I, I, I,
                                     I, I, I, I, P],
    'hoomd_planar_typed_occupancy': [I, I, I, I, I, P],
    'hoomd_n3l_occupancy': [I, I, I, I, I, P],
    'hoomd_cell_pair_planar_q': [P, P, P, P, P, P, I, I, P, P, P, I, I, I, I,
                                 I, I, P],
    'hoomd_planar_q_occupancy': [I, I, I, I, I, I, P],
    'hoomd_hpmc_sphere_sweep': [P, P, P, P, P, P, P, P, P, I, P, P,
                                I, I, I, I, F, F, F, P],
    'hoomd_hpmc_sphere_occupancy': [I, P],
    'hoomd_hpmc_poly_sweep': [P, P, P, P, P, P, P, P, P, P, P, I, P, P,
                              P, I, I, I, F, F, F,
                              I, I, I, I, F, F, F, P],
    'hoomd_hpmc_poly_occupancy': [I, P],
    'hoomd_rebin_select': [P, P, P, P, F, F, F, F, F, F, I, I, I, I, P],
    'hoomd_rebin_sweep': [P, P, P, P, F, F, F, F, F, F, I, I, I, I, I, I, I,
                          P],
    'hoomd_rebin_sweep_occupancy': [I, I, I, I, I, I, P],
    'hoomd_rebin_place': [P, P, P, P, F, F, F, F, F, F, I, I, I, I, I, I, P],
    'hoomd_rebin_place_occupancy': [I, I, P],
    'hoomd_rebin_serial': [P, P, P, P, P, P, F, F, F, F, F, F,
                           I, I, I, I, I, P],
}


class KernelLibrary:
    """The loaded kernel libraries, with how they were built.  ``lib``
    holds every C entry point of ``_SIGNATURES`` by name."""

    def __init__(self, lib, paths, seconds, log):
        self.lib = lib
        self.paths = paths
        self.build_seconds = seconds     # 0.0 when cached builds were reused
        self.build_log = log

    def check(self, err, what):
        if err != 0:
            msg = self.lib.hoomd_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_LOADED = {}


def _nvcc():
    cands = [os.environ.get('CUDA_HOME'), '/usr/local/cuda']
    for c in cands:
        if c and Path(c, 'bin', 'nvcc').exists():
            return str(Path(c, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hoomd_tpu_torch are built on the machine with "
                           "the card, which needs the CUDA toolkit")
    return found


def _hash(files):
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _targets():
    """(source, library path) for every csrc/*.cu."""
    headers = sorted(SRC_DIR.glob('*.cuh'))
    return [(src, BUILD_DIR / f'lib{src.stem}_{_hash([src] + headers)}.so')
            for src in sorted(SRC_DIR.glob('*.cu'))]


def source_hash():
    return _hash(sorted(SRC_DIR.glob('*.cu*')))


def load():
    """Build (where needed, every source in parallel) and load the kernel
    libraries."""
    key = source_hash()
    if key in _LOADED:
        return _LOADED[key]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = _targets()
    t0 = time.perf_counter()
    jobs = []
    for src, out in targets:
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ''
    failed = []
    for src, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        log += f'== {src.name}\n{text}'
        if proc.returncode != 0:
            failed.append(f'{src.name} ({proc.returncode})')
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    seconds = time.perf_counter() - t0 if jobs else 0.0
    cdlls = [ctypes.CDLL(str(out)) for _, out in targets]
    fns = {}
    for name, argtypes in list(_SIGNATURES.items()) + [
            ('hoomd_error_string', [I])]:
        lib = next((c for c in cdlls if hasattr(c, name)), None)
        if lib is None:
            raise RuntimeError(f"no kernel library exports {name}")
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_char_p if name == 'hoomd_error_string'
                      else ctypes.c_int)
        fns[name] = fn
    kl = KernelLibrary(types.SimpleNamespace(**fns),
                       [out for _, out in targets], seconds, log)
    _LOADED[key] = kl
    return kl
