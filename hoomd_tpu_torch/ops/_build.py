"""Build and load the CUDA kernels of hoomd_tpu_torch/csrc.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a into one shared library
with a plain C interface, at first use, into ``hoomd_tpu_torch/_build/``
(listed in .gitignore).  The library is keyed by a hash of the sources,
so an edit rebuilds it and an unchanged tree reuses it.  It is loaded
with ctypes: every pointer and the stream go over as ``c_void_p``, and
every C entry point returns ``cudaGetLastError()``, which ``check``
turns into an exception.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '--ptxas-options=-v']

P = ctypes.c_void_p
LL = ctypes.c_longlong
I = ctypes.c_int
_SIGNATURES = {
    'hoomd_cell_pair_plane': [P, LL, LL, P, P, P, P, LL, LL, I, I, I, I, I, P],
    'hoomd_cell_pair_planar': [P, LL, LL, P, P, P, P, P, P, I, I, I, I, P],
    'hoomd_megastep': [P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, P],
}


class KernelLibrary:
    """The loaded kernel library, with how it was built."""

    def __init__(self, lib, path, seconds, log):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds     # 0.0 when a cached build was reused
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


def source_hash():
    h = hashlib.sha256()
    for f in sorted(SRC_DIR.glob('*.cu*')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load():
    """Build (if needed) and load the kernel library."""
    key = source_hash()
    if key in _LOADED:
        return _LOADED[key]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f'libhoomd_tpu_torch_{key}.so'
    log = ''
    seconds = 0.0
    if not out.exists():
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               *map(str, sorted(SRC_DIR.glob('*.cu')))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hoomd_error_string.argtypes = [I]
    lib.hoomd_error_string.restype = ctypes.c_char_p
    kl = KernelLibrary(lib, out, seconds, log)
    _LOADED[key] = kl
    return kl
