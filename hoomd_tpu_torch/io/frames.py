"""Frame store on the GSD v1 container — checkpoints + trajectories
(the port's own copy of hoomd_tpu/io/frames.py, the same files on disk).

Writes real GSD files (hoomd/extern/gsd.c layout via
``io.gsd_binary.GSDFile``) with the HOOMD schema chunk names
(GSDDumpWriter.cc:160, GSDReader.h:36-96): ``configuration/step``,
``particles/position``, topology chunks, plus ``state/*`` chunks for
per-operation restart data (thermostat xi/eta, RNG cursors, ...).
Output opens in gsd-python / VMD / OVITO; files written by the
reference's dump.gsd read back through :class:`FrameReader`, using the
GSD frame-0 fallback rule for chunks omitted on later frames.

Files of the JAX package's older HTPF container are still readable
(magic-dispatched legacy path).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

from .gsd_binary import GSD_MAGIC, GSDFile

HTPF_MAGIC = b"HTPF0001"
_GSD_MAGIC_BYTES = struct.pack('<Q', GSD_MAGIC)

# canonical HOOMD-schema dtypes (GSDDumpWriter.cc writeFrameHeader/
# writeAttributes/writeProperties/writeMomenta + writeTopology)
_SCHEMA_DTYPE = {
    'configuration/step': np.uint64,
    'configuration/dimensions': np.uint8,
    'configuration/box': np.float32,
    'particles/N': np.uint32,
    'particles/typeid': np.uint32,
    'particles/image': np.int32,
    'particles/body': np.int32,
}
for _n in ('position', 'velocity', 'acceleration', 'mass', 'charge',
           'diameter', 'orientation', 'angmom', 'moment_inertia'):
    _SCHEMA_DTYPE[f'particles/{_n}'] = np.float32
for _k in ('bonds', 'angles', 'dihedrals', 'impropers', 'constraints',
           'pairs'):
    _SCHEMA_DTYPE[f'{_k}/N'] = np.uint32
    _SCHEMA_DTYPE[f'{_k}/typeid'] = np.uint32
    _SCHEMA_DTYPE[f'{_k}/group'] = np.uint32
    _SCHEMA_DTYPE[f'{_k}/value'] = np.float32

_open_writers = []


def flush_writes():
    """Block until queued frame writes hit the disk."""
    for w in list(_open_writers):
        w.flush()


def _encode_types(names):
    """Type-name list -> (n, max_len+1) null-padded uint8 chunk
    (GSDDumpWriter::writeTypeMapping, GSDDumpWriter.cc:284-302)."""
    names = [str(n) for n in names]
    max_len = max((len(n) for n in names), default=0) + 1
    out = np.zeros((len(names), max_len), dtype=np.uint8)
    for i, n in enumerate(names):
        b = n.encode()
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out


def _decode_types(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind == 'U':            # legacy HTPF frames
        return [str(x) for x in arr]
    out = []
    for row in np.atleast_2d(arr):
        out.append(bytes(row.astype(np.uint8)).split(b'\0', 1)[0].decode())
    return out


def _frame_to_chunks(snap, timestep, op_state=None):
    """Snapshot -> flat dict of schema-typed chunks."""
    c = {}
    c['configuration/step'] = np.array([timestep], dtype=np.uint64)
    c['configuration/dimensions'] = np.array([snap.box.dimensions],
                                             dtype=np.uint8)
    c['configuration/box'] = np.array(
        [snap.box.Lx, snap.box.Ly, snap.box.Lz,
         snap.box.xy, snap.box.xz, snap.box.yz], dtype=np.float32)
    p = snap.particles
    c['particles/N'] = np.array([p.N], dtype=np.uint32)
    c['particles/types'] = _encode_types(p.types)
    for name in ('position', 'velocity', 'acceleration', 'typeid', 'mass',
                 'charge', 'diameter', 'image', 'body', 'orientation',
                 'angmom', 'moment_inertia'):
        key = f'particles/{name}'
        c[key] = np.asarray(getattr(p, name), dtype=_SCHEMA_DTYPE[key])
    for kind in ('bonds', 'angles', 'dihedrals', 'impropers', 'constraints',
                 'pairs'):
        t = getattr(snap, kind)
        c[f'{kind}/N'] = np.array([t.N], dtype=np.uint32)
        c[f'{kind}/types'] = _encode_types(t.types)
        c[f'{kind}/typeid'] = np.asarray(t.typeid, dtype=np.uint32)
        c[f'{kind}/group'] = np.asarray(t.group, dtype=np.uint32)
        c[f'{kind}/value'] = np.asarray(t.value, dtype=np.float32)
    if op_state:
        for k, v in op_state.items():
            a = np.asarray(v)
            if a.ndim != 1 and a.ndim != 2:   # GSD chunks are 1-D/2-D
                c[f'state/{k}#shape'] = np.asarray(a.shape, np.int64)
                a = (a.reshape(a.shape[0], -1) if a.ndim > 2
                     else a.reshape(1))
            c[f'state/{k}'] = a
    return c


def _chunks_to_frame(c):
    from ..snapshot import BoxSnapshot, Snapshot
    box = np.asarray(c['configuration/box'], dtype=np.float64)
    dims = int(np.asarray(c.get('configuration/dimensions', [3]))[0])
    bs = BoxSnapshot(box[0], box[1], box[2], box[3], box[4], box[5],
                     dimensions=dims)
    N = int(np.asarray(c['particles/N'])[0])
    snap = Snapshot(N, bs,
                    particle_types=_decode_types(c['particles/types']))
    p = snap.particles
    for name in ('position', 'velocity', 'acceleration', 'typeid', 'mass',
                 'charge', 'diameter', 'image', 'body', 'orientation',
                 'angmom', 'moment_inertia'):
        key = f'particles/{name}'
        if key in c:                      # external files omit defaults
            dst = getattr(p, name)
            dst[:] = np.asarray(c[key]).reshape(dst.shape).astype(dst.dtype)
    for kind in ('bonds', 'angles', 'dihedrals', 'impropers', 'constraints',
                 'pairs'):
        t = getattr(snap, kind)
        if f'{kind}/types' in c:
            t.types = _decode_types(c[f'{kind}/types'])
        t.resize(int(np.asarray(c.get(f'{kind}/N', [0]))[0]))
        if t.N:
            t.typeid[:] = np.asarray(c[f'{kind}/typeid'],
                                     dtype=t.typeid.dtype)
            t.group[:] = np.asarray(c[f'{kind}/group'],
                                    dtype=t.group.dtype).reshape(
                                        t.group.shape)
            if f'{kind}/value' in c:
                t.value[:] = np.asarray(c[f'{kind}/value'],
                                        dtype=t.value.dtype).reshape(
                                            t.value.shape)
    op_state = {}
    for k, v in c.items():
        if k.startswith('state/') and not k.endswith('#shape'):
            name = k[len('state/'):]
            a = np.asarray(v)
            shp = c.get(f'state/{name}#shape')
            if shp is not None:
                a = a.reshape(tuple(int(x) for x in np.asarray(shp)))
            op_state[name] = a
    timestep = int(np.asarray(c['configuration/step'])[0])
    return snap, timestep, op_state


class FrameWriter:
    """Append frames to a GSD file; ``truncate`` keeps only the newest
    frame (the reference dump.gsd truncate flag) via atomic rewrite."""

    def __init__(self, filename, overwrite=False, truncate=False):
        self.filename = filename
        self.truncate = truncate
        self._gsd = None
        if not truncate:
            self._gsd = GSDFile(filename, 'w' if overwrite else 'a')
            _open_writers.append(self)
        elif overwrite and os.path.exists(filename):
            os.remove(filename)

    def append(self, snap, timestep, op_state=None):
        chunks = _frame_to_chunks(snap, timestep, op_state)
        if self.truncate:
            _atomic_single_frame(self.filename, chunks)
            return
        for name, arr in chunks.items():
            self._gsd.write_chunk(name, arr)
        self._gsd.end_frame()

    def flush(self):
        if self._gsd is not None:
            self._gsd.flush()


def _atomic_single_frame(filename, chunks):
    tmp = filename + '.tmp'
    with GSDFile(tmp, 'w') as g:
        for name, arr in chunks.items():
            g.write_chunk(name, arr)
        g.end_frame()
    os.replace(tmp, filename)


def write_single_frame(filename, snap, timestep, op_state=None):
    """Atomic single-frame write (restart files, dump.gsd write_restart)."""
    flush_writes()   # don't let a queued periodic frame clobber us later
    _atomic_single_frame(filename,
                         _frame_to_chunks(snap, timestep, op_state))


class FrameReader:
    """Random access over the frames of a GSD (or legacy HTPF) file
    (GSDReader analog, hoomd/GSDReader.h:36-96)."""

    def __init__(self, filename):
        flush_writes()
        self.filename = filename
        with open(filename, 'rb') as f:
            magic = f.read(8)
        if magic == _GSD_MAGIC_BYTES:
            self._gsd = GSDFile(filename, 'r')
            self._n = self._gsd.nframes
            self._offsets = None
        elif magic == HTPF_MAGIC:
            self._gsd = None
            self._offsets = []
            with open(filename, 'rb') as f:
                f.seek(8)
                while True:
                    head = f.read(8)
                    if len(head) < 8:
                        break
                    (n,) = struct.unpack('<Q', head)
                    self._offsets.append((f.tell(), n))
                    f.seek(n, 1)
            self._n = len(self._offsets)
        else:
            raise IOError(f"{filename}: neither a GSD nor a hoomd_tpu "
                          f"frame file")

    def __len__(self):
        return self._n

    def read(self, frame=-1):
        """Returns (snapshot, timestep, op_state); negative frames index
        from the end.  Chunks absent at ``frame`` fall back to frame 0
        (the GSD convention for static data, gsd.c gsd_find_chunk use
        in GSDReader.cc)."""
        if frame < 0:
            frame = self._n + frame
        if not (0 <= frame < self._n):
            raise IndexError(f"frame {frame} of {self._n}")
        if self._gsd is not None:
            names = set(self._gsd.frame_chunks(frame))
            names |= set(self._gsd.frame_chunks(0))
            c = {}
            for nm in names:
                src = frame if self._gsd.chunk_exists(frame, nm) else 0
                c[nm] = self._gsd.read_chunk(src, nm)
            return _chunks_to_frame(c)
        off, n = self._offsets[frame]
        with open(self.filename, 'rb') as f:
            f.seek(off)
            blob = f.read(n)
        buf = io.BytesIO(zlib.decompress(blob))
        with np.load(buf, allow_pickle=False) as z:
            c = {k: z[k] for k in z.files}
        return _chunks_to_frame(c)
