"""GSD v1 on-disk container (the port's own copy of
hoomd_tpu/io/gsd_binary.py) — binary-compatible with the reference's
vendored gsd (hoomd/extern/gsd.c, gsd.h:46-88) and the external
gsd-python / VMD / OVITO readers.

Layout (all little-endian, from gsd.h):
  header   256 B: magic u64 = 0x65DF65DF65DF65DF, index_location u64,
           index_allocated_entries u64, namelist_location u64,
           namelist_allocated_entries u64, schema_version u32
           (0xAAAABBBB => AAAA.BBBB), gsd_version u32, application
           char[64], schema char[64], reserved char[80]
  index    32 B/entry: frame u64, N u64, location i64, M u32, id u16,
           type u8, flags u8 — sorted by (frame, id); location == 0
           marks an unused slot
  namelist 64 B/entry: null-padded chunk name; entry i defines id i

Clean-room Python implementation of the format with gsd.c's own write
discipline: the index and namelist blocks are preallocated after the
header, entries are written in place as frames commit (so the file is
valid on disk after every frame), and a full block is relocated to EOF
at double capacity (the old block becomes dead space, exactly as
gsd.c's gsd_expand_index does).
"""

from __future__ import annotations

import os
import struct

import numpy as np

GSD_MAGIC = 0x65DF65DF65DF65DF
_HEADER_FMT = '<QQQQQII64s64s80s'
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)        # 256
_INDEX_FMT = '<QQqIHBB'
_INDEX_SIZE = struct.calcsize(_INDEX_FMT)          # 32
_NAME_SIZE = 64
_INITIAL_INDEX_CAP = 128
_INITIAL_NAME_CAP = 128

# gsd.h:21-31 enum gsd_type
_DTYPE_TO_GSD = {
    np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
    np.dtype(np.uint32): 3, np.dtype(np.uint64): 4,
    np.dtype(np.int8): 5, np.dtype(np.int16): 6,
    np.dtype(np.int32): 7, np.dtype(np.int64): 8,
    np.dtype(np.float32): 9, np.dtype(np.float64): 10,
}
_GSD_TO_DTYPE = {v: k for k, v in _DTYPE_TO_GSD.items()}


def _make_version(major, minor):
    return (major << 16) | minor


class GSDFile:
    """Read/append handle over a GSD v1 file.

    Modes: 'w' create (overwrite), 'a' append (create if absent),
    'r' read-only.  Frames are staged with ``write_chunk`` and
    committed by ``end_frame``, after which the on-disk file is
    complete and readable.
    """

    def __init__(self, filename, mode='r', application='hoomd_tpu',
                 schema='hoomd', schema_version=(1, 2)):
        self.filename = filename
        self.mode = mode
        self._names = []                 # id -> name
        self._name_to_id = {}
        self._entries = []               # (frame, N, location, M, id, type)
        self._pending = []               # staged (name, ndarray)
        exists = os.path.exists(filename)
        if mode == 'r' or (mode == 'a' and exists):
            self._f = open(filename, 'rb' if mode == 'r' else 'r+b')
            self._read_metadata()
        elif mode in ('w', 'a'):
            self._f = open(filename, 'w+b')
            self._app = application[:63]
            self._schema = schema[:63]
            self._schema_version = _make_version(*schema_version)
            self._index_loc = _HEADER_SIZE
            self._index_cap = _INITIAL_INDEX_CAP
            self._name_loc = self._index_loc + \
                self._index_cap * _INDEX_SIZE
            self._name_cap = _INITIAL_NAME_CAP
            self._write_header()
            self._f.seek(self._index_loc)
            self._f.write(b'\0' * (self._index_cap * _INDEX_SIZE
                                   + self._name_cap * _NAME_SIZE))
            self._data_end = self._f.tell()
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- metadata ------------------------------------------------------------
    def _write_header(self):
        self._f.seek(0)
        self._f.write(struct.pack(
            _HEADER_FMT, GSD_MAGIC, self._index_loc, self._index_cap,
            self._name_loc, self._name_cap,
            self._schema_version, _make_version(1, 0),
            self._app.encode(), self._schema.encode(), b''))

    def _read_metadata(self):
        self._f.seek(0)
        raw = self._f.read(_HEADER_SIZE)
        if len(raw) < _HEADER_SIZE:
            raise IOError(f"{self.filename}: truncated GSD header")
        (magic, self._index_loc, self._index_cap, self._name_loc,
         self._name_cap, self._schema_version, gsd_ver, app, schema,
         _res) = struct.unpack(_HEADER_FMT, raw)
        if magic != GSD_MAGIC:
            raise IOError(f"{self.filename}: not a GSD file")
        if gsd_ver >= _make_version(2, 0):
            raise IOError(f"{self.filename}: GSD v{gsd_ver >> 16} file; "
                          f"this build reads/writes v1")
        self._app = app.rstrip(b'\0').decode(errors='replace')
        self._schema = schema.rstrip(b'\0').decode(errors='replace')
        if self._name_loc:
            self._f.seek(self._name_loc)
            blob = self._f.read(self._name_cap * _NAME_SIZE)
            for i in range(self._name_cap):
                nm = blob[i * _NAME_SIZE:(i + 1) * _NAME_SIZE]
                nm = nm.split(b'\0', 1)[0].decode(errors='replace')
                if not nm:
                    break
                self._names.append(nm)
                self._name_to_id[nm] = i
        data_end = _HEADER_SIZE
        if self._index_loc:
            self._f.seek(self._index_loc)
            blob = self._f.read(self._index_cap * _INDEX_SIZE)
            for i in range(len(blob) // _INDEX_SIZE):
                frame, N, loc, M, nid, typ, _fl = struct.unpack_from(
                    _INDEX_FMT, blob, i * _INDEX_SIZE)
                if loc == 0:             # unused slot (gsd.c sentinel)
                    continue
                self._entries.append((frame, N, loc, M, nid, typ))
                size = N * max(M, 1) * _GSD_TO_DTYPE[typ].itemsize
                data_end = max(data_end, loc + size)
        self._f.seek(0, 2)
        file_end = self._f.tell()
        self._data_end = file_end if self.mode == 'a' else data_end

    # -- writing ---------------------------------------------------------------
    @property
    def nframes(self):
        return (max(e[0] for e in self._entries) + 1 if self._entries
                else 0)

    def _expand_index(self):
        """Relocate the index block to EOF at double capacity
        (gsd.c gsd_expand_index)."""
        self._index_cap *= 2
        self._f.seek(0, 2)
        self._index_loc = self._f.tell()
        # keep the in-memory list in disk-slot order (sorted by
        # (frame, id)) so in-place appends land in the right slot
        self._entries = sorted(self._entries, key=lambda e: (e[0], e[4]))
        blob = bytearray(self._index_cap * _INDEX_SIZE)
        for i, e in enumerate(self._entries):
            struct.pack_into(_INDEX_FMT, blob, i * _INDEX_SIZE, *e, 0)
        self._f.write(bytes(blob))
        self._data_end = self._f.tell()
        self._write_header()

    def _expand_namelist(self):
        self._name_cap *= 2
        self._f.seek(0, 2)
        self._name_loc = self._f.tell()
        blob = bytearray(self._name_cap * _NAME_SIZE)
        for i, nm in enumerate(self._names):
            b = nm.encode()[:_NAME_SIZE - 1]
            blob[i * _NAME_SIZE:i * _NAME_SIZE + len(b)] = b
        self._f.write(bytes(blob))
        self._data_end = self._f.tell()
        self._write_header()

    def write_chunk(self, name, data):
        arr = np.ascontiguousarray(data)
        if arr.dtype not in _DTYPE_TO_GSD:
            raise TypeError(f"GSD cannot store dtype {arr.dtype} "
                            f"(chunk {name!r})")
        if arr.ndim > 2:
            raise ValueError(f"GSD chunks are at most 2-D (chunk {name!r}"
                             f" has shape {arr.shape})")
        self._pending.append((name, arr))

    def end_frame(self):
        frame = self.nframes
        new = []
        for name, arr in self._pending:
            nid = self._name_to_id.get(name)
            if nid is None:
                nid = len(self._names)
                if nid >= 0xFFFF:
                    raise RuntimeError("GSD namelist full (65535 names)")
                if nid >= self._name_cap:
                    self._expand_namelist()
                self._names.append(name)
                self._name_to_id[name] = nid
                b = name.encode()[:_NAME_SIZE - 1]
                self._f.seek(self._name_loc + nid * _NAME_SIZE)
                self._f.write(b.ljust(_NAME_SIZE, b'\0'))
            N = arr.shape[0] if arr.ndim >= 1 else 1
            M = arr.shape[1] if arr.ndim == 2 else 1
            new.append([frame, N, 0, M, nid, _DTYPE_TO_GSD[arr.dtype],
                        arr])
        # data first
        self._f.seek(self._data_end)
        for rec in new:
            rec[2] = self._f.tell()
            self._f.write(rec[6].tobytes())
        self._data_end = self._f.tell()
        # then index entries, in id order so the block stays sorted by
        # (frame, id) for gsd_find_chunk's binary search
        while len(self._entries) + len(new) > self._index_cap:
            self._expand_index()
        base = len(self._entries)
        self._f.seek(self._index_loc + base * _INDEX_SIZE)
        for rec in sorted(new, key=lambda r: r[4]):
            frame_, N, loc, M, nid, typ, _arr = rec
            self._f.write(struct.pack(_INDEX_FMT, frame_, N, loc, M, nid,
                                      typ, 0))
            self._entries.append((frame_, N, loc, M, nid, typ))
        self._pending = []
        # write-through at frame boundaries: gsd.c uses unbuffered
        # write() syscalls, so a reference reader (or a crash-recovery
        # restart) sees every completed frame immediately; Python's
        # userspace buffer would otherwise hold the small index-entry
        # writes while the bulk data (large writes bypass the buffer)
        # is already on disk — a torn file to any concurrent reader
        self.flush()

    def flush(self):
        if self.mode != 'r':
            self._f.flush()

    def close(self):
        if self.mode != 'r':
            self.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- reading ---------------------------------------------------------------
    def chunk_exists(self, frame, name):
        nid = self._name_to_id.get(name)
        if nid is None:
            return False
        return any(e[0] == frame and e[4] == nid for e in self._entries)

    def read_chunk(self, frame, name):
        nid = self._name_to_id.get(name)
        if nid is None:
            raise KeyError(f"chunk {name!r} not in {self.filename}")
        for f, N, loc, M, eid, typ in self._entries:
            if f == frame and eid == nid:
                dt = _GSD_TO_DTYPE[typ]
                self._f.seek(loc)
                raw = self._f.read(N * max(M, 1) * dt.itemsize)
                arr = np.frombuffer(raw, dtype=dt).copy()
                return arr.reshape(N, M) if M > 1 else arr
        raise KeyError(f"chunk {name!r} has no frame {frame} entry")

    def frame_chunks(self, frame):
        """All chunk names present at ``frame``."""
        return [self._names[e[4]] for e in self._entries if e[0] == frame]
