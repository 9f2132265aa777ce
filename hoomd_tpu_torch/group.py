"""Particle groups (counterpart of hoomd_tpu/group.py).

A group is an immutable set of particle tags.  The cell-major engine
runs a method on ``all()`` only; a method on any other group runs on the
general engine.
"""

from __future__ import annotations

import numpy as np

from . import context


class group:
    def __init__(self, name, member_tags):
        self.name = name
        self.member_tags = np.unique(np.asarray(member_tags,
                                                dtype=np.int64))

    def __len__(self):
        return len(self.member_tags)

    def __repr__(self):
        return f"group {self.name!r} ({len(self)} particles)"


def _sys():
    if context.current is None or context.current.system is None:
        raise RuntimeError("initialize the system first")
    return context.current.system


def all():
    """Every particle."""
    return group('all', np.arange(_sys().state.N))


def tags(tag_min, tag_max=None, name=None):
    """Tag range [tag_min, tag_max] inclusive."""
    if tag_max is None:
        tag_max = tag_min
    return group(name or f"tags_{tag_min}-{tag_max}",
                 np.arange(tag_min, tag_max + 1))


def type(type=None, name=None, update=False):
    """Every particle of one type name."""
    sys_ = _sys()
    tid = sys_.particle_types.index(type)
    typeid = sys_.snapshot_template.particles.typeid
    return group(name or f"type_{type}",
                 np.nonzero(np.asarray(typeid) == tid)[0])


def tag_list(name, tags):
    """An explicit list of tags."""
    return group(name, tags)
