"""hpmc.data — per-type shape parameter proxies (counterpart of
hoomd_tpu/hpmc/data.py, the same content).

Shape parameters are plain host-side values read when the sweep program
is built, so one generic proxy covers every shape.  The reference access
patterns are both supported:

    mc.shape_param.set('A', diameter=1.0)          # bulk set
    mc.shape_param['A'].set(diameter=2.0)          # per-type set
    d = mc.shape_param['A'].diameter               # attribute read
"""

from __future__ import annotations


class type_param_proxy:
    """Live view of one type's shape parameters (reference
    hpmc/data.py:87 _param and the per-shape *_params subclasses)."""

    __slots__ = ('_store', '_mc')

    def __init__(self, store, mc):
        object.__setattr__(self, '_store', store)
        object.__setattr__(self, '_mc', mc)

    def set(self, **params):
        self._store.update(params)
        self._mc._dirty()

    def get(self, key, default=None):
        return self._store.get(key, default)

    def keys(self):
        return self._store.keys()

    def items(self):
        return self._store.items()

    def __contains__(self, key):
        return key in self._store

    def __getitem__(self, key):
        return self._store[key]

    def __getattr__(self, name):
        try:
            return self._store[name]
        except KeyError:
            raise AttributeError(
                f"shape parameter '{name}' is not set for this type")

    def __setattr__(self, name, value):
        self._store[name] = value
        self._mc._dirty()

    def __repr__(self):
        return f"type_param_proxy({dict(self._store)!r})"


class param_dict:
    """Per-type shape-parameter registry attached to every HPMC
    integrator as ``mc.shape_param`` (reference hpmc/data.py:12)."""

    def __init__(self, mc):
        self._mc = mc
        self._params = {}

    def set(self, types, **params):
        if not isinstance(types, (list, tuple)):
            types = [types]
        for t in types:
            self._params.setdefault(t, {}).update(params)
        self._mc._dirty()

    def __getitem__(self, t):
        return type_param_proxy(self._params.setdefault(t, {}), self._mc)

    def __contains__(self, t):
        return t in self._params

    def keys(self):
        return self._params.keys()
