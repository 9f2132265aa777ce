"""Base classes of the operation layer (counterpart of
hoomd_tpu/operation.py): python objects that describe a force or an
integration method; the System turns them into tensors and kernels."""

from __future__ import annotations


class Force:
    """Base of every force compute."""

    def __init__(self, name=None):
        self.name = name or type(self).__name__
        self.enabled = True
        self._nlist = None

    def disable(self):
        self.enabled = False
        _current_system()._dirty()

    def enable(self):
        self.enabled = True
        _current_system()._dirty()


class IntegrationMethod:
    """Base two-step integration method."""

    def __init__(self, group):
        self.group = group
        self.enabled = True

    def disable(self):
        self.enabled = False
        _current_system()._dirty()

    def enable(self):
        self.enabled = True
        _current_system()._dirty()

    def _init_aux(self, device):
        return {}


def _current_system():
    from . import context
    if context.current is None or context.current.system is None:
        raise RuntimeError("no simulation context: call "
                           "context.initialize() and init.* first")
    return context.current.system
