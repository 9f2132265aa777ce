"""Base classes of the operation layer (counterpart of
hoomd_tpu/operation.py): python objects that describe a force, an
integration method, an analyzer or an updater; the System turns forces
and methods into tensors and kernels, and fires analyzers and updaters
on the host between chunks of steps, with the reference's period/phase
semantics (System.h:71-128).
"""

from __future__ import annotations


class Force:
    """Base of every force compute.  ``log_name`` is its logger quantity
    (e.g. 'pair_lj_energy', suffixed by the user's name if given)."""

    def __init__(self, name=None):
        self.user_name = name
        self.name = name or type(self).__name__
        self._log_base = type(self).__name__ + "_energy"
        self.enabled = True
        self._nlist = None

    def disable(self):
        self.enabled = False
        _current_system()._dirty()

    def enable(self):
        self.enabled = True
        _current_system()._dirty()

    @property
    def log_name(self):
        suffix = f"_{self.user_name}" if self.user_name else ""
        return self._log_base + suffix

    def get_energy(self, group=None):
        """Total potential energy of this force, optionally over a
        group."""
        return _current_system().force_energy(self, group)


class _Periodic:
    """Period/phase firing schedule of analyzers and updaters.

    ``period`` may be a callable n -> step offset, the reference's
    variable period (System.h:210-232 shouldExecute): the first due
    check records the creation step, n starts at 1, and after each fire
    the next step is ``created + period(n)`` (clamped forward), n += 1."""

    def _init_period(self, period, phase):
        self.phase = int(phase)
        self.enabled = True
        if callable(period):
            self.period = period
            self._vp_n = 1
            self._vp_created = None
            self._vp_next = None
        else:
            self.period = int(period) if period else None

    def _due(self, ts):
        """True when this op fires at ``ts`` (advances a variable
        period's state)."""
        if not self.enabled or self.period is None:
            return False
        if callable(self.period):
            if self._vp_created is None:
                self._vp_created = ts
                self._vp_next = ts
            # >= not ==: a step skipped while disabled must not wedge the
            # schedule
            if ts >= self._vp_next:
                nxt = int(self.period(self._vp_n)) + self._vp_created
                self._vp_next = nxt if nxt > ts else ts + 1
                self._vp_n += 1
                return True
            return False
        return is_due(self.period, self.phase, ts)

    def _next_stop(self, ts):
        """First step > ts at which this op must fire (a chunk boundary);
        None when it never fires."""
        if not self.enabled or self.period is None:
            return None
        if callable(self.period):
            if self._vp_next is None:
                return ts + 1
            return max(self._vp_next, ts + 1)
        return ts + self.period - ((ts - self.phase) % self.period)

    def disable(self):
        self.enabled = False

    def enable(self):
        self.enabled = True


class Analyzer(_Periodic):
    """Periodic host-side observer."""

    def __init__(self, period, phase=0):
        self._init_period(period, phase)

    def analyze(self, system, timestep):  # pragma: no cover - interface
        raise NotImplementedError


class Updater(_Periodic):
    """Periodic host-side state mutator."""

    def __init__(self, period, phase=0):
        self._init_period(period, phase)

    def update(self, system, timestep):  # pragma: no cover - interface
        raise NotImplementedError


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

    def restore_state(self):
        """Take this method's variables (Nose-Hoover xi, eta) from the
        frame init.read_gsd read."""
        _current_system().restore_method_state(self)


def _current_system():
    from . import context
    if context.current is None or context.current.system is None:
        raise RuntimeError("no simulation context: call "
                           "context.initialize() and init.* first")
    return context.current.system


def is_due(period, phase, timestep):
    """Period/phase gating (reference System.h:71-106)."""
    if period is None:
        return False
    return (timestep - phase) % period == 0
