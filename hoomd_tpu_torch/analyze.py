"""Analyzers: quantity logging and python callbacks (counterpart of
hoomd_tpu/analyze.py log and callback).

``log`` writes a tab-separated file: a header line (``header_prefix``,
'timestep', the quantity names) and one row per fire, each value as
``:.9g``.  A quantity is, in this order: 'timestep' or 'time', a
callback registered with ``register_callback``, an entry of
System.thermo_quantities, or a force's ``log_name`` (its energy by
System.force_energy).
"""

from __future__ import annotations

import os

from . import context
from .operation import Analyzer


def _sys():
    return context.current.system


class log(Analyzer):
    """Log named quantities to a TSV file every ``period`` steps."""

    def __init__(self, filename, quantities, period, header_prefix='',
                 overwrite=False, phase=0):
        Analyzer.__init__(self, period, phase if phase != -1 else 0)
        self.filename = filename
        self.quantities = list(quantities)
        self.header_prefix = header_prefix
        self.user_callbacks = {}
        self._wrote_header = False
        self._last_row = {}
        if filename and overwrite:
            open(filename, 'w').close()
        elif filename and os.path.exists(filename) \
                and os.path.getsize(filename):
            self._wrote_header = True
        _sys().register_analyzer(self)

    def register_callback(self, name, callback):
        """Add a quantity computed by ``callback(timestep)``."""
        self.user_callbacks[name] = callback

    def query(self, quantity):
        """The current value of one quantity."""
        return self._value(quantity, _sys().timestep, {})

    def _value(self, q, ts, thermo):
        """One quantity at step ts; ``thermo`` caches the row's thermo
        quantities (computed once, at the first name that needs them)."""
        if q == 'timestep':
            return ts
        if q == 'time':
            mode = _sys().integrator_mode
            return ts * (mode.dt if mode else 0.0)
        if q in self.user_callbacks:
            return float(self.user_callbacks[q](ts))
        if not thermo:
            thermo.update(_sys().thermo_quantities())
        if q in thermo:
            return thermo[q]
        for f in _sys().forces:
            if f.log_name == q:
                return _sys().force_energy(f)
        raise ValueError(f"unknown log quantity {q!r}")

    def analyze(self, system, timestep):
        thermo = {}
        row = {q: self._value(q, timestep, thermo) for q in self.quantities}
        self._last_row = row
        if not self.filename:
            return
        with open(self.filename, 'a') as f:
            if not self._wrote_header:
                f.write(self.header_prefix + 'timestep\t'
                        + '\t'.join(self.quantities) + '\n')
                self._wrote_header = True
            f.write(str(timestep) + '\t'
                    + '\t'.join(f"{row[q]:.9g}" for q in self.quantities)
                    + '\n')


class callback(Analyzer):
    """Call ``callback(timestep)`` every ``period`` steps."""

    def __init__(self, callback, period, phase=0):
        Analyzer.__init__(self, period, phase if phase != -1 else 0)
        self.cb = callback
        _sys().register_analyzer(self)

    def analyze(self, system, timestep):
        self.cb(timestep)
