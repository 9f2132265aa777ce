"""Trajectory and checkpoint writers (counterpart of hoomd_tpu/dump.py):
``gsd`` writes frames of the whole system to a GSD file, with each
integration method's variables (Nose-Hoover xi, eta) as ``state/``
chunks, so that init.read_gsd restarts a job where it stopped.  The
frames are the JAX package's, byte for byte in layout (io/frames.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import context
from .io.frames import FrameWriter, write_single_frame
from .operation import Analyzer


def _sys():
    return context.current.system


def _collect_op_state(system):
    """'method/variable' -> host array of each integration method's aux
    state: the fast engine's carry (materialized by the state read
    before this) or the general engine's."""
    if system._fast_state_stale:
        system._sync_fast_state()
    out = {}
    for m, aux in system._method_aux_by_obj.items():
        if isinstance(aux, dict):
            for k, v in aux.items():
                if isinstance(v, torch.Tensor):
                    v = v.detach().cpu().numpy()
                out[f"{type(m).__name__}/{k}"] = np.asarray(v)
    return out


class gsd(Analyzer):
    """Write system frames every ``period`` steps; ``period=None`` writes
    one now.  ``truncate`` keeps only the newest frame (a restart
    file)."""

    def __init__(self, filename, period, group=None, overwrite=False,
                 truncate=False, phase=0, dynamic=None, static=None):
        Analyzer.__init__(self, period, phase if phase != -1 else 0)
        self.filename = filename
        self.group = group
        self._writer = FrameWriter(filename, overwrite=overwrite,
                                   truncate=truncate)
        _sys().register_analyzer(self)
        if period is None:
            self.analyze(_sys(), _sys().timestep)

    def analyze(self, system, timestep):
        snap = system.take_snapshot()
        self._writer.append(snap, timestep, _collect_op_state(system))

    def write_restart(self):
        """Write a single restart frame now, replacing the file."""
        system = _sys()
        write_single_frame(self.filename, system.take_snapshot(),
                           system.timestep, _collect_op_state(system))
