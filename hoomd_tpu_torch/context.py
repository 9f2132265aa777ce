"""Simulation context (counterpart of hoomd_tpu/context.py).

``initialize`` parses the same option string as the JAX package.  The
port reads two options: ``--notice-level`` and ``--mode``, which picks
the device explicitly — 'gpu' (and the default 'auto') needs CUDA and
raises without it, 'cpu' runs the plain torch versions of the kernels.
Other reference flags are accepted and ignored.
"""

from __future__ import annotations

import shlex
import sys

from ._config import resolve_device

current = None


class options:
    """Parsed command-line-style options."""

    def __init__(self):
        self.mode = 'auto'
        self.notice_level = 2


class SimulationContext:
    """Tracks the current simulation."""

    def __init__(self):
        self.system = None
        self.options = options()
        self.device = None


def initialize(args=None):
    """Parse options and set up a fresh context."""
    global current
    ctx = SimulationContext()
    opts = ctx.options
    argv = shlex.split(args) if isinstance(args, str) else \
        (list(args) if args is not None else [])
    it = iter(argv)
    for tok in it:
        if tok.startswith('--mode'):
            opts.mode = tok.split('=', 1)[1] if '=' in tok else next(it)
        elif tok.startswith('--notice-level'):
            v = tok.split('=', 1)[1] if '=' in tok else next(it)
            opts.notice_level = int(v)
    ctx.device = resolve_device(opts.mode)
    if opts.notice_level >= 2:
        import torch
        name = (torch.cuda.get_device_name(ctx.device)
                if ctx.device.type == 'cuda' else 'cpu')
        print(f"hoomd_tpu_torch: torch {torch.__version__} on {name}",
              file=sys.stderr)
    current = ctx
    return ctx
