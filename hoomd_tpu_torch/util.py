"""Small helpers (counterpart of hoomd_tpu/util.py)."""

from __future__ import annotations

import sys


def notice(level, msg):
    """A notice on stderr, shown when the context's notice level is at
    least ``level`` (the reference Messenger's notice streams)."""
    from . import context
    lvl = 2
    if context.current is not None:
        lvl = getattr(context.current.options, 'notice_level', 2)
    if lvl >= level:
        print(f"notice({level}): {msg}", file=sys.stderr, flush=True)
