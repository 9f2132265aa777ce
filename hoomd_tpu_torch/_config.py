"""Global runtime configuration for hoomd_tpu_torch.

The particle state is float32 with int32 tags/types/images, as in the
JAX package's default single precision.  Every float32 matrix product
runs in full float32: the JAX package pins full precision at every
matmul whose rounding once broke exactness (Box.wrap, the SAT overlap
test, the rebin payload), and TF32 on the card is the same trap, so it
is turned off here, at import.

The device is explicit: ``context.initialize('--mode=gpu')`` (and the
default ``auto``) requires CUDA, ``--mode=cpu`` runs the plain torch
versions of every kernel.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

# Sentinel coordinate of padding slots.  Padding never pairs: validity
# comes from tag >= 0, the sentinel only keeps padded rows far away.
PAD_COORD = 1.0e9


def real_dtype():
    """dtype of positions/velocities/forces."""
    return torch.float32


def int_dtype():
    """dtype of tags, type ids and image flags."""
    return torch.int32


def resolve_device(mode):
    """torch.device for a ``--mode`` value: 'gpu' and 'auto' need CUDA
    and raise without it; 'cpu' is the plain-torch path."""
    if mode in ('gpu', 'auto'):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--mode={mode} needs a CUDA device and none is visible; "
                "use --mode=cpu to run the plain torch path")
        return torch.device('cuda', torch.cuda.current_device())
    if mode == 'cpu':
        return torch.device('cpu')
    raise ValueError(f"unknown --mode {mode!r} (gpu|cpu|auto)")
