"""Molecular dynamics package (counterpart of hoomd_tpu/md): the slice's
nlist, pair, charge and integrate namespaces."""

from . import charge, integrate, nlist, pair

__all__ = ['charge', 'integrate', 'nlist', 'pair']
