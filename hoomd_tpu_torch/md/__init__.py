"""Molecular dynamics package (counterpart of hoomd_tpu/md): the slice's
nlist, pair and integrate namespaces."""

from . import integrate, nlist, pair

__all__ = ['integrate', 'nlist', 'pair']
