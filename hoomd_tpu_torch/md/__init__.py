"""Molecular dynamics package (counterpart of hoomd_tpu/md): the slice's
nlist, pair, bond, angle, charge and integrate namespaces."""

from . import angle, bond, charge, integrate, nlist, pair

__all__ = ['angle', 'bond', 'charge', 'integrate', 'nlist', 'pair']
