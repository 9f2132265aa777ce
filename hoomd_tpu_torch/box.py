"""Periodic simulation box (counterpart of hoomd_tpu/box.py).

Same parameterization as the JAX package: edge lengths L and tilt
factors (xy, xz, yz), lattice vectors a1=(Lx,0,0), a2=(xy*Ly, Ly, 0),
a3=(xz*Lz, yz*Lz, Lz).  wrap / make_fraction / from_fraction are
elementwise, never matrix products, so they are bit-exact on every
device and agree bit for bit with the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._config import real_dtype


@dataclass
class Box:
    L: torch.Tensor          # (3,)
    tilt: torch.Tensor       # (3,) xy, xz, yz
    periodic: torch.Tensor   # (3,) bool
    dimensions: int = 3

    @staticmethod
    def create(Lx, Ly=None, Lz=None, xy=0.0, xz=0.0, yz=0.0, dimensions=3,
               periodic=(True, True, True), device='cpu'):
        if Ly is None:
            Ly = Lx
        if Lz is None:
            Lz = Lx if dimensions == 3 else 1.0
        dt = real_dtype()
        return Box(L=torch.tensor([Lx, Ly, Lz], dtype=dt, device=device),
                   tilt=torch.tensor([xy, xz, yz], dtype=dt, device=device),
                   periodic=torch.tensor(periodic, dtype=torch.bool,
                                         device=device),
                   dimensions=dimensions)

    def volume(self):
        if self.dimensions == 2:
            return self.L[0] * self.L[1]
        return self.L[0] * self.L[1] * self.L[2]

    def make_fraction(self, pos):
        """Positions -> box fractions in [0, 1)."""
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        fz = pos[..., 2] / Lz
        fy = (pos[..., 1] - fz * yz * Lz) / Ly
        fx = (pos[..., 0] - fy * xy * Ly - fz * xz * Lz) / Lx
        return torch.stack([fx, fy, fz], dim=-1) + 0.5

    def from_fraction(self, f):
        """Inverse of make_fraction."""
        g = f - 0.5
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        x = g[..., 0] * Lx + g[..., 1] * xy * Ly + g[..., 2] * xz * Lz
        y = g[..., 1] * Ly + g[..., 2] * yz * Lz
        z = g[..., 2] * Lz
        return torch.stack([x, y, z], dim=-1)

    def min_image(self, dr):
        """Nearest periodic image of displacement vectors: z first, then
        y, then x, subtracting whole lattice vectors."""
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        x, y, z = dr[..., 0], dr[..., 1], dr[..., 2]
        img = torch.where(self.periodic[2], torch.round(z / Lz), 0.0)
        z = z - Lz * img
        y = y - yz * Lz * img
        x = x - xz * Lz * img
        img = torch.where(self.periodic[1], torch.round(y / Ly), 0.0)
        y = y - Ly * img
        x = x - xy * Ly * img
        img = torch.where(self.periodic[0], torch.round(x / Lx), 0.0)
        x = x - Lx * img
        return torch.stack([x, y, z], dim=-1)

    def wrap(self, pos, image):
        """Wrap positions into the box, accumulating image flags."""
        f = self.make_fraction(pos)
        shift = torch.where(self.periodic, torch.floor(f), 0.0)
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        sx = (shift[..., 0] * Lx + shift[..., 1] * xy * Ly
              + shift[..., 2] * xz * Lz)
        sy = shift[..., 1] * Ly + shift[..., 2] * yz * Lz
        sz = shift[..., 2] * Lz
        new_pos = pos - torch.stack([sx, sy, sz], dim=-1)
        return new_pos, image + shift.to(image.dtype)

    def to_numpy(self):
        return (self.L.cpu().numpy(), self.tilt.cpu().numpy(),
                self.periodic.cpu().numpy())

    def __repr__(self):  # pragma: no cover - debugging aid
        L, t, _ = self.to_numpy()
        return (f"Box(Lx={L[0]:g}, Ly={L[1]:g}, Lz={L[2]:g}, "
                f"xy={t[0]:g}, xz={t[1]:g}, yz={t[2]:g}, "
                f"dimensions={self.dimensions})")

