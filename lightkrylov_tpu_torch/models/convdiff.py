"""Nonsymmetric convection-diffusion operator.

Counterpart of :mod:`lightkrylov_tpu.models.convdiff`:
``-eps Delta u + (cx, cy) . grad u`` on the unit square, homogeneous
Dirichlet boundaries, the 5-point diffusion stencil and centred first-order
convection.  The state is the interior grid ``(ny, nx)``, as for
:class:`~lightkrylov_tpu_torch.models.Poisson2D`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_torch_dtype, resolve_device
from ..linops import LinearOperator

__all__ = ["ConvectionDiffusion2D"]


class ConvectionDiffusion2D(LinearOperator):
    """``A u = -eps Delta u + cx u_x + cy u_y`` (nonsymmetric).  ``device``
    is where :meth:`template` allocates."""

    def __init__(self, nx: int, ny: int | None = None, eps: float = 1e-2,
                 cx: float = 1.0, cy: float = 0.5, dtype=torch.float64, device=None):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.eps = float(eps)
        self.cx = float(cx)
        self.cy = float(cy)
        self.dtype_ = as_torch_dtype(dtype)
        self.device = resolve_device(device)

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def template(self):
        return torch.zeros((self.ny, self.nx), dtype=self.dtype_, device=self.device)

    def _parts(self, u):
        """The diffusion term and the convection term of ``A u``."""
        un = torch.nn.functional.pad(u, (1, 1))        # pad x
        left, right = un[:, :-2], un[:, 2:]
        um = torch.nn.functional.pad(u, (0, 0, 1, 1))  # pad y
        down, up = um[:-2, :], um[2:, :]
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        diff = (2.0 * (ihx2 + ihy2)) * u - ihx2 * (left + right) - ihy2 * (down + up)
        conv = self.cx * (right - left) / (2.0 * self.hx) \
            + self.cy * (up - down) / (2.0 * self.hy)
        return diff, conv

    def matvec(self, u):
        diff, conv = self._parts(u)
        return self.eps * diff + conv

    def rmatvec(self, u):
        # adjoint: the diffusion is symmetric, the convection changes sign
        diff, conv = self._parts(u)
        return self.eps * diff - conv

    def dense(self):
        """Dense matrix as a float64 CPU tensor (small grids only)."""
        nx, ny = self.nx, self.ny
        A = np.zeros((nx * ny, nx * ny))
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        for j in range(ny):
            for i in range(nx):
                k = j * nx + i
                A[k, k] = self.eps * 2.0 * (ihx2 + ihy2)
                if i > 0:
                    A[k, k - 1] = -self.eps * ihx2 - self.cx / (2 * self.hx)
                if i < nx - 1:
                    A[k, k + 1] = -self.eps * ihx2 + self.cx / (2 * self.hx)
                if j > 0:
                    A[k, k - nx] = -self.eps * ihy2 - self.cy / (2 * self.hy)
                if j < ny - 1:
                    A[k, k + nx] = -self.eps * ihy2 + self.cy / (2 * self.hy)
        return torch.from_numpy(A)
