"""2-D Poisson (5-point Laplacian) operator and its block-Jacobi preconditioner.

Counterpart of :mod:`lightkrylov_tpu.models.poisson` (reference:
test/TestSpecialMatrices.f90:29-159).  The state vector is the interior grid
``(ny, nx)``.  ``Poisson2D.matvec`` is the plain pad-and-slice form; it is
also the plain version that the CUDA stencil kernel of
:mod:`lightkrylov_tpu_torch.ops.stencil` is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_torch_dtype, resolve_device
from ..linops import LinearOperator
from ..ops.stencil import stencil_matvec_reference

__all__ = ["Poisson2D", "poisson2d_eigvals", "BlockJacobiPoisson"]


class Poisson2D(LinearOperator):
    """Negative 5-point Laplacian ``-Delta`` with homogeneous Dirichlet BCs
    on the unit square; SPD.  Interior grid ``(ny, nx)``, spacing
    ``hx = 1/(nx+1)``, ``hy = 1/(ny+1)``.  ``device`` (default:
    :func:`..constants.default_device`, the card) is where :meth:`template`
    allocates."""

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, dtype=torch.float64,
                 device=None):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = as_torch_dtype(dtype)
        self.device = resolve_device(device)

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def matvec(self, u):
        return stencil_matvec_reference(u, ihx2=1.0 / self.hx**2,
                                        ihy2=1.0 / self.hy**2)

    def rmatvec(self, u):
        return self.matvec(u)

    def template(self):
        return torch.zeros((self.ny, self.nx), dtype=self.dtype_, device=self.device)

    def dense(self):
        """Dense oracle as a float64 CPU tensor (small grids only)."""
        nx, ny = self.nx, self.ny
        n = nx * ny
        A = np.zeros((n, n))
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        for j in range(ny):
            for i in range(nx):
                k = j * nx + i
                A[k, k] = 2.0 * (ihx2 + ihy2)
                if i > 0:
                    A[k, k - 1] = -ihx2
                if i < nx - 1:
                    A[k, k + 1] = -ihx2
                if j > 0:
                    A[k, k - nx] = -ihy2
                if j < ny - 1:
                    A[k, k + nx] = -ihy2
        return torch.from_numpy(A)


def poisson2d_eigvals(nx: int, ny: int | None = None):
    """Closed-form spectrum of the 5-point ``-Delta`` (a sorted numpy array):
    ``lambda_{ij} = (2 - 2 cos(i pi hx))/hx^2 + (2 - 2 cos(j pi hy))/hy^2``."""
    ny = ny if ny is not None else nx
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    i = np.arange(1, nx + 1)
    j = np.arange(1, ny + 1)
    lx = (2.0 - 2.0 * np.cos(i * np.pi * hx)) / hx**2
    ly = (2.0 - 2.0 * np.cos(j * np.pi * hy)) / hy**2
    return np.sort((lx[None, :] + ly[:, None]).ravel())


class BlockJacobiPoisson(LinearOperator):
    """Block-Jacobi preconditioner: exact solve of the 1-D tridiagonal
    x-line blocks ``(2/hx^2 + 2/hy^2) I + tridiag(-1/hx^2)``
    (reference: test/TestSpecialMatrices.f90:29-159).

    The block inverse (nx x nx) is computed once in float64 on the host,
    then cast to the operator's dtype on ``device``; it is applied to all
    rows as one matrix product."""

    is_hermitian = True

    def __init__(self, op: Poisson2D, device=None):
        nx = op.nx
        ihx2 = 1.0 / op.hx**2
        ihy2 = 1.0 / op.hy**2
        B = np.zeros((nx, nx))
        np.fill_diagonal(B, 2.0 * (ihx2 + ihy2))
        i = np.arange(nx - 1)
        B[i + 1, i] = -ihx2
        B[i, i + 1] = -ihx2
        self.Binv = torch.as_tensor(np.linalg.inv(B), dtype=op.dtype_,
                                    device=op.device if device is None else device)

    @classmethod
    def from_block_inverse(cls, Binv: torch.Tensor) -> "BlockJacobiPoisson":
        """The preconditioner with a given block inverse (used to carry one
        across from the JAX package)."""
        obj = cls.__new__(cls)
        obj.Binv = Binv
        return obj

    def matvec(self, r):
        return r @ self.Binv.T

    def rmatvec(self, r):
        return self.matvec(r)
