"""Tridiagonal Toeplitz test operators with closed-form spectra.

Counterpart of :mod:`lightkrylov_tpu.models.toeplitz` (reference: eigs is
validated on a tridiagonal Toeplitz matrix with closed-form complex
eigenvalues, test/TestIterativeSolvers.fypp:135-225, and eighs on an SPD
Toeplitz with ``lambda_i = a + 2|b| cos(i pi / (n+1))``, :228-310).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_torch_dtype, resolve_device
from ..linops import LinearOperator

__all__ = ["TridiagToeplitz", "toeplitz_eigvals"]


def _shift_down(x):
    """``x_{i-1}``, with zero above the first entry."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _shift_up(x):
    """``x_{i+1}``, with zero below the last entry."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


class TridiagToeplitz(LinearOperator):
    """Tridiagonal Toeplitz operator on vectors of length ``n``: ``a`` on
    the diagonal, ``b`` on the subdiagonal, ``c`` (default ``b``) on the
    superdiagonal, applied matrix-free with shifts.  The coefficients are
    0-d tensors of ``dtype`` on ``device``."""

    def __init__(self, n: int, a, b, c=None, dtype=torch.float64, device=None):
        if c is None:
            c = b
        dtype, device = as_torch_dtype(dtype), resolve_device(device)
        self.n = n
        self.a, self.b, self.c = (torch.as_tensor(v, dtype=dtype, device=device)
                                  for v in (a, b, c))
        a_, b_, c_ = (complex(v.item()) for v in (self.a, self.b, self.c))
        self.is_hermitian = a_.imag == 0 and b_.conjugate() == c_

    def matvec(self, x):
        return self.a * x + self.b * _shift_down(x) + self.c * _shift_up(x)

    def rmatvec(self, y):
        return (self.a.conj() * y + self.c.conj() * _shift_down(y)
                + self.b.conj() * _shift_up(y))

    def dense(self):
        """Dense matrix as a CPU tensor of the coefficients' dtype."""
        n = self.n
        A = torch.diag(self.a.cpu().expand(n))
        idx = torch.arange(n - 1)
        A[idx + 1, idx] = self.b.cpu()
        A[idx, idx + 1] = self.c.cpu()
        return A


def toeplitz_eigvals(n: int, a, b, c=None):
    """Closed-form spectrum ``lambda_k = a + 2 sqrt(b c) cos(k pi/(n+1))``,
    ``k = 1..n`` (complex for ``b c < 0``; reference:
    TestIterativeSolvers.fypp:135-310)."""
    if c is None:
        c = b
    k = np.arange(1, n + 1)
    return a + 2.0 * np.sqrt(complex(b * c)) * np.cos(k * np.pi / (n + 1))
