"""Linear operators acting on tensor and pytree vectors.

Counterpart of :mod:`lightkrylov_tpu.linops` (reference:
src/AbstractTypes/AbstractLinops.fypp): a base class with ``matvec`` and
``rmatvec`` (AbstractLinops.fypp:58-87), the operator algebra (adjoint,
scaled, axpby, composition) and the dense, diagonal and identity operators.

Operators here are plain Python objects.  Where the JAX package derived
``rmatvec`` with ``jax.linear_transpose``, the default here is
``torch.func.vjp`` of ``matvec``: for a linear map ``x -> A x`` its
vector-Jacobian product with ``y`` is ``A^H y`` for real and complex dtypes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import vectors

__all__ = [
    "LinearOperator",
    "Preconditioner",
    "MatvecOperator",
    "DenseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "ScaledOperator",
    "AdjointOperator",
    "AxpbyOperator",
    "ComposedOperator",
    "adjoint",
    "aslinop",
]


def _conj(a):
    return a.conj() if isinstance(a, torch.Tensor) else np.conj(a)


class LinearOperator:
    """Base class: subclasses implement :meth:`matvec`; ``rmatvec``
    defaults to the vector-Jacobian product of ``matvec``
    (reference: AbstractLinops.fypp:27-87)."""

    #: True for operators guaranteed self-adjoint (reference:
    #: ``abstract_sym_linop`` / ``abstract_hermitian_linop``).
    is_hermitian: bool = False

    def matvec(self, x):
        """Apply ``y = A x``."""
        raise NotImplementedError

    def rmatvec(self, y):
        """Apply ``x = A^H y``; valid for square operators."""
        if self.is_hermitian:
            return self.matvec(y)
        _, vjp = torch.func.vjp(self.matvec, y)
        (x,) = vjp(y)
        return x

    def __call__(self, x):
        return self.matvec(x)

    def matvec_basis(self, X):
        """Apply the operator to every column of a stacked basis, one
        :meth:`matvec` per column, for the block Krylov methods (the JAX
        package batches them with ``jax.vmap``; a hand-written kernel has
        no batched form to map onto)."""
        return vectors.stack([self.matvec(x) for x in vectors.unstack(X)])

    def rmatvec_basis(self, Y):
        """Batched adjoint application (see :meth:`matvec_basis`)."""
        return vectors.stack([self.rmatvec(y) for y in vectors.unstack(Y)])

    # -- operator algebra (reference: AbstractLinops.fypp:89-197) ------------

    @property
    def H(self) -> "LinearOperator":
        return adjoint(self)

    def __mul__(self, sigma):
        return ScaledOperator(sigma, self)

    __rmul__ = __mul__

    def __neg__(self):
        return ScaledOperator(-1.0, self)

    def __add__(self, other):
        return AxpbyOperator(1.0, self, 1.0, aslinop(other))

    def __sub__(self, other):
        return AxpbyOperator(1.0, self, -1.0, aslinop(other))

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ComposedOperator(self, other)
        return self.matvec(other)


def adjoint(A: LinearOperator) -> LinearOperator:
    """Adjoint of ``A``; collapses double adjoints
    (reference: AbstractLinops.fypp:573-599)."""
    if isinstance(A, AdjointOperator):
        return A.A
    if A.is_hermitian:
        return A
    return AdjointOperator(A)


def aslinop(A) -> LinearOperator:
    """Coerce a 2-D tensor or array, or a callable, into an operator.

    Wrappers made here are marked ``_aslinop_wrapped`` so the call counters
    aggregate them by class name across solves."""
    if isinstance(A, LinearOperator):
        return A
    op = MatvecOperator(A) if callable(A) else DenseOperator(torch.as_tensor(A))
    op._aslinop_wrapped = True
    return op


# -- concrete operators ------------------------------------------------------


class Preconditioner(LinearOperator):
    """Base class for iteration-aware preconditioners: solvers call
    :meth:`apply` with the inner-iteration index and the residual state
    (reference: ``abstract_precond_*%apply``, IterativeSolvers.fypp:80-95)."""

    def apply(self, v, iteration=0, current_residual=0.0, target_residual=0.0):
        return self.matvec(v)

    def matvec(self, x):
        return self.apply(x)


class MatvecOperator(LinearOperator):
    """Wrap user callables ``matvec(x)`` / ``rmatvec(y)``; with ``params``
    the callables receive ``(params, x)``."""

    def __init__(self, matvec, rmatvec=None, params=None, is_hermitian=False):
        self._matvec = matvec
        self._rmatvec = rmatvec
        self.params = params
        self.is_hermitian = is_hermitian

    def matvec(self, x):
        if self.params is not None:
            return self._matvec(self.params, x)
        return self._matvec(x)

    def rmatvec(self, y):
        if self._rmatvec is None:
            return super().rmatvec(y)
        if self.params is not None:
            return self._rmatvec(self.params, y)
        return self._rmatvec(y)


class DenseOperator(LinearOperator):
    """Dense matrix operator on 1-D vectors
    (reference: ``dense_linop``, AbstractLinops.fypp:264-271,607-660).
    ``data`` is converted with ``torch.as_tensor`` onto ``device``."""

    def __init__(self, data, is_hermitian=False, device=None):
        self.data = torch.as_tensor(data, device=device)
        self.is_hermitian = is_hermitian

    def matvec(self, x):
        return self.data @ x

    def rmatvec(self, y):
        return self.data.mH @ y


class DiagonalOperator(LinearOperator):
    """Diagonal operator ``y = d * x`` elementwise over the pytree."""

    def __init__(self, d):
        self.d = d

    def matvec(self, x):
        return pytree.tree_map(lambda dl, xl: dl * xl, self.d, x)

    def rmatvec(self, y):
        return pytree.tree_map(lambda dl, yl: dl.conj() * yl, self.d, y)


class IdentityOperator(LinearOperator):
    """Identity (reference: ``Id_*``, AbstractLinops.fypp:137-147)."""

    is_hermitian = True

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y


class ScaledOperator(LinearOperator):
    """``sigma * A`` (reference: ``scaled_linop``, AbstractLinops.fypp:153-176)."""

    def __init__(self, sigma, A):
        self.sigma = sigma
        self.A = aslinop(A)

    def matvec(self, x):
        return vectors.scal(self.sigma, self.A.matvec(x))

    def rmatvec(self, y):
        return vectors.scal(_conj(self.sigma), self.A.rmatvec(y))


class AdjointOperator(LinearOperator):
    """``A^H``: swaps matvec and rmatvec
    (reference: ``adjoint_linop``, AbstractLinops.fypp:89-100)."""

    def __init__(self, A):
        self.A = aslinop(A)

    def matvec(self, x):
        return self.A.rmatvec(x)

    def rmatvec(self, y):
        return self.A.matvec(y)


class AxpbyOperator(LinearOperator):
    """``alpha*op(A) + beta*op(B)`` with optional per-term adjoints
    (reference: ``axpby_linop``, AbstractLinops.fypp:182-197,498-566)."""

    def __init__(self, alpha, A, beta, B, transA=False, transB=False):
        self.alpha = alpha
        self.beta = beta
        self.A = aslinop(A)
        self.B = aslinop(B)
        self.transA = transA
        self.transB = transB

    def matvec(self, x):
        ax = self.A.rmatvec(x) if self.transA else self.A.matvec(x)
        bx = self.B.rmatvec(x) if self.transB else self.B.matvec(x)
        return vectors.axpby(self.alpha, ax, self.beta, bx)

    def rmatvec(self, y):
        ay = self.A.matvec(y) if self.transA else self.A.rmatvec(y)
        by = self.B.matvec(y) if self.transB else self.B.rmatvec(y)
        return vectors.axpby(_conj(self.alpha), ay, _conj(self.beta), by)


class ComposedOperator(LinearOperator):
    """``(A @ B) x = A(B(x))``."""

    def __init__(self, A, B):
        self.A = aslinop(A)
        self.B = aslinop(B)

    def matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    def rmatvec(self, y):
        return self.B.rmatvec(self.A.rmatvec(y))
