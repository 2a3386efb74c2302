"""Nonlinear systems ``F(X)`` and their Jacobian operators.

Counterpart of :mod:`lightkrylov_tpu.systems` (reference:
src/AbstractTypes/AbstractSystems.fypp): a system wraps a response callable,
``response(x)`` or ``response(x, atol)`` (the reference's tolerance argument,
for time-stepper responses that integrate adaptively,
AbstractSystems.fypp:64-86), and its Jacobian is a linear operator carrying
the linearization state ``X`` (AbstractSystems.fypp:48-54).  The Jacobian
defaults to the exact derivative: ``matvec`` is ``torch.func.jvp`` and
``rmatvec`` ``torch.func.vjp`` of the response at ``X``, where the JAX
package uses ``jax.jvp`` and ``jax.vjp``.  A user Jacobian replaces it.
"""

from __future__ import annotations

import torch

from .linops import LinearOperator, aslinop

__all__ = ["System", "JacobianOperator"]


class JacobianOperator(LinearOperator):
    """The Jacobian ``dF/dX`` at the state ``X`` as a linear operator
    (reference: ``abstract_jacobian_linop``, AbstractSystems.fypp:48-54,
    where the user writes the tangent map by hand).  ``X`` may be a tensor
    or a pytree of tensors; with ``params`` the response is called as
    ``response(params, x)``."""

    def __init__(self, response, X, params=None):
        self._response = response
        self.X = X
        self.params = params

    def _f(self, x):
        if self.params is not None:
            return self._response(self.params, x)
        return self._response(x)

    def matvec(self, dx):
        _, tangent = torch.func.jvp(self._f, (self.X,), (dx,))
        return tangent

    def rmatvec(self, dy):
        """``J^H dy``.  The JAX package conjugates the cotangent and the
        result of ``jax.vjp`` to get it for a complex map
        (``systems.py:51-57``); ``torch.func.vjp`` returns the
        conjugate-transpose action itself, so no conjugation is needed."""
        _, vjp = torch.func.vjp(self._f, self.X)
        (x,) = vjp(dy)
        return x

    def with_state(self, X):
        """The Jacobian at a new state (reference: ``jacobian%X = X``,
        NewtonKrylov.fypp:346)."""
        return JacobianOperator(self._response, X, self.params)


class System:
    """Nonlinear system ``F(X)`` (reference: ``abstract_system``,
    AbstractSystems.fypp:19-40).

    ``response`` is ``response(x)``, or ``response(x, atol)`` with
    ``takes_atol=True``; ``jacobian``, optional, is ``jacobian(x) ->
    LinearOperator`` and defaults to :class:`JacobianOperator`."""

    def __init__(self, response, jacobian=None, takes_atol: bool = False):
        self._response = response
        self._jacobian = jacobian
        self._takes_atol = takes_atol

    def eval(self, x, atol: float = 0.0):
        """``F(x)`` (reference: the counting wrapper ``eval``,
        AbstractSystems.fypp:163-180)."""
        if self._takes_atol:
            return self._response(x, atol)
        return self._response(x)

    def jacobian(self, x, atol: float = 0.0) -> LinearOperator:
        """The Jacobian operator at ``x``."""
        if self._jacobian is not None:
            return aslinop(self._jacobian(x))
        if self._takes_atol:
            return JacobianOperator(lambda xx: self._response(xx, atol), x)
        return JacobianOperator(self._response, x)
