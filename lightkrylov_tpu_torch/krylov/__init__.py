"""Krylov building blocks (the CGS2 step of the linear solvers)."""

from .gram_schmidt import double_gram_schmidt_step, orthogonalize_against_basis

__all__ = ["double_gram_schmidt_step", "orthogonalize_against_basis"]
