"""Krylov building blocks: CGS2 and the Lanczos factorization."""

from .gram_schmidt import double_gram_schmidt_step, orthogonalize_against_basis
from .lanczos import initialize_lanczos, lanczos, lanczos_step

__all__ = ["double_gram_schmidt_step", "initialize_lanczos", "lanczos",
           "lanczos_step", "orthogonalize_against_basis"]
