"""Model operators."""

from .poisson import BlockJacobiPoisson, Poisson2D, poisson2d_eigvals

__all__ = ["BlockJacobiPoisson", "Poisson2D", "poisson2d_eigvals"]
