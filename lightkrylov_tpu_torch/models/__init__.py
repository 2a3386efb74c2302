"""Model operators."""

from .convdiff import ConvectionDiffusion2D
from .poisson import BlockJacobiPoisson, Poisson2D, poisson2d_eigvals
from .toeplitz import TridiagToeplitz, toeplitz_eigvals

__all__ = ["BlockJacobiPoisson", "ConvectionDiffusion2D", "Poisson2D",
           "TridiagToeplitz", "poisson2d_eigvals", "toeplitz_eigvals"]
