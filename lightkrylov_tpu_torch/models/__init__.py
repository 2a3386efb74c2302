"""Model operators."""

from .convdiff import ConvectionDiffusion2D
from .ginzburg_landau import (GinzburgLandau, GinzburgLandauReal, GLPropagator,
                              gl_analytic_eigvals)
from .poisson import BlockJacobiPoisson, Poisson2D, poisson2d_eigvals
from .toeplitz import TridiagToeplitz, toeplitz_eigvals

__all__ = ["BlockJacobiPoisson", "ConvectionDiffusion2D", "GLPropagator", "GinzburgLandau",
           "GinzburgLandauReal", "Poisson2D", "TridiagToeplitz", "gl_analytic_eigvals",
           "poisson2d_eigvals", "toeplitz_eigvals"]
