"""Model operators."""

from .convdiff import ConvectionDiffusion2D
from .ginzburg_landau import (GinzburgLandau, GinzburgLandauReal, GLPropagator,
                              gl_analytic_eigvals)
from .otd import lyapunov_exponents, otd_evolve, otd_rhs
from .poisson import BlockJacobiPoisson, Poisson2D, poisson2d_eigvals
from .roessler import (UPOJacobian, fixed_point_system, floquet_exponents, flow, monodromy,
                       roessler_fixed_points, roessler_rhs, upo_system)
from .toeplitz import TridiagToeplitz, toeplitz_eigvals

__all__ = ["BlockJacobiPoisson", "ConvectionDiffusion2D", "GLPropagator", "GinzburgLandau",
           "GinzburgLandauReal", "Poisson2D", "TridiagToeplitz", "UPOJacobian",
           "fixed_point_system", "floquet_exponents", "flow", "gl_analytic_eigvals",
           "lyapunov_exponents", "monodromy", "otd_evolve", "otd_rhs", "poisson2d_eigvals",
           "roessler_fixed_points", "roessler_rhs", "toeplitz_eigvals", "upo_system"]
