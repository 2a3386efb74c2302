"""Linear solvers, eigen- and singular value solvers, the Krylov exponential
and Newton-Krylov."""

from .cg import cg
from .eighs import eighs
from .eigs import eigs, save_eigenspectrum
from .expm import ExponentialPropagator, kexpm, kexpm_mat, krylov_exptA
from .gmres import fgmres, gmres
from .newton import constant_tol, dynamic_tol, newton
from .svds import svds

__all__ = ["ExponentialPropagator", "cg", "constant_tol", "dynamic_tol", "eighs", "eigs",
           "fgmres", "gmres", "kexpm", "kexpm_mat", "krylov_exptA", "newton",
           "save_eigenspectrum", "svds"]
