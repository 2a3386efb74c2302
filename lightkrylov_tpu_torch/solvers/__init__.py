"""Linear solvers, eigensolvers and the Krylov exponential."""

from .cg import cg
from .eighs import eighs
from .eigs import eigs, save_eigenspectrum
from .expm import ExponentialPropagator, kexpm, kexpm_mat, krylov_exptA
from .gmres import fgmres, gmres

__all__ = ["ExponentialPropagator", "cg", "eighs", "eigs", "fgmres", "gmres", "kexpm",
           "kexpm_mat", "krylov_exptA", "save_eigenspectrum"]
