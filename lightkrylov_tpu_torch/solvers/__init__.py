"""Linear solvers and the Hermitian eigensolver."""

from .cg import cg
from .eighs import eighs
from .gmres import fgmres, gmres

__all__ = ["cg", "eighs", "fgmres", "gmres"]
