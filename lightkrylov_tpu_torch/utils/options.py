"""Options and metadata records of the solvers.

Mirror of :mod:`lightkrylov_tpu.utils.options` for the solvers this package
ports (reference: ``gmres_*_opts`` kdim=30, maxiter=10,
IterativeSolvers.fypp:141-151; ``cg_*_opts`` maxiter=100, :468-474; the
eigensolver defaults kdim = 4*nev, :1023-1024; and the metadata types,
:153-186,476-505).  The fields and defaults are the JAX
package's, so options carry across by field name (:mod:`..convert`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["GMRESOptions", "CGOptions", "EigsOptions", "SolverMetadata"]


@dataclass(frozen=True)
class GMRESOptions:
    """(reference: ``gmres_{sp,dp}_opts``, IterativeSolvers.fypp:141-151).

    ``orthogonalization``: ``"dcgs2"`` (default) is the delayed
    re-orthogonalization variant, one fused reduction and two basis streams
    per inner iteration; ``"cgs2"`` is the classical reference scheme
    (gmres.fypp:167-169).  FGMRES always uses CGS2.
    """

    kdim: int = 30          # dimension of the Krylov subspace per restart
    maxiter: int = 10       # number of restarts
    if_print_metadata: bool = False
    sanity_check: bool = True  # recompute the true residual each outer cycle
    orthogonalization: str = "dcgs2"


@dataclass(frozen=True)
class CGOptions:
    """(reference: ``cg_{sp,dp}_opts``, IterativeSolvers.fypp:467-474)."""

    maxiter: int = 100
    if_print_metadata: bool = False


@dataclass(frozen=True)
class EigsOptions:
    """Options of ``eighs`` (reference: defaults kdim = 4*nev, tol = rtol,
    IterativeSolvers.fypp:1023-1024); the JAX record's fields and defaults.

    Only what the host projected path reads is implemented; ``eighs``
    raises :class:`NotImplementedError` on the rest rather than ignore it:

    * ``projected``: ``"auto"`` and ``"host"`` both mean the host path (a
      dense ``eigh`` of the projected matrix per check); ``"device"``, the
      fused on-device sweep, waits for ROADMAP M10.
    * ``checkpoint_every`` other than 0 (and ``eighs(resume_from=...)``):
      checkpointing is ROADMAP M13.
    * ``write_intermediate``: read by ``eigs`` (ROADMAP M8); the JAX
      ``eighs`` does not read it either.
    """

    kdim: int | None = None       # None -> 4 * nev
    maxiter: int = 20             # max restart cycles
    write_intermediate: bool = False
    outpost: str = "eigs_output.txt"
    checkpoint_every: int = 0     # every N convergence checks; 0 = off
    checkpoint_path: str | None = None
    projected: str = "auto"


@dataclass
class SolverMetadata:
    """Iteration counts and residual history of a solve
    (reference: ``gmres_*_metadata`` etc, IterativeSolvers.fypp:153-186)."""

    converged: bool = False
    n_iter: int = 0
    n_inner: int = 0
    info: int = 0
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def history(self) -> np.ndarray:
        """Residual history trimmed to executed iterations."""
        return self.residuals[: self.n_inner if self.n_inner else self.n_iter]

    def print(self, log_fn=print) -> None:
        log_fn(
            f"converged={self.converged} n_iter={self.n_iter} "
            f"n_inner={self.n_inner} final_res="
            f"{self.history[-1] if len(self.history) else float('nan'):.3e}"
        )

