"""Options and metadata records of the solvers.

Mirror of :mod:`lightkrylov_tpu.utils.options` for the solvers this package
ports (reference: ``gmres_*_opts`` kdim=30, maxiter=10,
IterativeSolvers.fypp:141-151; ``cg_*_opts`` maxiter=100, :468-474; the
eigensolver defaults kdim = 4*nev, :1023-1024; ``newton_*_opts``
maxiter=100, ifbisect, maxstep_bisection=5, NewtonKrylov.fypp:28-39; and the
metadata types, IterativeSolvers.fypp:153-186,476-505, NewtonKrylov.fypp:44-65).
The fields and defaults are the JAX package's, so options carry across by
field name (:mod:`..convert`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["GMRESOptions", "CGOptions", "EigsOptions", "SVDSOptions", "KexpmOptions",
           "NewtonOptions", "SolverMetadata", "NewtonMetadata", "check_host_projected"]


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
    """Options of ``eigs`` and ``eighs`` (reference: defaults kdim = 4*nev,
    tol = rtol, IterativeSolvers.fypp:1023-1024); the JAX record's fields
    and defaults.

    ``checkpoint_every``/``checkpoint_path``: write the factorization state
    (basis, projected matrix, restart index, counters) to one ``.npz`` every
    N convergence checks, at the next sweep or restart boundary, or, when
    the path names a directory (ends with a separator), with
    ``torch.distributed.checkpoint``; the solver's ``resume_from=`` argument
    restores it from either (:mod:`.checkpoint`).

    Only what the host projected path reads is implemented; the solvers
    raise :class:`NotImplementedError` on the rest rather than ignore it:

    * ``projected``: ``"auto"`` and ``"host"`` both mean the host path (a
      dense ``eig``/``eigh`` of the projected matrix per check);
      ``"device"``, the fused on-device sweep, waits for ROADMAP M10.
    * ``write_intermediate``/``outpost``: ``eigs`` writes the Ritz values
      and residuals of each check to ``outpost``; the JAX ``eighs`` does not
      read them, and the port's ``eighs`` raises on ``write_intermediate``.
    """

    kdim: int | None = None       # None -> 4 * nev
    maxiter: int = 20             # max restart cycles
    write_intermediate: bool = False
    outpost: str = "eigs_output.txt"
    checkpoint_every: int = 0     # every N convergence checks; 0 = off
    checkpoint_path: str | None = None
    projected: str = "auto"


@dataclass(frozen=True)
class SVDSOptions:
    """Options of ``svds`` (the JAX record's fields and defaults; see
    :class:`EigsOptions` for ``checkpoint_every`` and ``projected``)."""

    kdim: int | None = None       # None -> 4 * nsv
    maxiter: int = 20             # max restart cycles
    checkpoint_every: int = 0     # every N convergence checks; 0 = off
    checkpoint_path: str | None = None
    projected: str = "auto"


def check_host_projected(name: str, opts) -> None:
    """Raise on a ``projected`` choice of ``opts`` (:class:`EigsOptions` or
    :class:`SVDSOptions`) that the host projected path of ``eigs``,
    ``eighs`` and ``svds`` does not implement."""
    if opts.projected == "device":
        raise NotImplementedError(
            f"{name}: projected='device' (the fused on-device sweep) is not ported yet "
            "(ROADMAP M10). Use 'host' or 'auto'.")
    if opts.projected not in ("auto", "host"):
        raise ValueError(f"{name}: unknown projected={opts.projected!r}")


@dataclass(frozen=True)
class KexpmOptions:
    """(reference: kdim=30 default wrapper, kmax=100; ExpmLib.fypp:149,365-392)."""

    kdim: int = 30


@dataclass(frozen=True)
class NewtonOptions:
    """(reference: ``newton_{sp,dp}_opts``, NewtonKrylov.fypp:28-39)."""

    maxiter: int = 100
    ifbisect: bool = False
    maxstep_bisection: int = 5
    if_print_metadata: bool = False


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



@dataclass
class NewtonMetadata:
    """(reference: ``newton_*_metadata``, one (residual, tolerance) record
    per evaluation, NewtonKrylov.fypp:44-65,221-242).

    ``residuals`` and ``tolerances`` hold one entry per ``system.eval``: the
    initial evaluation, every bisection probe, each post-update residual and
    each target-tolerance recheck, so ``n_evals == len(residuals)``."""

    converged: bool = False
    n_iter: int = 0
    n_evals: int = 0
    info: int = 0
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tolerances: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def print(self, log_fn=print) -> None:
        log_fn(
            f"newton: converged={self.converged} n_iter={self.n_iter} "
            f"residuals={np.array2string(self.residuals, precision=3)}"
        )
