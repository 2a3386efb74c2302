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
           "NewtonOptions", "SolverMetadata", "NewtonMetadata", "check_projected"]


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

    ``projected`` picks where the k x k projected problem of each check is
    solved:

    * ``"host"``: read to the host for a dense numpy ``eig``/``eigh``/``svd``
      (the JAX package's host path);
    * ``"device"``: the fused device sweep of :mod:`..utils.hessenberg`, the
      Francis-QR kernel on a card, with device restarts (exact-shift IRAM,
      the device Krylov-Schur restart, device thick restarts); complex
      dtypes take the host path, as in the JAX package;
    * ``"auto"`` (default): the host path.  The JAX package's ``"auto"``
      chooses the device path only on a TPU, where every host check was a
      relay round-trip; off a TPU it is the host path, and so it is here.

    ``write_intermediate``/``outpost``: ``eigs`` writes the Ritz values and
    residuals of each check to ``outpost``; ``eighs`` accepts them and does
    not read them, as the JAX ``eighs`` does.
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


def check_projected(name: str, opts) -> None:
    """Raise ``ValueError`` on a ``projected`` choice of ``opts``
    (:class:`EigsOptions` or :class:`SVDSOptions`) other than ``"auto"``,
    ``"host"`` and ``"device"``."""
    if opts.projected not in ("auto", "host", "device"):
        raise ValueError(f"{name}: unknown projected={opts.projected!r} "
                         "(expected 'auto', 'host' or 'device')")


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

    def reset(self) -> None:
        self.converged = False
        self.n_iter = 0
        self.n_inner = 0
        self.info = 0
        self.residuals = np.zeros(0)


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
