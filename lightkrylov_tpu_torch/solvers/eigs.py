"""General eigenvalue solver: Arnoldi with Krylov-Schur restarts.

Counterpart of :mod:`lightkrylov_tpu.solvers.eigs` (reference:
src/IterativeSolvers/IterativeSolvers.fypp:971-1143): an outer Krylov-Schur
loop grows an Arnoldi factorization, a dense ``eig`` of the projected
Hessenberg gives the Ritz pairs at each check, Ritz residuals are
``|beta * (last row of the eigenvector)|`` (:1069-1083), the solve stops
when the leading ``nev`` residuals are below ``tol``, and otherwise it
restarts at ``kdim`` through ``krylov_schur`` with a median-of-|lambda|
selector (:1099-1100,1137-1142).  The Ritz vectors are ``X @ eigvecs``,
sorted by ``|lambda|`` descending (:1108-1132).  Defaults: ``kdim = 4*nev``,
``tol = rtol`` (:1023-1024).

Only the JAX package's host projected path is ported (its
``eigs.py:608-656``), which is also the path it takes off a TPU: each check
reads ``H`` to the host for a numpy ``eig``.  With timing on, the host
solves are timed as ``eigs.projected_eig`` and, in restarts,
``krylov_schur.schur_select``.  Checks come every
``check_every`` steps, or once per sweep of ``kdim`` steps by default.  The
fused on-device sweep and restarts (``projected="device"``) wait for
ROADMAP M10; block mode (``blksize > 1``) waits for M13.

Checkpoints (``options.checkpoint_every``/``checkpoint_path`` and
``resume_from=``) write and restore ``(X, H, kstart, cycle, niter)`` at
sweep and restart boundaries, as the JAX solvers do; the checkpointer here
serves ``eighs`` and ``svds`` too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.arnoldi import arnoldi, initialize_arnoldi
from ..krylov.krylov_schur import krylov_schur, median_selector
from ..linops import aslinop
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata, check_host_projected
from ..utils.timer import count_applications, host_read, timed, timed_fn

__all__ = ["eigs", "save_eigenspectrum"]


def _check_options(opts: EigsOptions, blksize: int) -> None:
    """Raise on every option the host path does not implement."""
    if blksize > 1:
        raise NotImplementedError(
            "eigs: blksize > 1 (block mode) is not ported; see ROADMAP M13 "
            "(it rests on the device restarts of M10).")
    check_host_projected("eigs", opts)


class _DriverCheckpointer:
    """Checkpoint cadence and writing, shared by ``eigs``, ``eighs`` and
    ``svds`` (the JAX package's ``eigs.py:337-372``).

    ``every`` counts convergence checks; the state is written at the next
    safe boundary, one where entering the solver's loop again with the stored
    ``(kstart, cycle)`` repeats the uninterrupted run.  Only the IO rank
    writes."""

    def __init__(self, every: int, path):
        self.every = int(every or 0)
        self.path = path
        self._since = 0

    def check(self) -> None:
        self._since += 1

    @property
    def due(self) -> bool:
        return self.every > 0 and self.path is not None and self._since >= self.every

    def save(self, state: dict) -> None:
        if not self.due:
            return
        if constants.io_rank():
            save_checkpoint(state, self.path)
        self._since = 0


def _resume_driver_state(template: dict, path: str) -> dict:
    """The solver state stored at ``path``, shaped like ``template``, with
    ``kstart``, ``cycle`` and ``niter`` as Python ints."""
    st = load_checkpoint(template, path)
    for k in ("kstart", "cycle", "niter"):
        st[k] = int(st[k])
    return st


def _solver_state(bases: dict, kstart: int, cycle: int, niter: int) -> dict:
    """The state a solver checkpoints: its buffers and three counters."""
    return dict(bases, kstart=np.int64(kstart), cycle=np.int64(cycle), niter=np.int64(niter))


def _ritz_residuals(H, evecs, k):
    """Ritz residuals ``res_i = |H[k, k-1]| * |evecs[k-1, i]|`` (reference:
    IterativeSolvers.fypp:1069-1083; with complex eigenvectors the
    conjugate-pair bookkeeping of LAPACK's real form disappears)."""
    return abs(H[k, k - 1]) * np.abs(evecs[-1, :])


@timed_fn("eigs", "IterativeSolvers")
def eigs(A, nev: int, x0=None, kdim: int | None = None, tolerance: float | None = None,
         transpose: bool = False, select=None, options: EigsOptions | None = None,
         generator: torch.Generator | None = None, check_every: int | None = None,
         resume_from: str | None = None, blksize: int = 1):
    """Leading eigenpairs of a general square operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)`` (reference: ``eigs``,
    IterativeSolvers.fypp:971-1143).

    ``eigvals`` is a complex numpy array sorted by modulus, descending;
    ``eigvecs`` a basis (leading axis ``nev``) of complex tensors shaped
    like ``x0``, reconstructed over a real basis as two real products (the
    basis is never copied to complex); ``residuals`` the matching Ritz
    residuals as a real numpy array; ``info`` the number of converged pairs,
    negative if they did not converge within ``options.maxiter`` restart
    cycles.

    Documented deviation, copied from the JAX package: convergence counts
    the LEADING ``nev`` Ritz values (the ones returned), where the
    reference counts over the whole spectrum (:1087-1092), so
    ``info = nev`` means every returned pair meets the tolerance.

    ``select(eigvals) -> bool mask`` picks what a restart keeps (default:
    :func:`..krylov.krylov_schur.median_selector`).  ``x0`` is required; a
    zero ``x0`` is replaced by a random vector from ``generator`` (default:
    a new generator seeded with 0 on ``x0``'s device).  With
    ``options.write_intermediate`` each check writes its Ritz values and
    residuals to ``options.outpost``.

    ``options.checkpoint_every``/``checkpoint_path`` write the factorization
    state ``(X, H, kstart, cycle, niter)`` at sweep and restart boundaries;
    ``resume_from=`` restores it and continues the run (``x0`` then only
    gives the buffers' shape, dtype and device)."""
    A = aslinop(A)
    opts = options or EigsOptions()
    _check_options(opts, blksize)
    if kdim is None:
        kdim = opts.kdim or 4 * nev  # (reference: :1023)
    if x0 is None:
        raise ValueError("eigs requires x0 (a template/seed vector)")
    dt = vectors.dtype_of(x0)
    rdt = constants.as_numpy_dtype(constants.real_dtype_of(dt))
    cdt = np.dtype(np.complex64) if rdt == np.float32 else np.dtype(np.complex128)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    if select is None:
        select = median_selector
    stride = kdim if not check_every else check_every
    kind = "rmatvec" if transpose else "matvec"

    seed = x0
    if float(host_read(vectors.norm(x0))) == 0.0:
        if generator is None:
            generator = torch.Generator(device=pytree.tree_leaves(x0)[0].device).manual_seed(0)
        seed = vectors.rand_like(generator, x0)
    X, H = initialize_arnoldi(seed, kdim)

    kstart = 1
    cycle0 = 0
    n_conv = 0
    niter = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path)
    if resume_from is not None:
        st = _resume_driver_state(_solver_state({"X": X, "H": H}, 0, 0, 0), resume_from)
        X, H = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(f"eigs: resumed from {resume_from} (cycle {cycle0}, kstart {kstart}, "
                        f"{niter} matvecs done)", "solvers", "eigs")
    res_history = []
    invariant = False
    for cycle in range(cycle0, opts.maxiter):
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            X, H, ainfo = arnoldi(A, X, H, kstart=k, kend=kend, transpose=transpose)
            ainfo = int(host_read(ainfo))
            check_info(ainfo, "arnoldi", "solvers", "eigs")
            k_eff = ainfo if ainfo > 0 else kend
            niter += k_eff - (k - 1)
            count_applications(A, k_eff - (k - 1), kind)

            Hh = host_read(H)
            with timed("eigs.projected_eig", "IterativeSolvers"):
                w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
                r = _ritz_residuals(Hh, V, k_eff) if k_eff > 0 else np.zeros(0)
                if ainfo > 0:
                    r = np.zeros_like(r)  # invariant subspace: exact (:1099)
                    invariant = True
                order = np.argsort(-np.abs(w))
                w, V, r = w[order], V[:, order], r[order]
            n_conv = int(np.sum(r[:nev] < tol))
            res_history.append(r[: min(nev, len(r))].copy())
            if opts.write_intermediate and constants.io_rank():
                _write_intermediate(opts.outpost, w, r)
            evals, evecs, res, k_final = w, V, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if kend < kdim:
                # a sweep boundary inside the cycle: resuming enters this
                # cycle again at k = kend + 1
                ckpt.save(_solver_state({"X": X, "H": H}, kend + 1, cycle, niter))
            k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1:
            X, H, n = krylov_schur(X, H, select)  # (:1099-1100)
            kstart = n + 1
            # a restart boundary: resuming starts the next cycle at n + 1
            ckpt.save(_solver_state({"X": X, "H": H}, kstart, cycle + 1, niter))
            log_information(f"eigs: restart cycle {cycle + 1}, compressed to n={n}, "
                            f"{n_conv}/{nev} converged", "solvers", "eigs")

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eigs: only {n_conv}/{nev} pairs converged", "solvers", "eigs")

    # Ritz vectors X @ eigvecs (:1108-1132); complex coefficients over a
    # real basis contract as two real products (vectors.linear_combination)
    nev_out = min(nev, len(evals))
    coeffs = np.zeros((kdim, nev_out), dtype=cdt)
    coeffs[:k_final] = evecs[:, :nev_out]
    ritz_vecs = vectors.linear_combination(vectors.lead(X, kdim),
                                           torch.from_numpy(coeffs).to(H.device))

    info = n_conv if converged else -n_conv
    check_info(info if not converged else niter, "eigs", "solvers", "eigs")
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return evals[:nev_out].astype(cdt), ritz_vecs, res[:nev_out].astype(rdt), info, meta


def _write_intermediate(path, eigvals, residuals):
    """Text dump of the current Ritz values (reference: ``write_results_*``,
    IterativeSolvers.fypp:882-925, IO-rank gated)."""
    with open(path, "w") as f:
        f.write("# re(lambda) im(lambda) residual\n")
        for lam, r in zip(eigvals, residuals):
            f.write(f"{lam.real:+.16e} {lam.imag:+.16e} {r:.16e}\n")


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_eigenspectrum(eigvals, residuals, path: str) -> None:
    """Save the spectrum as ``.npy``, one row ``(re, im, residual)`` per
    eigenvalue (reference: ``save_eigenspectrum``,
    IterativeSolvers.fypp:944-963, stdlib ``save_npy``)."""
    eigvals, residuals = _numpy(eigvals), _numpy(residuals)
    out = np.zeros((len(eigvals), 3))
    out[:, 0] = eigvals.real
    out[:, 1] = eigvals.imag
    out[:, 2] = residuals
    np.save(path, out)
