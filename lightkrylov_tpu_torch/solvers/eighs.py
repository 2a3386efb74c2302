"""Hermitian eigenvalue solver: Lanczos and a dense ``eigh``, with thick
restart.

Counterpart of :mod:`lightkrylov_tpu.solvers.eighs` (reference:
src/IterativeSolvers/EIGHS/eighs.fypp): incremental Lanczos with full
re-orthogonalization and a dense ``eigh`` of the projected tridiagonal at
each check (eighs.fypp:79-101), Ritz residuals ``|beta * v_last|``
(:91-92), the descending sort and the Ritz-vector reconstruction
(:107-123).  On non-convergence at ``kdim`` it thick-restarts (Wu & Simon)
as the JAX package does: the basis is compressed onto the ``n`` best Ritz
vectors, ``T`` becomes ``diag(theta)`` with the coupling row
``beta * V[kdim-1, :n]`` at row ``n``, and Lanczos goes on from column
``n+1``.

Only the JAX package's host projected path is ported (its
``eighs.py:253-314``), which is also the path it takes off a TPU: each check
reads ``T`` to the host for a numpy ``eigh``.  Checks come every
``check_every`` steps, or once per sweep of ``kdim`` steps by default.  The
fused on-device sweep and restart (``projected="device"``) wait for ROADMAP
M10.  Checkpoints write and restore ``(X, T, kstart, cycle, niter)`` at
sweep and restart boundaries (see :mod:`.eigs`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.lanczos import initialize_lanczos, lanczos
from ..linops import aslinop
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata, check_host_projected
from ..utils.timer import count_applications, host_read, timed_fn
from .eigs import _DriverCheckpointer, _solver_state, _resume_driver_state

__all__ = ["eighs"]


def _check_options(opts: EigsOptions) -> None:
    """Raise on every option the host path does not implement."""
    check_host_projected("eighs", opts)
    if opts.write_intermediate:
        raise NotImplementedError(
            "eighs: write_intermediate is read by eigs, not by eighs (as in the JAX package).")


def _thick_restart(X, evals, evecs, beta, n: int):
    """Compress the basis onto the ``n`` leading Ritz vectors and move the
    residual vector (column ``kdim``) to column ``n``; the new ``T`` is
    ``diag(evals[:n])`` with the coupling row ``beta * evecs[kdim-1, :n]``
    at row ``n``.  Returns new ``(X, T)``."""
    kdim = evecs.shape[0]
    leaf = pytree.tree_leaves(X)[0]
    dt, dev = leaf.dtype, leaf.device
    coeffs = torch.zeros((kdim, kdim), dtype=dt)
    coeffs[:, :n] = torch.from_numpy(np.ascontiguousarray(evecs[:, :n])).to(dt)
    Xc = vectors.linear_combination(vectors.lead(X, kdim), coeffs.to(dev))
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]),
                            Xc, X)
    vectors.set_column(X_new, n, vectors.get_column(X, kdim))
    T = torch.zeros((kdim + 1, kdim), dtype=dt)
    idx = torch.arange(n)
    T[idx, idx] = torch.from_numpy(np.ascontiguousarray(evals[:n])).to(dt)
    T[n, :n] = torch.from_numpy(beta * evecs[kdim - 1, :n]).to(dt)
    return X_new, T.to(dev)


@timed_fn("eighs", "IterativeSolvers")
def eighs(A, nev: int, x0=None, kdim: int | None = None,
          tolerance: float | None = None, options: EigsOptions | None = None,
          generator: torch.Generator | None = None, check_every: int | None = None,
          resume_from: str | None = None):
    """Leading eigenpairs of a symmetric/Hermitian operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)`` (reference: ``eighs``,
    eighs.fypp:28-123; restart cycles bounded by ``options.maxiter``).

    ``eigvals`` and ``residuals`` are real numpy arrays of ``nev`` entries,
    eigenvalues sorted descending; ``eigvecs`` is a basis (leading axis
    ``nev``) of tensors shaped like ``x0``.  ``info = n_conv`` when the
    leading ``nev`` Ritz pairs converged (residual below ``tolerance``,
    default ``rtol`` of the dtype) or the Krylov space became invariant,
    else ``-n_conv``.  ``x0`` is required, as in the JAX package; a zero
    ``x0`` is replaced by a random vector from ``generator`` (default: a
    new generator seeded with 0 on ``x0``'s device).

    ``options.checkpoint_every``/``checkpoint_path`` and ``resume_from``
    write and restore ``(X, T, kstart, cycle, niter)`` at sweep and restart
    boundaries, as in :func:`.eigs.eigs`."""
    A = aslinop(A)
    opts = options or EigsOptions()
    _check_options(opts)
    if kdim is None:
        kdim = opts.kdim or 4 * nev
    if x0 is None:
        raise ValueError("eighs requires x0 (a template/seed vector)")
    dt = vectors.dtype_of(x0)
    rdt = constants.real_dtype_of(dt)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    stride = kdim if not check_every else check_every

    seed = x0
    if float(host_read(vectors.norm(x0))) == 0.0:
        if generator is None:
            dev = pytree.tree_leaves(x0)[0].device
            generator = torch.Generator(device=dev).manual_seed(0)
        seed = vectors.rand_like(generator, x0)
    X, T = initialize_lanczos(seed, kdim)

    niter = 0
    kstart = 1
    cycle0 = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path, {"X": 1})
    if resume_from is not None:
        # the JAX package stores T under the key "H"
        st = _resume_driver_state(_solver_state({"X": X, "H": T}, 0, 0, 0), resume_from,
                                  {"X": 1})
        X, T = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(f"eighs: resumed from {resume_from} (cycle {cycle0}, kstart {kstart}, "
                        f"{niter} matvecs done)", "solvers", "eighs")
    res_history = []
    invariant = False
    n_conv = 0
    for cycle in range(cycle0, opts.maxiter):
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            X, T, linfo = lanczos(A, X, T, kstart=k, kend=kend)
            linfo = int(host_read(linfo))
            check_info(linfo, "lanczos", "solvers", "eighs")
            k_eff = linfo if linfo > 0 else kend
            count_applications(A, max(k_eff - (k - 1), 0), "matvec")
            niter += k_eff - (k - 1)

            Th = host_read(T)
            Tk = Th[:k_eff, :k_eff]
            Tk = (Tk + Tk.conj().T) / 2  # CGS2 leaves tiny asymmetric noise
            w, V = np.linalg.eigh(Tk)
            beta = abs(Th[k_eff, k_eff - 1])
            r = beta * np.abs(V[-1, :])
            if linfo > 0:
                r = np.zeros_like(r)
                invariant = True
            order = np.argsort(-w)  # descending eigenvalue (:107)
            w, V, r = w[order], V[:, order], r[order]
            n_conv = int(np.sum(r[:nev] < tol))
            res_history.append(r[: min(nev, len(r))].copy())
            evals, evecs, res, k_final = w, V, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if kend < kdim:
                ckpt.save(_solver_state({"X": X, "H": T}, kend + 1, cycle, niter))
            k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            # thick restart: keep the n best Ritz pairs and the residual vector
            n = min(max(nev + (kdim - nev) // 2, nev + 1), kdim - 1)
            X, T = _thick_restart(X, evals, evecs, Th[kdim, kdim - 1], n)
            kstart = n + 1
            ckpt.save(_solver_state({"X": X, "H": T}, kstart, cycle + 1, niter))
            log_information(f"eighs: thick restart cycle {cycle + 1}, kept n={n}, "
                            f"{n_conv}/{nev} converged", "solvers", "eighs")

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eighs: only {n_conv}/{nev} pairs converged after "
                    f"{opts.maxiter} cycles", "solvers", "eighs")

    nev_out = min(nev, len(evals))
    coeffs = torch.zeros((kdim, nev_out), dtype=dt)
    coeffs[:k_final] = torch.from_numpy(np.ascontiguousarray(evecs[:, :nev_out])).to(dt)
    ritz_vecs = vectors.linear_combination(vectors.lead(X, kdim), coeffs.to(T.device))

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    np_rdt = constants.as_numpy_dtype(rdt)
    return evals[:nev_out].real.astype(np_rdt), ritz_vecs, res[:nev_out].astype(np_rdt), info, meta
