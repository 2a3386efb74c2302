"""Preconditioned conjugate gradient.

Counterpart of :mod:`lightkrylov_tpu.solvers.cg` (reference:
src/IterativeSolvers/CG/CG.fypp:106-171): PCG with ``z = M^-1 r``,
maxiter=100 by default (IterativeSolvers.fypp:467-474), the iteration-aware
preconditioner interface and residual-history metadata; ``A`` is trusted to
be symmetric/Hermitian positive definite.

A host loop: its one wait per iteration is the convergence flag
(``res >= tol``, through :func:`..utils.timer.host_read`), plus one batched
fetch of the metadata at the end.  While timing is on, an iteration is a
span ``cg.matvec`` (the operator) and a span ``cg.update`` (the rest).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..utils.logger import check_info
from ..utils.options import CGOptions, SolverMetadata
from ..utils.timer import count_applications, host_read, timed, timed_fn

__all__ = ["cg"]


def _nonzero(a):
    return torch.where(a == 0, torch.ones_like(a), a)


def _cg_impl(A, b, x0, M, tol, maxiter):
    rdt = constants.real_dtype_of(vectors.dtype_of(b))

    def precond(r, k, res):
        # iteration-aware interface (IterativeSolvers.fypp:80-95)
        if isinstance(M, Preconditioner):
            return M.apply(r, iteration=k, current_residual=res,
                           target_residual=tol)
        return M.matvec(r)

    x = x0
    with timed("cg.matvec", "IterativeSolvers", device=True):
        r = A.matvec(x0)
    r = vectors.axpby(1.0, b, -1.0, r)
    res = vectors.norm(r).to(rdt)
    z = precond(r, 0, res)
    p = z
    rz = vectors.dot(r, z)
    hist = torch.zeros(maxiter, dtype=rdt, device=pytree.tree_leaves(b)[0].device)
    k = 0
    while k < maxiter and bool(host_read(res >= tol)):
        with timed("cg.matvec", "IterativeSolvers", device=True):
            Ap = A.matvec(p)
        with timed("cg.update", "IterativeSolvers", device=True):
            alpha = rz / _nonzero(vectors.dot(p, Ap))
            x = vectors.axpby(1.0, x, alpha, p)
            r = vectors.axpby(1.0, r, -alpha, Ap)
            res = vectors.norm(r).to(rdt)
            z = precond(r, k + 1, res)
            rz_new = vectors.dot(r, z)
            p = vectors.axpby(1.0, z, rz_new / _nonzero(rz), p)
            rz = rz_new
            hist[k] = res
        k += 1
    return x, res, hist[:k], k


@timed_fn("cg", "IterativeSolvers")
def cg(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
       options: CGOptions | None = None):
    """Preconditioned CG for SPD/HPD ``A x = b`` -> ``(x, info, metadata)``
    (reference: ``cg``, CG.fypp:106-171; ``info = +-n_iter``)."""
    A = aslinop(A)
    rdt = constants.real_dtype_of(vectors.dtype_of(b))
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    opts = options or CGOptions()
    M = aslinop(preconditioner) if preconditioner is not None else IdentityOperator()
    if x0 is None:
        x0 = vectors.zero_like(b)
    tol = (atol + rtol * vectors.norm(b)).to(rdt)  # stays on the device

    x, res, hist, k = _cg_impl(A, b, x0, M, tol, opts.maxiter)
    fetched = host_read(torch.cat([hist, res.reshape(1), tol.reshape(1)]))
    hist, res, tol = fetched[:-2], float(fetched[-2]), float(fetched[-1])
    converged = res < tol
    info = k if converged else -k
    # r0 matvec + one matvec per iteration (apply_matvec accounting)
    count_applications(A, k + 1, "matvec")
    if not isinstance(M, IdentityOperator):
        count_applications(M, k + 1, "matvec")
    check_info(info, "cg", "solvers", "cg")
    meta = SolverMetadata(converged=converged, n_iter=k, n_inner=k, info=info,
                          residuals=hist)
    if opts.if_print_metadata:
        meta.print()
    return x, info, meta
