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

Without a preconditioner, on one real contiguous float32 or float64 tensor
and with no reduction group set, the update after the operator runs as the
three kernels of :mod:`..ops.cg` (the plain versions on the CPU): the same
recurrences, with ``x``, ``r`` and ``p`` updated in place in the solve's own
buffers and ``alpha``, ``beta`` and the flag kept on the device; counted as
``"cg.fused_iterations"``.  Every other solve takes the loop of separate
vector operations.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..ops import cg as fused
from ..utils.logger import check_info
from ..utils.options import CGOptions, SolverMetadata
from ..utils.timer import count_applications, count_event, host_read, timed, timed_fn

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
    if _fits_fused(b, x0, r, M):
        return _cg_fused(A, b, x0, r, tol, maxiter)
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


def _fits_fused(b, x0, Ax0, M):
    """Whether the solve suits the kernels of :mod:`..ops.cg`: no
    preconditioner, no reduction group, and ``b``, ``x0`` and ``A x0`` one
    real float32 or float64 tensor each, alike, ``b`` contiguous."""
    return (isinstance(M, IdentityOperator) and vectors.reduction_group() is None
            and all(type(t) is torch.Tensor for t in (b, x0, Ax0))
            and b.dtype in (torch.float32, torch.float64) and b.is_contiguous()
            and all(t.dtype == b.dtype and t.shape == b.shape and t.device == b.device
                    for t in (x0, Ax0)))


def _cg_fused(A, b, x0, Ax0, tol, maxiter):
    """The loop of :func:`_cg_impl` without a preconditioner, its update
    after the operator as :class:`..ops.cg.FusedCG`'s three kernels.  ``x``,
    ``r`` and ``p`` are the solve's own buffers, updated in place: nothing
    the caller passed is written, and ``p`` does not alias ``r``.  The flag
    is read once an iteration, as there, but between the kernel that sets it
    and the last kernel, which it does not depend on; the update's two
    launches and its last one are each a ``cg.update`` span."""
    x = x0.clone(memory_format=torch.contiguous_format)
    r = (b - Ax0).contiguous()
    p = r.clone()
    s = fused.scalars(torch.dot(r.reshape(-1), r.reshape(-1)), torch.linalg.vector_norm(r), tol)
    flag = s[fused.FLAG:fused.FLAG + 1]
    hist = torch.zeros(maxiter, dtype=b.dtype, device=b.device)
    k = 0
    with fused.FusedCG(x, r, p, s, hist) as kernels:
        more = maxiter > 0 and bool(host_read(flag))
        while more:
            with timed("cg.matvec", "IterativeSolvers", device=True):
                Ap = A.matvec(p)
            with timed("cg.update", "IterativeSolvers", device=True):
                kernels.update(Ap, k)
            k += 1
            # the next iteration's test, read before cg_p is queued, so the
            # card runs cg_p while the host queues that iteration; outside
            # the spans, as the separate operations' loop reads it
            more = k < maxiter and bool(host_read(flag))
            with timed("cg.update", "IterativeSolvers", device=True):
                kernels.direction()
    count_event("cg.fused_iterations", k)
    return x, s[fused.RES], hist[:k], k


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
