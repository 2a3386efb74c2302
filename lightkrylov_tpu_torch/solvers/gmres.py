"""GMRES and flexible GMRES with restarts and right preconditioning.

Counterpart of :mod:`lightkrylov_tpu.solvers.gmres` (reference:
src/IterativeSolvers/GMRES/gmres.fypp and fgmres.fypp): restarted
GMRES(kdim) whose inner loop is an Arnoldi sweep (gmres.fypp:153-196),
incremental Givens least squares (:177-182), right preconditioning (:155), a
triangular solve for the update (:199-202) and a true-residual recompute per
outer cycle (:204-214).  FGMRES keeps the preconditioned directions ``Z``
(fgmres.fypp:158-207).  ``info = +-n_iter`` (gmres.fypp:233-239).

Orthogonalization is DCGS2 by default (delayed re-orthogonalization: one
reduction and one rank-2 update over the basis per inner iteration, so one
all-reduce per iteration on row-partitioned vectors) or CGS2 (two
projections and a norm, three); FGMRES always uses CGS2.

Where the JAX package runs the restart nest as one ``while_loop`` on the
device, this is a host loop.  Its only waits on the device are the loop
conditions: one flag per inner iteration (``res >= tol``), one per outer
cycle, one per DCGS2 cycle that runs to ``kdim`` (did the last column
converge?), and one batched fetch of the metadata at the end.  All of them
go through :func:`..utils.timer.host_read`.  ``tol``, the Givens state and
the residual history stay on the device in the working dtype.  Basis
columns are written in place, and every reduction reads only the filled
columns ``V[:k+1]``.  While timing is on, each restart cycle is a span
``gmres.cycle`` holding ``gmres.matvec``, ``gmres.orth``, ``gmres.lsq`` and
``gmres.update`` spans (:mod:`..utils.timer`).

For real float32 or float64 vectors on a card, a DCGS2 iteration's k-sized
work, everything between the measurement and the rank-2 update and the
Givens update of the finished column, is one launch of
:func:`..ops.gmres.dcgs2_step` inside ``gmres.orth`` (no ``gmres.lsq`` span
a step), counted as ``"gmres.fused_steps"``, and the flag the loop reads is
the kernel's.  Where the vectors are besides one tensor (a pytree of one
leaf), so that the basis is one contiguous tensor, the measurement and the
rank-2 update are a launch each of :func:`..ops.gmres.dcgs2_measure` and
:func:`..ops.gmres.dcgs2_update`, which read the basis once each; those
steps are counted as ``"gmres.fused_basis_steps"`` too.  Complex vectors,
CGS2, FGMRES and the CPU run the same arithmetic as separate tensor
operations, the plain versions of :mod:`..ops.gmres`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.gram_schmidt import double_gram_schmidt_step
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..ops import gmres as fused
from ..ops.gmres import _padded, givens_col, safe_inverse
from ..utils import linalg
from ..utils.logger import check_info
from ..utils.options import GMRESOptions, SolverMetadata
from ..utils.timer import count_applications, count_event, host_read, timed, timed_fn

__all__ = ["gmres", "fgmres"]


def _gmres_impl(A, b, x0, M, tol, kdim, maxiter, transpose, flexible,
                sanity_check, orth):
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    dev = pytree.tree_leaves(b)[0].device
    eps_r = constants.eps(rdt)
    fused_route = orth == "dcgs2" and _fits_fused(dt, dev, kdim)
    basis_route = fused_route and len(pytree.tree_leaves(b)) == 1

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def matvec(v):
        return A.rmatvec(v) if transpose else A.matvec(v)

    def precond(vk, k, res):
        # right preconditioner (gmres.fypp:155), iteration-aware interface
        # (IterativeSolvers.fypp:80-95); ``res`` as it stands now (on the
        # fused route it lives in the kernel's scalar block)
        if isinstance(M, Preconditioner):
            return M.apply(vk, iteration=k, current_residual=res.clone(),
                           target_residual=tol)
        return M.matvec(vk)

    def dcgs2_cycle(V, R, c, s, e, res, hist, nin):
        """Inner sweep with delayed re-orthogonalization (the JAX
        ``dcgs2_body``/``dcgs2_flush``).  Slot k of ``V`` holds the
        uncorrected direction u_k; iteration k measures it, finishes
        Hessenberg column k-1, and writes the corrected q_k and the next
        direction u_{k+1} = (w - Q p - q_k t) / gamma with one rank-2 update.
        gamma, the Pythagorean estimate of ||u_{k+1}||, keeps every stored
        direction at unit scale (any positive scale is exact).

        On the fused route everything k-sized of an iteration, the Givens
        update of column k-1 included, is one launch of
        :func:`..ops.gmres.dcgs2_step` inside ``gmres.orth``, and the loop
        reads the kernel's flag; on one tensor the measurement, whose one
        buffer the all-reduce sums in place, and the rank-2 update are a
        launch each besides.  Otherwise the plain versions run as separate
        tensor operations, the Givens update after the rank-2 update in a
        ``gmres.lsq`` span.  Row k of the measurement gives (sigma, tau)
        because slot k holds u_k itself.  Returns ``(c, s, res, nin, k,
        matvecs)``."""
        if basis_route:
            st = fused.FusedDCGS2(R, c, s, e, hist, res, tol, eps_r, V=pytree.tree_leaves(V)[0])
        else:
            state = fused.FusedDCGS2 if fused_route else fused.DCGS2State
            st = state(R, c, s, e, hist, res, tol, eps_r)
        k = 0
        with st:
            while k < kdim and bool(host_read(st.flag)):
                u_k = vectors.get_column(V, k)
                with timed("gmres.matvec", "IterativeSolvers", device=True):
                    w = matvec(precond(u_k, k, st.res))
                with timed("gmres.orth", "IterativeSolvers", device=True):
                    if basis_route:
                        w = pytree.tree_leaves(w)[0]
                        m = vectors.allreduce_sum(fused.dcgs2_measure(st, k, w))[0]
                        fused.dcgs2_step(st, m[:-1].view(k + 1, 2), m[-1], k, nin)
                        fused.dcgs2_update(st, k, w)
                    else:
                        PR, wTw = vectors.allreduce_sum(*fused.dcgs2_measure_reference(V, k, w))
                        if fused_route:
                            C, inv_gamma = fused.dcgs2_step(st, PR, wTw, k, nin)
                        else:
                            C, inv_gamma = fused.dcgs2_coefficients_reference(st, PR, wTw, k)
                        fused.dcgs2_update_reference(V, k, w, C, inv_gamma)
                if k > 0:  # column k-1 into the least squares (reads no basis data)
                    if not fused_route:
                        with timed("gmres.lsq", "IterativeSolvers", device=True):
                            fused.dcgs2_givens_reference(st, k, nin)
                    nin += 1
                k += 1
            k_exit = k
            # stopped early only on convergence; at kdim the flag is unread yet
            if k_exit < kdim or bool(host_read(st.conv)):
                # the k_exit-1 finished columns already beat tol
                return st.c, st.s, st.res, nin, k_exit - 1, k_exit
            # finish the pending column k_exit-1: one reduction, no matvec
            with timed("gmres.lsq", "IterativeSolvers", device=True):
                zf = vectors.innerprod(vectors.lead(V, k_exit + 1), vectors.get_column(V, k_exit))
                if fused_route:
                    fused.dcgs2_flush(st, zf, k_exit, nin)
                else:
                    fused.dcgs2_flush_reference(st, zf, k_exit, nin)
        return st.c, st.s, st.res, nin + 1, k_exit, k_exit

    def cgs2_cycle(V, Z, R, c, s, e, res, hist, nin):
        k = 0
        while k < kdim and bool(host_read(res >= tol)):
            with timed("gmres.matvec", "IterativeSolvers", device=True):
                z = precond(vectors.get_column(V, k), k, res)
                w = matvec(z)
            with timed("gmres.orth", "IterativeSolvers", device=True):
                if flexible:
                    vectors.set_column(Z, k, z)
                w, proj = double_gram_schmidt_step(w, vectors.lead(V, k + 1))
                beta = vectors.norm(w)
                h_col = _padded(proj.to(dt), kdim + 1)
                h_col[k + 1] = beta
                vectors.set_column(V, k + 1, vectors.scal(safe_inverse(beta).to(rdt), w))
            with timed("gmres.lsq", "IterativeSolvers", device=True):
                c, s, res = givens_col(h_col, R, c, s, e, k)
                hist[nin] = res
            nin += 1
            k += 1
        return c, s, res, nin, k, k

    x = x0
    res = torch.full((), float("inf"), dtype=rdt, device=dev)
    hist = zeros(maxiter * kdim, dtype=rdt)
    outer = nin = n_iter = nmv = fused_steps = 0
    while outer < maxiter and bool(host_read(res >= tol)):
        with timed("gmres.cycle", "IterativeSolvers", device=True):
            with timed("gmres.matvec", "IterativeSolvers", device=True):
                r = matvec(x)
            r = vectors.axpby(1.0, b, -1.0, r)  # r0 = b - A x (:134-143)
            beta = vectors.norm(r)
            V = vectors.zeros_basis(b, kdim + 1)
            vectors.set_column(V, 0, vectors.scal(safe_inverse(beta).to(rdt), r))
            R = zeros(kdim, kdim)
            c = zeros(kdim, dtype=rdt)
            s = zeros(kdim)
            e = zeros(kdim + 1)
            e[0] = beta
            if orth == "dcgs2":
                c, s, res_in, nin, k, mv_inner = dcgs2_cycle(
                    V, R, c, s, e, beta.to(rdt), hist, nin)
                Z = None
            else:
                Z = vectors.zero_like(V) if flexible else None
                c, s, res_in, nin, k, mv_inner = cgs2_cycle(
                    V, Z, R, c, s, e, beta.to(rdt), hist, nin)

            # back-substitution on the rotated Hessenberg (gmres.fypp:199-202)
            if k > 0:
                with timed("gmres.update", "IterativeSolvers", device=True):
                    y = linalg.solve_triangular(R[:k, :k], e[:k])
                    dx = vectors.linear_combination(vectors.lead(Z if flexible else V, k), y)
                    if not flexible:
                        dx = M.matvec(dx)  # right-preconditioned correction (:201-202)
                    x = vectors.add(x, dx)

            if sanity_check:
                with timed("gmres.matvec", "IterativeSolvers", device=True):
                    r = matvec(x)
                res = vectors.norm(vectors.axpby(1.0, b, -1.0, r)).to(rdt)
                mv_cycle = mv_inner + 2
            else:
                res = res_in
                mv_cycle = mv_inner + 1
            outer += 1
            n_iter += k
            nmv += mv_cycle
            if fused_route:
                fused_steps += mv_inner
    if fused_steps:
        count_event("gmres.fused_steps", fused_steps)
        if basis_route:
            count_event("gmres.fused_basis_steps", fused_steps)
    return x, res, hist[:nin], nin, n_iter, outer, nmv


def _fits_fused(dt, dev, kdim) -> bool:
    """Whether DCGS2's k-sized work takes the kernel of :mod:`..ops.gmres`:
    real float32 or float64 vectors on a card and ``kdim`` within the
    kernel's.  It runs after the measurement's all-reduce, on inputs equal
    on every rank, so the reduction group does not matter; nor does it for
    the two passes over the basis, which work on this rank's rows."""
    return (dt in (torch.float32, torch.float64) and dev.type == "cuda"
            and kdim <= fused.MAX_KDIM)


def _solve(A, b, x0, rtol, atol, preconditioner, options, transpose, flexible, meta_name):
    A = aslinop(A)
    rdt = constants.real_dtype_of(vectors.dtype_of(b))
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    opts = options or GMRESOptions()
    M = aslinop(preconditioner) if preconditioner is not None else IdentityOperator()
    if x0 is None:
        x0 = vectors.zero_like(b)
    orth = opts.orthogonalization
    if flexible and orth == "dcgs2":
        # FGMRES builds the update from Z = M v_k, which needs the final q_k
        # at preconditioning time; the delayed scheme has only u_k then.
        orth = "cgs2"
    if orth not in ("cgs2", "dcgs2"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    tol = (atol + rtol * vectors.norm(b)).to(rdt)  # stays on the device

    x, res, hist, nin, n_iter, outer, nmv = _gmres_impl(
        A, b, x0, M, tol, opts.kdim, opts.maxiter, transpose, flexible,
        opts.sanity_check, orth,
    )
    # one batched fetch of everything the metadata needs
    fetched = host_read(torch.cat([hist, res.reshape(1), tol.reshape(1)]))
    hist, res, tol = fetched[:-2], float(fetched[-2]), float(fetched[-1])
    converged = res < tol
    info = n_iter if converged else -n_iter
    # executed applications: inner iterations + r0 + sanity recomputes (the
    # DCGS2 path can run one matvec beyond the solved column count)
    count_applications(A, nmv, "rmatvec" if transpose else "matvec")
    if not isinstance(M, IdentityOperator):
        n_inner_mv = nmv - outer * (1 + int(bool(opts.sanity_check)))
        count_applications(M, n_inner_mv + (0 if flexible else outer), "matvec")
    check_info(info, meta_name, "solvers", meta_name)
    meta = SolverMetadata(converged=converged, n_iter=outer, n_inner=nin,
                          info=info, residuals=np.asarray(hist))
    if opts.if_print_metadata:
        meta.print()
    return x, info, meta


@timed_fn("gmres", "IterativeSolvers")
def gmres(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
          options: GMRESOptions | None = None, transpose: bool = False):
    """Restarted GMRES(kdim) for ``A x = b`` -> ``(x, info, metadata)``
    (reference: ``gmres``, gmres.fypp:65-258).

    ``info = n_inner`` if converged else ``-n_inner`` (gmres.fypp:233-239).
    A tensor or array ``A`` is wrapped in a :class:`DenseOperator`.
    """
    return _solve(A, b, x0, rtol, atol, preconditioner, options, transpose,
                  flexible=False, meta_name="gmres")


@timed_fn("fgmres", "IterativeSolvers")
def fgmres(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
           options: GMRESOptions | None = None, transpose: bool = False):
    """Flexible GMRES: stores the preconditioned directions, so the
    preconditioner may vary per iteration (reference: fgmres.fypp:158-207)."""
    return _solve(A, b, x0, rtol, atol, preconditioner, options, transpose,
                  flexible=True, meta_name="fgmres")
