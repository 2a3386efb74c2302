"""GMRES and flexible GMRES with restarts and right preconditioning.

Counterpart of :mod:`lightkrylov_tpu.solvers.gmres` (reference:
src/IterativeSolvers/GMRES/gmres.fypp and fgmres.fypp): restarted
GMRES(kdim) whose inner loop is an Arnoldi sweep (gmres.fypp:153-196),
incremental Givens least squares (:177-182), right preconditioning (:155), a
triangular solve for the update (:199-202) and a true-residual recompute per
outer cycle (:204-214).  FGMRES keeps the preconditioned directions ``Z``
(fgmres.fypp:158-207).  ``info = +-n_iter`` (gmres.fypp:233-239).

Orthogonalization is DCGS2 by default (delayed re-orthogonalization: one
reduction and one rank-2 update over the basis per inner iteration) or
CGS2; FGMRES always uses CGS2.

Where the JAX package runs the restart nest as one ``while_loop`` on the
device, this is a host loop.  Its only waits on the device are the loop
conditions: one flag per inner iteration (``res >= tol``), one per outer
cycle, one per DCGS2 cycle that runs to ``kdim`` (did the last column
converge?), and one batched fetch of the metadata at the end.  All of them
go through :func:`..utils.timer.host_read`.  ``tol``, the Givens state and
the residual history stay on the device in the working dtype.  Basis
columns are written in place, and every reduction reads only the filled
columns ``V[:k+1]``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.gram_schmidt import double_gram_schmidt_step
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..utils import linalg
from ..utils.logger import check_info
from ..utils.options import GMRESOptions, SolverMetadata
from ..utils.timer import count_applications, host_read, timed_fn

__all__ = ["gmres", "fgmres"]


def _padded(v, n: int):
    """``v`` (leading axis m <= n) zero-padded to leading axis ``n``."""
    out = v.new_zeros((n,) + tuple(v.shape[1:]))
    out[: v.shape[0]] = v
    return out


def _gmres_impl(A, b, x0, M, tol, kdim, maxiter, transpose, flexible,
                sanity_check, orth):
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    dev = pytree.tree_leaves(b)[0].device
    eps_r = constants.eps(rdt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def matvec(v):
        return A.rmatvec(v) if transpose else A.matvec(v)

    def precond(vk, k, res):
        # right preconditioner (gmres.fypp:155), iteration-aware interface
        # (IterativeSolvers.fypp:80-95)
        if isinstance(M, Preconditioner):
            return M.apply(vk, iteration=k, current_residual=res,
                           target_residual=tol)
        return M.matvec(vk)

    def givens_col(h_col, R, c, s, e, j):
        """Rotate the finished Hessenberg column ``j`` into the least-squares
        recursion (gmres.fypp:177-182).  ``R`` and ``e`` are updated in
        place; returns the new ``(c, s, res)``."""
        h_col, c, s = linalg.apply_givens_rotation(h_col, c, s, j)
        R[:, j] = h_col[:-1]
        ej = e[j].clone()
        e[j + 1] = -s[j] * ej
        e[j] = c[j] * ej
        return c, s, torch.abs(e[j + 1]).to(rdt)

    def safe_inverse(a):
        ok = a > 0
        return torch.where(ok, 1.0 / torch.where(ok, a, torch.ones_like(a)),
                           torch.zeros_like(a))

    def pythag_eta(sigma, z):
        # breakdown (u_k in span Q) gives eta ~ 0: inv_eta = 0 writes an
        # exactly-zero column and the vanishing H[k, k-1] ends the recursion
        eta2 = sigma - torch.vdot(z, z).real.to(rdt)
        eta = torch.sqrt(torch.clamp_min(eta2, 0.0))
        return eta, safe_inverse(eta)

    def dcgs2_measure(V, u_k, w, k):
        """The one reduction of iteration k: ``Q^H [u_k, w]`` over the
        filled columns, and ``||w||^2``.  Row k gives (sigma, tau) because
        slot k holds u_k itself."""
        Y2 = pytree.tree_map(lambda a, b_: torch.stack([a, b_]), u_k, w)
        PR = _padded(vectors.innerprod_vpu(vectors.lead(V, k + 1), Y2).to(dt), kdim + 1)
        wTw = vectors.dot(w, w).real.to(rdt)
        sigma = PR[k, 0].real.to(rdt, copy=True)
        tau = PR[k, 1].clone()
        PR[k] = 0
        return PR[:, 0], PR[:, 1], sigma, tau, wTw

    def dcgs2_cycle(V, R, c, s, e, res, hist, nin):
        """Inner sweep with delayed re-orthogonalization (the JAX
        ``dcgs2_body``/``dcgs2_flush``).  Slot k of ``V`` holds the
        uncorrected direction u_k; iteration k measures it, finishes
        Hessenberg column k-1, and writes the corrected q_k and the next
        direction u_{k+1} = (w - Q p - q_k t) / gamma with one rank-2 update.
        gamma, the Pythagorean estimate of ||u_{k+1}||, keeps every stored
        direction at unit scale (any positive scale is exact)."""
        Ht = zeros(kdim + 1, kdim)
        hp = zeros(kdim + 1)
        fac_prev = torch.ones((), dtype=rdt, device=dev)
        k = 0
        while k < kdim and bool(host_read(res >= tol)):
            u_k = vectors.get_column(V, k)
            w = matvec(precond(u_k, k, res))
            z, p, sigma, tau, wTw = dcgs2_measure(V, u_k, w, k)
            eta, inv_eta = pythag_eta(sigma, z)
            t = (tau - torch.vdot(z, p)) * inv_eta
            if k > 0:  # finish true-H column k-1
                h_col = hp + z * fac_prev
                h_col[k] = eta * fac_prev
                Ht[:, k - 1] = h_col
                c, s, res = givens_col(h_col, R, c, s, e, k - 1)
                hist[nin] = res
                nin += 1
            # provisional column k, exact for the corrected q_k
            pt = p.clone()
            pt[k] = t
            hp = (pt - Ht @ z[:kdim]) * inv_eta
            gamma2 = wTw - torch.vdot(p, p).real.to(rdt) - torch.abs(t) ** 2
            gamma = torch.sqrt(torch.maximum(gamma2, eps_r * eps_r * wTw))
            inv_gamma = safe_inverse(gamma)
            c_q = -z * inv_eta
            c_q[k] = inv_eta
            c_u = (p - (t * inv_eta) * z) * inv_gamma
            c_u[k] = t * inv_eta * inv_gamma
            # D is a new tensor, computed in full before V[k] (which u_k
            # views) is overwritten
            D = vectors.linear_combination_vpu(
                vectors.lead(V, k + 1), torch.stack([c_q, c_u], dim=1)[: k + 1])
            u_next = vectors.axpby(inv_gamma, w, -1.0, vectors.get_column(D, 1))
            vectors.set_column(V, k, vectors.get_column(D, 0))
            vectors.set_column(V, k + 1, u_next)
            fac_prev = (gamma * inv_eta).to(rdt)
            k += 1
        k_exit = k
        # stopped early only on convergence; at kdim the flag is unread yet
        if k_exit < kdim or bool(host_read(res < tol)):
            # the k_exit-1 finished columns already beat tol
            return c, s, res, nin, k_exit - 1, k_exit
        # finish the pending column k_exit-1: one reduction, no matvec
        u_last = vectors.get_column(V, k_exit)
        zf = _padded(vectors.innerprod(vectors.lead(V, k_exit + 1), u_last).to(dt), kdim + 1)
        sigma = zf[k_exit].real.to(rdt, copy=True)
        zf[k_exit] = 0
        eta, _ = pythag_eta(sigma, zf)
        h_col = hp + zf * fac_prev
        h_col[k_exit] = eta * fac_prev
        c, s, res = givens_col(h_col, R, c, s, e, k_exit - 1)
        hist[nin] = res
        return c, s, res, nin + 1, k_exit, k_exit

    def cgs2_cycle(V, Z, R, c, s, e, res, hist, nin):
        k = 0
        while k < kdim and bool(host_read(res >= tol)):
            z = precond(vectors.get_column(V, k), k, res)
            if flexible:
                vectors.set_column(Z, k, z)
            w, proj = double_gram_schmidt_step(matvec(z), vectors.lead(V, k + 1))
            beta = vectors.norm(w)
            h_col = _padded(proj.to(dt), kdim + 1)
            h_col[k + 1] = beta
            vectors.set_column(V, k + 1, vectors.scal(safe_inverse(beta).to(rdt), w))
            c, s, res = givens_col(h_col, R, c, s, e, k)
            hist[nin] = res
            nin += 1
            k += 1
        return c, s, res, nin, k, k

    x = x0
    res = torch.full((), float("inf"), dtype=rdt, device=dev)
    hist = zeros(maxiter * kdim, dtype=rdt)
    outer = nin = n_iter = nmv = 0
    while outer < maxiter and bool(host_read(res >= tol)):
        r = vectors.axpby(1.0, b, -1.0, matvec(x))  # r0 = b - A x (:134-143)
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
            y = linalg.solve_triangular(R[:k, :k], e[:k])
            dx = vectors.linear_combination(vectors.lead(Z if flexible else V, k), y)
            if not flexible:
                dx = M.matvec(dx)  # right-preconditioned correction (:201-202)
            x = vectors.add(x, dx)

        if sanity_check:
            res = vectors.norm(vectors.axpby(1.0, b, -1.0, matvec(x))).to(rdt)
            mv_cycle = mv_inner + 2
        else:
            res = res_in
            mv_cycle = mv_inner + 1
        outer += 1
        n_iter += k
        nmv += mv_cycle
    return x, res, hist[:nin], nin, n_iter, outer, nmv


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
