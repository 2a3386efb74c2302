"""Newton-Krylov solver for fixed points and periodic orbits.

Counterpart of :mod:`lightkrylov_tpu.solvers.newton` (reference:
src/Newton/NewtonKrylov.fypp): Newton's iteration on ``F(X) = 0`` with the
Jacobian taken again at each iterate (NewtonKrylov.fypp:346), the Newton
system ``J dx = -F(X)`` solved by an injected linear solver (:349-352), an
optional golden-section line search on the step length (a 4-point bracket
contracted by ``invphi``, at most ``maxstep_bisection`` residual
evaluations, :355-359,422-525), the inexact-Newton tolerance schedulers
``constant_tol`` and ``dynamic_tol`` (``max(0.1 * |F|, target)``,
:534-598), a check for convergence on entry (:325-332) and, when a
step converged at a relaxed tolerance, a recheck at the target tolerance
(:370-388).

The Newton loop runs on the host; each residual norm is one read of the
device through :func:`..utils.timer.host_read`.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants, vectors
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import NewtonMetadata, NewtonOptions
from ..utils.timer import count_applications, host_read, timed_fn
from .gmres import gmres

__all__ = ["newton", "constant_tol", "dynamic_tol"]


def constant_tol(target: float, rnorm: float, iteration: int) -> float:
    """Constant tolerance (reference: ``constant_atol_*``,
    NewtonKrylov.fypp:534-560)."""
    return target


def dynamic_tol(target: float, rnorm: float, iteration: int) -> float:
    """Inexact-Newton tolerance ``max(0.1 * rnorm, target)`` (reference:
    ``dynamic_tol_*``, NewtonKrylov.fypp:562-598)."""
    return max(0.1 * rnorm, target)


_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


def _eval_norm(system, X, atol: float, record):
    """``(F(X), |F(X)|)`` at tolerance ``atol``: one counted ``system.eval``,
    one host read and one ``(residual, tolerance)`` record."""
    residual = system.eval(X, atol)
    count_applications(system, 1, "eval")
    rnorm = float(host_read(vectors.norm(residual)))
    record(rnorm, atol)
    return residual, rnorm


def _bisection_step(system, X, dx, f0: float, maxstep: int, atol: float, record) -> float:
    """Golden-section search for the step length ``alpha`` in [0, 1] that
    minimises ``|F(X + alpha dx)|`` (reference: ``increment_bisection``,
    NewtonKrylov.fypp:422-525), with at most ``maxstep`` evaluations, each
    recorded.  When no probe beats ``f0 = |F(X)|``, the full step is taken,
    as in the JAX package."""

    def fnorm(alpha):
        return _eval_norm(system, vectors.axpby(1.0, X, alpha, dx), atol, record)[1]

    a, b = 0.0, 1.0
    c = b - _INVPHI * (b - a)
    d = a + _INVPHI * (b - a)
    fc, fd = fnorm(c), fnorm(d)
    evals = 2
    while evals < maxstep:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _INVPHI * (b - a)
            fc = fnorm(c)
        else:
            a, c, fc = c, d, fd
            d = a + _INVPHI * (b - a)
            fd = fnorm(d)
        evals += 1
    alpha = c if fc < fd else d
    if min(fc, fd) >= f0:
        alpha = 1.0
    return alpha


@timed_fn("newton", "Newton")
def newton(system, X0, solver=None, rtol: float | None = None, atol: float | None = None,
           options: NewtonOptions | None = None, linear_solver_options=None,
           preconditioner=None, scheduler=None):
    """Newton-Krylov iteration for ``F(X) = 0`` -> ``(X, info, metadata)``
    (reference: ``newton``, NewtonKrylov.fypp:246-420).

    ``solver(A, b, **kw) -> (x, info, meta)`` is any linear solver of the
    reference's ``abstract_linear_solver`` interface
    (IterativeSolvers.fypp:102-131), :func:`.gmres.gmres` by default; it is
    called with ``atol`` set by ``scheduler`` (default :func:`dynamic_tol`),
    ``rtol=0``, and ``options``/``preconditioner`` when given.  The target
    is ``atol + rtol * max(|F(X0)|, 1)``.  ``info = n_iter`` if converged,
    else ``-max(n_iter, 1)``; ``metadata`` holds one ``(residual,
    tolerance)`` record per ``system.eval``."""
    opts = options or NewtonOptions()
    if solver is None:
        solver = gmres
    rdt = constants.real_dtype_of(vectors.dtype_of(X0))
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    if scheduler is None:
        scheduler = dynamic_tol

    eval_res: list[float] = []
    eval_tol: list[float] = []

    def record(r: float, t: float) -> None:
        eval_res.append(r)
        eval_tol.append(t)

    X = X0
    residual, rnorm = _eval_norm(system, X, atol, record)
    target = atol + rtol * max(rnorm, 1.0)
    converged = rnorm < target  # lucky convergence (:325-332)
    n_iter = 0

    for i in range(1, opts.maxiter + 1):
        if converged:
            break
        tol = scheduler(target, rnorm, i)
        J = system.jacobian(X, tol)  # (:346)
        kw = {"atol": tol, "rtol": 0.0}
        if preconditioner is not None:
            kw["preconditioner"] = preconditioner
        if linear_solver_options is not None:
            kw["options"] = linear_solver_options
        dx, s_info, _ = solver(J, vectors.chsgn(residual), **kw)
        # the inner solve's non-convergence is logged, not fatal (:352)
        check_info(s_info, getattr(solver, "__name__", "gmres"), "solvers", "newton")

        if opts.ifbisect:
            alpha = _bisection_step(system, X, dx, rnorm, opts.maxstep_bisection, atol, record)
            X = vectors.axpby(1.0, X, alpha, dx)  # (:355-359)
        else:
            X = vectors.add(X, dx)

        # the new residual at the scheduler's tolerance (:361)
        residual, rnorm = _eval_norm(system, X, tol, record)
        n_iter = i
        log_information(f"newton: iter {i}, |F| = {rnorm:.3e} (tol {tol:.1e})",
                        "solvers", "newton")
        if rnorm < tol and target <= tol < 100.0 * target:
            # converged at a tolerance near the target: evaluate again at the
            # target and accept only if it passes there (:369-387)
            residual, rnorm = _eval_norm(system, X, target, record)
            if rnorm < target:
                converged = True
                log_information(f"newton: converged after {i} iterations.", "solvers", "newton")
            else:
                log_warning("newton: dynamic tolerance but not target tolerance reached. "
                            "Continue.", "solvers", "newton")

    if not converged:
        log_warning(f"newton: no convergence in {opts.maxiter} iterations "
                    f"(|F| = {rnorm:.3e})", "solvers", "newton")

    info = n_iter if converged else -max(n_iter, 1)
    meta = NewtonMetadata(converged=converged, n_iter=n_iter, info=info, n_evals=len(eval_res),
                          residuals=np.asarray(eval_res), tolerances=np.asarray(eval_tol))
    if opts.if_print_metadata:
        meta.print()
    return X, info, meta
