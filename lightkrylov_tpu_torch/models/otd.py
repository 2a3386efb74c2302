"""Optimally time-dependent (OTD) modes along a trajectory.

Counterpart of :mod:`lightkrylov_tpu.models.otd` (reference:
example/roessler/roessler_OTD.f90): an orthonormal basis ``U`` of ``r``
perturbation directions evolves with the trajectory,

    dx/dt = f(x)
    dU/dt = J(x) U - U (U^T J(x) U)        (the gauge A = 0)

so that ``U`` follows the most unstable subspace; the reduced operator
``Lr = U^T J U`` carries the instantaneous stability eigenvalues, and the
time averages of ``diag(Lr)`` are the finite-time Lyapunov exponents.
Anchors: instantaneous eigenvalue real part 0.097000856 (twice) at the
Roessler fixed point, Lyapunov exponents (0.149141556, 0.0) on the period-1
UPO (reference: roessler_OTD.f90:31-32).

``J U`` is ``torch.func.vmap`` of ``torch.func.jvp`` of any ``rhs`` over the
columns of ``U``.  The contractions run in full float32, as the package
turns TF32 off (its ``__init__``), where the JAX package asks for
``Precision.HIGHEST``.  The RK4 integration is a Python loop; after each
step an explicit modified Gram-Schmidt keeps ``U`` orthonormal.
"""

from __future__ import annotations

import torch

__all__ = ["otd_rhs", "otd_evolve", "lyapunov_exponents"]


def _jac_apply(rhs, x, U):
    """``J(x) U``, column by column through ``torch.func.jvp``."""
    return torch.func.vmap(lambda u: torch.func.jvp(rhs, (x,), (u,))[1],
                           in_dims=1, out_dims=1)(U)


def otd_rhs(rhs, x, U):
    """The right-hand side of the coupled ``(x, U)`` system, gauge 0:
    ``(f(x), dU, Lr)``."""
    fx = rhs(x)
    JU = _jac_apply(rhs, x, U)
    Lr = U.mT @ JU
    return fx, JU - U @ Lr, Lr


def _reorthonormalize(U):
    """Explicit modified Gram-Schmidt over the ``r`` (few) columns; it keeps
    each column's direction, so the basis stays continuous in time."""
    cols = []
    for j in range(U.shape[1]):
        v = U[:, j]
        for q in cols:
            v = v - q * torch.vdot(q, v)
        nv = torch.linalg.vector_norm(v)
        cols.append(v / torch.where(nv == 0, torch.ones_like(nv), nv))
    return torch.stack(cols, dim=1)


def otd_evolve(rhs, x0, U0, T, n_steps: int = 2000):
    """Integrate the coupled system over ``[0, T]`` with RK4 in ``n_steps``
    steps -> ``(x_T, U_T, Lr_T, lyap)``, ``lyap`` the time averages of
    ``diag(Lr)``, the finite-time Lyapunov exponents."""
    dt = T / n_steps

    def f(x, U):
        fx, dU, _ = otd_rhs(rhs, x, U)
        return fx, dU

    x, U = x0, U0
    acc = torch.zeros(U0.shape[1], dtype=torch.promote_types(x0.dtype, torch.float32),
                      device=x0.device)
    for _ in range(n_steps):
        k1 = f(x, U)
        k2 = f(x + 0.5 * dt * k1[0], U + 0.5 * dt * k1[1])
        k3 = f(x + 0.5 * dt * k2[0], U + 0.5 * dt * k2[1])
        k4 = f(x + dt * k3[0], U + dt * k3[1])
        x = x + (dt / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        U = _reorthonormalize(U + (dt / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]))
        _, _, Lr = otd_rhs(rhs, x, U)  # the instantaneous growth rates diag(U^T J U)
        acc = acc + torch.diagonal(Lr).real * dt
    _, _, Lr = otd_rhs(rhs, x, U)
    return x, U, Lr, acc / T


def lyapunov_exponents(rhs, x0, U0, T, n_steps: int = 2000, n_transient: int = 0,
                       T_transient: float = 0.0):
    """Leading Lyapunov exponents by OTD averaging, after an optional
    transient of ``n_transient`` steps over ``T_transient`` that lets the
    basis align (reference: roessler_OTD.f90)."""
    x, U = x0, U0
    if n_transient:
        x, U, _, _ = otd_evolve(rhs, x, U, T_transient, n_transient)
    return otd_evolve(rhs, x, U, T, n_steps)[3]
