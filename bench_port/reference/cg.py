"""Conjugate gradients from ``x0 = 0`` to ``||r|| < rtol ||b||`` on the
recursively updated residual, as CG is stated (Hestenes and Stiefel)."""

import torch


def cg(matvec, b: torch.Tensor, rtol: float, maxiter: int, rounding=None):
    """``(x, iterations)``; ``rounding`` (see :mod:`.precision`) rounds the
    operands of every inner product, as a lower-precision control does."""
    rnd = rounding or (lambda t: t)

    def dot(u, v):
        return torch.sum(rnd(u) * rnd(v))

    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = dot(r, r)
    tol2 = (rtol * torch.linalg.vector_norm(b)) ** 2
    k = 0
    while k < maxiter and bool(rr >= tol2):
        Ap = matvec(p)
        alpha = rr / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k
