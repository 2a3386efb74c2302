"""Leading eigenpairs of a real operator by Arnoldi with exact-shift
implicit restarts (IRAM: Sorensen, SIAM J. Matrix Anal. Appl. 13, 1992),
the way LightKrylov's ``eigs`` states them (IterativeSolvers.fypp:971-1143).

A cycle grows the factorisation ``A V_k = V_k H_k + beta v_{k+1} e_k^T``
to ``kdim`` columns, classical Gram-Schmidt applied twice a step.  A
restart keeps ``kdim // 2`` columns, the subspace that exact shifts by the
other Ritz values keep (:func:`_restart`), in float64 on the host for
``H`` and one product for the basis.  After the last
cycle the Ritz pairs come from a dense ``eig`` of ``H`` in float64, sorted
by modulus, descending; a pair's residual is ``|beta| |y_k|``.

Nothing here computes in TF32: a float32 run is float32 throughout
(``torch.backends.cuda.matmul.allow_tf32`` is turned off, as the port turns
it off) unless ``rounding`` rounds the operands of every product with the
basis, as the control does."""

import numpy as np
import scipy.linalg
import torch


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _arnoldi(matvec, V, H, j0, shape, rnd):
    """Steps ``j0 .. kdim - 1`` in place: column ``j + 1`` of ``V`` and
    column ``j`` of ``H`` (float64 numpy)."""
    kdim = H.shape[1]
    for j in range(j0, kdim):
        w = matvec(V[j].reshape(shape)).to(V.dtype).reshape(-1)
        for _ in range(2):
            Q = rnd(V[: j + 1])
            h = Q @ rnd(w)
            w = w - rnd(h) @ Q
            H[: j + 1, j] += h.double().cpu().numpy()
        beta = float(torch.linalg.vector_norm(w))
        H[j + 1, j] = beta
        if beta == 0.0:
            raise ArithmeticError(f"Arnoldi broke down at step {j + 1}")
        V[j + 1] = w / beta


def _keep_count(w, order, keep):
    """``keep`` moved up, as the port's filter moves it, to the first count
    that splits no conjugate pair at the boundary and leaves an even number
    of shifts, clamped to ``[1, kdim - 2]``."""
    k = len(w)

    def splits(n):
        a, b = w[order[n - 1]], w[order[min(n, k - 1)]]
        return a.imag != 0.0 and b == np.conj(a)

    while keep < k - 2 and (splits(keep) or (k - keep) % 2):
        keep += 1
    return min(max(keep, 1), k - 2)


def _restart(V, H, keep, rnd):
    """Compress the ``kdim``-step factorisation ``(V, H)`` in place onto the
    Ritz vectors of the ``keep`` (:func:`_keep_count`) Ritz values of
    largest modulus; returns the count kept.

    The kept subspace is the one the exact-shift implicit restart keeps,
    found by a real Schur form of ``H`` ordered so that those values lead
    (Stewart's Krylov-Schur restart, SIAM J. Matrix Anal. Appl. 23, 2002,
    which gives the same Krylov subspace as exact shifts).  Explicit QR
    steps with exact shifts lose the factorisation's structure in a tight
    cluster (a relation residual of 0.15 of ``||H||`` at 128^2, kdim 64),
    and the Schur form keeps it."""
    kdim = H.shape[1]
    w = np.linalg.eigvals(H[:kdim])
    order = np.argsort(-np.abs(w), kind="stable")
    keep = _keep_count(w, order, keep)
    cut = 0.5 * (abs(w[order[keep - 1]]) + abs(w[order[keep]]))
    T, Z, keep = scipy.linalg.schur(H[:kdim], output="real",
                                    sort=lambda re, im: np.hypot(re, im) > cut)
    Zt = torch.as_tensor(np.ascontiguousarray(Z[:, :keep]), dtype=V.dtype, device=V.device)
    rot = rnd(Zt).T @ rnd(V[:kdim])
    V[:keep] = rot
    V[keep] = V[kdim]
    V[keep + 1:] = 0.0
    spike = H[kdim, kdim - 1] * Z[kdim - 1, :keep]
    H[:] = 0.0
    H[:keep, :keep] = T[:keep, :keep]
    H[keep, :keep] = spike
    return keep


def eigs(matvec, x0: torch.Tensor, nev: int, kdim: int, maxiter: int,
         dtype=torch.float64, rounding=None):
    """``(eigvals, eigvecs, residuals)`` after ``maxiter`` cycles of
    ``kdim`` Arnoldi steps from ``x0`` (restarting between them): the
    ``nev`` Ritz values of largest modulus (complex numpy, descending), their
    Ritz vectors (complex, leading axis ``nev``, shaped like ``x0``, each of
    unit norm in exact arithmetic) and residuals (numpy).  The basis, the
    operator and its products run in ``dtype``; ``rounding`` (see
    :mod:`.precision`) rounds the operands of every product with the basis."""
    _no_tf32()
    rnd = rounding or (lambda t: t)
    shape = x0.shape
    b = x0.to(dtype).reshape(-1)
    V = torch.zeros((kdim + 1, b.numel()), dtype=dtype, device=b.device)
    H = np.zeros((kdim + 1, kdim))
    V[0] = b / torch.linalg.vector_norm(b)
    j0 = 0
    for cycle in range(maxiter):
        _arnoldi(matvec, V, H, j0, shape, rnd)
        if cycle < maxiter - 1:
            j0 = _restart(V, H, kdim // 2, rnd)
    w, Y = np.linalg.eig(H[:kdim])
    order = np.argsort(-np.abs(w), kind="stable")[:nev]
    w, Y = w[order], Y[:, order]
    res = abs(H[kdim, kdim - 1]) * np.abs(Y[kdim - 1])
    Yr = rnd(torch.as_tensor(np.ascontiguousarray(Y.real), dtype=dtype, device=b.device))
    Yi = rnd(torch.as_tensor(np.ascontiguousarray(Y.imag), dtype=dtype, device=b.device))
    Vk = rnd(V[:kdim])
    vecs = torch.complex(Yr.T @ Vk, Yi.T @ Vk)
    return w, vecs.reshape((len(w),) + tuple(shape)), res
