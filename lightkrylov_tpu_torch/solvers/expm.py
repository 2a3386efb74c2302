"""Krylov approximation of the matrix exponential action ``exp(tau A) b``.

Counterpart of :mod:`lightkrylov_tpu.solvers.expm` (reference:
src/Expm/ExpmLib.fypp): incremental Arnoldi with, after each step, a dense
exponential of the *extended* (k+1)-square Hessenberg
``[[H_k, 0], [beta e_k^T, 0]]``; the approximation is
``beta0 * X[:, :k] @ E[:k, 0]`` and the error estimate the last-row
correction ``|beta0 * E[k, 0]|`` (ExpmLib.fypp:189-220).  An
invariant-subspace breakdown makes the result exact and gives
``info = -2`` (:200-204).  ``krylov_exptA`` is the fixed ``kdim = 30``,
``tol = atol`` configuration behind the ``abstract_exptA`` interface
(:365-392); ``kexpm_mat`` is the block version with a QR of the input block
(:234-363).

As in the JAX package, the projected exponential is taken of the
zero-padded ``(kdim+1)``-square matrix, whose exponential's leading block is
exactly ``exp(Hext_k)``.  It runs on the tensors' device
(``torch.linalg.matrix_exp``).  The loop is on the host and reads the error
estimate and ``beta`` once per step, where the JAX package runs one
``while_loop`` on the device.
"""

from __future__ import annotations

import torch

from .. import constants, vectors
from ..krylov.arnoldi import arnoldi_block, arnoldi_step, initialize_arnoldi
from ..krylov.qr import qr
from ..linops import LinearOperator, aslinop
from ..utils import linalg
from ..utils.logger import check_info
from ..utils.options import KexpmOptions
from ..utils.timer import count_applications, host_read, timed_fn

__all__ = ["kexpm", "kexpm_mat", "krylov_exptA", "ExponentialPropagator"]


def _padded(H, width):
    """``H`` with zero columns appended up to a square of side ``width``."""
    Hsq = torch.zeros((H.shape[0], width), dtype=H.dtype, device=H.device)
    Hsq[:, :H.shape[1]] = H
    return Hsq


def _kexpm_impl(A, b, tau, tol: float, kdim: int, transpose: bool):
    """Returns ``(c, err, k, broke)``: the approximation, the final error
    estimate (a float), the Krylov dimension used and whether Arnoldi broke
    down."""
    dt = vectors.dtype_of(b)
    atol_break = constants.atol(dt)
    beta0 = vectors.norm(b)
    X, H = initialize_arnoldi(b, kdim)
    k, err, broke = 0, float("inf"), False
    while k < kdim and err >= tol and not broke:
        X, H, beta = arnoldi_step(A, X, H, k, transpose=transpose, tol=atol_break)
        k += 1
        E = linalg.expm(tau * _padded(H, kdim + 1))
        est, beta_h = host_read(torch.stack([beta0 * torch.abs(E[k, 0]), beta.to(E.real.dtype)]))
        broke = bool(beta_h <= atol_break)
        err = 0.0 if broke else float(est)  # exact on breakdown
    coeff = torch.zeros(kdim + 1, dtype=dt, device=H.device)
    coeff[:k] = E[:k, 0] * beta0.to(dt)
    return vectors.linear_combination(X, coeff), err, k, broke


@timed_fn("kexpm", "ExpmLib")
def kexpm(A, b, tau, tol: float | None = None, transpose: bool = False,
          kdim: int | None = None, options: KexpmOptions | None = None):
    """``c ~= exp(tau A) b`` -> ``(c, info)``: ``info = k``, the Krylov
    dimension used, on success; ``-2`` on an invariant-subspace breakdown
    (the result is exact); ``-1`` if the error estimate did not meet
    ``tol`` within ``kdim`` steps (reference: ``kexpm``,
    ExpmLib.fypp:128-232)."""
    A = aslinop(A)
    opts = options or KexpmOptions()
    if kdim is None:
        kdim = opts.kdim
    if tol is None:
        tol = constants.atol(vectors.dtype_of(b))  # (reference: krylov_exptA default, :379)
    c, err, k, broke = _kexpm_impl(A, b, tau, tol, kdim, transpose)
    info = -2 if broke else (k if err < tol else -1)
    count_applications(A, k, "rmatvec" if transpose else "matvec")
    check_info(info, "kexpm", "solvers", "kexpm")
    return c, info


class ExponentialPropagator(LinearOperator):
    """``exp(tau A)`` as a linear operator, the library's time-stepper for
    eigenanalysis of the exponential propagator (reference:
    ``krylov_exptA`` under ``abstract_exptA_linop``, ExpmLib.fypp:365-392;
    AbstractLinops.fypp:105-123 carries ``tau``).  A 0-d tensor ``tau`` is
    kept as a Python number."""

    def __init__(self, A, tau, kdim: int = 30, tol: float | None = None):
        self.A = aslinop(A)
        self.tau = tau.item() if isinstance(tau, torch.Tensor) else tau
        self.kdim = kdim
        self.tol = tol

    def _apply(self, x, transpose):
        tol = self.tol if self.tol is not None else constants.atol(vectors.dtype_of(x))
        return _kexpm_impl(self.A, x, self.tau, tol, self.kdim, transpose)[0]

    def matvec(self, x):
        return self._apply(x, False)

    def rmatvec(self, y):
        return self._apply(y, True)


def kexpm_mat(A, B, tau, tol: float | None = None, transpose: bool = False,
              kdim: int | None = None, options: KexpmOptions | None = None):
    """Block version: ``C ~= exp(tau A) B`` for a stacked block ``B`` of p
    columns -> ``(C, info)``, ``info`` the Krylov dimension used or ``-1``
    (reference: ``kexpm_mat``, ExpmLib.fypp:234-363: QR of the input block,
    block Arnoldi, error ``||E[kp:kp+p, :p] R||``).  ``kdim`` is rounded up
    to a multiple of p."""
    A = aslinop(A)
    opts = options or KexpmOptions()
    p = vectors.basis_size(B)
    kdim = -(-(opts.kdim if kdim is None else kdim) // p) * p
    dt = vectors.dtype_of(B)
    if tol is None:
        tol = constants.atol(dt)
    atol_break = constants.atol(dt)

    # the reference takes a pivoted QR of the block; as in the JAX package
    # a plain CGS2 QR, whose random replacement covers rank deficiency
    Q0, R0, _ = qr(B)
    X = vectors.zeros_basis(vectors.get_column(B, 0), kdim + p)
    vectors.set_columns_block(X, 0, Q0)
    H = torch.zeros((kdim + p, kdim), dtype=dt, device=R0.device)
    for b_i in range(kdim // p):
        X, H, info = arnoldi_block(A, X, H, p, kstart=b_i * p + 1, kend=(b_i + 1) * p,
                                   transpose=transpose, tol=atol_break)
        kp = (b_i + 1) * p
        E = linalg.expm(tau * _padded(H, kdim + p))
        err_t = torch.linalg.norm(E[kp:kp + p, :p] @ R0)
        err, info = (float(v) for v in host_read(torch.stack([err_t, info.to(err_t.dtype)])))
        if err < tol or info > 0:
            break
    C = vectors.linear_combination(X, E[:, :p] @ R0)
    return C, kp if err < tol else -1


def krylov_exptA(A, b, tau, transpose: bool = False, kdim: int = 30):
    """Fixed configuration: ``exp(tau A) b`` at machine-precision tolerance
    (reference: ``krylov_exptA``, ExpmLib.fypp:365-392)."""
    c, _ = kexpm(A, b, tau, transpose=transpose, kdim=kdim)
    return c
