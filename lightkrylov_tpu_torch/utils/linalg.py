"""Dense linear algebra of the small projected problems.

Counterpart of :mod:`lightkrylov_tpu.utils.linalg` (reference:
src/Utilities/Utils.fypp, submodule_utility_functions.fypp).

The projected problems are k x k with k of order 100.  The general
eigendecomposition (GEEV), the Schur form and its reordering (TRSEN) run on
the host in numpy/scipy, as in the JAX package; a tensor argument is read to
the host through :func:`..utils.timer.host_read`, which counts the read.
``eigh``, ``svd``, ``sqrtm``, ``expm``, the Givens rotations of the GMRES
least-squares problem and the triangular solve stay on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as _sla
import torch

from .. import constants
from .timer import host_read

__all__ = [
    "eig",
    "eigh",
    "svd",
    "schur",
    "ordschur",
    "schur_select",
    "selection_mask",
    "sqrtm",
    "expm",
    "givens_rotation",
    "apply_givens_rotation",
    "solve_triangular",
    "assert_shape",
    "log2",
]


def _host(a):
    """``a`` as a numpy array; a tensor is read through ``host_read``."""
    return host_read(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _complex_of(dtype):
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return dtype
    return np.dtype(np.complex64) if dtype == np.float32 else np.dtype(np.complex128)


def eig(A):
    """Eigendecomposition of a small dense matrix, LAPACK GEEV convention
    (reference: Utils.fypp ``eig``; used on the projected Hessenberg,
    IterativeSolvers.fypp:1065).  Host LAPACK; returns numpy ``(w, V)``,
    complex whatever the input dtype."""
    a = _host(A)
    cdt = _complex_of(a.dtype)
    w, v = np.linalg.eig(a)
    return w.astype(cdt), v.astype(cdt)


def eigh(A):
    """Hermitian eigendecomposition, on the tensor's device."""
    return torch.linalg.eigh(A)


def svd(A, full_matrices: bool = False):
    """Singular value decomposition ``(U, S, Vh)``, on the tensor's device."""
    return torch.linalg.svd(A, full_matrices=full_matrices)


def schur(A, output: str | None = None):
    """Schur decomposition ``A = Z T Z^H`` on the host (reference: stdlib
    ``schur`` used by ``krylov_schur``, BaseKrylov.fypp:807).

    ``output``: ``'real'`` (default for a real ``A``: 2x2 blocks for
    conjugate pairs and a real ``Z``, so that a real Krylov basis stays real
    after compression) or ``'complex'``.  Returns numpy ``(T, Z)``."""
    a = _host(A)
    if output is None:
        output = "complex" if np.issubdtype(a.dtype, np.complexfloating) else "real"
    T, Z = _sla.schur(a, output=output)
    return T.astype(a.dtype), Z.astype(a.dtype)


def ordschur(T, Z, select_mask):
    """Reorder a Schur factorization so that the eigenvalues flagged in
    ``select_mask`` lead: LAPACK TRSEN (reference: ``ordschur``,
    Utils.fypp:128-268; used by ``krylov_schur``, BaseKrylov.fypp:813).
    For a real Schur form LAPACK moves whole 2x2 blocks."""
    T, Z = _host(T), _host(Z)
    mask = np.asarray(select_mask).astype(np.int32)
    if np.issubdtype(T.dtype, np.complexfloating):
        trsen = _sla.lapack.ctrsen if T.dtype == np.complex64 else _sla.lapack.ztrsen
    else:
        trsen = _sla.lapack.strsen if T.dtype == np.float32 else _sla.lapack.dtrsen
    res = trsen(mask, T, Z, job="N")
    return res[0].astype(T.dtype), res[1].astype(Z.dtype)


def selection_mask(T, select):
    """The mask of the *global* selector ``select(eigvals) -> bool mask``
    over the diagonal positions of the Schur form ``T``.  For a real ``T``
    it is made consistent over each 2x2 block first: a conjugate pair moves
    whole or not at all.  Returns ``(mask, eigvals)``, numpy."""
    is_cplx = np.issubdtype(T.dtype, np.complexfloating)
    w = np.diag(T) if is_cplx else _sla.eigvals(T)
    mask = np.array(select(w), dtype=bool)
    if not is_cplx:
        i, n = 0, T.shape[0]
        while i < n - 1:
            if abs(T[i + 1, i]) > 0:
                both = mask[i] or mask[i + 1]
                mask[i] = mask[i + 1] = both
                i += 2
            else:
                i += 1
    return mask, w


def schur_select(A, select):
    """Sorted Schur form in one call: decompose ``A``, apply the *global*
    selector ``select(eigvals) -> bool mask`` and reorder.

    The selector sees the whole spectrum at once (the median selector of
    eigs, IterativeSolvers.fypp:1137-1142), which scipy's per-eigenvalue
    ``sort`` cannot express (:func:`selection_mask`).  Returns numpy
    ``(T, Z, n_selected)``."""
    a = _host(A)
    T, Z = _sla.schur(a, output="complex" if np.issubdtype(a.dtype, np.complexfloating)
                      else "real")
    mask, _ = selection_mask(T, select)
    Ts, Zs = ordschur(T, Z, mask)
    return Ts, Zs, int(mask.sum())


def sqrtm(A, hermitian: bool = True):
    """Square root of a positive (semi)definite matrix through ``eigh``, on
    the tensor's device -> ``(sqrtA, info)`` (reference: ``sqrtm``,
    submodule_utility_functions.fypp:123-163).

    ``info`` is 0 for a positive definite input and 1 when eigenvalues at
    or below ``10*atol`` were clipped to zero.  The reference's symmetry
    check runs first: ``0.5*max|A - A^H| > rtol`` is fatal
    (``stop_error``), ``> 10*atol`` logs a warning (:133-144).  The
    symmetry error and ``info`` are read to the host, one read each."""
    A = torch.as_tensor(A)
    rdt = constants.real_dtype_of(A.dtype)
    tol = 10.0 * constants.atol(rdt)
    err = float(host_read(0.5 * torch.max(torch.abs(A - A.mH))))
    if err > constants.rtol(rdt):
        from .logger import stop_error

        stop_error(f"Input matrix is not Hermitian. 0.5*max|A - A^H| = {err:.2e}",
                   "utils", "sqrtm")
    elif err > tol:
        from .logger import log_warning

        log_warning(f"Input matrix is not exactly Hermitian. 0.5*max|A - A^H| = {err:.2e}",
                    "utils", "sqrtm")
    w, V = torch.linalg.eigh(A)
    clipped = w <= tol
    w = torch.where(clipped, torch.zeros_like(w), w)
    sqrtA = (V * torch.sqrt(w).to(V.dtype)) @ V.mH
    return sqrtA, int(host_read(clipped.any()))


def expm(A):
    """Dense matrix exponential on the tensor's device (used for the
    projected exponential, reference: ExpmLib.fypp:207)."""
    return torch.linalg.matrix_exp(A)


def givens_rotation(a, b):
    """``(c, s)`` zeroing ``b`` against ``a``: complex-safe, ``c`` real,
    ``s`` of the inputs' dtype (reference: Utils.fypp:128-268)."""
    anorm = torch.abs(a)
    bnorm = torch.abs(b)
    d = torch.sqrt(anorm**2 + bnorm**2)
    d = torch.where(d == 0, torch.ones_like(d), d)
    c = anorm / d
    # phase-correct sine for complex entries; b/d for real
    phase = torch.where(anorm == 0, torch.ones_like(a),
                        a / torch.where(anorm == 0, torch.ones_like(anorm), anorm))
    s = phase.conj() * b / d
    both_zero = (anorm == 0) & (bnorm == 0)
    c = torch.where(both_zero, torch.ones_like(c), c)
    s = torch.where(both_zero, torch.zeros_like(s), s)
    return c, s


def apply_givens_rotation(h, c, s, k: int):
    """Apply the ``k`` stored rotations to column ``h`` (length >= k+2),
    compute the rotation annihilating ``h[k+1]``, and return the updated
    ``(h, c, s)`` (reference: Utils.fypp:128-268).

    ``k`` is a host integer, so the loop runs over the ``k`` rotations that
    exist; the JAX version loops over all ``len(c)`` of them with masking,
    which gives the same result.  Each rotation is applied as one 2x2
    product, to keep the number of small launches per rotation at two.
    ``h``, ``c`` and ``s`` are not modified.
    """
    h, c, s = h.clone(), c.clone(), s.clone()
    if k:
        ch = c[:k].to(h.dtype)
        G = torch.stack([torch.stack([ch, s[:k].conj()], -1),
                         torch.stack([-s[:k], ch], -1)], -2)      # (k, 2, 2)
        for i in range(k):
            h[i:i + 2] = G[i] @ h[i:i + 2]
    ck, sk = givens_rotation(h[k], h[k + 1])
    h[k] = ck * h[k] + sk.conj() * h[k + 1]
    h[k + 1] = 0
    c[k] = ck
    s[k] = sk
    return h, c, s


def solve_triangular(R, b, lower: bool = False):
    """Triangular solve ``R y = b`` for a 1-D or 2-D ``b``
    (reference: ``trtrs`` call, gmres.fypp:200)."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(R, b[:, None], upper=not lower)[:, 0]
    return torch.linalg.solve_triangular(R, b, upper=not lower)


def assert_shape(A, shape, name: str = "array") -> None:
    """Shape guard (reference: ``assert_shape``, Utils.fypp:85-116)."""
    if tuple(A.shape) != tuple(shape):
        from .logger import stop_error

        stop_error(f"{name} has shape {tuple(A.shape)}, expected {tuple(shape)}",
                   "utils", "assert_shape")


def log2(x):
    """Base-2 logarithm (reference: ``log2``, Utils.fypp:37-60)."""
    return torch.log2(torch.as_tensor(x))
