"""The real-Hessenberg projected eigensolve on the device: Francis
double-shift QR, the real Schur form and its reordering, the exact-shift
IRAM filter, inverse-iteration eigenvectors and the fused Ritz check.

Counterpart of :mod:`lightkrylov_tpu.utils.hessenberg` (reference: the
projected ``eig`` of ``H(:k,:k)`` each Arnoldi step,
src/IterativeSolvers/IterativeSolvers.fypp:1065, and the Ritz residuals of
:1069-1083), with the same functions, names and ``__all__``:

- :func:`hessenberg_eigvals`: ``dhseqr``-style Francis double-shift QR with
  deflation, 2x2-block acceptance and exceptional shifts, all in real
  arithmetic (complex pairs live in accepted 2x2 diagonal blocks);
- :func:`schur_real`: the same with the accumulated transform and the
  standardization of real-pair 2x2 blocks (``dlanv2``'s role), ``H = Z T Z^T``;
- :func:`ordschur_device`: LAPACK TRSEN/dtrexc's reordering by adjacent
  orthogonal block swaps (Bai and Demmel's direct swap);
- :func:`francis_filter`: the exact-shift IRAM filter of a Krylov restart;
- :func:`hessenberg_eigvecs`: ``dhsein``-style eigenvectors, one inverse
  iteration per eigenvalue, batched (the JAX package's realified ``2n x 2n``
  system solved as the complex ``n x n`` system it is);
- :func:`hessenberg_ritz`: the Ritz values, residuals, modulus-descending
  order and converged count of one ``eigs`` check (``p = 1``, and the block
  residual for ``p > 1``).

The active ``k_eff x k_eff`` problem is embedded in the static buffer by
zeroing the rest and planting separated dummy diagonal entries
(``> 2 ||H||``), pre-deflated 1x1 blocks that are masked out afterwards, so
``k_eff`` may be a 0-d tensor on the device and never cross to the host.

The Schur core (embedding, Householder reduction to Hessenberg form, the
Francis sweeps, the block split, the eigenvalue extraction), the filter's
sweeps, the inverse iteration with the check's residuals, order and count,
and the Schur reordering run through :mod:`..ops.hessenberg`: on a CUDA
tensor one launch of the hand-written kernels of ``csrc/hessenberg.cu``,
``csrc/ritz.cu`` and ``csrc/ordschur.cu`` each, on a CPU tensor the plain
versions below, whose data-dependent loops are Python loops reading the few
scalars they branch on.  The arithmetic follows the JAX package's
order: each chase step applies its 3-row and 3-column updates over the full
slices and sets the annihilated bulge entries to exactly zero.  The small
products of a chase, its closing rotation and the pair split are written as
elementwise sums in a fixed order (:func:`_ordered_rows`), which the kernel
repeats operation for operation; only the reduction's products with a dense
column (``u @ H``, ``H @ u``) keep the library's order.  Square roots are
numpy's (:func:`_sqrt`), correctly rounded, so the plain versions round
alike on every device.  The inverse iteration's elimination and back
substitution are written the same way (:func:`_cmul`, :func:`_recip`), and
``csrc/ritz.cu`` repeats them; so are a reorder's swaps (its solve, QR and
updates; :func:`_swap_plain`), which ``csrc/ordschur.cu`` repeats.  A check
on the card is the Schur kernel, one fill of the converged count and the
Ritz kernel: three launches and no host read; a device Krylov-Schur
restart's Schur form and reordering are two launches and no host read.
What stays plain torch on the device: the shift bookkeeping of the filter
and its stable sorts.

Two departures from the JAX package, in the plain versions and the
kernels alike: a reflector's or rotation's vector too small to square is
scaled by a power of two first (:func:`_pow2_scaled`, ROADMAP F10), and a
block whose largest entry lies outside ``[sqrt(tiny) / eps, eps /
sqrt(tiny)]`` is scaled into ``[0.5, 1)`` before the Schur core, the
filter's sweeps and the inverse iteration (:func:`_range_exponent`, LAPACK
``xGEEV``'s prescale, ROADMAP F12 and F14).  Neither changes a bit inside
its range.

Real dtypes only, as in the JAX package: a complex input raises
``TypeError`` (complex projected problems take the host path).
"""

from __future__ import annotations

import numpy as np
import torch

from .timer import count_event, host_read

__all__ = ["francis_filter", "hessenberg_eigvals", "hessenberg_eigvecs",
           "hessenberg_ritz", "ordschur_device", "schur_real"]


def _real_only(H, name):
    if H.is_complex():
        raise TypeError(f"{name} is real-only; complex projected problems take the host "
                        "LAPACK path")


def _np(t):
    return t.detach().cpu().numpy()


def _sqrt(x):
    """``torch.sqrt(x)`` taken by numpy, correctly rounded on every device
    (one host read), as the kernel's ``sqrt`` is.  A CPU build's vectorized
    ``torch.sqrt`` need not be: torch 2.11.0's AVX-512 one missed numpy's
    and the H100's value in the last bit on 0.6-0.8% of random inputs."""
    return torch.from_numpy(np.asarray(np.sqrt(_np(x)))).to(x.device)


def take_at(x, i):
    """The entry of ``x`` at the flat index ``i`` (a 0-d integer tensor on
    ``x``'s device), gathered on the device with no host read."""
    return x.reshape(-1).index_select(0, i.reshape(1).long()).reshape(())


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _stable_argsort(x):
    return torch.argsort(x, stable=True)


def _lexsort(keys):
    """``numpy.lexsort``/``jnp.lexsort`` on the device: the last key is the
    primary one; successive stable argsorts, least significant first."""
    order = _stable_argsort(keys[0])
    for k in keys[1:]:
        order = order.index_select(0, _stable_argsort(k.index_select(0, order)))
    return order


# -- the plain versions of the kernel's pieces ---------------------------------

def _ordered_rows(M, R):
    """``M @ R`` for a small ``M`` (``m x k``) and the ``k``-row ``R``, in a
    fixed order: row ``r`` is ``(M[r,0] R[0] + M[r,1] R[1]) + M[r,2] R[2]``
    (and so on, left to right), each product and each sum rounded on its
    own.  ``csrc/hessenberg.cu`` sums in the same order, so the result does
    not hang on the order a library picks."""
    t = M[:, :, None] * R[None, :, :]
    out = t[:, 0]
    for k in range(1, M.shape[1]):
        out = out + t[:, k]
    return out


def _ordered_cols(C, M):
    """``C @ M`` for the ``k``-column ``C`` and a small ``M``: column ``c`` is
    ``(C[:,0] M[0,c] + C[:,1] M[1,c]) + C[:,2] M[2,c]``, as
    :func:`_ordered_rows`."""
    return _ordered_rows(M.T, C.T).T


def _pow2_scaled(*v):
    """``v`` scaled by the power of two that brings its largest magnitude
    into [0.5, 1) when that magnitude is below ``sqrt(tiny) / eps`` of the
    dtype (2^-40 in float32, 2^-459 in float64), where the squares of its
    entries would underflow and lose digits; else ``v`` as it is.  The scale
    is exact, and a reflector or a rotation built from ``v`` does not
    depend on it.  The JAX package scales nothing: on the Hessenberg of an
    eigs check at kdim 300 in float32 its reflector's ``2 / (v^T v)``
    overflows (a NaN, then the sweep budget runs out).
    ``csrc/hessenberg.cu`` (``pow2_exp``) does the same."""
    m = max(abs(c) for c in v)
    fi = np.finfo(m.dtype)
    if not 0 < m < np.sqrt(fi.tiny) / fi.eps:
        return v
    e = np.frexp(m)[1]
    return tuple(np.ldexp(c, -e) for c in v)


def _underflows(sq):
    """Whether a sum of squares lies below ``(sqrt(tiny) / eps)^2`` of its
    dtype, where its terms lose digits: the vector is then scaled
    (:func:`_pow2_scaled`) and the sum taken again."""
    fi = np.finfo(sq.dtype)
    return sq < fi.tiny / (fi.eps * fi.eps)


def _householder3(x, y, z):
    """3-element Householder ``P = I - 2 v v^T / (v^T v)`` annihilating
    ``(y, z)`` in ``(x, y, z)`` (numpy scalars of the working dtype, so the
    arithmetic is the dtype's); identity when the vector already is
    ``(x, 0, 0)``.  A vector too small to square is scaled first
    (:func:`_underflows`)."""
    dt = x.dtype.type
    sq = x * x + y * y + z * z
    if _underflows(sq):
        x, y, z = _pow2_scaled(x, y, z)
        sq = x * x + y * y + z * z
    s = np.sqrt(sq)
    alpha = -(s if x >= 0 else -s)
    v0 = x - alpha
    vnorm2 = v0 * v0 + y * y + z * z
    inv = dt(2.0) / vnorm2 if vnorm2 > 0 else dt(0.0)
    one, zero = dt(1.0), dt(0.0)
    v = (v0, y, z)
    return np.array([[(one if r == c else zero) - inv * (v[r] * v[c]) for c in range(3)]
                     for r in range(3)], dtype=x.dtype)


def _chase(H, lo, hi, s, t, Z=None):
    """One Francis double-implicit-shift bulge chase on the window
    ``[lo, hi]`` (0-indexed, inclusive, size >= 3) with shift sum ``s`` and
    product ``t`` (Golub and Van Loan Alg. 7.5.1-7.5.2), in place on ``H``
    (and ``Z <- Z Q``).  Row and column updates apply to the full slices;
    the annihilated bulge entries are set to exactly zero.  Returns the
    number of chase steps."""
    n = H.shape[0]
    if n < 3:
        return 0
    dt = H.dtype
    h = _np(H[lo:lo + 3, lo:lo + 2])
    h00, h01, h10, h11, h21 = h[0, 0], h[0, 1], h[1, 0], h[1, 1], h[2, 1]
    x0 = h00 * h00 + h01 * h10 - s * h00 + t
    y0 = h10 * (h00 + h11 - s)
    z0 = h10 * h21
    p = min(max(lo, 0), n - 3)
    while p <= hi - 2:
        first = p == lo
        x, y, z = (x0, y0, z0) if first else _np(H[p:p + 3, p - 1])
        P = torch.from_numpy(_householder3(x, y, z)).to(H.device, dt)
        H[p:p + 3, :] = _ordered_rows(P, H[p:p + 3, :])
        H[:, p:p + 3] = _ordered_cols(H[:, p:p + 3], P)
        if Z is not None:
            Z[:, p:p + 3] = _ordered_cols(Z[:, p:p + 3], P)
        if not first:
            H[p + 1:p + 3, p - 1] = 0.0
        p += 1
    x, y = _np(H[hi - 1:hi + 1, hi - 2])
    sq = x * x + y * y
    if _underflows(sq):
        x, y = _pow2_scaled(x, y)
        sq = x * x + y * y
    r = np.sqrt(sq)
    c, sn = (x / r, y / r) if r > 0 else (x.dtype.type(1.0), x.dtype.type(0.0))
    G = torch.from_numpy(np.array([[c, sn], [-sn, c]])).to(H.device, dt)
    H[hi - 1:hi + 1, :] = _ordered_rows(G, H[hi - 1:hi + 1, :])
    H[:, hi - 1:hi + 1] = _ordered_cols(H[:, hi - 1:hi + 1], G.T)
    if Z is not None:
        Z[:, hi - 1:hi + 1] = _ordered_cols(Z[:, hi - 1:hi + 1], G.T)
    H[hi, hi - 2] = 0.0
    return hi - lo - 1


def _embed(H, k_eff):
    """Zero the inactive block of the buffer and plant separated dummy
    diagonal entries there (pre-deflated 1x1 blocks).  ``k_eff`` is an int
    or a 0-d tensor; returns ``(Hm, active)``."""
    n = H.shape[0]
    idx = torch.arange(n, device=H.device)
    active = idx < k_eff
    Hm = torch.where(active[:, None] & active[None, :], H, torch.zeros((), dtype=H.dtype,
                                                                      device=H.device))
    norm = torch.max(torch.abs(Hm)) + 1.0
    dummy = norm * (2.0 + idx.to(H.dtype) / n)
    diag = torch.where(active, torch.diagonal(Hm), dummy)
    Hm = Hm.clone()
    Hm[idx, idx] = diag
    return Hm, active


def _to_hessenberg(H, Z=None):
    """Householder similarity reduction to upper Hessenberg form (GEHRD's
    role), one vectorized reflector a column; with ``Z``, also ``Z <- Z Q``.
    The products with the reflector's vector sum in the library's order; on
    a column that is already Hessenberg they hold one nonzero product, exact
    in any order.  Returns ``(H, Z)``."""
    n = H.shape[0]
    if n < 3:
        return H, Z
    rows = torch.arange(n, device=H.device)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    for j in range(n - 2):
        below = rows > j
        x = torch.where(below, H[:, j], zero)
        s = _sqrt(torch.sum(x * x))
        x0 = H[j + 1, j]
        alpha = -torch.where(x0 >= 0, s, -s)
        u = x - alpha * (rows == j + 1).to(H.dtype)
        un2 = torch.sum(u * u)
        safe = un2 > 0
        inv = torch.where(safe, 2.0 / torch.where(safe, un2, torch.ones_like(un2)), zero)
        H = H - inv * torch.outer(u, u @ H)
        H = H - inv * torch.outer(H @ u, u)
        if Z is not None:
            Z = Z - inv * torch.outer(Z @ u, u)
        keep = ~below | (rows == j + 1)
        H[:, j] = torch.where(keep, H[:, j], zero)
    return H, Z


def _schur_core(H, Z=None):
    """Francis sweeps to quasi-triangular form, in place: LAPACK
    ``dlahqr``-style deflation with the zero-neighbour safeguard, the
    trailing 2x2 Wilkinson double shift, an exceptional shift every 10
    stalled sweeps, and a budget of 30 n sweeps.  Returns
    ``(H, Z, accepted, ok, work)``: ``accepted[i]`` marks a terminal 2x2
    block on rows ``(i, i+1)`` (a bool tensor), ``ok`` is False only if the
    budget ran out, ``work`` the passes made and their chase steps."""
    n = H.shape[0]
    dev = H.device
    if n < 2:
        return H, Z, torch.zeros(0, dtype=torch.bool, device=dev), True, (0, 0)
    eps = torch.finfo(H.dtype).eps
    ii = np.arange(n - 1)
    accepted = np.zeros(n - 1, bool)
    last_hi, stall, sweeps, steps = -1, 0, 0, 0
    max_sweeps = 30 * n
    while True:
        band = _np(torch.stack([torch.diagonal(H), torch.cat([torch.diagonal(H, -1),
                                                             H[:1, 0]])]))
        d, sub = np.abs(band[0]), band[1, :-1].copy()
        if not (np.any((sub != 0) & ~accepted) and sweeps < max_sweeps):
            break
        tst = d[:-1] + d[1:]
        if np.any(tst == 0):
            tst = np.where(tst == 0, _np(torch.max(torch.abs(H))), tst)
        small = np.abs(sub) <= eps * tst
        if small.any():
            sub[small] = 0
            rows = torch.from_numpy(ii[small]).to(dev)
            H[rows + 1, rows] = 0.0
        op = (sub != 0) & ~accepted
        any_open = bool(op.any())
        hi_c = int(np.max(np.where(op, ii, -1)))
        hi = hi_c + 1
        zero_below = (sub == 0) & (ii < hi_c)
        lo = int(np.max(np.where(zero_below, ii + 1, 0)))
        stall = stall + 1 if hi == last_hi else 0
        if any_open and hi - lo >= 2:
            blk = _np(H[hi - 2:hi + 1, hi - 2:hi + 1])
            a11, a12, a21, a22 = blk[1, 1], blk[1, 2], blk[2, 1], blk[2, 2]
            s = a11 + a22
            t = a11 * a22 - a12 * a21
            if stall > 0 and stall % 10 == 0:
                sexc = np.abs(a21) + np.abs(blk[1, 0])
                wexc = a22 + a22.dtype.type(0.75) * sexc
                s, t = a22.dtype.type(2.0) * wexc, wexc * wexc
            steps += _chase(H, lo, hi, s, t, Z)
        elif any_open:
            accepted[max(hi_c, 0)] = True
        last_hi = hi
        sweeps += 1
    sub = _np(torch.diagonal(H, -1))
    ok = not np.any((sub != 0) & ~accepted)
    return H, Z, torch.from_numpy(accepted).to(dev), ok, (sweeps, steps)


def _extract_eigvals(H, accepted):
    """Eigenvalues of the quasi-triangular form: the diagonal for 1x1
    blocks, the quadratic formula on accepted 2x2 blocks (real and
    imaginary parts as two real arrays)."""
    d = torch.diagonal(H)
    pad = torch.zeros(1, dtype=H.dtype, device=H.device)
    padb = torch.zeros(1, dtype=torch.bool, device=H.device)
    pair_start = torch.cat([accepted, padb])
    pair_second = torch.cat([padb, accepted])
    a = d
    b = torch.cat([torch.diagonal(H, 1), pad])
    c = torch.cat([torch.diagonal(H, -1), pad])
    dd = torch.cat([d[1:], pad])
    m = 0.5 * (a + dd)
    disc = 0.25 * (a - dd) ** 2 + b * c
    sq = _sqrt(torch.abs(disc))
    real_pair = disc >= 0
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    wr1 = torch.where(real_pair, m + sq, m)
    wr2 = torch.where(real_pair, m - sq, m)
    wi1 = torch.where(real_pair, zero, sq)
    wr2s = torch.cat([pad, wr2[:-1]])
    wi2s = torch.cat([pad, wi1[:-1]])
    wr = torch.where(pair_start, wr1, torch.where(pair_second, wr2s, d))
    wi = torch.where(pair_start, wi1, torch.where(pair_second, -wi2s, zero))
    return wr, wi


def _split_real_blocks(T, Z, accepted):
    """Split each accepted 2x2 block whose eigenvalues are REAL into two
    1x1 blocks by a Givens similarity (``dlanv2``'s standardization), in
    place: afterwards every 2x2 block is a complex-conjugate pair.  The
    rotation's first column is the eigenvector of the larger-modulus real
    eigenvalue."""
    n = T.shape[0]
    if n < 2:
        return T, Z, accepted
    acc = _np(accepted).copy()
    for i in np.flatnonzero(acc):
        i = int(i)
        (a, b), (c, d) = _np(T[i:i + 2, i:i + 2])
        dt = a.dtype.type
        m = dt(0.5) * (a + d)
        disc = dt(0.25) * (a - d) ** 2 + b * c
        if not disc >= 0:
            continue
        sq = np.sqrt(np.abs(disc))
        lam = m + (sq if m >= 0 else -sq)
        v1a, v1b, v2a, v2b = _pow2_scaled(b, lam - a, lam - d, c)
        v1 = np.array([v1a, v1b])
        v2 = np.array([v2a, v2b])
        v = v1 if np.sum(v1 * v1) >= np.sum(v2 * v2) else v2
        nrm = np.sqrt(np.sum(v * v))
        v = v / nrm if nrm > 0 else np.array([1.0, 0.0], dtype=a.dtype)
        G = torch.from_numpy(np.array([[v[0], -v[1]], [v[1], v[0]]])).to(T.device, T.dtype)
        T[i:i + 2, :] = _ordered_rows(G.T, T[i:i + 2, :])
        T[:, i:i + 2] = _ordered_cols(T[:, i:i + 2], G)
        Z[:, i:i + 2] = _ordered_cols(Z[:, i:i + 2], G)
        T[i + 1, i] = 0.0
        acc[i] = False
    return T, Z, torch.from_numpy(acc).to(T.device)


def _sweeps_plain(H, wr, wi, shift_order, n_keep, pure):
    """The plain version of :func:`francis_filter`'s ``kdim // 2`` sweeps:
    each does its own explicit deflation (the ``dlahqr`` threshold) and
    chases only the top-connected block with the next pair of shifts.
    ``H`` and the shifts are prescaled as the Schur core's block
    (:func:`_range_exponent`; the sweeps' first vector is quadratic in the
    scale) and ``Hf`` unscaled after; ``Z`` does not depend on the scale.
    Returns ``(Hf, Z, work)``, ``work`` (int32) the number of sweeps that
    chased and their chase steps."""
    kdim = H.shape[0]
    e = _range_exponent(H, kdim)
    Hc = _ldexp(H, -e).clone()
    Z = _eye(kdim, H)
    n, pure = int(torch.as_tensor(n_keep)), bool(torch.as_tensor(pure))
    wr, wi, order = _np(wr), _np(wi), _np(shift_order)
    if e:
        wr, wi = np.ldexp(wr, -e), np.ldexp(wi, -e)
    eps = np.finfo(wr.dtype).eps
    ii = np.arange(kdim - 1)
    active_sweeps = steps = 0
    for j in range(kdim // 2):
        band = _np(torch.stack([torch.diagonal(Hc), torch.cat([torch.diagonal(Hc, -1),
                                                              Hc[:1, 0]])]))
        d, sub = np.abs(band[0]), band[1, :-1].copy()
        tst = d[:-1] + d[1:]
        if np.any(tst == 0):
            tst = np.where(tst == 0, _np(torch.max(torch.abs(Hc))), tst)
        small = np.abs(sub) <= eps * tst
        if small.any():
            sub[small] = 0
            rows = torch.from_numpy(ii[small]).to(H.device)
            Hc[rows + 1, rows] = 0.0
        hi = int(np.min(np.where(sub == 0, ii, kdim - 1))) if kdim > 1 else 0
        if (2 * j + 1) < (kdim - n) and pure and hi >= 2:
            ia = order[min(max(2 * j, 0), kdim - 1)]
            ib = order[min(max(2 * j + 1, 0), kdim - 1)]
            s = wr[ia] + wr[ib]
            t = wr[ia] * wr[ib] - wi[ia] * wi[ib]
            steps += _chase(Hc, 0, hi, s, t, Z)
            active_sweeps += 1
    return (_ldexp(Hc, e), Z,
            torch.tensor([active_sweeps, steps], dtype=torch.int32, device=H.device))


def _cmul(ar, ai, br, bi):
    """``(ar + i ai)(br + i bi)`` elementwise, each product and sum rounded on
    its own; ``csrc/ritz.cu`` (``cmul``) computes it in the same order."""
    return ar * br - ai * bi, ar * bi + ai * br


def _recip(br, bi):
    """``1 / (br + i bi)`` elementwise by Smith's formula (no square of an
    entry, so no overflow before the result's); ``csrc/ritz.cu``
    (``recip``) computes it in the same order."""
    one = torch.ones_like(br)
    big = torch.abs(br) >= torch.abs(bi)
    r1 = bi / br
    d1 = br + bi * r1
    r2 = br / bi
    d2 = bi + br * r2
    return torch.where(big, one / d1, r2 / d2), torch.where(big, -(r1 / d1), -(one / d2))


def _eigvec_rhs(n, dt, device):
    """Fixed right-hand side of the inverse iteration, ``2n`` entries (a
    dense incommensurate pattern, never orthogonal to the null direction by
    accident): ``b[:n] + i b[n:]`` is the complex system's."""
    i = torch.arange(2 * n, device=device).to(dt)
    b = torch.sin(1.7 * i + 0.3) + 0.25
    return b / torch.linalg.vector_norm(b)


def _shifts(Hm, wr, wi):
    """The inverse iteration's ridge ``eps3 = eps (max |Hm| + 1)`` over the
    embedded matrix ``Hm`` (its dummy diagonal included), the separation
    ``sep = 4 eps3``, and the real parts moved apart: each by ``sep`` for
    every EARLIER slot within ``sep`` of it (dhsein's cluster rule, over all
    slots, the inactive ones at 0 included).  Returns ``(eps3, sep, wr')``."""
    eps = torch.finfo(Hm.dtype).eps
    eps3 = eps * (torch.max(torch.abs(Hm)) + 1.0)
    sep = 4.0 * eps3
    close = (torch.abs(wr[None, :] - wr[:, None]) + torch.abs(wi[None, :] - wi[:, None])) <= sep
    earlier = torch.tril(close, diagonal=-1)
    return eps3, sep, wr + earlier.sum(dim=1).to(Hm.dtype) * sep


def _inverse_iteration_plain(H, wr, wi, k_eff):
    """The plain version of the inverse iteration of ``csrc/ritz.cu``, batched
    over the slots: for slot ``j`` the complex system
    ``(Hm - sigma_j I) z = b[:n] + i b[n:]`` with
    ``sigma_j = (wr'_j - eps3) + i wi_j`` (:func:`_shifts`; the block and the
    eigenvalues prescaled as the Schur core's, :func:`_range_exponent`, so
    that the ridge ``eps3`` is relative to the block), which is the
    JAX package's realified ``[[A, wi I], [-wi I, A]] + eps3 I`` with
    ``A = Hm - wr'_j I``.  LU with partial pivoting (the largest
    ``|re| + |im|``, ties to the lower position; an exact zero pivot becomes
    ``eps3``, as ``dlaein`` does) among the rows that can hold a nonzero in
    the column, those whose first nonzero column (the profile) is at most
    the column: two a step on a Hessenberg or the Krylov-Schur arrow form.
    Then back substitution a column at a time, in real and imaginary parts
    apart (:func:`_cmul`, :func:`_recip`).  Returns ``(Vr, Vi)`` in slot
    order, columns of unit norm (zero if the solve gave 0), rows ``>= k_eff``
    zero."""
    n = H.shape[0]
    dt, dev = H.dtype, H.device
    e = _range_exponent(H, k_eff)
    Hm, active = _embed(_ldexp(H, -e), k_eff)
    wr, wi = _ldexp(wr, -e), _ldexp(wi, -e)
    eps3, _, wrp = _shifts(Hm, wr, wi)
    zero = torch.zeros((), dtype=dt, device=dev)
    slots = torch.arange(n, device=dev)
    S = slots[:, None]
    Wr = Hm.expand(n, n, n).clone()
    Wi = torch.zeros_like(Wr)
    Wr[:, slots, slots] = (torch.diagonal(Hm)[None, :] - wrp[:, None]) + eps3
    Wi[:, slots, slots] = (-wi)[:, None].expand(n, n)
    b = _eigvec_rhs(n, dt, dev)
    yr, yi = b[:n].expand(n, n).clone(), b[n:].expand(n, n).clone()
    nz = (Hm != 0) | torch.eye(n, dtype=torch.bool, device=dev)
    profile = torch.argmax(nz.to(torch.int8), dim=1)
    fpos = profile.expand(n, n).clone()
    # the rows that can hold a nonzero in column j: as many in every slot
    counts = np.cumsum(np.bincount(_np(profile), minlength=n)) - np.arange(n)
    for j in range(n):
        cand = fpos[:, j:] <= j
        pos = torch.argsort((~cand).to(torch.int8), dim=1, stable=True)[:, :int(counts[j])] + j
        score = torch.abs(Wr[S, pos, j]) + torch.abs(Wi[S, pos, j])
        score = torch.where(torch.isnan(score), -1.0, score)
        pv = pos[slots, torch.argmax(score, dim=1)]
        for M in (Wr, Wi, yr, yi, fpos):
            top = M[slots, j].clone()
            M[slots, j] = M[slots, pv]
            M[slots, pv] = top
        if counts[j] < 2:
            continue
        pr, pi = Wr[slots, j, j], Wi[slots, j, j]
        ir, ii = _recip(torch.where((pr == 0) & (pi == 0), eps3, pr), pi)
        rest = pos[:, 1:]  # position j leads; the pivot's old row now sits at pv
        lr, li = _cmul(Wr[S, rest, j], Wi[S, rest, j], ir[:, None], ii[:, None])
        tr, ti = _cmul(lr[..., None], li[..., None], Wr[slots, j, j + 1:][:, None],
                       Wi[slots, j, j + 1:][:, None])
        Wr[S, rest, j + 1:] = Wr[S, rest, j + 1:] - tr
        Wi[S, rest, j + 1:] = Wi[S, rest, j + 1:] - ti
        tr, ti = _cmul(lr, li, yr[slots, j][:, None], yi[slots, j][:, None])
        yr[S, rest] = yr[S, rest] - tr
        yi[S, rest] = yi[S, rest] - ti
    for c in range(n - 1, -1, -1):
        pr, pi = Wr[:, c, c], Wi[:, c, c]
        pr = torch.where((pr == 0) & (pi == 0), eps3, pr)
        ir, ii = _recip(pr, pi)
        xr, xi = _cmul(yr[:, c], yi[:, c], ir, ii)
        yr[:, c], yi[:, c] = xr, xi
        if c:
            tr, ti = _cmul(Wr[:, :c, c], Wi[:, :c, c], xr[:, None], xi[:, None])
            yr[:, :c] = yr[:, :c] - tr
            yi[:, :c] = yi[:, :c] - ti
    return _unit_columns(torch.where(active[None, :], yr, zero),
                         torch.where(active[None, :], yi, zero))


def _unit_columns(xr, xi):
    """The rows of ``x = xr + i xi`` (one a slot) as unit columns, zero where
    the norm is 0: each scaled down first by the power of two of its largest
    entry, an exact scale that changes no bit where the sum of squares does
    not overflow.  Where it would, the JAX package's unscaled sum gives
    ``inf``, a zero column and a zero residual that counts as converged (in
    f32 at a triple eigenvalue, where ``|x|`` reaches ``1 / eps3^3``; ROADMAP
    F11).  ``csrc/ritz.cu`` scales alike."""
    m = _np(torch.maximum(torch.abs(xr), torch.abs(xi)).amax(dim=1))
    e = np.where((m > 0) & np.isfinite(m), np.frexp(m)[1], 0).clip(min=0)
    scale = torch.from_numpy(np.ldexp(np.ones_like(m), -e)).to(xr.device)[:, None]
    xr, xi = xr * scale, xi * scale
    nrm = _sqrt(torch.sum(xr * xr + xi * xi, dim=1))
    pos = nrm > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, nrm, torch.ones_like(nrm)),
                      torch.zeros_like(nrm))
    return (xr * inv[:, None]).T, (xi * inv[:, None]).T


def _ritz_plain(H_ext, wr, wi, ok, k_eff, tol, nev=None, p: int = 1):
    """The plain version of the check's analysis of ``csrc/ritz.cu``: the
    vectors of :func:`_inverse_iteration_plain` for the Schur kernel's
    ``(wr, wi, ok)``, their residuals (``+inf`` unless the slot is active and
    ``ok``), the stable modulus-descending order and the converged count
    among the leading ``nev``.  Returns ``(wr, wi, res, Vr, Vi, n_conv)``
    in that order; the order is taken on the prescaled eigenvalues
    (:func:`_range_exponent`), whose squares neither underflow nor
    overflow."""
    kdim = H_ext.shape[1]
    dev, dt = H_ext.device, H_ext.dtype
    k_t = torch.clamp(torch.as_tensor(k_eff, device=dev).long().reshape(()), 0, kdim)
    Vr, Vi = _inverse_iteration_plain(H_ext[:kdim, :kdim], wr, wi, k_t)
    idx = torch.arange(kdim, device=dev)
    live = (idx < k_t) & torch.as_tensor(ok, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    if p == 1:
        km1 = torch.clamp(k_t - 1, min=0)
        beta = torch.abs(take_at(H_ext, k_t * kdim + km1))
        vr, vi = Vr.index_select(0, km1.reshape(1))[0], Vi.index_select(0, km1.reshape(1))[0]
        res = beta * _sqrt(vr * vr + vi * vi)
    else:
        kmp = torch.clamp(k_t - p, min=0)
        rows = k_t + torch.arange(p, device=dev)
        cols = kmp + torch.arange(p, device=dev)
        B = H_ext.index_select(0, rows).index_select(1, cols)
        Br, Bi = B @ Vr.index_select(0, cols), B @ Vi.index_select(0, cols)
        res = _sqrt(torch.sum(Br * Br + Bi * Bi, dim=0))
    res = torch.where(live, res, inf)
    e = _range_exponent(H_ext[:kdim, :kdim], k_t)
    wrs, wis = _ldexp(wr, -e), _ldexp(wi, -e)
    order = _stable_argsort(-(wrs * wrs + wis * wis))
    res = res[order]
    lead = idx < (kdim if nev is None else nev)
    n_conv = torch.sum(lead & torch.isfinite(res) & (res < tol)).to(torch.int32)
    return wr[order], wi[order], res, Vr[:, order], Vi[:, order], n_conv


def _range_exponent(H, k_eff):
    """The exponent ``e`` that the active ``k_eff x k_eff`` block of ``H`` is
    scaled by, ``2^-e``, before the Schur core (LAPACK ``xGEEV``'s
    prescale): that of ``anrm = max |H_act|`` when ``anrm`` lies outside
    ``[sqrt(tiny) / eps, eps / sqrt(tiny)]`` of the dtype (``[2^-40, 2^40]``
    in float32, ``[2^-459, 2^459]`` in float64), so that the block's largest
    entry lands in ``[0.5, 1)``; else 0, and nothing changes.  Below the
    range the Householder reduction's rank-one products ``u (u^T H)``, cubic
    in the scale, fall into the subnormals (float32: from ``2^-42``) and lose
    digits; above it they overflow.  ``csrc/hessenberg.cu`` and
    ``csrc/ritz.cu`` (``range_exp``) compute the same."""
    active = torch.arange(H.shape[0], device=H.device) < k_eff
    blk = torch.where(active[:, None] & active[None, :], torch.abs(H),
                      torch.zeros((), dtype=H.dtype, device=H.device))
    m = _np(torch.max(blk))[()]
    fi = np.finfo(m.dtype)
    small = np.sqrt(fi.tiny) / fi.eps
    if not (np.isfinite(m) and m > 0 and (m < small or m > 1 / small)):
        return 0
    return int(np.frexp(m)[1])


def _ldexp(t, e):
    """``t * 2^e``, exact (by numpy, so that no power of two is rounded in
    the tensor's dtype)."""
    if t is None or e == 0:
        return t
    return torch.from_numpy(np.ldexp(_np(t), e)).to(t.device)


def _schur_plain(H, k_eff, with_z: bool, split: bool):
    """The plain version of the ``hessenberg_schur`` kernel: the range
    prescale (:func:`_range_exponent`), embedding, Hessenberg reduction,
    Francis sweeps, optionally the real-block split, and the eigenvalues,
    then ``T``, ``wr`` and ``wi`` unscaled.  Returns ``(T, Z, wr, wi,
    accepted, ok, work)`` with ``Z`` None unless ``with_z``; ``ok`` a 0-d
    bool tensor, ``work`` an int32 tensor ``[sweeps, chase steps]``."""
    n = H.shape[0]
    e = _range_exponent(H, k_eff)
    Hm, active = _embed(_ldexp(H, -e), k_eff)
    Z = _eye(n, H) if with_z else None
    Hh, Z = _to_hessenberg(Hm, Z)
    T, Z, acc, ok, work = _schur_core(Hh.contiguous(), Z)
    if split and Z is not None:
        T, Z, acc = _split_real_blocks(T, Z, acc)
    wr, wi = _extract_eigvals(T, acc)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    wr = torch.where(active, wr, zero)
    wi = torch.where(active, wi, zero)
    return (_ldexp(T, e), Z, _ldexp(wr, e), _ldexp(wi, e), acc,
            torch.tensor(ok, device=H.device),
            torch.tensor(work, dtype=torch.int32, device=H.device))


# -- the public functions ------------------------------------------------------

def _keff(k_eff, n, device):
    if k_eff is None:
        return n
    return k_eff.to(device) if isinstance(k_eff, torch.Tensor) else int(k_eff)


def hessenberg_eigvals(H, k_eff=None):
    """Eigenvalues of a real upper-Hessenberg (or any real square) matrix
    on its device -> ``(wr, wi, ok)``: real and imaginary parts aligned with
    the buffer's positions (entries at ``>= k_eff`` are inactive and report
    0) and the convergence flag, a 0-d bool tensor.  ``k_eff`` may be a 0-d
    tensor on the device and defaults to the full buffer.  One launch of the
    ``hessenberg_schur`` kernel on a CUDA tensor."""
    from ..ops import hessenberg as kernels

    _real_only(H, "hessenberg_eigvals")
    _, _, wr, wi, _, ok, _ = kernels.hessenberg_schur(H, _keff(k_eff, H.shape[0], H.device))
    return wr, wi, ok


def schur_real(H, k_eff=None):
    """Real Schur decomposition ``H = Z T Z^T`` on the device: Householder
    reduction, Francis QR with accumulated transforms and the real-pair
    block split (the device counterpart of the host ``schur`` of the
    Krylov-Schur restart, BaseKrylov.fypp:807).  Returns
    ``(T, Z, wr, wi, ok)``: every 2x2 block of ``T`` a conjugate pair,
    ``(wr, wi)`` aligned with ``T``'s diagonal.  With ``k_eff`` the active
    block is embedded as in :func:`hessenberg_eigvals` (``Z`` is then the
    identity on the inactive part).  One kernel launch on a CUDA tensor."""
    from ..ops import hessenberg as kernels

    _real_only(H, "schur_real")
    T, Z, wr, wi, _, ok, _ = kernels.hessenberg_schur(
        H, _keff(k_eff, H.shape[0], H.device), with_z=True, split=True)
    return T, Z, wr, wi, ok


def _maxnan(a, b):
    """``max(a, b)`` that keeps a NaN, as ``torch.max`` and the kernels do."""
    return b if (b > a or b != b) else a


def _solve_pivoted(A, b):
    """``A x = b`` for the small square ``A`` (numpy, the working dtype) by
    Gaussian elimination with partial pivoting (the first largest ``|a|``
    of the column, as LAPACK ``getrf``), then back substitution, each
    product and sum rounded on its own in the order written here;
    ``csrc/ordschur.cu`` (``solve_pivoted``) repeats it."""
    A, b = A.copy(), b.copy()
    q = len(b)
    for j in range(q):
        p = j
        for r in range(j + 1, q):
            if abs(A[r, j]) > abs(A[p, j]):
                p = r
        if p != j:
            A[[j, p]] = A[[p, j]]
            b[[j, p]] = b[[p, j]]
        for r in range(j + 1, q):
            l = A[r, j] / A[j, j]
            for c in range(j + 1, q):
                A[r, c] = A[r, c] - l * A[j, c]
            b[r] = b[r] - l * b[j]
    x = np.zeros_like(b)
    for r in range(q - 1, -1, -1):
        acc = b[r]
        for c in range(r + 1, q):
            acc = acc - A[r, c] * x[c]
        x[r] = acc / A[r, r]
    return x


def _householder_q(M):
    """``Q`` of the complete QR of the small ``(m, q)`` matrix ``M`` (numpy,
    the working dtype, ``q < m``) by Householder reflectors in LAPACK's
    convention (``dgeqrf``'s ``dlarfg``: ``beta = -sign(alpha) ||x||``,
    ``tau = (beta - alpha) / beta``, ``v = [1, x[1:] / (alpha - beta)]``;
    then ``dorgqr``), each product and sum rounded on its own in the order
    written here; ``||x||`` is taken on the column scaled by the power of
    two of its largest entry (exact), so that a large ``X`` (blocks with
    nearly equal eigenvalues) cannot overflow its squares, as ``dlapy2``
    guards LAPACK's.  ``csrc/ordschur.cu`` (``householder_q``) repeats it."""
    m, q = M.shape
    dt = M.dtype.type
    R = M.copy()
    vs = []
    for j in range(q):
        mx = dt(0)
        for r in range(j, m):
            mx = _maxnan(mx, abs(R[r, j]))
        e = int(np.frexp(mx)[1]) if 0 < mx < np.inf else 0
        ss = dt(0)
        for r in range(j + 1, m):
            t = np.ldexp(R[r, j], -e)
            ss = ss + t * t
        v = np.zeros(m, M.dtype)
        v[j] = 1
        tau = dt(0)
        if ss != 0:
            alpha = R[j, j]
            a = np.ldexp(alpha, -e)
            h = np.ldexp(np.sqrt(a * a + ss), e)
            beta = -h if alpha >= 0 else h
            tau = (beta - alpha) / beta
            scl = dt(1) / (alpha - beta)
            for r in range(j + 1, m):
                v[r] = R[r, j] * scl
            for c in range(j + 1, q):
                w = dt(0)
                for r in range(j, m):
                    w = w + v[r] * R[r, c]
                for r in range(j, m):
                    R[r, c] = R[r, c] - tau * (v[r] * w)
        vs.append((v, tau))
    Q = np.eye(m, dtype=M.dtype)
    for j in range(q - 1, -1, -1):
        v, tau = vs[j]
        for c in range(m):
            w = dt(0)
            for r in range(j, m):
                w = w + v[r] * Q[r, c]
            for r in range(j, m):
                Q[r, c] = Q[r, c] - tau * (v[r] * w)
    return Q


def _swap_plain(W, n1: int, n2: int, anrm, rej_factor: float = 50.0):
    """The direct swap of the adjacent diagonal blocks of sizes ``(n1, n2)``
    leading the window ``W`` (numpy, ``m x m``, ``m = n1 + n2``; Bai and
    Demmel, LAPACK ``dlaexc``), as the JAX package's ``_swap_q_factory``
    and its test compute it, in a written order: the Sylvester system of
    :func:`_sylvester_system` solved by :func:`_solve_pivoted`, ``Q`` from
    :func:`_householder_q` of ``[X; I]``, then ``Q^T W Q`` as ``(Q^T W) Q``
    with each entry an ordered sum, and the largest ``|.|`` of its
    ``(n1, n2)`` lower-left block (the coupling the swap annihilates)
    against ``rej_factor eps (anrm + 1)``, ``anrm = max |T|``.  Returns
    ``(Q, resid, bad)``."""
    m = n1 + n2
    dt = W.dtype.type
    eps = np.finfo(W.dtype).eps
    x = _solve_pivoted(*_sylvester_system(W, n1, n2))
    M = np.zeros((m, n2), W.dtype)
    for c in range(n2):
        for r in range(n1):
            M[r, c] = x[c * n1 + r]
        M[n1 + c, c] = 1
    Q = _householder_q(M)
    U = np.zeros((m, m), W.dtype)
    for r in range(m):
        for c in range(m):
            acc = Q[0, r] * W[0, c]
            for a in range(1, m):
                acc = acc + Q[a, r] * W[a, c]
            U[r, c] = acc
    resid = dt(0)
    for r in range(n2, m):
        for c in range(n2):
            acc = U[r, 0] * Q[0, c]
            for b in range(1, m):
                acc = acc + U[r, b] * Q[b, c]
            resid = _maxnan(resid, abs(acc))
    thr = dt(rej_factor) * eps * (anrm + dt(1))
    return Q, resid, bool(resid > thr)


def _sylvester_system(W, n1: int, n2: int):
    """The swap's Sylvester equation ``A11 X - X A22 = -A12`` on the window
    ``W`` as the ``n1 n2``-square system of the JAX package's
    ``_swap_q_factory``: ``K = kron(I, A11) - kron(A22^T, I)`` (column-major
    ``vec``) with the ridge ``eps (max |K| + 1)`` added to its diagonal, and
    ``-vec(A12)``.  ``K`` is singular iff the blocks share an eigenvalue;
    the ridge keeps the solve finite and the swap's test rejects what it
    gives.  Returns ``(K + ridge I, rhs)``."""
    dt = W.dtype.type
    eps = np.finfo(W.dtype).eps
    q = n1 * n2
    K = np.zeros((q, q), W.dtype)
    rhs = np.zeros(q, W.dtype)
    for c in range(n2):
        for r in range(n1):
            a = c * n1 + r
            rhs[a] = -W[r, n1 + c]
            for c2 in range(n2):
                for r2 in range(n1):
                    b = c2 * n1 + r2
                    if c == c2 and r == r2:
                        K[a, b] = W[r, r] - W[n1 + c, n1 + c]
                    elif c == c2:
                        K[a, b] = W[r, r2]
                    elif r == r2:
                        K[a, b] = -W[n1 + c2, n1 + c]
    kmax = dt(0)
    for a in range(q):
        for b in range(q):
            kmax = _maxnan(kmax, abs(K[a, b]))
    reg = eps * (kmax + dt(1))
    for a in range(q):
        K[a, a] = K[a, a] + reg
    return K, rhs


def _next_swap(T, sel):
    """The next swap of the bubble sort on the device: the first block
    start whose block is unselected with a selected block right below it
    (``n`` when there is none), and the sizes ``n1``, ``n2`` of the two
    blocks from the subdiagonal (the JAX package's ``find``)."""
    n = T.shape[0]
    dev = T.device
    idx = torch.arange(n, device=dev)
    zero = torch.zeros(1, dtype=T.dtype, device=dev)
    sub = torch.cat([torch.diagonal(T, -1), zero])
    prev = torch.cat([zero, sub[:-1]])
    start = (idx == 0) | (prev == 0)
    nxt = idx + 1 + (sub != 0).long()
    cand = start & (nxt < n) & ~sel & sel[torch.clamp(nxt, 0, n - 1)]
    i = torch.min(torch.where(cand, idx, torch.full_like(idx, n)))
    ic = torch.clamp(i, 0, n - 1)
    n1 = 1 + (take_at(sub, ic) != 0).long()
    n2 = 1 + (take_at(sub, torch.clamp(ic + n1, 0, n - 1)) != 0).long()
    return i, n1, n2


def _pair_consistent(T, sel):
    """``sel`` with a flag on either position of a 2x2 block of ``T`` set on
    both (LAPACK's behaviour)."""
    coupled = torch.diagonal(T, -1) != 0
    pad = torch.zeros(1, dtype=torch.bool, device=T.device)
    up = torch.cat([coupled & sel[1:], pad])
    down = torch.cat([pad, coupled & sel[:-1]])
    return sel | up | down


def _ordschur_plain(T, Z, select_mask, rej_factor: float = 50.0):
    """The plain version of the ``ordschur`` kernel of ``csrc/ordschur.cu``:
    reorder a real Schur form so that the flagged diagonal positions lead
    (LAPACK TRSEN/dtrexc: bubble each selected block up by adjacent
    orthogonal swaps; the JAX package's ``_ordschur_core``).  The mask is
    made pair-consistent first; every 2x2 block must be a conjugate pair.  A
    swap whose annihilated coupling exceeds ``rej_factor eps (max |T| + 1)``
    is not applied and the loop stops (``ok`` False); what was applied is an
    exact orthogonal similarity.  The loop ends too after ``n^2 + 4``
    passes.

    Each pass finds the next swap on ``T``'s device and reads its position
    and block sizes in one counted host read (``ordschur_reads``); the
    swap's ``4 x 4`` work (:func:`_swap_plain`) runs on numpy scalars of the
    window; the accepted swap's ``Q^T`` on rows ``i..i+m-1`` of ``T`` (from
    column ``i``), ``Q`` on columns ``i..i+m-1`` of ``T`` (rows ``< i + m``)
    and of ``Z`` (every row), as ordered sums (:func:`_ordered_rows`), the
    exact zeros below the new block diagonal written after.  The entries
    the JAX package's full-width updates also touch are exact zeros there
    (the quasi-triangular form), and its padding to ``n + 3`` only keeps its
    fixed-shape window in range.  Returns ``(T', Z', sel', ok, swaps)``,
    ``ok`` a 0-d bool tensor, ``swaps`` the swaps applied (int32)."""
    n = T.shape[0]
    dev = T.device
    T, Z = T.clone(), Z.clone()
    sel = _pair_consistent(T, torch.as_tensor(select_mask, device=dev).to(torch.bool))
    idx = torch.arange(n, device=dev)
    max_swaps = n * n + 4
    passes = swaps = 0
    failed = False
    while True:
        i, n1, n2 = (int(v) for v in host_read(torch.stack(_next_swap(T, sel))))
        count_event("ordschur_reads")
        if i >= n or passes >= max_swaps:
            break
        passes += 1
        m = n1 + n2
        anrm = _np(torch.max(torch.abs(T)))[()]
        Q, _, bad = _swap_plain(_np(T[i:i + m, i:i + m]), n1, n2, anrm, rej_factor)
        if bad:
            failed = True
            break
        Qt = torch.from_numpy(Q).to(dev)
        T[i:i + m, i:] = _ordered_rows(Qt.T, T[i:i + m, i:])
        T[:i + m, i:i + m] = _ordered_cols(T[:i + m, i:i + m], Qt)
        Z[:, i:i + m] = _ordered_cols(Z[:, i:i + m], Qt)
        # exact zeros below the new block diagonal inside the window: the
        # block of size n2 leads, the block of size n1 follows
        for r in range(1, m):
            for c in range(r):
                keep = (n2 == 2 and r == 1 and c == 0) or (n1 == 2 and r == n2 + 1 and c == n2)
                if not keep:
                    T[i + r, i + c] = 0.0
        sel = torch.where((idx >= i) & (idx < i + m), idx < i + n2, sel)
        swaps += 1
    ok = i >= n and not failed
    return (T, Z, sel, torch.tensor(ok, device=dev),
            torch.tensor(swaps, dtype=torch.int32, device=dev))


def ordschur_device(T, Z, select_mask):
    """Reorder the real Schur factorization ``(T, Z)`` so the eigenvalues
    at the ``select_mask``-flagged positions lead (reference: ``ordschur``,
    TRSEN, Utils.fypp:37-60, used by ``krylov_schur``,
    BaseKrylov.fypp:813).  The mask is made pair-consistent (a flag on
    either position of a 2x2 block selects the block).  Returns
    ``(T', Z', sel', ok)``: ``sel'`` the reordered mask, ``ok`` (a 0-d bool
    tensor) False if a block swap was rejected, the output then a valid but
    partially reordered form.  ``Z`` may have more rows than ``T``.  One
    launch of the kernel of ``csrc/ordschur.cu`` on a CUDA tensor, with no
    host read; on a CPU tensor the plain version, :func:`_ordschur_plain`."""
    from ..ops import hessenberg as kernels

    _real_only(T, "ordschur_device")
    n = T.shape[0]
    sel = torch.as_tensor(select_mask, device=T.device).to(torch.bool)
    if n < 2:
        return T, Z, sel, torch.ones((), dtype=torch.bool, device=T.device)
    return kernels.ordschur(T, Z, sel)[:4]


def _filter_shifts(H_sq, n_target):
    """The shift bookkeeping of :func:`francis_filter`, on the device:
    ``(wr, wi, shift_order, n, pure, ok)``, the eigenvalues, the order the
    sweeps take them in, the adjusted keep count, whether sweeps apply, and
    the eigensolve's flag."""
    kdim = H_sq.shape[0]
    dev = H_sq.device
    hess_in = torch.all(torch.abs(torch.tril(H_sq, -2)) == 0)
    wr, wi, ok = hessenberg_eigvals(H_sq)
    mod = wr * wr + wi * wi
    idx = torch.arange(kdim, device=dev)
    # descending modulus, ties broken by the pair's base index, +wi first
    # within a pair: a conjugate pair shares every key, so it stays adjacent
    pairbase = idx - (wi < 0).long()
    order = _lexsort([-wi, pairbase, -mod])

    def straddles(nv):
        a = order[torch.clamp(nv - 1, 0, kdim - 1)]
        b = order[torch.clamp(nv, 0, kdim - 1)]
        return (wi[a] != 0) & (wr[a] == wr[b]) & (wi[a] == -wi[b])

    n_t = torch.as_tensor(n_target, device=dev).long().reshape(())
    bad = straddles(idx) | ((kdim - idx) % 2 == 1)
    stop = (idx >= n_t) & (~bad | (idx >= kdim - 2))
    n = torch.where(stop.any(), torch.argmax(stop.int()), n_t)
    n = torch.clamp(n, 1, kdim - 2)
    pure = ~straddles(n) & hess_in
    rank = torch.zeros(kdim, dtype=torch.long, device=dev).scatter_(0, order, idx)
    is_real = (wi == 0).long()
    key = torch.where(rank >= n, is_real * kdim + rank, 3 * kdim + rank)
    return wr, wi, _stable_argsort(key), n, pure, ok


def francis_filter(H_sq, n_target):
    """The exact-shift IRAM filter of a Krylov restart, on the device.

    Applies ``(kdim - n) / 2`` Francis double-shift sweeps to the square
    Hessenberg ``H_sq``, the shifts taken pairwise from the smallest-modulus
    eigenvalues (the unwanted part of the spectrum).  ``n_target`` (an int
    or a 0-d tensor) is moved up to the first keep count that neither
    splits a conjugate pair at the kept/unwanted boundary nor leaves an odd
    unwanted count, then clamped to ``[1, kdim - 2]``; this is the JAX
    package's fixed-point loop as one vectorized search.  On an input that
    is not Hessenberg (the Krylov-Schur arrow form), or a straddle left at
    the clamp, no sweep is applied (a pure truncation, always exact).

    Returns ``(Hf, Z, n, ok)``: ``Hf = Z^T H Z``, the accumulated transform,
    the keep count (a 0-d int64 tensor) and the flag (eigensolve converged
    and sweeps applied).  Two kernel launches on a CUDA tensor: the
    eigenvalues, then the sweeps."""
    from ..ops import hessenberg as kernels

    _real_only(H_sq, "francis_filter")
    wr, wi, shift_order, n, pure, ok = _filter_shifts(H_sq, n_target)
    Hf, Z, _ = kernels.francis_filter_sweeps(H_sq, wr, wi, shift_order, n, pure)
    return Hf, Z, n, ok & pure


def hessenberg_eigvecs(H, wr, wi, k_eff=None):
    """Eigenvectors by one inverse-iteration solve per eigenvalue (LAPACK
    ``dhsein``'s method), batched over all eigenvalues: for
    ``wr[j] + i wi[j]`` the JAX package's realified system
    ``[[H - wr I, wi I], [-wi I, H - wr I]] x = b`` with a diagonal ridge
    ``ulp ||H||`` and duplicates separated by ``4 ulp ||H||`` each as dhsein
    does, solved as the complex ``n x n`` system it is (LU with partial
    pivoting over each column's possible nonzeros, then back substitution;
    :func:`_inverse_iteration_plain`).  ``H`` may be any real square matrix.
    Returns ``(Vr, Vi)``, columns normalized, rows ``>= k_eff`` zero.  One
    launch of the kernel of ``csrc/ritz.cu`` on a CUDA tensor."""
    from ..ops import hessenberg as kernels

    _real_only(H, "hessenberg_eigvecs")
    return kernels.inverse_iteration(H, wr, wi, _keff(k_eff, H.shape[0], H.device))


def hessenberg_ritz(H_ext, k_eff, tol, nev=None, p: int = 1):
    """The Ritz analysis of one ``eigs`` check on the device, with no host
    round-trip: the projected eigensolve of the ``(kdim + p, kdim)`` Arnoldi
    buffer's active ``k_eff x k_eff`` block (``k_eff`` an int or a 0-d
    integer tensor), its eigenvectors, residuals and converged count.

    Returns ``(wr, wi, res, Vr, Vi, n_conv, ok)`` in modulus-descending
    order (a stable sort, as the host path's ``argsort(-|w|)``); inactive
    slots carry ``res = +inf``.  Residuals are ``|beta| |last eigenvector
    component|`` with ``beta = H_ext[k_eff, k_eff-1]`` for ``p = 1``
    (IterativeSolvers.fypp:1069-1083), ``||B y_last||`` with the coupling
    block ``B = H_ext[k:k+p, k-p:k]`` for ``p > 1``.  ``n_conv`` (0-d int32)
    counts converged residuals among the LEADING ``nev`` entries (the JAX
    package's documented deviation; ``nev = None``: the whole spectrum);
    ``tol`` and ``nev`` are numbers.  On a CUDA tensor: the Schur kernel,
    a fill of the count and the Ritz kernel, three launches."""
    from ..ops import hessenberg as kernels

    kdim = H_ext.shape[1]
    k = _keff(k_eff, kdim, H_ext.device)
    wr, wi, ok = hessenberg_eigvals(H_ext[:kdim, :kdim], k)
    return kernels.ritz_check(H_ext, wr, wi, ok, k, tol, nev, p) + (ok,)
