"""Hermitian eigenvalue solver: Lanczos and a dense ``eigh``, with thick
restart.

Counterpart of :mod:`lightkrylov_tpu.solvers.eighs` (reference:
src/IterativeSolvers/EIGHS/eighs.fypp): incremental Lanczos with full
re-orthogonalization and a dense ``eigh`` of the projected tridiagonal at
each check (eighs.fypp:79-101), Ritz residuals ``|beta * v_last|``
(:91-92), the descending sort and the Ritz-vector reconstruction
(:107-123).  On non-convergence at ``kdim`` it thick-restarts (Wu & Simon)
as the JAX package does: the basis is compressed onto the ``n`` best Ritz
vectors, ``T`` becomes ``diag(theta)`` with the coupling row
``beta * V[kdim-1, :n]`` at row ``n``, and Lanczos goes on from column
``n+1``.

With ``options.projected = "host"`` (or ``"auto"``) each check reads ``T``
to the host for a numpy ``eigh`` (the JAX package's ``eighs.py:253-314``);
checks come every ``check_every`` steps, or once per sweep of ``kdim``
steps by default.  With ``"device"`` (real dtypes; complex ones keep the
host path, as in the JAX package) the sweep checks on the device
(:func:`_fused_lanczos_sweep`, the JAX package's ``eighs.py:51-117``): a
``torch.linalg.eigh`` of the embedded projected matrix, at the adaptive
cadence of :class:`.eigs._AdaptiveStride`, with one batched read a cycle
besides the step's breakdown flag, the thick restart on the device
(:func:`_thick_restart_device`), and the final float64 host recheck.  On a
CUDA tensor ``torch.linalg.eigh`` waits for the device to check its result:
each such check is counted under ``"library_syncs"``
(:func:`..utils.timer.count_event`).  Checkpoints write and restore
``(X, T, kstart, cycle, niter)`` at sweep and restart boundaries (see
:mod:`.eigs`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.lanczos import initialize_lanczos, lanczos, lanczos_step
from ..linops import aslinop
from ..utils.hessenberg import take_at
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata, check_projected
from ..utils.timer import count_applications, count_event, host_read, timed_fn
from .eigs import (_AdaptiveStride, _DriverCheckpointer, _device_projected, _read,
                   _resume_driver_state, _solver_state)

__all__ = ["eighs"]


def _check_options(opts: EigsOptions) -> None:
    """Raise on an unknown ``projected`` value.  ``write_intermediate`` and
    ``outpost`` are accepted and not read: only ``eigs`` writes its checks
    (as in the JAX package, whose ``eighs`` never reads the flag)."""
    check_projected("eighs", opts)


def _thick_restart(X, evals, evecs, beta, n: int):
    """Compress the basis onto the ``n`` leading Ritz vectors and move the
    residual vector (column ``kdim``) to column ``n``; the new ``T`` is
    ``diag(evals[:n])`` with the coupling row ``beta * evecs[kdim-1, :n]``
    at row ``n``.  Returns new ``(X, T)``."""
    kdim = evecs.shape[0]
    leaf = pytree.tree_leaves(X)[0]
    dt, dev = leaf.dtype, leaf.device
    coeffs = torch.zeros((kdim, kdim), dtype=dt)
    coeffs[:, :n] = torch.from_numpy(np.ascontiguousarray(evecs[:, :n])).to(dt)
    Xc = vectors.linear_combination(vectors.lead(X, kdim), coeffs.to(dev))
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]),
                            Xc, X)
    vectors.set_column(X_new, n, vectors.get_column(X, kdim))
    T = torch.zeros((kdim + 1, kdim), dtype=dt)
    idx = torch.arange(n)
    T[idx, idx] = torch.from_numpy(np.ascontiguousarray(evals[:n])).to(dt)
    T[n, :n] = torch.from_numpy(beta * evecs[kdim - 1, :n]).to(dt)
    return X_new, T.to(dev)


def _ritz_check_sym(T, k_eff, tol, nev):
    """The eighs check on the device (eighs.fypp:79-101; the JAX package's
    ``eighs.py:51-76``): the active ``k_eff x k_eff`` block of the
    symmetrized ``T`` embedded with strongly negative dummy diagonal
    entries, so that after the descending sort its eigenpairs lead; the
    residuals ``|beta v_last|``, ``+inf`` at inactive slots; the converged
    count among the leading ``nev``.  Returns ``(w, res, V, n_conv)``."""
    kdim = T.shape[1]
    dev, dt = T.device, T.dtype
    idx = torch.arange(kdim, device=dev)
    active = idx < k_eff
    zero = torch.zeros((), dtype=dt, device=dev)
    Tk = T[:kdim, :kdim]
    Tk = (Tk + Tk.T) / 2  # CGS2 leaves tiny asymmetric noise
    Tm = torch.where(active[:, None] & active[None, :], Tk, zero)
    norm = torch.max(torch.abs(Tm)) + 1.0
    dummy = -norm * (2.0 + idx.to(dt) / kdim)
    Tm[idx, idx] = torch.where(active, torch.diagonal(Tm), dummy)
    w, V = torch.linalg.eigh(Tm)  # ascending; the dummies are the most negative
    if T.device.type == "cuda":
        count_event("library_syncs")  # eigh reads its error flag to the host
    w, V = w.flip(0), V.flip(1)
    km1 = torch.clamp(k_eff - 1, min=0)
    beta = torch.abs(take_at(T, k_eff * kdim + km1))
    r = beta * torch.abs(V.index_select(0, km1.reshape(1))[0])
    res = torch.where(active, r, torch.full((), float("inf"), dtype=dt, device=dev))
    n_conv = torch.sum(torch.where(idx < nev, res, float("inf")) < tol).to(torch.int32)
    return w, res, V, n_conv


def _fused_lanczos_sweep(A, X, T, kstart: int, kend: int, nev, tol, btol, stride):
    """One Lanczos sweep with on-device checks (the JAX package's
    ``_fused_lanczos_sweep``, ``eighs.py:79-117``): a step, and every
    ``stride`` steps (always at the first and the last step and on a
    breakdown) :func:`_ritz_check_sym`, until ``kend``, a breakdown or
    ``nev`` converged.  One host read a step (the breakdown flag, with a
    check's converged count), none after the last.  Returns
    ``(X, T, k_fin, info, n_conv, w, res, V)``, ``k_fin`` an int."""
    kdim = T.shape[1]
    dev, dt = T.device, T.dtype
    chk = (torch.zeros(kdim, dtype=dt, device=dev),
           torch.full((kdim,), float("inf"), dtype=dt, device=dev),
           torch.zeros((kdim, kdim), dtype=dt, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    k = kstart - 1
    while True:
        X, T, beta = lanczos_step(A, X, T, k, tol=btol)
        info = torch.where(beta <= btol, k + 1, 0)
        info = torch.where(torch.isnan(beta), -(k + 1), info).to(torch.int32)
        k_eff = torch.where(info > 0, info, k + 1)
        check = (k + 1 - kstart) % stride == 0 or k + 1 >= kend

        def ritz_check():
            count_event("ritz_checks")
            w, res, V, n_conv = _ritz_check_sym(T, k_eff, tol, nev)
            return w, res, V, torch.where(info < 0, 0, n_conv).to(torch.int32)

        if check:
            chk = ritz_check()
        if k + 1 >= kend:
            break
        vals = _read(info, chk[3]) if check else _read(info)
        if int(vals[0]) != 0:
            if not check:
                chk = ritz_check()
            break
        if check and int(vals[1]) >= nev:
            break
        k += 1
    return (X, T, k + 1, info, chk[3]) + chk[:3]


def _thick_restart_device(X, T, w, V, n: int):
    """The thick restart from the device check's outputs, on the device
    (the JAX package's ``eighs.py:120-144``): compress onto the leading
    ``n`` Ritz vectors, ``T = diag(w[:n])`` with the coupling row
    ``beta V[kdim-1, :n]`` at row ``n``, the residual vector to column
    ``n``.  Returns new ``(X, T)``."""
    kdim = T.shape[1]
    dev, dt = T.device, T.dtype
    idx = torch.arange(kdim, device=dev)
    keep = idx < n
    zero = torch.zeros((), dtype=dt, device=dev)
    Xc = vectors.linear_combination(vectors.lead(X, kdim), torch.where(keep[None, :], V, zero))
    T_new = torch.zeros_like(T)
    T_new[idx, idx] = torch.where(keep, w, zero)
    T_new[n, :] = torch.where(keep, T[kdim, kdim - 1] * V[kdim - 1, :], zero)
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]), Xc, X)
    vectors.set_column(X_new, n, vectors.get_column(X, kdim))
    return X_new, T_new


@timed_fn("eighs", "IterativeSolvers")
def eighs(A, nev: int, x0=None, kdim: int | None = None,
          tolerance: float | None = None, options: EigsOptions | None = None,
          generator: torch.Generator | None = None, check_every: int | None = None,
          resume_from: str | None = None):
    """Leading eigenpairs of a symmetric/Hermitian operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)`` (reference: ``eighs``,
    eighs.fypp:28-123; restart cycles bounded by ``options.maxiter``).

    ``eigvals`` and ``residuals`` are real numpy arrays of ``nev`` entries,
    eigenvalues sorted descending; ``eigvecs`` is a basis (leading axis
    ``nev``) of tensors shaped like ``x0``.  ``info = n_conv`` when the
    leading ``nev`` Ritz pairs converged (residual below ``tolerance``,
    default ``rtol`` of the dtype) or the Krylov space became invariant,
    else ``-n_conv``.  ``x0`` is required, as in the JAX package; a zero
    ``x0`` is replaced by a random vector from ``generator`` (default: a
    new generator seeded with 0 on ``x0``'s device).

    ``options.checkpoint_every``/``checkpoint_path`` and ``resume_from``
    write and restore ``(X, T, kstart, cycle, niter)`` at sweep and restart
    boundaries, as in :func:`.eigs.eigs`."""
    A = aslinop(A)
    opts = options or EigsOptions()
    _check_options(opts)
    if kdim is None:
        kdim = opts.kdim or 4 * nev
    if x0 is None:
        raise ValueError("eighs requires x0 (a template/seed vector)")
    dt = vectors.dtype_of(x0)
    rdt = constants.real_dtype_of(dt)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    stride = kdim if not check_every else check_every

    seed = x0
    if float(host_read(vectors.norm(x0))) == 0.0:
        if generator is None:
            dev = pytree.tree_leaves(x0)[0].device
            generator = torch.Generator(device=dev).manual_seed(0)
        seed = vectors.rand_like(generator, x0)
    X, T = initialize_lanczos(seed, kdim)

    niter = 0
    kstart = 1
    cycle0 = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path, {"X": 1})
    if resume_from is not None:
        # the JAX package stores T under the key "H"
        st = _resume_driver_state(_solver_state({"X": X, "H": T}, 0, 0, 0), resume_from,
                                  {"X": 1})
        X, T = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(f"eighs: resumed from {resume_from} (cycle {cycle0}, kstart {kstart}, "
                        f"{niter} matvecs done)", "solvers", "eighs")
    res_history = []
    invariant = False
    n_conv = 0
    use_device = _device_projected(opts, dt)
    evecs_device = None  # V on the device when the device path checked last
    btol = constants.atol(rdt)
    adapt = _AdaptiveStride(kdim, "eighs") if use_device and not check_every else None
    device_cycles, host_cycles = ((range(cycle0, opts.maxiter), ()) if use_device
                                  else ((), range(cycle0, opts.maxiter)))
    for cycle in device_cycles:
        dstride = check_every if check_every else adapt.next_stride()
        t0 = time.perf_counter()
        X, T, k_fin, info_d, nconv_d, w_d, res_d, V_d = _fused_lanczos_sweep(
            A, X, T, kstart, kdim, nev, tol, btol, dstride)
        out = _read(info_d, nconv_d, w_d, res_d)
        linfo, n_conv = int(out[0]), int(out[1])
        w_h, r_all = out[2:2 + kdim], out[2 + kdim:]
        if adapt is not None:
            adapt.record(time.perf_counter() - t0, k_fin - (kstart - 1), dstride)
        check_info(linfo, "lanczos", "solvers", "eighs")
        k_eff = linfo if linfo > 0 else k_fin
        count_applications(A, k_fin - (kstart - 1), "matvec")
        niter += k_fin - (kstart - 1)
        if linfo > 0:
            invariant = True  # residuals exactly zero (beta = 0)
        r = r_all[:k_eff]
        res_history.append(r[: min(nev, len(r))].copy())
        evals, res, k_final = w_h[:k_eff], r, k_eff
        evecs, evecs_device = None, V_d
        ckpt.check()
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            n = min(max(nev + (kdim - nev) // 2, nev + 1), kdim - 1)
            X, T = _thick_restart_device(X, T, w_d, V_d, n)
            kstart = n + 1
            count_event("restarts.eighs.thick_device")
            ckpt.save(_solver_state({"X": X, "H": T}, kstart, cycle + 1, niter))
            log_information(f"eighs: thick restart cycle {cycle + 1}, kept n={n}, "
                            f"{n_conv}/{nev} converged", "solvers", "eighs")
    for cycle in host_cycles:
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            X, T, linfo = lanczos(A, X, T, kstart=k, kend=kend)
            linfo = int(host_read(linfo))
            check_info(linfo, "lanczos", "solvers", "eighs")
            k_eff = linfo if linfo > 0 else kend
            niter += k_eff - (k - 1)  # lanczos counted these applications

            Th = host_read(T)
            Tk = Th[:k_eff, :k_eff]
            Tk = (Tk + Tk.conj().T) / 2  # CGS2 leaves tiny asymmetric noise
            w, V = np.linalg.eigh(Tk)
            beta = abs(Th[k_eff, k_eff - 1])
            r = beta * np.abs(V[-1, :])
            if linfo > 0:
                r = np.zeros_like(r)
                invariant = True
            order = np.argsort(-w)  # descending eigenvalue (:107)
            w, V, r = w[order], V[:, order], r[order]
            n_conv = int(np.sum(r[:nev] < tol))
            res_history.append(r[: min(nev, len(r))].copy())
            evals, evecs, res, k_final = w, V, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if kend < kdim:
                ckpt.save(_solver_state({"X": X, "H": T}, kend + 1, cycle, niter))
            k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            # thick restart: keep the n best Ritz pairs and the residual vector
            n = min(max(nev + (kdim - nev) // 2, nev + 1), kdim - 1)
            X, T = _thick_restart(X, evals, evecs, Th[kdim, kdim - 1], n)
            kstart = n + 1
            ckpt.save(_solver_state({"X": X, "H": T}, kstart, cycle + 1, niter))
            log_information(f"eighs: thick restart cycle {cycle + 1}, kept n={n}, "
                            f"{n_conv}/{nev} converged", "solvers", "eighs")

    if n_conv < nev and not invariant and evecs is None and evecs_device is not None:
        # the device path's final float64 recheck of the stored projected
        # matrix (the JAX package's eighs.py:316-339)
        Th = host_read(T).astype(np.float64)
        if k_final > 0:
            Tk = Th[:k_final, :k_final]
            w, V = np.linalg.eigh((Tk + Tk.T) / 2)
            r = abs(Th[k_final, k_final - 1]) * np.abs(V[-1, :])
            order = np.argsort(-w)
            w, V, r = w[order], V[:, order], r[order]
            n_conv2 = int(np.sum(r[:nev] < tol))
            if n_conv2 > n_conv:
                log_information(f"eighs: final f64 host recheck sharpened the converged count "
                                f"{n_conv} -> {n_conv2}", "solvers", "eighs")
                evals, evecs, res, evecs_device = w, V, r, None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eighs: only {n_conv}/{nev} pairs converged after "
                    f"{opts.maxiter} cycles", "solvers", "eighs")

    nev_out = min(nev, len(evals))
    if evecs is None and evecs_device is not None:
        coeffs = evecs_device[:, :nev_out]
    else:
        coeffs = torch.zeros((kdim, nev_out), dtype=dt)
        coeffs[:k_final] = torch.from_numpy(np.ascontiguousarray(evecs[:, :nev_out])).to(dt)
    ritz_vecs = vectors.linear_combination(vectors.lead(X, kdim), coeffs.to(T.device, dt))

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    np_rdt = constants.as_numpy_dtype(rdt)
    return evals[:nev_out].real.astype(np_rdt), ritz_vecs, res[:nev_out].astype(np_rdt), info, meta
