"""Singular value decomposition by Golub-Kahan bidiagonalization, with thick
restart.

Counterpart of :mod:`lightkrylov_tpu.solvers.svds` (reference:
src/IterativeSolvers/SVDS/svd_solvers.fypp): incremental bidiagonalization,
a dense SVD of the projected matrix at each check (svd_solvers.fypp:80-102),
residuals ``|beta * v_last|`` (:93) and the singular vectors ``U @ umat``,
``V @ vmat`` (:108-119).  The reference does not restart
(IterativeSolvers.fypp:655-658); as in the JAX package, a sweep that ends at
``kdim`` unconverged thick-restarts (Baglama-Reichel): the bases are
compressed onto the ``n`` best singular triplets, ``B`` becomes
``diag(s)`` with the coupling row ``beta * vmat[kdim-1, :n]`` at row ``n``,
and the bidiagonalization goes on from column ``n+1``.  The general
(non-bidiagonal) projected matrix this leaves is handled exactly because
:mod:`..krylov.bidiag` stores the full CGS2 projection columns.  ``U``
lives in the codomain of ``A`` and ``V`` in its domain, so rectangular
operators work.

With ``options.projected = "host"`` (or ``"auto"``) each check reads ``B``
to the host for one numpy SVD (the JAX package's ``svds.py:227-290``);
checks come every ``check_every`` steps, or once per sweep of ``kdim``
steps by default.  With ``"device"`` (real dtypes) the sweep checks on the
device (:func:`_fused_bidiag_sweep`, the JAX package's
``svds.py:44-100``): a ``torch.linalg.svd`` of the zero-padded projected
matrix at the adaptive cadence of :class:`.eigs._AdaptiveStride`, one
batched read a cycle besides the step's breakdown flag, the thick restart
on the device (:func:`_svds_thick_restart_device`) and the final float64
host recheck.  On a CUDA tensor ``torch.linalg.svd`` waits for the device
to check its result: each such check is counted under ``"library_syncs"``.
Checkpoints write and restore ``(U, V, B, kstart, cycle, niter)`` at sweep
and restart boundaries (see :mod:`.eigs`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.bidiag import bidiag_step, bidiagonalization, initialize_bidiag
from ..linops import aslinop
from ..utils.hessenberg import take_at
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import SVDSOptions, SolverMetadata, check_projected
from ..utils.timer import count_applications, count_event, host_read, timed_fn
from .eigs import (_AdaptiveStride, _DriverCheckpointer, _device_projected, _read,
                   _resume_driver_state, _solver_state)

__all__ = ["svds"]


def _coeffs(mat, rows: int, dt, device):
    """A (rows, cols) tensor of ``dt`` on ``device`` whose leading rows are
    the numpy matrix ``mat`` and the rest zero."""
    out = torch.zeros((rows, mat.shape[1]), dtype=dt)
    out[: mat.shape[0]] = torch.from_numpy(np.ascontiguousarray(mat)).to(dt)
    return out.to(device)


def _thick_restart(U, V, svals, umat, vmat, beta, n: int):
    """Compress both bases onto the ``n`` leading singular triplets and move
    the residual vector (column ``kdim`` of ``U``) to column ``n``; the new
    ``B`` is ``diag(svals[:n])`` with the coupling row
    ``beta * vmat[kdim-1, :n]`` at row ``n``.  Returns new ``(U, V, B)``."""
    kdim = vmat.shape[0]
    dt, dev = vectors.dtype_of(U), pytree.tree_leaves(U)[0].device
    Uc = vectors.linear_combination(vectors.lead(U, kdim), _coeffs(umat[:, :n], kdim, dt, dev))
    Vc = vectors.linear_combination(V, _coeffs(vmat[:, :n], kdim, dt, dev))
    U_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:kdim + 1 - n])]),
                            Uc, U)
    vectors.set_column(U_new, n, vectors.get_column(U, kdim))
    V_new = pytree.tree_map(lambda c: torch.cat([c, torch.zeros_like(c[: kdim - n])]), Vc)
    B = np.zeros((kdim + 1, kdim), dtype=constants.as_numpy_dtype(dt))
    B[np.arange(n), np.arange(n)] = svals[:n]
    B[n, :n] = beta * vmat[kdim - 1, :n]
    return U_new, V_new, torch.from_numpy(B).to(dev)


def _ritz_check_svd(B, k_eff, tol, nsv):
    """The svds check on the device (svd_solvers.fypp:80-102; the JAX
    package's ``svds.py:44-60``): the SVD of the zero-padded active block
    (its padding's singular values are 0 and sort last), the residuals
    ``|beta vm_last|``, ``+inf`` at inactive slots, and the converged count
    among the leading ``nsv``.  Returns ``(s, res, um, vm, n_conv)``."""
    kdim = B.shape[1]
    dev, dt = B.device, B.dtype
    idx = torch.arange(kdim, device=dev)
    active = idx < k_eff
    Bk = torch.where(active[:, None] & active[None, :], B[:kdim, :kdim],
                     torch.zeros((), dtype=dt, device=dev))
    um, s, vmh = torch.linalg.svd(Bk)  # descending
    if B.device.type == "cuda":
        count_event("library_syncs")  # svd reads its error flag to the host
    vm = vmh.T
    km1 = torch.clamp(k_eff - 1, min=0)
    beta = torch.abs(take_at(B, k_eff * kdim + km1))
    r = beta * torch.abs(vm.index_select(0, km1.reshape(1))[0])  # (:93)
    res = torch.where(active, r, torch.full((), float("inf"), dtype=dt, device=dev))
    n_conv = torch.sum(torch.where(idx < nsv, res, float("inf")) < tol).to(torch.int32)
    return s, res, um, vm, n_conv


def _fused_bidiag_sweep(A, U, V, B, kstart: int, kend: int, nsv, tol, btol, stride):
    """One Golub-Kahan sweep with on-device checks (the JAX package's
    ``_fused_bidiag_sweep``, ``svds.py:63-100``), with one host read a step
    (the breakdown flag, with a check's converged count) and none after the
    last.  Returns ``(U, V, B, k_fin, info, n_conv, s, res, um, vm)``."""
    kdim = B.shape[1]
    dev, dt = B.device, B.dtype
    chk = (torch.zeros(kdim, dtype=dt, device=dev),
           torch.full((kdim,), float("inf"), dtype=dt, device=dev),
           torch.zeros((kdim, kdim), dtype=dt, device=dev),
           torch.zeros((kdim, kdim), dtype=dt, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    k = kstart - 1
    while True:
        U, V, B, alpha, beta = bidiag_step(A, U, V, B, k, tol=btol)
        info = torch.where((alpha <= btol) | (beta <= btol), k + 1, 0)
        info = torch.where(torch.isnan(alpha) | torch.isnan(beta), -(k + 1), info)
        info = info.to(torch.int32)
        k_eff = torch.where(info > 0, info, k + 1)
        check = (k + 1 - kstart) % stride == 0 or k + 1 >= kend

        def ritz_check():
            count_event("ritz_checks")
            s, res, um, vm, n_conv = _ritz_check_svd(B, k_eff, tol, nsv)
            return s, res, um, vm, torch.where(info < 0, 0, n_conv).to(torch.int32)

        if check:
            chk = ritz_check()
        if k + 1 >= kend:
            break
        vals = _read(info, chk[4]) if check else _read(info)
        if int(vals[0]) != 0:
            if not check:
                chk = ritz_check()
            break
        if check and int(vals[1]) >= nsv:
            break
        k += 1
    return (U, V, B, k + 1, info, chk[4]) + chk[:4]


def _svds_thick_restart_device(U, V, B, s, um, vm, n: int):
    """The thick restart from the device check's outputs, on the device
    (the JAX package's ``svds.py:103-125``).  Returns new ``(U, V, B)``."""
    kdim = B.shape[1]
    dev, dt = B.device, B.dtype
    idx = torch.arange(kdim, device=dev)
    keep = idx < n
    zero = torch.zeros((), dtype=dt, device=dev)
    Uc = vectors.linear_combination(vectors.lead(U, kdim), torch.where(keep[None, :], um, zero))
    Vc = vectors.linear_combination(V, torch.where(keep[None, :], vm, zero))
    U_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]), Uc, U)
    vectors.set_column(U_new, n, vectors.get_column(U, kdim))
    B_new = torch.zeros_like(B)
    B_new[idx, idx] = torch.where(keep, s, zero)
    B_new[n, :] = torch.where(keep, B[kdim, kdim - 1] * vm[kdim - 1, :], zero)
    return U_new, Vc, B_new


@timed_fn("svds", "IterativeSolvers")
def svds(A, nsv: int, u0=None, v_template=None, kdim: int | None = None,
         tolerance: float | None = None, options: SVDSOptions | None = None,
         generator: torch.Generator | None = None, check_every: int | None = None,
         resume_from: str | None = None):
    """Leading singular triplets -> ``(U, S, V, residuals, info, metadata)``
    (reference: ``svds``, svd_solvers.fypp:28-119; restart cycles bounded by
    ``options.maxiter``).

    ``U`` and ``V`` are bases (leading axis ``nsv``) of left and right
    singular vectors, shaped like ``u0`` and ``v_template``; ``S`` and
    ``residuals`` are real numpy arrays, ``S`` descending; ``info = n_conv``
    when the leading ``nsv`` residuals are below ``tolerance`` (default
    ``rtol`` of the dtype) or the Krylov space became invariant, else
    ``-n_conv``.  ``u0`` (a vector of the codomain) is required;
    ``v_template`` (a vector of the domain) defaults to ``u0``, for a square
    operator.  A zero ``u0`` is replaced by a random vector from
    ``generator`` (default: a new generator seeded with 0 on ``u0``'s
    device).

    ``options.checkpoint_every``/``checkpoint_path`` and ``resume_from``
    write and restore ``(U, V, B, kstart, cycle, niter)`` at sweep and
    restart boundaries, as in :func:`.eigs.eigs`."""
    A = aslinop(A)
    opts = options or SVDSOptions()
    check_projected("svds", opts)
    if kdim is None:
        kdim = opts.kdim or 4 * nsv
    if u0 is None:
        raise ValueError("svds requires u0 (codomain template/seed vector)")
    if v_template is None:
        v_template = u0
    dt = vectors.dtype_of(u0)
    rdt = constants.as_numpy_dtype(constants.real_dtype_of(dt))
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    stride = kdim if not check_every else check_every

    seed = u0
    if float(host_read(vectors.norm(u0))) == 0.0:
        if generator is None:
            generator = torch.Generator(device=pytree.tree_leaves(u0)[0].device).manual_seed(0)
        seed = vectors.rand_like(generator, u0)
    U, V, B = initialize_bidiag(seed, v_template, kdim)

    niter = 0
    kstart = 1
    cycle0 = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path, {"U": 1, "V": 1})
    if resume_from is not None:
        st = _resume_driver_state(_solver_state({"U": U, "V": V, "B": B}, 0, 0, 0), resume_from,
                                  {"U": 1, "V": 1})
        U, V, B = st["U"], st["V"], st["B"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(f"svds: resumed from {resume_from} (cycle {cycle0}, kstart {kstart}, "
                        f"{niter} sweeps done)", "solvers", "svds")
    res_history = []
    invariant = False
    n_conv = 0
    use_device = _device_projected(opts, dt)
    svecs_device = None  # (um, vm) on the device when the device path checked last
    btol = constants.atol(rdt)
    adapt = _AdaptiveStride(kdim, "svds") if use_device and not check_every else None
    device_cycles, host_cycles = ((range(cycle0, opts.maxiter), ()) if use_device
                                  else ((), range(cycle0, opts.maxiter)))
    for cycle in device_cycles:
        dstride = check_every if check_every else adapt.next_stride()
        t0 = time.perf_counter()
        U, V, B, k_fin, info_d, nconv_d, s_d, res_d, um_d, vm_d = _fused_bidiag_sweep(
            A, U, V, B, kstart, kdim, nsv, tol, btol, dstride)
        out = _read(info_d, nconv_d, s_d, res_d)
        binfo, n_conv = int(out[0]), int(out[1])
        s_h, r_all = out[2:2 + kdim].astype(rdt), out[2 + kdim:].astype(rdt)
        if adapt is not None:
            adapt.record(time.perf_counter() - t0, k_fin - (kstart - 1), dstride)
        check_info(binfo, "bidiagonalization", "solvers", "svds")
        k_eff = binfo if binfo > 0 else k_fin
        count_applications(A, k_fin - (kstart - 1), "matvec")
        count_applications(A, k_fin - (kstart - 1), "rmatvec")
        niter += k_fin - (kstart - 1)
        if binfo > 0:
            invariant = True  # residuals exactly zero (beta = 0)
        r = r_all[:k_eff]
        res_history.append(r[: min(nsv, len(r))].copy())
        svals, res, k_final = s_h[:k_eff], r, k_eff
        umat = vmat = None
        svecs_device = (um_d, vm_d)
        ckpt.check()
        if n_conv >= nsv or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            n = min(max(nsv + (kdim - nsv) // 2, nsv + 1), kdim - 1)
            U, V, B = _svds_thick_restart_device(U, V, B, s_d, um_d, vm_d, n)
            kstart = n + 1
            count_event("restarts.svds.thick_device")
            ckpt.save(_solver_state({"U": U, "V": V, "B": B}, kstart, cycle + 1, niter))
            log_information(f"svds: thick restart cycle {cycle + 1}, kept n={n}, "
                            f"{n_conv}/{nsv} converged", "solvers", "svds")
    for cycle in host_cycles:
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            U, V, B, binfo = bidiagonalization(A, U, V, B, kstart=k, kend=kend)
            binfo = int(host_read(binfo))
            check_info(binfo, "bidiagonalization", "solvers", "svds")
            k_eff = binfo if binfo > 0 else kend
            niter += k_eff - (k - 1)  # bidiagonalization counted these applications

            Bh = host_read(B)
            um, s, vmh = np.linalg.svd(Bh[:k_eff, :k_eff])
            vm = vmh.conj().T
            r = abs(Bh[k_eff, k_eff - 1]) * np.abs(vm[-1, :])  # (:93)
            if binfo > 0:
                r = np.zeros_like(r)  # invariant subspace: exact
                invariant = True
            n_conv = int(np.sum(r[:nsv] < tol))
            res_history.append(r[: min(nsv, len(r))].copy())
            svals, umat, vmat, res, k_final = s, um, vm, r, k_eff
            ckpt.check()
            if n_conv >= nsv or invariant:
                break
            if kend < kdim:
                ckpt.save(_solver_state({"U": U, "V": V, "B": B}, kend + 1, cycle, niter))
            k = kend + 1
        if n_conv >= nsv or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            # thick restart onto the n best triplets (Baglama-Reichel)
            n = min(max(nsv + (kdim - nsv) // 2, nsv + 1), kdim - 1)
            U, V, B = _thick_restart(U, V, svals, umat, vmat, Bh[kdim, kdim - 1], n)
            kstart = n + 1
            ckpt.save(_solver_state({"U": U, "V": V, "B": B}, kstart, cycle + 1, niter))
            log_information(f"svds: thick restart cycle {cycle + 1}, kept n={n}, "
                            f"{n_conv}/{nsv} converged", "solvers", "svds")

    if n_conv < nsv and not invariant and umat is None and svecs_device is not None:
        # the device path's final float64 recheck (the JAX package's
        # svds.py:292-314): the working-dtype SVD floors the residuals near
        # eps * sigma_max; a float64 SVD of the same stored B settles them
        Bh = host_read(B).astype(np.float64)
        if k_final > 0:
            um, s, vmh = np.linalg.svd(Bh[:k_final, :k_final])
            vm = vmh.T
            r = abs(Bh[k_final, k_final - 1]) * np.abs(vm[-1, :])
            n_conv2 = int(np.sum(r[:nsv] < tol))
            if n_conv2 > n_conv:
                log_information(f"svds: final f64 host recheck sharpened the converged count "
                                f"{n_conv} -> {n_conv2}", "solvers", "svds")
                svals, umat, vmat, res, svecs_device = s, um, vm, r, None
                n_conv = n_conv2
                res_history.append(r[: min(nsv, len(r))].copy())

    converged = n_conv >= nsv or invariant
    if not converged:
        log_warning(f"svds: only {n_conv}/{nsv} triplets converged after {opts.maxiter} "
                    "cycles", "solvers", "svds")

    nsv_out = min(nsv, len(svals))
    dev = B.device
    if umat is None and svecs_device is not None:
        um_d, vm_d = svecs_device
        cu = torch.zeros((kdim + 1, nsv_out), dtype=dt, device=dev)
        cu[:kdim] = um_d[:, :nsv_out].to(dt)
        Usv = vectors.linear_combination(U, cu)
        Vsv = vectors.linear_combination(V, vm_d[:, :nsv_out].to(dt))
    else:
        Usv = vectors.linear_combination(U, _coeffs(umat[:, :nsv_out], kdim + 1, dt, dev))
        Vsv = vectors.linear_combination(V, _coeffs(vmat[:, :nsv_out], kdim, dt, dev))

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return Usv, svals[:nsv_out].astype(rdt), Vsv, res[:nsv_out].astype(rdt), info, meta
