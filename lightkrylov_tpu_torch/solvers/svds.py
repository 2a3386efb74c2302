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

Only the JAX package's host projected path is ported (its
``svds.py:227-290``): each check reads ``B`` to the host for one numpy SVD.
Checks come every ``check_every`` steps, or once per sweep of ``kdim`` steps
by default.  Left out with the device projected path, which ROADMAP M10
leaves out: the fused on-device sweep (``_fused_bidiag_sweep``), the device
restart (``_svds_thick_restart_device``), the adaptive check cadence
(``_AdaptiveStride``) and the final float64 recheck, which runs only after
the device path (``svds.py:63-125,184-226,292-314``).  ``projected="device"``
raises.  Checkpoints write and restore ``(U, V, B, kstart, cycle, niter)``
at sweep and restart boundaries (see :mod:`.eigs`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.bidiag import bidiagonalization, initialize_bidiag
from ..linops import aslinop
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import SVDSOptions, SolverMetadata, check_host_projected
from ..utils.timer import count_applications, host_read, timed_fn
from .eigs import _DriverCheckpointer, _solver_state, _resume_driver_state

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
    check_host_projected("svds", opts)
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
    for cycle in range(cycle0, opts.maxiter):
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            U, V, B, binfo = bidiagonalization(A, U, V, B, kstart=k, kend=kend)
            binfo = int(host_read(binfo))
            check_info(binfo, "bidiagonalization", "solvers", "svds")
            k_eff = binfo if binfo > 0 else kend
            count_applications(A, max(k_eff - (k - 1), 0), "matvec")
            count_applications(A, max(k_eff - (k - 1), 0), "rmatvec")
            niter += k_eff - (k - 1)

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

    converged = n_conv >= nsv or invariant
    if not converged:
        log_warning(f"svds: only {n_conv}/{nsv} triplets converged after {opts.maxiter} "
                    "cycles", "solvers", "svds")

    nsv_out = min(nsv, len(svals))
    dev = B.device
    Usv = vectors.linear_combination(U, _coeffs(umat[:, :nsv_out], kdim + 1, dt, dev))
    Vsv = vectors.linear_combination(V, _coeffs(vmat[:, :nsv_out], kdim, dt, dev))

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return Usv, svals[:nsv_out].astype(rdt), Vsv, res[:nsv_out].astype(rdt), info, meta
