"""General eigenvalue solver: Arnoldi with Krylov-Schur restarts.

Counterpart of :mod:`lightkrylov_tpu.solvers.eigs` (reference:
src/IterativeSolvers/IterativeSolvers.fypp:971-1143): an outer Krylov-Schur
loop grows an Arnoldi factorization, a dense ``eig`` of the projected
Hessenberg gives the Ritz pairs at each check, Ritz residuals are
``|beta * (last row of the eigenvector)|`` (:1069-1083), the solve stops
when the leading ``nev`` residuals are below ``tol``, and otherwise it
restarts at ``kdim`` through ``krylov_schur`` with a median-of-|lambda|
selector (:1099-1100,1137-1142).  The Ritz vectors are ``X @ eigvecs``,
sorted by ``|lambda|`` descending (:1108-1132).  Defaults: ``kdim = 4*nev``,
``tol = rtol`` (:1023-1024).

Two projected paths, as in the JAX package (``options.projected``):

- ``"host"`` and ``"auto"`` (the JAX package's path off a TPU, its
  ``eigs.py:608-656``): each check reads ``H`` to the host for a numpy
  ``eig``, every ``check_every`` steps or once per sweep of ``kdim`` steps
  by default, and restarts through the host ``krylov_schur``.  With timing
  on, the host solves are timed as ``eigs.projected_eig`` and
  ``krylov_schur.schur_select``.
- ``"device"`` (real dtypes; complex ones keep the host path): the sweep
  checks on the device (:func:`_fused_sweep`, each check one
  :func:`..utils.hessenberg.hessenberg_ritz`, whose Francis QR is the
  ``hessenberg_schur`` kernel of ``csrc/hessenberg.cu``) at the adaptive
  cadence of :class:`_AdaptiveStride`; it reads the breakdown flag once a
  step and its check outputs in one batched read a cycle, and restarts on
  the device through the exact-shift IRAM filter or the device
  Krylov-Schur restart, with host LAPACK as the last resort; a final
  float64 host recheck settles a working-dtype residual floor
  (:func:`_eigs_device_cycles`; the JAX package's ``eigs.py:479-607,
  658-699``).  With timing on, a cycle is the span ``eigs.cycle``, holding
  each check as ``eigs.check`` and the restart as ``eigs.restart``; the
  host path's restarts are ``eigs.restart`` spans too.

Block mode (``blksize = p > 1``, the JAX package's ``_eigs_block``,
``eigs.py:738-918``) runs block Arnoldi sweeps at column offsets ``s0, s0 +
p, ...`` (one ``matvec_basis`` of ``p`` columns a step, which the CUDA
operators make one launch).  With ``projected="device"`` it is the JAX
block driver: block-residual device checks (:func:`_fused_sweep_block`) and
device Krylov-Schur restarts ``krylov_schur_device(p=p)``.  With ``"auto"``
or ``"host"`` (the JAX block driver ignores the option and always runs its
device machinery) it checks with the block Ritz residuals ``||B y_last_p||``
on the host and restarts through
:func:`..krylov.krylov_schur.krylov_schur_block`.  Both keep exactly the
selected count, and a rejected reorder falls back to an explicit restart
from the leading Ritz direction.  It is real-only and refuses checkpoints,
as the JAX block driver does.

Checkpoints (``options.checkpoint_every``/``checkpoint_path`` and
``resume_from=``) write and restore ``(X, H, kstart, cycle, niter)`` at
sweep and restart boundaries, as the JAX solvers do; the checkpointer here
serves ``eighs`` and ``svds`` too.  A path that ends with a separator
(:func:`..utils.checkpoint.is_dcp_path`) goes through
``torch.distributed.checkpoint``, any other is one ``.npz`` file.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..krylov.arnoldi import (arnoldi, arnoldi_block_step, arnoldi_step, initialize_arnoldi,
                              initialize_arnoldi_block)
from ..krylov.krylov_schur import (iram_restart, krylov_schur, krylov_schur_block,
                                   krylov_schur_device, median_selector)
from ..linops import aslinop
from ..utils.checkpoint import (is_dcp_path, load_checkpoint, load_checkpoint_dcp,
                                save_checkpoint, save_checkpoint_dcp)
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata, check_projected
from ..utils.hessenberg import hessenberg_ritz
from ..utils.timer import count_applications, count_event, host_read, timed, timed_fn

__all__ = ["eigs", "save_eigenspectrum"]


def _check_options(opts: EigsOptions) -> None:
    """Raise on an unknown ``projected`` choice."""
    check_projected("eigs", opts)


class _DriverCheckpointer:
    """Checkpoint cadence and writing, shared by ``eigs``, ``eighs`` and
    ``svds`` (the JAX package's ``eigs.py:337-372``).

    ``every`` counts convergence checks; the state is written at the next
    safe boundary, one where entering the solver's loop again with the stored
    ``(kstart, cycle)`` repeats the uninterrupted run.  ``row_dims`` names
    the partitioned bases (:func:`..utils.checkpoint.save_checkpoint`);
    every rank takes part.  A path that ends with a separator
    (:func:`..utils.checkpoint.is_dcp_path`) is written with
    ``torch.distributed.checkpoint``, each rank its own rows; any other is
    one ``.npz`` that only the IO rank writes."""

    def __init__(self, every: int, path, row_dims: dict):
        self.every = int(every or 0)
        self.path = path
        self.row_dims = row_dims
        self._since = 0

    def check(self) -> None:
        self._since += 1

    @property
    def due(self) -> bool:
        return self.every > 0 and self.path is not None and self._since >= self.every

    def save(self, state: dict) -> None:
        if not self.due:
            return
        save = save_checkpoint_dcp if is_dcp_path(self.path) else save_checkpoint
        save(state, self.path, self.row_dims)
        self._since = 0


def _resume_driver_state(template: dict, path: str, row_dims: dict) -> dict:
    """The solver state stored at ``path``, shaped like ``template`` (this
    rank's rows of the bases named in ``row_dims``), with ``kstart``,
    ``cycle`` and ``niter`` as Python ints; ``path`` is a ``.npz`` file or a
    DCP directory."""
    load = load_checkpoint_dcp if is_dcp_path(path) else load_checkpoint
    st = load(template, path, row_dims)
    for k in ("kstart", "cycle", "niter"):
        st[k] = int(st[k])
    return st


def _solver_state(bases: dict, kstart: int, cycle: int, niter: int) -> dict:
    """The state a solver checkpoints: its buffers and three counters."""
    return dict(bases, kstart=np.int64(kstart), cycle=np.int64(cycle), niter=np.int64(niter))


def _ritz_residuals(H, evecs, k):
    """Ritz residuals ``res_i = |H[k, k-1]| * |evecs[k-1, i]|`` (reference:
    IterativeSolvers.fypp:1069-1083; with complex eigenvectors the
    conjugate-pair bookkeeping of LAPACK's real form disappears)."""
    return abs(H[k, k - 1]) * np.abs(evecs[-1, :])


def _block_host_ritz(Hh, k_eff, p, nev, tol):
    """Ritz analysis of a BLOCK Arnoldi buffer on the host: ``eig`` of the
    active square, block residuals ``||B y_last_p||`` with
    ``B = Hh[k:k+p, k-p:k]``, sorted by modulus, descending, and the number
    converged among the leading ``nev`` (the JAX package's
    ``eigs.py:724-735``)."""
    w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
    B = Hh[k_eff:k_eff + p, k_eff - p:k_eff]
    r = np.linalg.norm(B @ V[-p:, :], axis=0)
    order = np.argsort(-np.abs(w))
    w, V, r = w[order], V[:, order], r[order]
    return w, V, r, int(np.sum(r[:nev] < tol))


# -- the device projected path -------------------------------------------------

def _device_projected(opts, dt) -> bool:
    """Whether the projected problem of each check is solved on the device
    (the fused sweep with the Francis-QR kernel) instead of by host LAPACK.
    Real dtypes only, as in the JAX package (its ``eigs.py:138-156``):
    complex projected problems keep the host path.  ``"auto"`` is the host
    path, as the JAX package's ``"auto"`` is off a TPU."""
    return opts.projected == "device" and not torch.empty((), dtype=dt).is_complex()


class _AdaptiveStride:
    """Device-mode convergence-check cadence (the JAX package's
    ``eigs.py:268-334``).  A check costs ``t_check`` and a skipped one wastes
    at most ``stride - 1`` steps, so the break-even stride is
    ``t_check / t_step``.  Cycle 0 runs at the default (its time, which holds
    the kernels' first build and launch, is discarded), cycle 1 probes
    stride 1 and cycle 2 stride 8; the two measurements give
    ``(t_step, t_check)`` by a 2x2 solve, and every later cycle runs at
    ``round(t_check / t_step)`` clamped to ``[1, kdim]``.  An explicit
    ``check_every >= 1`` bypasses it."""

    DEFAULT = 4
    PROBE2 = 8
    #: the stride each solver's last adaptation chose, by name
    chosen: dict = {}

    def __init__(self, kdim: int, name: str):
        self.kdim = int(kdim)
        self.name = name
        self.stride = self.DEFAULT
        self._phase = 0
        self._obs = []

    def next_stride(self) -> int:
        if self._phase == 0:
            return self.DEFAULT
        if self._phase == 1:
            return 1
        if self._phase == 2:
            return max(2, min(self.PROBE2, self.kdim))
        return self.stride

    def record(self, seconds: float, n_steps: int, stride: int) -> None:
        phase = self._phase
        self._phase += 1
        if n_steps <= 0 or phase == 0 or phase > 2:
            if phase == 0:
                self._phase = 1
            return
        n_checks = max(1, math.ceil(n_steps / max(1, stride)))
        self._obs.append((float(seconds), n_steps, n_checks))
        if phase == 2 and len(self._obs) == 2:
            (T1, n1, m1), (T2, n2, m2) = self._obs
            A = np.array([[n1, m1], [n2, m2]], dtype=np.float64)
            b = np.array([T1, T2], dtype=np.float64)
            try:
                t_step, t_check = np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                return
            if t_check <= 0:
                self.stride = 1
            elif t_step <= 0:
                self.stride = self.kdim
            else:
                self.stride = int(np.clip(round(t_check / t_step), 1, self.kdim))
            _AdaptiveStride.chosen[self.name] = self.stride
            log_information(f"{self.name}: adaptive check cadence -> every {self.stride} steps "
                            f"(t_step {t_step * 1e3:.2f} ms, t_check {t_check * 1e3:.2f} ms)",
                            "solvers", self.name)


def _read(*values):
    """One host read of several device scalars (and 1-d arrays, flattened
    after them): a float64 numpy vector, scalars first."""
    parts = [v.reshape(-1).to(torch.float64) for v in values]
    return host_read(torch.cat(parts))


class _DeviceState:
    """What the device cycles of ``eigs`` carry and return."""

    def __init__(self, X, H, kstart, niter):
        self.X, self.H, self.kstart, self.niter = X, H, kstart, niter
        self.n_conv, self.invariant, self.k_final = 0, False, 0
        self.evals = self.evecs = self.res = self.evecs_device = None


def _fused_sweep(A, X, H, kstart, kend, nev, tol, btol, transpose, stride):
    """One Arnoldi sweep with on-device Ritz checks (the JAX package's
    ``_fused_sweep``, ``eigs.py:159-212``): a step, and every ``stride``
    steps (always at the sweep's first and last step and on a breakdown) the
    check :func:`..utils.hessenberg.hessenberg_ritz`, until ``kend``, a
    breakdown, or ``nev`` converged.

    The loop is a host loop: it reads the breakdown flag once a step, with
    the converged count of a check in the same read, and not after the last
    step (the caller's one batched read covers it).  ``kstart`` may be a 0-d
    tensor left by a device restart: the first step then runs at that index
    and its read carries ``kstart`` too.  Returns ``(X, H, k_fin, kstart,
    info, n_conv, wr, wi, res, Vr, Vi, ok)``, ``k_fin`` and ``kstart`` ints,
    the rest device tensors; ``ok`` False means the QR sweep budget ran out
    at the last check.

    A check solves the projected problem in float64 whatever the basis
    dtype: in float32 the Schur kernel's eigenvalues of a kdim-64 ``H`` err
    by ``~kdim eps ||H||``, as much as the gaps of a clustered spectrum, and
    the inverse iteration from such a shift returns a neighbour's vector (on
    the 3162^2 Poisson grid a float32 check returned Ritz vectors 0.3 from
    orthogonal, whose reported residuals missed their own by 1e-5 of
    ``|lambda_1|``)."""
    kdim = H.shape[1]
    dev, rdt = H.device, torch.float64
    n_conv = torch.zeros((), dtype=torch.int32, device=dev)
    ritz = (torch.zeros(kdim, dtype=rdt, device=dev), torch.zeros(kdim, dtype=rdt, device=dev),
            torch.full((kdim,), float("inf"), dtype=rdt, device=dev),
            torch.zeros((kdim, kdim), dtype=rdt, device=dev),
            torch.zeros((kdim, kdim), dtype=rdt, device=dev),
            n_conv, torch.zeros((), dtype=torch.bool, device=dev))
    kstart_h = None if isinstance(kstart, torch.Tensor) else int(kstart)
    j = kstart - 1  # the column the next step expands (a tensor for a device kstart)
    nconv_h = 0
    while True:
        X, H, beta = arnoldi_step(A, X, H, j, transpose=transpose, tol=btol)
        done = j + 1
        info = torch.where(beta <= btol, done, 0)
        info = torch.where(torch.isnan(beta), -done, info).to(torch.int32)
        k_eff = torch.where(info > 0, info, done)
        check = kstart_h is None or (done - kstart_h) % stride == 0 or done >= kend

        def ritz_check():
            count_event("ritz_checks")
            with timed("eigs.check", "IterativeSolvers", device=True):
                out = hessenberg_ritz(H.double(), k_eff, tol, nev)
                # a fatal NaN: the count means nothing (the loop exits on info)
                return out[:5] + (torch.where(info < 0, 0, out[5]).to(torch.int32), out[6])

        if check:
            ritz = ritz_check()
        if kstart_h is None:
            kstart_h, info_h, nconv_h = (int(v) for v in _read(kstart, info, ritz[5]))
            j = kstart_h - 1
        elif done >= kend:
            break
        elif check:
            info_h, nconv_h = (int(v) for v in _read(info, ritz[5]))
        else:
            info_h = int(_read(info)[0])
        if info_h != 0:
            if not check:
                ritz = ritz_check()  # the breakdown's check
            break
        if nconv_h >= nev or j + 1 >= kend:
            break
        j += 1
    return (X, H, j + 1, kstart_h, info, ritz[5]) + ritz[:5] + (ritz[6],)


def _eigs_device_cycles(A, nev, kdim, tol, transpose, select, opts, check_every, cycle0, ckpt,
                        st: _DeviceState, res_history, name, resumed: bool):
    """The restart cycles of ``eigs`` on the device projected path (the JAX
    package's ``eigs.py:479-607``).  Each cycle is one :func:`_fused_sweep`
    and ONE batched read of its outputs ``(info, n_conv, ok, wr, wi, res)``
    with the previous restart's pending flags.  Restarts: the exact-shift
    IRAM filter (:func:`..krylov.krylov_schur.iram_restart`) for the median
    selector on a Hessenberg ``H``; after two truncation-only IRAM restarts,
    for a custom selector or the arrow form, the device Krylov-Schur restart
    (:func:`..krylov.krylov_schur.krylov_schur_device`); after a rejected
    block swap, host LAPACK (:func:`..krylov.krylov_schur.krylov_schur`).
    A check whose device QR ran out of its sweep budget is redone on the
    host, logged and counted (``"qr_host_redos"``).  A checkpoint reads the
    restart's ``n`` when one is due.  Fills ``st``."""
    dev = st.H.device
    rdt = constants.as_numpy_dtype(st.H.dtype)
    btol = constants.atol(rdt)
    kind = "rmatvec" if transpose else "matvec"
    X, H, kstart = st.X, st.H, st.kstart
    # the IRAM restart needs, and keeps, a Hessenberg H; a Schur restart
    # leaves the arrow form, after which IRAM would only truncate
    h_is_hessenberg = (not resumed
                       or bool(np.all(np.tril(host_read(H)[:kdim, :kdim], -2) == 0)))
    pending = []  # (kind, device flag) of the last restart
    iram_fail = 0
    device_ks_ok = True
    adapt = _AdaptiveStride(kdim, name) if not check_every else None
    for cycle in range(cycle0, opts.maxiter):
        with timed("eigs.cycle", "IterativeSolvers", device=True):
            dstride = check_every if check_every else adapt.next_stride()
            t0 = time.perf_counter()
            X, H, k_fin, kstart_h, info_d, nconv_d, wr_d, wi_d, res_d, Vr, Vi, dok = _fused_sweep(
                A, X, H, kstart, kdim, nev, tol, btol, transpose, dstride)
            out = _read(info_d, nconv_d, dok, *[f for _, f in pending], wr_d, wi_d, res_d)
            m = 3 + len(pending)
            ainfo, n_conv, dok_h = int(out[0]), int(out[1]), bool(out[2])
            flags = [bool(v) for v in out[3:m]]
            wr_h, wi_h, r_all = (out[m + i * kdim:m + (i + 1) * kdim].astype(rdt) for i in range(3))
            steps = k_fin - (kstart_h - 1)
            if adapt is not None:
                adapt.record(time.perf_counter() - t0, steps, dstride)
            for (what, _), ok in zip(pending, flags):
                if what == "iram":
                    iram_fail = 0 if ok else iram_fail + 1
                    if not ok:
                        log_warning(f"{name}: device IRAM filter applied no spectral filtering (a "
                                    f"pure truncation; {iram_fail} consecutive)", "solvers", name)
                elif what == "ks" and not ok:
                    device_ks_ok = False
                    log_warning(f"{name}: device Schur reordering rejected a block swap; routing "
                                "restarts to host LAPACK", "solvers", name)
            pending = []
            check_info(ainfo, "arnoldi", "solvers", name)
            k_eff = ainfo if ainfo > 0 else k_fin
            st.niter += steps
            count_applications(A, steps, kind)
            if dok_h or k_eff == 0:
                w = (wr_h + 1j * wi_h)[:k_eff]
                r = r_all[:k_eff]
                st.evecs_device, st.evecs = (Vr, Vi), None
            else:
                log_warning(f"{name}: device Hessenberg QR did not converge; host fallback for "
                            "this check", "solvers", name)
                count_event("qr_host_redos")
                Hh = host_read(H)
                w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
                r = _ritz_residuals(Hh, V, k_eff)
                order = np.argsort(-np.abs(w))
                w, V, r = w[order], V[:, order], r[order]
                n_conv = int(np.sum(r[:nev] < tol))
                st.evecs, st.evecs_device = V, None
            if ainfo > 0:
                st.invariant = True  # residuals are exactly zero (beta = 0)
            res_history.append(r[: min(nev, len(r))].copy())
            if opts.write_intermediate and constants.io_rank():
                _write_intermediate(opts.outpost, w, r)
            st.evals, st.res, st.k_final, st.n_conv = w, r, k_eff, n_conv
            ckpt.check()
            if n_conv >= nev or st.invariant:
                break
            if cycle == opts.maxiter - 1:
                break
            with timed("eigs.restart", "IterativeSolvers", device=True):
                if select is median_selector and h_is_hessenberg and iram_fail < 2:
                    X, H, n_dev, rok = iram_restart(X, H, kdim // 2)
                    pending.append(("iram", rok))
                    kstart = n_dev + 1
                    count_event(f"restarts.{name}.iram")
                elif device_ks_ok and dok_h:
                    mask = np.zeros(kdim, bool)
                    mask[:k_eff] = np.asarray(select(w), bool)
                    X, H, n_dev, ksok = krylov_schur_device(X, H, wr_d, wi_d,
                                                            torch.from_numpy(mask).to(dev))
                    pending.append(("ks", ksok))
                    h_is_hessenberg = False
                    kstart = n_dev + 1
                    count_event(f"restarts.{name}.schur_device")
                    log_information(f"{name}: device Schur restart cycle {cycle + 1}, "
                                    f"{n_conv}/{nev} converged", "solvers", name)
                else:
                    X, H, n = krylov_schur(X, H, select)
                    h_is_hessenberg = False
                    kstart = n + 1
                    count_event(f"restarts.{name}.host")
                    log_information(f"{name}: host restart cycle {cycle + 1}, compressed to n={n}, "
                                    f"{n_conv}/{nev} converged", "solvers", name)
            if ckpt.due:  # a checkpoint needs the concrete restart index
                kstart = int(host_read(kstart)) if isinstance(kstart, torch.Tensor) else kstart
                ckpt.save(_solver_state({"X": X, "H": H}, kstart, cycle + 1, st.niter))
    st.X, st.H = X, H


def _ritz_coeffs(evecs, evecs_device, kdim, k_final, nev_out, cdt, device):
    """The ``(kdim, nev_out)`` complex coefficients of the Ritz vectors: the
    host eigenvectors padded with zero rows, or, after a device check, the
    device pair ``(Vr, Vi)`` assembled on the device."""
    if evecs is None and evecs_device is not None:
        Vr, Vi = evecs_device
        return torch.complex(Vr[:, :nev_out], Vi[:, :nev_out])
    coeffs = np.zeros((kdim, nev_out), dtype=cdt)
    coeffs[:k_final] = evecs[:, :nev_out]
    return torch.from_numpy(coeffs).to(device)


@timed_fn("eigs", "IterativeSolvers")
def eigs(A, nev: int, x0=None, kdim: int | None = None, tolerance: float | None = None,
         transpose: bool = False, select=None, options: EigsOptions | None = None,
         generator: torch.Generator | None = None, check_every: int | None = None,
         resume_from: str | None = None, blksize: int = 1):
    """Leading eigenpairs of a general square operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)`` (reference: ``eigs``,
    IterativeSolvers.fypp:971-1143).

    ``eigvals`` is a complex numpy array sorted by modulus, descending;
    ``eigvecs`` a basis (leading axis ``nev``) of complex tensors shaped
    like ``x0``, reconstructed over a real basis as two real products (the
    basis is never copied to complex); ``residuals`` the matching Ritz
    residuals as a real numpy array; ``info`` the number of converged pairs,
    negative if they did not converge within ``options.maxiter`` restart
    cycles.

    Documented deviation, copied from the JAX package: convergence counts
    the LEADING ``nev`` Ritz values (the ones returned), where the
    reference counts over the whole spectrum (:1087-1092), so
    ``info = nev`` means every returned pair meets the tolerance.

    ``select(eigvals) -> bool mask`` picks what a restart keeps (default:
    :func:`..krylov.krylov_schur.median_selector`).  ``x0`` is required; a
    zero ``x0`` is replaced by a random vector from ``generator`` (default:
    a new generator seeded with 0 on ``x0``'s device).  With
    ``options.write_intermediate`` each check writes its Ritz values and
    residuals to ``options.outpost``.

    ``options.checkpoint_every``/``checkpoint_path`` write the factorization
    state ``(X, H, kstart, cycle, niter)`` at sweep and restart boundaries;
    ``resume_from=`` restores it and continues the run (``x0`` then only
    gives the buffers' shape, dtype and device).

    ``blksize = p > 1`` runs block Arnoldi with block Krylov-Schur restarts
    (see the module docstring): ``kdim`` is rounded up to a multiple of
    ``p``, ``check_every`` counts block steps, and ``generator`` also draws
    the ``p - 1`` random start directions.  As in the JAX package it is
    real-only (``TypeError`` on a complex ``x0``) and refuses checkpoints
    and ``resume_from`` (``NotImplementedError``)."""
    A = aslinop(A)
    opts = options or EigsOptions()
    _check_options(opts)
    if kdim is None:
        kdim = opts.kdim or 4 * nev  # (reference: :1023)
    if x0 is None:
        raise ValueError("eigs requires x0 (a template/seed vector)")
    if blksize > 1:
        return _eigs_block(A, nev, x0, kdim, tolerance, transpose, select, opts, generator,
                           check_every, resume_from, blksize)
    dt = vectors.dtype_of(x0)
    rdt = constants.as_numpy_dtype(constants.real_dtype_of(dt))
    cdt = np.dtype(np.complex64) if rdt == np.float32 else np.dtype(np.complex128)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    if select is None:
        select = median_selector
    stride = kdim if not check_every else check_every

    seed = x0
    if float(host_read(vectors.norm(x0))) == 0.0:
        if generator is None:
            generator = torch.Generator(device=pytree.tree_leaves(x0)[0].device).manual_seed(0)
        seed = vectors.rand_like(generator, x0)
    X, H = initialize_arnoldi(seed, kdim)

    kstart = 1
    cycle0 = 0
    n_conv = 0
    niter = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path, {"X": 1})
    if resume_from is not None:
        st = _resume_driver_state(_solver_state({"X": X, "H": H}, 0, 0, 0), resume_from,
                                  {"X": 1})
        X, H = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(f"eigs: resumed from {resume_from} (cycle {cycle0}, kstart {kstart}, "
                        f"{niter} matvecs done)", "solvers", "eigs")
    res_history = []
    invariant = False
    evecs_device = None  # (Vr, Vi) on the device when the device path checked last
    use_device = _device_projected(opts, dt)
    if use_device:
        st = _DeviceState(X, H, kstart, niter)
        _eigs_device_cycles(A, nev, kdim, tol, transpose, select, opts, check_every, cycle0,
                            ckpt, st, res_history, "eigs", resume_from is not None)
        X, H, niter, n_conv, invariant = st.X, st.H, st.niter, st.n_conv, st.invariant
        evals, evecs, res, k_final, evecs_device = st.evals, st.evecs, st.res, st.k_final, \
            st.evecs_device
    host_cycles = () if use_device else range(cycle0, opts.maxiter)
    for cycle in host_cycles:
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            X, H, ainfo = arnoldi(A, X, H, kstart=k, kend=kend, transpose=transpose)
            ainfo = int(host_read(ainfo))
            check_info(ainfo, "arnoldi", "solvers", "eigs")
            k_eff = ainfo if ainfo > 0 else kend
            niter += k_eff - (k - 1)  # arnoldi counted these applications

            Hh = host_read(H)
            with timed("eigs.projected_eig", "IterativeSolvers"):
                w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
                r = _ritz_residuals(Hh, V, k_eff) if k_eff > 0 else np.zeros(0)
                if ainfo > 0:
                    r = np.zeros_like(r)  # invariant subspace: exact (:1099)
                    invariant = True
                order = np.argsort(-np.abs(w))
                w, V, r = w[order], V[:, order], r[order]
            n_conv = int(np.sum(r[:nev] < tol))
            res_history.append(r[: min(nev, len(r))].copy())
            if opts.write_intermediate and constants.io_rank():
                _write_intermediate(opts.outpost, w, r)
            evals, evecs, res, k_final = w, V, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if kend < kdim:
                # a sweep boundary inside the cycle: resuming enters this
                # cycle again at k = kend + 1
                ckpt.save(_solver_state({"X": X, "H": H}, kend + 1, cycle, niter))
            k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1:
            with timed("eigs.restart", "IterativeSolvers", device=True):
                X, H, n = krylov_schur(X, H, select)  # (:1099-1100)
            kstart = n + 1
            # a restart boundary: resuming starts the next cycle at n + 1
            ckpt.save(_solver_state({"X": X, "H": H}, kstart, cycle + 1, niter))
            log_information(f"eigs: restart cycle {cycle + 1}, compressed to n={n}, "
                            f"{n_conv}/{nev} converged", "solvers", "eigs")

    if n_conv < nev and not invariant and evecs is None and evecs_device is not None:
        # the final float64 recheck of the device path (the JAX package's
        # eigs.py:658-683): the device residuals are in the working dtype,
        # whose floor can sit at a tight tolerance; one float64 eig of the
        # stored projected matrix settles the count
        Hh = host_read(H).astype(np.float64)
        if k_final > 0:
            w, V = np.linalg.eig(Hh[:k_final, :k_final])
            r = _ritz_residuals(Hh, V, k_final)
            order = np.argsort(-np.abs(w))
            w, V, r = w[order], V[:, order], r[order]
            n_conv2 = int(np.sum(r[:nev] < tol))
            if n_conv2 > n_conv:
                log_information(f"eigs: final f64 host recheck sharpened the converged count "
                                f"{n_conv} -> {n_conv2}", "solvers", "eigs")
                evals, evecs, res, evecs_device = w, V, r, None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eigs: only {n_conv}/{nev} pairs converged", "solvers", "eigs")

    # Ritz vectors X @ eigvecs (:1108-1132); complex coefficients over a
    # real basis contract as two real products (vectors.linear_combination)
    nev_out = min(nev, len(evals))
    ritz_vecs = vectors.linear_combination(
        vectors.lead(X, kdim), _ritz_coeffs(evecs, evecs_device, kdim, k_final, nev_out, cdt,
                                            H.device))

    info = n_conv if converged else -n_conv
    check_info(info if not converged else niter, "eigs", "solvers", "eigs")
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return evals[:nev_out].astype(cdt), ritz_vecs, res[:nev_out].astype(rdt), info, meta


def _eigs_block(A, nev, x0, kdim, tolerance, transpose, select, opts, generator,
                check_every, resume_from, p):
    """Block Arnoldi ``eigs`` driver, ``blksize = p > 1`` (the JAX package's
    ``_eigs_block``, ``eigs.py:738-918``, on the host projected path).

    Each cycle sweeps block steps at column offsets ``s0, s0 + p, ...``
    while ``s <= kdim - p``, reading the block breakdown indicator once a
    step; a check (:func:`_block_host_ritz` on the active ``s + p``
    columns) comes every ``check_every`` block steps, at the sweep's end
    and on a breakdown.  A restart keeps exactly the selected count
    (:func:`krylov_schur_block`) and the next sweep starts at its offset;
    a rejected reorder restarts from the leading Ritz vector instead.

    With ``projected="device"`` the cycles are
    :func:`_eigs_block_device_cycles` (the JAX block driver), followed by
    its final float64 recheck.

    Copied from the JAX driver for parity (ROADMAP F2, F4, F5): a breakdown
    in any column of a block ends the solve as converged; the explicit
    restart has no bound of its own beyond ``options.maxiter``; checkpoints
    and complex dtypes are refused."""
    if resume_from is not None or opts.checkpoint_every:
        raise NotImplementedError(
            "eigs(blksize>1): checkpoint/resume is not supported in block mode, as in the "
            "JAX package; use blksize=1 for checkpointed runs")
    dt = vectors.dtype_of(x0)
    if dt.is_complex:
        raise TypeError("eigs(blksize>1) is real-only, as in the JAX package; realify the "
                        "operator or use blksize=1")
    rdt = constants.as_numpy_dtype(dt)
    cdt = np.dtype(np.complex64) if rdt == np.float32 else np.dtype(np.complex128)
    kdim = -(-kdim // p) * p  # round up to a block multiple (JAX :761)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    btol = constants.atol(rdt)
    if select is None:
        select = median_selector
    stride = check_every if check_every else kdim // p
    kind = "rmatvec" if transpose else "matvec"

    seed = x0
    if float(host_read(vectors.norm(x0))) == 0.0:
        if generator is None:
            generator = torch.Generator(device=pytree.tree_leaves(x0)[0].device).manual_seed(0)
        seed = vectors.rand_like(generator, x0)
    X, H = initialize_arnoldi_block(seed, kdim, p, generator=generator)

    s0 = 0
    n_conv = niter = 0
    res_history = []
    invariant = False
    evecs_device = None
    use_device = _device_projected(opts, dt)
    if use_device:
        st = _DeviceState(X, H, 0, 0)
        _eigs_block_device_cycles(A, nev, kdim, p, tol, transpose, select, opts, generator,
                                  check_every, st, res_history)
        X, H, niter, n_conv, invariant = st.X, st.H, st.niter, st.n_conv, st.invariant
        evals, evecs, res, k_final, evecs_device = st.evals, st.evecs, st.res, st.k_final, \
            st.evecs_device
    host_cycles = () if use_device else range(opts.maxiter)
    for cycle in host_cycles:
        s, steps, ainfo = s0, 0, 0
        while s <= kdim - p:
            X, H, rmin = arnoldi_block_step(A, X, H, s, p, transpose=transpose, tol=btol,
                                            generator=generator)
            rmin = float(host_read(rmin))
            if np.isnan(rmin):
                ainfo = -(s + 1)
            elif rmin <= btol:
                ainfo = s + p  # processed columns at the breakdown
            s += p
            steps += 1
            if steps % stride and s <= kdim - p and ainfo == 0:
                continue
            if ainfo < 0:
                break
            k_eff = ainfo if ainfo > 0 else s
            Hh = host_read(H)
            with timed("eigs.projected_eig", "IterativeSolvers"):
                w, V, r, n_conv = _block_host_ritz(Hh, k_eff, p, nev, tol)
            if n_conv >= nev or ainfo > 0:
                break
        check_info(ainfo, "arnoldi", "solvers", "eigs")
        niter += s - s0
        count_applications(A, s - s0, kind)
        if ainfo > 0:
            invariant = True  # block breakdown: the subspace is (near) invariant (F2)
        res_history.append(r[: min(nev, len(r))].copy())
        if opts.write_intermediate and constants.io_rank():
            _write_intermediate(opts.outpost, w, r)
        evals, evecs, res, k_final = w, V, r, k_eff
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1:
            Xn, Hn, n, ok = krylov_schur_block(X, H, select, p, k_eff)
            if ok:
                X, H, s0 = Xn, Hn, n  # the continuation starts at offset n
                log_information(f"eigs(block): Schur restart cycle {cycle + 1}, kept n={n}, "
                                f"{n_conv}/{nev} converged", "solvers", "eigs")
            else:
                # explicit restart from the leading Ritz direction: always
                # exact, loses the subspace's history (F4: unbounded but by
                # maxiter)
                log_warning("eigs(block): Schur reorder rejected; restarting explicitly",
                            "solvers", "eigs")
                lead = torch.from_numpy(np.ascontiguousarray(evecs[:, 0].real))
                v = vectors.linear_combination(vectors.lead(X, k_eff), lead.to(H.device, dt))
                X, H = initialize_arnoldi_block(v, kdim, p, generator=generator)
                s0 = 0

    if n_conv < nev and not invariant and evecs is None and evecs_device is not None:
        # the device path's final float64 recheck (the JAX package's
        # eigs.py:874-888)
        Hh = host_read(H).astype(np.float64)
        if k_final > 0:
            w, V, r, n_conv2 = _block_host_ritz(Hh, k_final, p, nev, tol)
            if n_conv2 > n_conv:
                log_information(f"eigs(block): final f64 host recheck sharpened the converged "
                                f"count {n_conv} -> {n_conv2}", "solvers", "eigs")
                evals, evecs, res, evecs_device = w, V, r, None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eigs(block): only {n_conv}/{nev} pairs converged", "solvers", "eigs")

    nev_out = min(nev, len(evals))
    ritz_vecs = vectors.linear_combination(
        vectors.lead(X, kdim), _ritz_coeffs(evecs, evecs_device, kdim, k_final, nev_out, cdt,
                                            H.device))
    info = n_conv if converged else -n_conv
    check_info(info if not converged else niter, "eigs", "solvers", "eigs")
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return evals[:nev_out].astype(cdt), ritz_vecs, res[:nev_out].astype(rdt), info, meta


def _fused_sweep_block(A, X, H, s0, nev, tol, btol, transpose, p, stride, generator):
    """Block counterpart of :func:`_fused_sweep` (the JAX package's
    ``_fused_sweep_block``, ``eigs.py:215-265``): block steps at column
    offsets ``s0, s0 + p, ...`` while ``s <= kdim - p``, each one batched
    ``matvec_basis``, with the block-residual
    :func:`..utils.hessenberg.hessenberg_ritz` every ``stride`` block steps,
    at the sweep's end and on a breakdown.  A device restart's offset
    ``s0`` (a 0-d tensor) is read once, at the start.  Returns
    ``(X, H, s_fin, s0, info, n_conv, wr, wi, res, Vr, Vi, ok)``, ``s_fin``
    and ``s0`` ints."""
    kdim = H.shape[1]
    dev, rdt = H.device, H.dtype
    ritz = (torch.zeros(kdim, dtype=rdt, device=dev), torch.zeros(kdim, dtype=rdt, device=dev),
            torch.full((kdim,), float("inf"), dtype=rdt, device=dev),
            torch.zeros((kdim, kdim), dtype=rdt, device=dev),
            torch.zeros((kdim, kdim), dtype=rdt, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    s0 = int(host_read(s0)) if isinstance(s0, torch.Tensor) else int(s0)
    s, steps = s0, 0
    info = torch.zeros((), dtype=torch.int32, device=dev)
    while s <= kdim - p:
        X, H, rmin = arnoldi_block_step(A, X, H, s, p, transpose=transpose, tol=btol,
                                        generator=generator)
        info = torch.where(rmin <= btol, s + p, 0)
        info = torch.where(torch.isnan(rmin), -(s + 1), info).to(torch.int32)
        k_eff = torch.where(info > 0, info, s + p)
        steps += 1
        last = s + p > kdim - p
        check = steps % stride == 0 or last

        def ritz_check():
            count_event("ritz_checks")
            out = hessenberg_ritz(H, k_eff, tol, nev, p=p)
            return out[:5] + (torch.where(info < 0, 0, out[5]).to(torch.int32), out[6])

        if check:
            ritz = ritz_check()
        s += p
        if last:
            break
        vals = _read(info, ritz[5]) if check else _read(info)
        if int(vals[0]) != 0:
            if not check:
                ritz = ritz_check()
            break
        if check and int(vals[1]) >= nev:
            break
    return (X, H, s, s0, info, ritz[5]) + ritz[:5] + (ritz[6],)


def _eigs_block_device_cycles(A, nev, kdim, p, tol, transpose, select, opts, generator,
                              check_every, st: _DeviceState, res_history):
    """The restart cycles of block ``eigs`` on the device projected path
    (the JAX package's ``_eigs_block``, ``eigs.py:790-872``): a
    :func:`_fused_sweep_block` and one batched read a cycle, device
    Krylov-Schur restarts (``krylov_schur_device(p=p)``, exact keep count,
    the next sweep at its offset), and the explicit restart from the leading
    Ritz direction once a block swap was rejected (ROADMAP F4).  Fills
    ``st``."""
    dev = st.H.device
    rdt = constants.as_numpy_dtype(st.H.dtype)
    btol = constants.atol(rdt)
    kind = "rmatvec" if transpose else "matvec"
    X, H, s0 = st.X, st.H, 0
    pending = []
    device_ks_ok = True
    adapt = _AdaptiveStride(kdim // p, "eigs-block") if not check_every else None
    for cycle in range(opts.maxiter):
        dstride = check_every if check_every else adapt.next_stride()
        t0 = time.perf_counter()
        X, H, s_fin, s0_h, info_d, nconv_d, wr_d, wi_d, res_d, Vr, Vi, dok = _fused_sweep_block(
            A, X, H, s0, nev, tol, btol, transpose, p, dstride, generator)
        out = _read(info_d, nconv_d, dok, *[f for _, f in pending], wr_d, wi_d, res_d)
        m = 3 + len(pending)
        ainfo, n_conv, dok_h = int(out[0]), int(out[1]), bool(out[2])
        wr_h, wi_h, r_all = (out[m + i * kdim:m + (i + 1) * kdim].astype(rdt) for i in range(3))
        if adapt is not None:
            adapt.record(time.perf_counter() - t0, (s_fin - s0_h) // p, dstride)
        if any(not bool(v) for v in out[3:m]):
            device_ks_ok = False
            log_warning("eigs(block): device Schur restart unhealthy (rejected block swap); "
                        "restarting explicitly", "solvers", "eigs")
        pending = []
        check_info(ainfo, "arnoldi", "solvers", "eigs")
        k_eff = ainfo if ainfo > 0 else s_fin
        st.niter += s_fin - s0_h
        count_applications(A, s_fin - s0_h, kind)
        if dok_h or k_eff == 0:
            w = (wr_h + 1j * wi_h)[:k_eff]
            r = r_all[:k_eff]
            st.evecs_device, st.evecs = (Vr, Vi), None
        else:
            log_warning("eigs(block): device Hessenberg QR did not converge; host fallback for "
                        "this check", "solvers", "eigs")
            count_event("qr_host_redos")
            w, V, r, n_conv = _block_host_ritz(host_read(H), k_eff, p, nev, tol)
            st.evecs, st.evecs_device = V, None
        if ainfo > 0:
            st.invariant = True  # a block breakdown (F2)
        res_history.append(r[: min(nev, len(r))].copy())
        if opts.write_intermediate and constants.io_rank():
            _write_intermediate(opts.outpost, w, r)
        st.evals, st.res, st.k_final, st.n_conv = w, r, k_eff, n_conv
        if n_conv >= nev or st.invariant or cycle == opts.maxiter - 1:
            break
        if device_ks_ok and dok_h:
            mask = np.zeros(kdim, bool)
            mask[:k_eff] = np.asarray(select(w), bool)
            X, H, n_dev, ksok = krylov_schur_device(
                X, H, wr_d, wi_d, torch.from_numpy(mask).to(dev), p=p,
                k_eff=torch.full((), k_eff, dtype=torch.long, device=dev))
            pending.append(("ks", ksok))
            s0 = n_dev  # the continuation is offset-aligned
            count_event("restarts.eigs-block.schur_device")
            log_information(f"eigs(block): device Schur restart cycle {cycle + 1}, "
                            f"{n_conv}/{nev} converged", "solvers", "eigs")
        else:
            # explicit restart from the leading Ritz direction (F4)
            if st.evecs_device is not None:
                v = vectors.linear_combination(vectors.lead(X, kdim), st.evecs_device[0][:, 0])
            else:
                lead = torch.from_numpy(np.ascontiguousarray(st.evecs[:, 0].real))
                v = vectors.linear_combination(vectors.lead(X, k_eff), lead.to(dev, H.dtype))
            X, H = initialize_arnoldi_block(v, kdim, p, generator=generator)
            s0 = 0
            device_ks_ok = True
            count_event("restarts.eigs-block.explicit")
            log_information(f"eigs(block): explicit restart cycle {cycle + 1}, "
                            f"{n_conv}/{nev} converged", "solvers", "eigs")
    st.X, st.H = X, H


def _write_intermediate(path, eigvals, residuals):
    """Text dump of the current Ritz values (reference: ``write_results_*``,
    IterativeSolvers.fypp:882-925, IO-rank gated)."""
    with open(path, "w") as f:
        f.write("# re(lambda) im(lambda) residual\n")
        for lam, r in zip(eigvals, residuals):
            f.write(f"{lam.real:+.16e} {lam.imag:+.16e} {r:.16e}\n")


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_eigenspectrum(eigvals, residuals, path: str) -> None:
    """Save the spectrum as ``.npy``, one row ``(re, im, residual)`` per
    eigenvalue (reference: ``save_eigenspectrum``,
    IterativeSolvers.fypp:944-963, stdlib ``save_npy``)."""
    eigvals, residuals = _numpy(eigvals), _numpy(residuals)
    out = np.zeros((len(eigvals), 3))
    out[:, 0] = eigvals.real
    out[:, 1] = eigvals.imag
    out[:, 2] = residuals
    np.save(path, out)
