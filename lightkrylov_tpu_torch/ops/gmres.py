"""A DCGS2 step through three hand-written CUDA kernels (``csrc/gmres.cu``):
its two passes over the basis and its k-sized work, with its scalars on the
device.

Iteration k of GMRES's delayed-reorthogonalisation cycle
(:mod:`..solvers.gmres`) measures ``PR = Q^H [u_k, w]`` and ``w^H w`` over
the basis; everything after that up to the rank-2 update works on vectors
of length at most ``kdim + 1``: ``sigma``, ``tau``, ``eta`` and its safe
inverse, ``t``, the finished Hessenberg column ``k - 1``, the provisional
column ``hp``, ``gamma`` and its safe inverse, the update's coefficients
``[c_q, c_u]`` and the next scale ``fac``; then the least squares' Givens
update of column ``k - 1``.  :func:`dcgs2_step` is all of it as one launch;
:func:`dcgs2_flush` finishes the pending column of a cycle that ran to
``kdim``.  On a cycle's basis ``V``, one contiguous real tensor of
``kdim + 1`` rows, the step's two passes over the basis are a launch each:
:func:`dcgs2_measure` (``Q^H [u_k, w]`` and ``w . w`` into one buffer that
one all-reduce sums over a reduction group and :func:`dcgs2_step` reads in
place) and :func:`dcgs2_update` (the rank-2 update, ``V[k]`` and ``V[k+1]``
written in place from the coefficients where :func:`dcgs2_step` left
them).  No Pallas kernel is replaced: the JAX package leaves these fusions
to XLA (its ``innerprod_vpu`` and ``linear_combination_vpu`` forms).

The plain versions, :func:`dcgs2_measure_reference`,
:func:`dcgs2_coefficients_reference` (the step up to the coefficients),
:func:`dcgs2_givens_reference` (the Givens update),
:func:`dcgs2_update_reference` and :func:`dcgs2_flush_reference`, are the
solver's sequence of separate tensor operations, which it runs for complex
vectors, pytrees of several tensors and off the card.  They keep
the cycle's state in a :class:`DCGS2State`, whose tensors they replace.
Use a state as a context manager around its cycle: on a card a bound one
makes the buffers' device current.

:class:`FusedDCGS2` binds the kernel to one cycle's state: on a card it
holds ``H-tilde``, ``hp``, the coefficients and the scalar block (slots
:data:`FAC`, :data:`RES`, :data:`TOL`, :data:`FLAG`, :data:`CONV`,
:data:`INV_GAMMA`) in one workspace and updates them, and the solver's
``R``, ``c``, ``s``, ``e`` and ``hist``, in place; the host reads only a
flag.  Bound with a basis it also holds the measurement's buffer and the
reductions' workspace.  For CPU tensors the wrappers run the plain
versions on it; on a card each counts its launches in the counter
``launches.<wrapper>`` (:func:`..utils.timer.count_event`).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import vectors
from ..utils import linalg
from ..utils.timer import count_event
from . import _build

__all__ = ["MAX_KDIM", "FAC", "RES", "TOL", "FLAG", "CONV", "INV_GAMMA", "DCGS2State",
           "FusedDCGS2", "dcgs2_measure", "dcgs2_step", "dcgs2_update", "dcgs2_flush",
           "dcgs2_measure_reference", "dcgs2_coefficients_reference", "dcgs2_givens_reference",
           "dcgs2_update_reference", "dcgs2_flush_reference", "safe_inverse", "givens_col"]

#: the largest ``kdim`` the kernel holds (``csrc/gmres.cu``)
MAX_KDIM = 128
#: slots of the scalar block (``csrc/gmres.cu`` has the same numbers)
FAC, RES, TOL, FLAG, CONV, INV_GAMMA = range(6)
_SLOTS = 8
_STEP, _FLUSH = 0, 1
#: ``dcgs2_measure``'s columns a block (``csrc/gmres.cu`` has the same)
_TILE = 8

#: The C entries of ``csrc/gmres.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    **{f"lk_dcgs2_{t}": "i p ll p i l i pppppp d p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_dcgs2_measure_{t}": "p l ii pppp i p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_dcgs2_update_{t}": "p l ii ppp i p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_dcgs2_basis_blocks_per_sm_{t}": "p" for t in _build.DTYPE_TAGS.values()},
})


def safe_inverse(a):
    """``1 / a`` where ``a > 0``, else 0."""
    ok = a > 0
    return torch.where(ok, 1.0 / torch.where(ok, a, torch.ones_like(a)), torch.zeros_like(a))


def givens_col(h_col, R, c, s, e, j):
    """Rotate the finished Hessenberg column ``j`` into the least-squares
    recursion (gmres.fypp:177-182).  ``R`` and ``e`` are updated in
    place; returns the new ``(c, s, res)``."""
    h_col, c, s = linalg.apply_givens_rotation(h_col, c, s, j)
    R[:, j] = h_col[:-1]
    ej = e[j].clone()
    e[j + 1] = -s[j] * ej
    e[j] = c[j] * ej
    return c, s, torch.abs(e[j + 1]).to(c.dtype)


def _padded(v, n: int):
    """``v`` (leading axis m <= n) zero-padded to leading axis ``n``."""
    out = v.new_zeros((n,) + tuple(v.shape[1:]))
    out[: v.shape[0]] = v
    return out


def _pythag_eta(sigma, z, rdt):
    # breakdown (u_k in span Q) gives eta ~ 0: inv_eta = 0 writes an
    # exactly-zero column and the vanishing H[k, k-1] ends the recursion
    eta2 = sigma - torch.vdot(z, z).real.to(rdt)
    eta = torch.sqrt(torch.clamp_min(eta2, 0.0))
    return eta, safe_inverse(eta)


def dcgs2_measure_reference(V, k: int, w):
    """Plain version of :func:`dcgs2_measure`: this rank's ``Q^H [u_k, w]``
    over the filled columns ``V[:k+1]`` (k+1, 2), ``u_k`` being ``V[k]``,
    and ``w . w``; no reduction over the group."""
    Y2 = pytree.tree_map(lambda a, b: torch.stack([a, b]), vectors.get_column(V, k), w)
    return vectors.innerprod_local(vectors.lead(V, k + 1), Y2), vectors.dot_local(w, w)


def dcgs2_update_reference(V, k: int, w, C, inv_gamma) -> None:
    """Plain version of :func:`dcgs2_update`: ``D = V[:k+1]^T C``, then
    ``V[k] = D[0]`` and ``V[k+1] = inv_gamma w - D[1]`` in place.  ``D`` is
    computed in full before ``V[k]`` is overwritten."""
    D = vectors.linear_combination_vpu(vectors.lead(V, k + 1), C)
    u_next = vectors.axpby(inv_gamma, w, -1.0, vectors.get_column(D, 1))
    vectors.set_column(V, k, vectors.get_column(D, 0))
    vectors.set_column(V, k + 1, u_next)


class DCGS2State:
    """The k-sized state of one DCGS2 restart cycle as the plain versions
    keep it: the solver's least-squares buffers ``R`` (kdim, kdim), ``c``,
    ``s`` (kdim), ``e`` (kdim+1) and ``hist``, the residual ``res`` and
    ``tol`` (0-d, real), ``H-tilde`` ``Ht`` (kdim+1, kdim), the provisional
    column ``hp``, the scale ``fac_prev``, the finished column ``h_col`` and
    the last step's coefficients ``coeff`` and ``inv_gamma``; ``eps`` is the
    real dtype's machine epsilon.  :attr:`flag` (``res >= tol``) and
    :attr:`conv` (``res < tol``) are the loop's two tests, each a 1-element
    tensor for the host's read."""

    on_card = False

    def __init__(self, R, c, s, e, hist, res, tol, eps: float):
        self.kdim = R.shape[0]
        self.R, self.c, self.s, self.e, self.hist = R, c, s, e, hist
        self.res, self.tol, self.eps = res, tol, eps
        self.Ht = R.new_zeros(self.kdim + 1, self.kdim)
        self.hp = R.new_zeros(self.kdim + 1)
        self.fac_prev = torch.ones((), dtype=c.dtype, device=R.device)
        self.h_col = self.coeff = self.inv_gamma = None

    @property
    def flag(self):
        return (self.res >= self.tol).reshape(1)

    @property
    def conv(self):
        return (self.res < self.tol).reshape(1)

    def __enter__(self):
        if self.on_card:
            self._guard.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self._guard.__exit__(*exc)


def dcgs2_coefficients_reference(st: DCGS2State, PR, wTw, k: int):
    """Plain version of :func:`dcgs2_step` up to the coefficients: from the
    measurement ``PR`` (k+1, 2) and ``wTw``, column ``k - 1`` of
    ``st.Ht`` and ``st.h_col``, ``st.hp`` and ``st.fac_prev``; returns the
    rank-2 update's coefficients (k+1, 2) and ``inv_gamma``."""
    kdim, dt, rdt = st.kdim, st.R.dtype, st.c.dtype
    PR = _padded(PR.to(dt), kdim + 1)
    wTw = wTw.real.to(rdt)
    sigma = PR[k, 0].real.to(rdt, copy=True)
    tau = PR[k, 1].clone()
    PR[k] = 0
    z, p = PR[:, 0], PR[:, 1]
    eta, inv_eta = _pythag_eta(sigma, z, rdt)
    t = (tau - torch.vdot(z, p)) * inv_eta
    if k > 0:  # finish true-H column k-1
        h_col = st.hp + z * st.fac_prev
        h_col[k] = eta * st.fac_prev
        st.Ht[:, k - 1] = h_col
        st.h_col = h_col
    # provisional column k, exact for the corrected q_k
    pt = p.clone()
    pt[k] = t
    st.hp = (pt - st.Ht @ z[:kdim]) * inv_eta
    gamma2 = wTw - torch.vdot(p, p).real.to(rdt) - torch.abs(t) ** 2
    gamma = torch.sqrt(torch.maximum(gamma2, st.eps * st.eps * wTw))
    inv_gamma = safe_inverse(gamma)
    c_q = -z * inv_eta
    c_q[k] = inv_eta
    c_u = (p - (t * inv_eta) * z) * inv_gamma
    c_u[k] = t * inv_eta * inv_gamma
    st.fac_prev = (gamma * inv_eta).to(rdt)
    st.coeff, st.inv_gamma = torch.stack([c_q, c_u], dim=1)[: k + 1], inv_gamma
    return st.coeff, st.inv_gamma


def dcgs2_givens_reference(st: DCGS2State, k: int, nin: int) -> None:
    """Plain version of :func:`dcgs2_step`'s Givens update: for ``k > 0``,
    column ``k - 1`` (``st.h_col``) into ``R``, ``e``, ``c``, ``s``,
    ``res`` and ``hist[nin]``."""
    if k > 0:
        st.c, st.s, st.res = givens_col(st.h_col, st.R, st.c, st.s, st.e, k - 1)
        st.hist[nin] = st.res


def dcgs2_flush_reference(st: DCGS2State, zf, k: int, nin: int) -> None:
    """Plain version of :func:`dcgs2_flush`: column ``k - 1`` finished from
    the measurement ``zf = Q^H u_k`` (k+1,), then its Givens update."""
    dt, rdt = st.R.dtype, st.c.dtype
    zf = _padded(zf.to(dt), st.kdim + 1)
    sigma = zf[k].real.to(rdt, copy=True)
    zf[k] = 0
    eta, _ = _pythag_eta(sigma, zf, rdt)
    st.h_col = st.hp + zf * st.fac_prev
    st.h_col[k] = eta * st.fac_prev
    dcgs2_givens_reference(st, k, nin)


def _check(R, c, s, e, hist, res, tol) -> str:
    """Raise unless the cycle's buffers suit the kernel; their dtype's tag."""
    tag = _build.dtype_tag(R.dtype, "dcgs2")
    named = {"R": R, "c": c, "s": s, "e": e, "hist": hist, "res": res, "tol": tol}
    for name, v in named.items():
        if v.device != R.device or v.dtype != R.dtype:
            raise ValueError(f"dcgs2: {name} is {v.dtype} on {v.device}, "
                             f"not {R.dtype} on {R.device}")
        if not v.is_contiguous():
            raise ValueError(f"dcgs2: {name} must be contiguous")
    kdim = R.shape[0]
    if not 1 <= kdim <= MAX_KDIM:
        raise ValueError(f"dcgs2: kdim {kdim} outside 1..{MAX_KDIM}")
    shapes = {"R": (kdim, kdim), "c": (kdim,), "s": (kdim,), "e": (kdim + 1,),
              "res": (), "tol": ()}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"dcgs2: {name} has shape {tuple(named[name].shape)}, not {shape}")
    if hist.ndim != 1:
        raise ValueError("dcgs2: hist must be one-dimensional")
    return tag


class FusedDCGS2(DCGS2State):
    """The kernels bound to one cycle's state: ``R``, ``c``, ``s``, ``e``,
    ``hist`` (updated in place), the start residual ``res`` and ``tol``;
    real float32 or float64, one dtype, contiguous; and, for
    :func:`dcgs2_measure` and :func:`dcgs2_update`, the cycle's basis ``V``
    (kdim+1 rows, contiguous, of the same dtype).  On a card the C entries,
    the current stream and one workspace are resolved here: ``Ht`` (a view
    of its column-major ``H-tilde``), ``hp``, ``coeff`` (kdim+1, 2), the
    scalar block ``scal``, whose slots ``fac_prev``, ``res``, ``inv_gamma``,
    :attr:`flag` and :attr:`conv` view and the kernel sets, and with a basis
    the measurement ``meas`` (2 kdim + 3) and the reductions' partials and
    ticket.  On the CPU it is a :class:`DCGS2State` and the wrappers run the
    plain versions."""

    def __init__(self, R, c, s, e, hist, res, tol, eps: float, V=None):
        tag = _check(R, c, s, e, hist, res, tol)
        if V is not None:
            _check_basis(V, R)
        self.V = V
        self.on_card = R.device.type == "cuda"
        if not self.on_card:
            super().__init__(R, c, s, e, hist, res, tol, eps)
            return
        kdim = R.shape[0]
        ld = kdim + 1
        self.kdim, self.eps = kdim, eps
        self.R, self.c, self.s, self.e, self.hist, self.tol = R, c, s, e, hist, tol
        top = kdim * ld + 3 * ld + _SLOTS
        self.work = R.new_zeros(top + (2 * ld + 1 if V is not None else 0))
        self.Ht = self.work[: kdim * ld].view(kdim, ld).T
        self.hp = self.work[kdim * ld: kdim * ld + ld]
        self.coeff = self.work[kdim * ld + ld: kdim * ld + 3 * ld].view(ld, 2)
        self.scal = scal = self.work[kdim * ld + 3 * ld: top]
        scal[FAC] = 1.0
        scal[RES] = res
        scal[TOL] = tol
        scal[FLAG] = res >= tol
        scal[CONV] = res < tol
        self.fac_prev, self.res, self.inv_gamma = scal[FAC], scal[RES], scal[INV_GAMMA]
        self.h_col = None
        self.lib = _build.load()
        self.entry = ENTRIES.on(self.lib)[f"lk_dcgs2_{tag}"]
        # the launch's last arguments, the same at every step of the cycle
        self.stream = torch.cuda.current_stream(R.device).cuda_stream
        self.tail = (kdim, *(t.data_ptr() for t in (self.work, R, c, s, e, hist)), eps,
                     self.stream)
        self._guard = torch.cuda.device(R.device)
        if V is not None:
            self._bind_basis(V, tag, top)

    def _bind_basis(self, V, tag, top):
        """The measurement's buffer, the reductions' workspace and the grids
        of :func:`dcgs2_measure` and :func:`dcgs2_update`."""
        self.meas = self.work[top:]
        entries = ENTRIES.on(self.lib)
        self.basis_entries = (entries[f"lk_dcgs2_measure_{tag}"], entries[f"lk_dcgs2_update_{tag}"])
        # dcgs2_measure, dcgs2_update: each kernel's resident blocks, the most a launch uses
        self.basis_blocks = _build.resident_blocks(
            self.lib, entries[f"lk_dcgs2_basis_blocks_per_sm_{tag}"], 2, V.device)
        partials = V.new_empty((2 * _TILE + 1) * self.basis_blocks[0])
        ticket = torch.zeros(1, dtype=torch.int32, device=V.device)
        self._basis_workspace = partials, ticket  # held for the pointers below
        self.basis_head = (V.data_ptr(), V[0].numel(), self.kdim + 1)
        self.measure_ptrs = (self.meas.data_ptr(), partials.data_ptr(), ticket.data_ptr())

    @property
    def flag(self):
        return self.scal[FLAG:FLAG + 1] if self.on_card else super().flag

    @property
    def conv(self):
        return self.scal[CONV:CONV + 1] if self.on_card else super().conv

    def _launch(self, name, mode, pr, rs, cs, wtw, k, nin):
        _build.launch(self.lib, self.entry, name, None, mode, pr.data_ptr(), rs, cs, wtw, k, nin,
                      *self.tail)


def _check_basis(V, R) -> None:
    """Raise unless ``V`` is a basis the two passes take for the state of
    ``R``: ``kdim + 1`` rows, contiguous, of ``R``'s dtype and device."""
    kdim = R.shape[0]
    if V.dtype != R.dtype or V.device != R.device:
        raise ValueError(f"dcgs2: the basis is {V.dtype} on {V.device}, "
                         f"not {R.dtype} on {R.device}")
    if V.ndim < 2 or V.shape[0] != kdim + 1 or V[0].numel() < 1:
        raise ValueError(f"dcgs2: the basis has shape {tuple(V.shape)}, not ({kdim + 1}, ...)")
    if not V.is_contiguous():
        raise ValueError("dcgs2: the basis must be contiguous")


def _measurement(st: FusedDCGS2, name, t, shape, nin):
    """Raise unless ``t`` is a measurement of ``shape`` for ``st``'s kernel
    and ``nin`` a slot of its history."""
    R = st.R
    if t.dtype != R.dtype or t.device != R.device or tuple(t.shape) != shape:
        raise ValueError(f"{name}: the measurement is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"not {R.dtype} {shape} on {R.device}")
    if not 0 <= nin < st.hist.numel():
        raise IndexError(f"{name}: slot {nin} outside a history of {st.hist.numel()}")


def dcgs2_step(st: FusedDCGS2, PR, wTw, k: int, nin: int):
    """Step ``k`` (``0 <= k < kdim``) of the cycle bound in ``st`` from the
    measurement ``PR`` (k+1, 2) and ``wTw`` (0-d): the coefficients, ``Ht``,
    ``hp``, ``fac_prev`` and ``inv_gamma``, and for ``k > 0`` the Givens
    update of column ``k - 1``, with ``hist[nin]``, ``res`` and the flags.
    Returns the rank-2 update's coefficients (k+1, 2) and ``inv_gamma``."""
    if not 0 <= k < st.kdim:
        raise IndexError(f"dcgs2_step: step {k} outside a cycle of {st.kdim}")
    _measurement(st, "dcgs2_step", PR, (k + 1, 2), nin)
    _measurement(st, "dcgs2_step", wTw, (), nin)
    if not st.on_card:
        C, inv_gamma = dcgs2_coefficients_reference(st, PR, wTw, k)
        dcgs2_givens_reference(st, k, nin)
        return C, inv_gamma
    st._launch("dcgs2_step", _STEP, PR, PR.stride(0), PR.stride(1), wTw.data_ptr(), k, nin)
    count_event("launches.dcgs2_step")
    return st.coeff[: k + 1], st.inv_gamma


def dcgs2_flush(st: FusedDCGS2, zf, k: int, nin: int) -> None:
    """The pending column ``k - 1`` (``1 <= k <= kdim``) of the cycle bound
    in ``st``, from the measurement ``zf = Q^H u_k`` (k+1,), into the least
    squares, with ``hist[nin]``, ``res`` and the flags."""
    if not 1 <= k <= st.kdim:
        raise IndexError(f"dcgs2_flush: column {k - 1} outside a cycle of {st.kdim}")
    _measurement(st, "dcgs2_flush", zf, (k + 1,), nin)
    if not st.on_card:
        return dcgs2_flush_reference(st, zf, k, nin)
    st._launch("dcgs2_flush", _FLUSH, zf, zf.stride(0), 0, None, k, nin)
    count_event("launches.dcgs2_flush")


def _basis_operand(st: FusedDCGS2, name, k: int, w):
    """``w`` as the two passes read it at step ``k`` of ``st``'s cycle:
    shaped like a column of the bound basis, contiguous on a card."""
    V = st.V
    if V is None:
        raise ValueError(f"{name}: the state was bound without a basis")
    if not 0 <= k < st.kdim:
        raise IndexError(f"{name}: step {k} outside a cycle of {st.kdim}")
    if w.dtype != V.dtype or w.device != V.device or w.shape != V.shape[1:]:
        raise ValueError(f"{name}: the operator gave {w.dtype} {tuple(w.shape)} on {w.device}, "
                         f"not {V.dtype} {tuple(V.shape[1:])} on {V.device}")
    return w if w.is_contiguous() else w.contiguous()


def dcgs2_measure(st: FusedDCGS2, k: int, w):
    """Step ``k``'s measurement over the basis bound in ``st``: this rank's
    ``Q^H [u_k, w]`` over ``V[:k+1]`` (``u_k = V[k]``) row-major, then
    ``w . w``, in one buffer of ``2 k + 3`` (on a card a view of ``st.meas``,
    which an all-reduce may sum in place and :func:`dcgs2_step` reads)."""
    w = _basis_operand(st, "dcgs2_measure", k, w)
    if not st.on_card:
        PR, wTw = dcgs2_measure_reference(st.V, k, w)
        return torch.cat([PR.reshape(-1), wTw.reshape(1)])
    _build.launch(st.lib, st.basis_entries[0], "dcgs2_measure", None, *st.basis_head, k,
                  w.data_ptr(), *st.measure_ptrs, st.basis_blocks[0], st.stream)
    count_event("launches.dcgs2_measure")
    return st.meas[: 2 * k + 3]


def dcgs2_update(st: FusedDCGS2, k: int, w) -> None:
    """Step ``k``'s rank-2 update of the basis bound in ``st``, from the
    coefficients and ``inv_gamma`` that :func:`dcgs2_step` left in ``st``:
    ``V[k] = V[:k+1]^T C[:, 0]`` and ``V[k+1] = inv_gamma w - V[:k+1]^T
    C[:, 1]``, in place."""
    w = _basis_operand(st, "dcgs2_update", k, w)
    if not st.on_card:
        if st.coeff is None or st.coeff.shape[0] < k + 1:
            raise RuntimeError(f"dcgs2_update: no coefficients of step {k} in the state")
        return dcgs2_update_reference(st.V, k, w, st.coeff[: k + 1], st.inv_gamma)
    _build.launch(st.lib, st.basis_entries[1], "dcgs2_update", None, *st.basis_head, k,
                  w.data_ptr(), st.coeff.data_ptr(), st.inv_gamma.data_ptr(), st.basis_blocks[1],
                  st.stream)
    count_event("launches.dcgs2_update")
