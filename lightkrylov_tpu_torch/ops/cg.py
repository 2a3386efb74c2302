"""The conjugate gradient iteration's vector update through three
hand-written CUDA kernels (``csrc/cg.cu``), with its scalars on the device.

After the operator has given ``Ap``, an iteration of unpreconditioned CG is

* :func:`cg_pdot`: ``pAp = p . Ap``;
* :func:`cg_xr`: ``alpha = rz / pAp``, ``x += alpha p``, ``r -= alpha Ap``,
  ``rr = r . r``, ``res = sqrt(rr)``, ``hist[k] = res``, the stopping flag
  ``res >= tol``, ``beta = rr / rz`` and ``rz = rr``;
* :func:`cg_p`: ``p = r + beta p``;

a zero ``pAp`` or ``rz`` divides by 1, as the solver's ``_nonzero`` does.
The scalars live in the scalar block ``s`` (:func:`scalars`; slots
:data:`RZ`, :data:`PAP`, :data:`RR`, :data:`RES`, :data:`TOL`,
:data:`BETA`, :data:`FLAG`), so the host reads only the flag.  ``x``, ``r``
and ``p`` are updated in place: they are the solve's own buffers.  No
Pallas kernel is replaced; the JAX package leaves this fusion to XLA.

:class:`FusedCG` binds the kernels to the buffers of one solve, resolving
the C entries, the stream, the grid and the reductions' workspace once, so
an iteration costs the host three foreign calls.  Each function takes it:
for CUDA tensors the function launches its kernel or raises, and counts the
launch in the counter ``launches.<function>``
(:func:`..utils.timer.count_event`); for CPU tensors it runs the plain
PyTorch version (``*_reference``), which repeats the arithmetic with
PyTorch's own reductions.
"""

from __future__ import annotations

import torch

from ..utils.timer import count_event
from . import _build

__all__ = ["RZ", "PAP", "RR", "RES", "TOL", "BETA", "FLAG", "scalars", "FusedCG",
           "cg_pdot", "cg_xr", "cg_p",
           "cg_pdot_reference", "cg_xr_reference", "cg_p_reference"]

#: slots of the scalar block (``csrc/cg.cu`` has the same numbers)
RZ, PAP, RR, RES, TOL, BETA, FLAG = range(7)
_SLOTS = 8

#: The C entries of ``csrc/cg.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    **{f"lk_cg_pdot_{t}": "pp l ppp i p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_cg_xr_{t}": "pppp l pppp l i p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_cg_p_{t}": "pp l p i p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_cg_blocks_per_sm_{t}": "p" for t in _build.DTYPE_TAGS.values()},
})


def scalars(rz, res, tol):
    """The scalar block of a solve about to start: ``rz = rr = r . r`` of the
    start residual, its norm ``res``, the tolerance ``tol`` and the flag
    ``res >= tol``; each a 0-d tensor of the vectors' dtype and device."""
    zero = torch.zeros_like(rz)
    return torch.stack([rz, zero, rz, res, tol, zero, (res >= tol).to(rz.dtype), zero])


def _nonzero(a):
    return torch.where(a == 0, torch.ones_like(a), a)


def cg_pdot_reference(p, Ap, s):
    """Plain version of :func:`cg_pdot`."""
    s[PAP] = torch.dot(p.reshape(-1), Ap.reshape(-1))


def cg_xr_reference(x, r, p, Ap, s, hist, k: int):
    """Plain version of :func:`cg_xr`."""
    alpha = s[RZ] / _nonzero(s[PAP])
    x += alpha * p
    r -= alpha * Ap
    rr = torch.dot(r.reshape(-1), r.reshape(-1))
    res = torch.sqrt(rr)
    s[BETA] = rr / _nonzero(s[RZ])
    s[FLAG] = (res >= s[TOL]).to(s.dtype)
    s[RR], s[RES], s[RZ] = rr, res, rr
    hist[k] = res


def cg_p_reference(r, p, s):
    """Plain version of :func:`cg_p`."""
    p.mul_(s[BETA]).add_(r)


def _check(name, vectors, s, hist=None) -> str:
    """Raise unless the vectors and the scalar block suit the kernels; their
    dtype's tag."""
    t = vectors[0]
    tag = _build.dtype_tag(t.dtype, name)
    for v in (*vectors, s) + (() if hist is None else (hist,)):
        if v.device != t.device or v.dtype != t.dtype:
            raise ValueError(f"{name}: every tensor must be {t.dtype} on {t.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    if any(v.numel() != t.numel() for v in vectors):
        raise ValueError(f"{name}: the vectors differ in length")
    if s.numel() < _SLOTS:
        raise ValueError(f"{name}: the scalar block has {s.numel()} slots, not {_SLOTS}")
    return tag


class FusedCG:
    """The three kernels bound to the buffers ``x``, ``r``, ``p``, ``s`` and
    ``hist`` of one solve.  On a card, the C entries, the current stream, the
    grid and a workspace (the reductions' partials and ticket) are resolved
    once here; an iteration is then :meth:`update` (:func:`cg_pdot` and
    :func:`cg_xr`) and :meth:`direction` (:func:`cg_p`).  On the CPU the
    functions run the plain versions.  Use it as a context manager: on a card
    it makes the vectors' device current while the solve runs."""

    def __init__(self, x, r, p, s, hist):
        tag = _check("cg", (x, r, p), s, hist)
        self.x, self.r, self.p, self.s, self.hist = x, r, p, s, hist
        self.n = x.numel()
        self.on_card = x.device.type == "cuda"
        if not self.on_card:
            return
        self.lib = lib = _build.load()
        entries = ENTRIES.on(lib)
        self.entries = tuple(entries[f"lk_cg_{kind}_{tag}"] for kind in ("pdot", "xr", "p"))
        # cg_pdot, cg_xr, cg_p: each kernel's resident blocks, the most a launch uses
        self.blocks = _build.resident_blocks(lib, entries[f"lk_cg_blocks_per_sm_{tag}"], 3,
                                             x.device)
        partials = torch.empty(max(self.blocks[:2]), dtype=x.dtype, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        self._workspace = partials, ticket  # held for the pointers below
        self.stream = torch.cuda.current_stream(x.device).cuda_stream
        self.ptr = {name: t.data_ptr() for name, t in
                    (("x", x), ("r", r), ("p", p), ("s", s), ("hist", hist),
                     ("partials", partials), ("ticket", ticket))}
        self._guard = torch.cuda.device(x.device)

    def __enter__(self):
        if self.on_card:
            self._guard.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self._guard.__exit__(*exc)

    def update(self, Ap, k: int) -> None:
        """:func:`cg_pdot` and :func:`cg_xr` from the operator's output
        ``Ap``: ``x``, ``r``, the scalars, ``hist[k]`` and the flag."""
        cg_pdot(self, Ap)
        cg_xr(self, Ap, k)

    def direction(self) -> None:
        """:func:`cg_p`: the next search direction ``p``."""
        cg_p(self)


def _operand(cg: FusedCG, Ap):
    """``Ap`` as the kernels read it: contiguous, and like ``cg.x``."""
    x = cg.x
    if Ap.dtype != x.dtype or Ap.device != x.device or Ap.numel() != cg.n:
        raise ValueError(f"cg: the operator gave {Ap.dtype} {tuple(Ap.shape)} on {Ap.device}, "
                         f"not {x.dtype} {tuple(x.shape)} on {x.device}")
    return Ap if Ap.is_contiguous() else Ap.contiguous()


def cg_pdot(cg: FusedCG, Ap) -> None:
    """``s[PAP] = p . Ap`` on the buffers of ``cg``."""
    Ap = _operand(cg, Ap)
    if not cg.on_card:
        return cg_pdot_reference(cg.p, Ap, cg.s)
    ptr = cg.ptr
    _build.launch(cg.lib, cg.entries[0], "cg_pdot", None, ptr["p"], Ap.data_ptr(), cg.n,
                  ptr["partials"], ptr["ticket"], ptr["s"], cg.blocks[0], cg.stream)
    count_event("launches.cg_pdot")


def cg_xr(cg: FusedCG, Ap, k: int) -> None:
    """``x += alpha p`` and ``r -= alpha Ap`` in place with ``alpha = rz /
    pAp``; then ``rr``, ``res``, ``hist[k]``, the flag, ``beta`` and ``rz``
    in ``s``; on the buffers of ``cg``."""
    Ap = _operand(cg, Ap)
    if not 0 <= k < cg.hist.numel():
        raise IndexError(f"cg_xr: iteration {k} outside a history of {cg.hist.numel()}")
    if not cg.on_card:
        return cg_xr_reference(cg.x, cg.r, cg.p, Ap, cg.s, cg.hist, k)
    ptr = cg.ptr
    _build.launch(cg.lib, cg.entries[1], "cg_xr", None, ptr["x"], ptr["r"], ptr["p"],
                  Ap.data_ptr(), cg.n, ptr["partials"], ptr["ticket"], ptr["s"], ptr["hist"], k,
                  cg.blocks[1], cg.stream)
    count_event("launches.cg_xr")


def cg_p(cg: FusedCG) -> None:
    """``p = r + beta p`` in place, with ``beta = s[BETA]``; on the buffers
    of ``cg``."""
    if not cg.on_card:
        return cg_p_reference(cg.r, cg.p, cg.s)
    ptr = cg.ptr
    _build.launch(cg.lib, cg.entries[2], "cg_p", None, ptr["r"], ptr["p"], cg.n, ptr["s"],
                  cg.blocks[2], cg.stream)
    count_event("launches.cg_p")
