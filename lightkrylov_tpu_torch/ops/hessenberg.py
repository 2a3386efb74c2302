"""The projected Hessenberg eigensolve through the hand-written CUDA kernels.

The JAX package computes its device projected path
(:mod:`lightkrylov_tpu.utils.hessenberg`) outside Pallas: ``jax.jit``
compiles the Francis iteration's ``while_loop`` and its chases into one
program.  A line-by-line PyTorch translation would read the device at every
loop test and launch a dozen small kernels a chase step, so here the whole
iteration is one CTA of ``csrc/hessenberg.cu`` that keeps the matrix on
chip:

- :func:`hessenberg_schur` embeds the active ``k_eff x k_eff`` block
  (``k_eff`` read by the kernel from device memory), reduces it to
  Hessenberg form, runs the Francis sweeps to quasi-triangular form
  (optionally accumulating ``Z`` and splitting real-pair 2x2 blocks) and
  extracts the eigenvalues: ``_embed``, ``_to_hessenberg``, ``_schur_core``,
  ``_split_real_blocks`` and ``_extract_eigvals`` of the JAX module;
- :func:`francis_filter_sweeps` applies the ``kdim // 2`` sweeps of
  ``francis_filter`` (its ``hessenberg.py:687-714``) for a given shift
  order, keep count and ``pure`` flag, all read from device memory;
- :func:`ritz_check` (``csrc/ritz.cu``, a warp an eigenvalue, up to four a
  CTA) solves each
  eigenvalue's inverse iteration and writes its residual, its place in the
  modulus-descending order and the converged count: ``hessenberg_eigvecs``
  and ``hessenberg_ritz`` of the JAX module after its eigenvalues, the
  realified ``2n x 2n`` systems solved as the complex ``n x n`` ones they
  are; :func:`inverse_iteration` is the same kernel's vectors alone;
- :func:`ordschur` (``csrc/ordschur.cu``) reorders a real Schur form so that
  flagged positions lead, by adjacent block swaps: ``ordschur_device`` and
  its ``_ordschur_core`` of the JAX module, the loop on the card.

:func:`geometry` (and :func:`ordschur_geometry`, :func:`ritz_geometry`)
decides each launch's layout in Python (warps, whether ``H`` and ``Z`` fit
in shared memory, the bytes), so that the CPU tests can
hold it against the card's limit; the C entries check it and refuse what
does not fit.

For a CUDA tensor a wrapper launches its kernel or raises: a failed build
(:class:`._build.KernelCompileError`), a refused launch or an unsupported
tensor is an error, never a quiet switch to another path.  For a CPU tensor
it runs the plain version (:func:`hessenberg_schur_reference`,
:func:`francis_filter_sweeps_reference`, :func:`ritz_check_reference`,
:func:`inverse_iteration_reference`, :func:`ordschur_reference`), built from
the pieces of :mod:`..utils.hessenberg`.  Each wrapper counts its launches
in the counter ``launches.<wrapper>`` (:func:`..utils.timer.count_event`).
:func:`launch_schur`, :func:`launch_filter`, :func:`launch_ritz` and
:func:`launch_ordschur` are the launches themselves, from a library that the
caller names (the shipping build, or the lagging-warp build of
:func:`._build.load_lagging` that the tests hold to it), and count nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import hessenberg as _plain
from ..utils.timer import count_event
from . import _build

__all__ = ["Geometry", "RitzGeometry", "francis_filter_sweeps", "francis_filter_sweeps_reference",
           "geometry", "hessenberg_schur", "hessenberg_schur_reference", "inverse_iteration",
           "inverse_iteration_reference", "launch_filter", "launch_ordschur", "launch_ritz",
           "launch_schur", "ordschur", "ordschur_geometry", "ordschur_reference", "ritz_check",
           "ritz_check_reference", "ritz_geometry"]

#: The C entries of ``csrc/hessenberg.cu``, ``csrc/ritz.cu`` and
#: ``csrc/ordschur.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    **{f"lk_hessenberg_schur_{t}": "ppppppppp il iiiiiii p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_francis_sweeps_{t}": "ppppppp il p il p iiiii p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_ritz_{t}": "pppp il p il d l ii ppppppp iiiiii p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_ordschur_{t}": "pppppppp iiiiii p" for t in _build.DTYPE_TAGS.values()},
})


def hessenberg_schur_reference(H, k_eff=None, with_z: bool = False, split: bool = False):
    """Plain PyTorch version of :func:`hessenberg_schur`, on ``H``'s
    device."""
    k = H.shape[0] if k_eff is None else k_eff
    return _plain._schur_plain(H, k, with_z, split)


def francis_filter_sweeps_reference(H, wr, wi, shift_order, n_keep, pure):
    """Plain PyTorch version of :func:`francis_filter_sweeps`."""
    return _plain._sweeps_plain(H, wr, wi, shift_order, n_keep, pure)


def ritz_check_reference(H_ext, wr, wi, ok, k_eff, tol, nev=None, p: int = 1):
    """Plain PyTorch version of :func:`ritz_check`, on ``H_ext``'s device."""
    return _plain._ritz_plain(H_ext, wr, wi, ok, k_eff, tol, nev, p)


def inverse_iteration_reference(H, wr, wi, k_eff=None):
    """Plain PyTorch version of :func:`inverse_iteration`."""
    return _plain._inverse_iteration_plain(H, wr, wi, H.shape[0] if k_eff is None else k_eff)


def ordschur_reference(T, Z, sel):
    """Plain PyTorch version of :func:`ordschur`, on ``T``'s device."""
    return _plain._ordschur_plain(T, Z, sel)


#: Shared memory a CTA may take on the H100 (sm_90), and the part the
#: kernels keep for their static scalars (``csrc/hessenberg.cu`` holds the
#: same numbers and refuses a geometry that does not fit)
SMEM_LIMIT = 232448
SMEM_RESERVED = 512
MAX_WARPS = 8


class Geometry(NamedTuple):
    """How one launch lays out: ``warps`` in the CTA; whether ``H`` and
    ``Z`` live in shared memory (rows of odd stride ``n | 1``) or in the
    output buffers; the dynamic shared memory in bytes."""

    warps: int
    h_smem: bool
    z_smem: bool
    smem_bytes: int


def geometry(n: int, itemsize: int, with_z: bool, schur: bool = True) -> Geometry:
    """The launch geometry of a kernel on an ``n x n`` matrix of
    ``itemsize``-byte entries: a thread a row or column, for the reduction
    and the chase alike (``ceil(n / 32)`` warps, at most 8; one warp is
    synchronised by ``__syncwarp``); ``H`` in shared memory when it fits with
    the Schur kernel's vectors (the reflector and the accepted flags,
    ``n * itemsize + 4 n`` bytes), ``Z`` too when both fit."""
    ld = n | 1
    mat = n * ld * itemsize
    vec = n * itemsize + 4 * n if schur else 0
    budget = SMEM_LIMIT - SMEM_RESERVED
    h_smem = mat + vec <= budget
    z_smem = bool(with_z) and h_smem and 2 * mat + vec <= budget
    warps = min(MAX_WARPS, max(1, -(-n // 32)))
    return Geometry(warps, h_smem, z_smem, vec + mat * (int(h_smem) + int(z_smem)))


#: Eigenvalue slots (a warp each) a CTA of the Ritz kernel holds at most
RITZ_MAX_SLOTS = 4
#: Columns a lane of the Ritz kernel's register path can hold: its
#: instantiations (``32 * cols >= kdim``); beyond 320 it has none
RITZ_COLS = (1, 2, 4, 10)


class RitzGeometry(NamedTuple):
    """How one launch of the Ritz kernel lays out: ``slots`` eigenvalue slots
    (a warp each) a CTA; whether the active block is staged in shared memory
    (``h_smem``) and the slots' working matrices live there (``w_smem``, else
    in a global scratch slice a slot); the columns a lane holds on the
    register path (``cols``, 0 beyond kdim 320: the general path alone); the
    dynamic shared memory a CTA takes in bytes."""

    slots: int
    h_smem: bool
    w_smem: bool
    cols: int
    smem_bytes: int


def ordschur_geometry(n: int, nz: int, itemsize: int) -> Geometry:
    """The ordschur kernel's layout for an ``n x n`` ``T`` and an ``nz x n``
    ``Z``: :func:`geometry`'s warps (a thread a column of ``T``'s rows and a
    row of ``T``'s and ``Z``'s columns), ``T`` in shared memory when it fits
    (rows of odd stride ``n | 1``) beside the mask (``n`` bytes), ``Z`` too
    when all do; ``h_smem`` is ``T``'s place.  With ``nz = n``: ``Z`` leaves
    shared memory at ``n = 120`` in f64 and 170 in f32, ``T`` at 170 and
    241."""
    ld = n | 1
    t, z = n * ld * itemsize, nz * ld * itemsize
    budget = SMEM_LIMIT - SMEM_RESERVED - n
    t_smem = t <= budget
    z_smem = t_smem and t + z <= budget
    warps = min(MAX_WARPS, max(1, -(-n // 32)))
    return Geometry(warps, t_smem, z_smem, t * int(t_smem) + z * int(z_smem) + n)


def ritz_geometry(n: int, itemsize: int) -> RitzGeometry:
    """The Ritz kernel's layout at ``kdim = n``.  A CTA's shared memory holds
    the prescaled eigenvalues and right-hand side (``4 n`` entries), the
    profile, its entering rows and counts (``16 n`` bytes), optionally the
    staged active block (``n`` rows of stride ``n | 1``) and, a slot, the
    working matrix (``n`` rows of odd stride ``(n + 1) | 1``, real and
    imaginary parts apart, the right-hand side in its last column) and a copy
    of the profile (``4 n`` bytes).  Preferred in this order: block and
    working matrices in shared memory (f32 to n = 136, f64 to 96), the
    working matrices alone (f32 to 167, f64 to 118), the block alone (f32 to
    235, f64 to 167), neither; each with as many slots as fit, at most
    RITZ_MAX_SLOTS and n."""
    ld = (n + 1) | 1
    h = n * (n | 1) * itemsize
    w = 2 * n * ld * itemsize
    shared = 4 * n * itemsize + 16 * n
    budget = SMEM_LIMIT - SMEM_RESERVED
    cols = next((c for c in RITZ_COLS if 32 * c >= n), 0)
    for h_smem, w_smem in ((True, True), (False, True), (True, False), (False, False)):
        base = shared + h * h_smem
        per_slot = w * w_smem + 4 * n
        slots = min(RITZ_MAX_SLOTS, n, (budget - base) // per_slot)
        if slots >= 1:
            return RitzGeometry(slots, h_smem, w_smem, cols, base + slots * per_slot)
    raise ValueError(f"ritz kernel: kdim {n} leaves no room for one slot's profile")


def _check(H, what) -> str:
    """Raise unless ``H`` is a non-empty square matrix on a card; its
    dtype's tag."""
    if H.device.type != "cuda":
        raise ValueError(f"{what} kernel: expected a CUDA tensor, got {H.device}")
    tag = _build.dtype_tag(H.dtype, f"{what} kernel")
    if H.ndim != 2 or H.shape[0] != H.shape[1] or H.shape[0] == 0:
        raise ValueError(f"{what} kernel: expected a non-empty square matrix, "
                         f"got shape {tuple(H.shape)}")
    return tag


_INT_BYTES = {torch.int64: 8, torch.int32: 4, torch.bool: 1}


def _int_arg(v, default, device):
    """An integer argument as the kernels take it, ``(tensor, bytes,
    value)``: a one-element integer or bool tensor on ``device`` is read by
    the kernel where it lies (other dtypes are cast first); an int, a bool or
    ``None`` (``default``) is passed by value."""
    if v is None:
        return None, 0, int(default)
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"expected a scalar on {device}, got {v.device}")
        if v.numel() != 1:
            raise ValueError(f"expected a scalar, got shape {tuple(v.shape)}")
        if v.dtype not in _INT_BYTES:
            v = v.to(torch.int64)
        return v, _INT_BYTES[v.dtype], 0
    return None, 0, int(v)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(load, name, what, device, *args):
    """Launch the entry ``name`` of the library ``load()`` returns with
    ``args`` on the current stream of ``device`` (:func:`._build.launch`)."""
    lib = load()
    _build.launch(lib, ENTRIES.on(lib)[name], what, device.index, *args)


def hessenberg_schur(H, k_eff=None, with_z: bool = False, split: bool = False):
    """The Schur core of the square real matrix ``H`` on its active
    ``k_eff x k_eff`` block -> ``(T, Z, wr, wi, accepted, ok, work)``:
    ``T`` quasi-triangular, ``Z`` the accumulated transform (``None`` unless
    ``with_z``; ``H_embedded = Z T Z^T``), the eigenvalues aligned with
    ``T``'s diagonal (0 at inactive positions), ``accepted`` the terminal
    2x2 blocks (bool, ``n - 1``), ``ok`` (0-d bool) False if the budget of
    30 n sweeps ran out, ``work`` (int32) the passes made and the chase
    steps they took, ``[sweeps, steps]``.  With
    ``split`` every remaining 2x2 block is a conjugate pair.  ``k_eff`` is
    an int, a 0-d integer tensor on ``H``'s device (read there), or ``None``
    (all of ``H``).  On a CUDA tensor the kernel writes every output in its
    returned type: one launch, and nothing else when ``k_eff`` is an int
    or an int32/int64 tensor."""
    if H.device.type == "cpu":
        return hessenberg_schur_reference(H, k_eff, with_z, split)
    out = launch_schur(_build.load, H, k_eff, with_z, split)
    count_event("launches.hessenberg_schur")
    return out


def launch_schur(load, H, k_eff=None, with_z: bool = False, split: bool = False):
    """The launch of :func:`hessenberg_schur` on the CUDA tensor ``H``, from
    the library that ``load()`` returns (:func:`._build.load` or
    :func:`._build.load_lagging`), called once the arguments are checked;
    not counted."""
    tag = _check(H, "hessenberg_schur")
    n = H.shape[0]
    dev = H.device
    H = H.contiguous()
    keff, kbytes, kval = _int_arg(k_eff, n, dev)
    geo = geometry(n, H.element_size(), with_z)
    T = torch.empty_like(H)
    Z = torch.empty_like(H) if with_z else None
    wr = torch.empty(n, dtype=H.dtype, device=dev)
    wi = torch.empty(n, dtype=H.dtype, device=dev)
    acc = torch.empty(max(n - 1, 0), dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    work = torch.empty(2, dtype=torch.int32, device=dev)
    _launch(load, f"lk_hessenberg_schur_{tag}", "hessenberg_schur", dev,
            H.data_ptr(), T.data_ptr(), _ptr(Z), wr.data_ptr(), wi.data_ptr(),
            acc.data_ptr() if n > 1 else None, ok.data_ptr(), work.data_ptr(), _ptr(keff), kbytes,
            kval, n, int(with_z), int(split), geo.warps, int(geo.h_smem),
            int(geo.z_smem), geo.smem_bytes)
    return T, Z, wr, wi, acc, ok, work


def francis_filter_sweeps(H, wr, wi, shift_order, n_keep, pure):
    """The sweeps of :func:`..utils.hessenberg.francis_filter` ->
    ``(Hf, Z, work)``: sweep ``j`` deflates explicitly and, while
    ``2 j + 1 < kdim - n_keep``, ``pure`` holds and the top-connected block
    reaches row 2, chases that block with the shifts
    ``shift_order[2j], shift_order[2j+1]`` of ``(wr, wi)``, accumulating
    ``Hf = Z^T H Z``; ``work`` (int32) counts the sweeps that chased and
    their chase steps, ``[sweeps, steps]``.
    ``n_keep`` and ``pure`` are ints/bools or 0-d tensors on ``H``'s device,
    read there.  One launch on a CUDA tensor, and nothing else when
    ``shift_order`` is int64 and ``(wr, wi)`` are of ``H``'s dtype."""
    if H.device.type == "cpu":
        return francis_filter_sweeps_reference(H, wr, wi, shift_order, n_keep, pure)
    out = launch_filter(_build.load, H, wr, wi, shift_order, n_keep, pure)
    count_event("launches.francis_filter_sweeps")
    return out


def launch_filter(load, H, wr, wi, shift_order, n_keep, pure):
    """The launch of :func:`francis_filter_sweeps` on the CUDA tensor ``H``,
    from the library that ``load()`` returns, as :func:`launch_schur`; not
    counted."""
    tag = _check(H, "francis_filter_sweeps")
    n = H.shape[0]
    dev = H.device
    H = H.contiguous()
    wr = wr.to(H.dtype).contiguous()
    wi = wi.to(H.dtype).contiguous()
    order = shift_order.to(torch.int64).contiguous()
    nk, nkb, nkv = _int_arg(n_keep, n, dev)
    pu, pub, puv = _int_arg(pure, 1, dev)
    for t, name in ((wr, "wr"), (wi, "wi"), (order, "shift_order")):
        if t.device != dev or t.shape != (n,):
            raise ValueError(f"francis_filter_sweeps kernel: {name} must have shape ({n},) "
                             f"on {dev}, got {tuple(t.shape)} on {t.device}")
    geo = geometry(n, H.element_size(), True, schur=False)
    Hf = torch.empty_like(H)
    Z = torch.empty_like(H)
    work = torch.empty(2, dtype=torch.int32, device=dev)
    _launch(load, f"lk_francis_sweeps_{tag}", "francis_filter_sweeps", dev,
            H.data_ptr(), Hf.data_ptr(), Z.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            order.data_ptr(), _ptr(nk), nkb, nkv, _ptr(pu), pub, puv, work.data_ptr(), n,
            geo.warps, int(geo.h_smem), int(geo.z_smem), geo.smem_bytes)
    return Hf, Z, work


def ritz_check(H_ext, wr, wi, ok, k_eff, tol, nev=None, p: int = 1):
    """The analysis of one check after its eigenvalues -> ``(wr, wi, res, Vr,
    Vi, n_conv)``, ordered by descending modulus (stable): for each slot of
    the Schur kernel's ``(wr, wi)`` the inverse iteration's unit vector on
    the active ``k_eff x k_eff`` block of the ``(kdim + p, kdim)`` buffer
    ``H_ext`` (rows ``>= k_eff`` zero), its residual (``|H_ext[k, k-1]|
    |v[k-1]|`` for ``p = 1``, ``||H_ext[k:k+p, k-p:k] v[k-p:k]||`` else;
    ``+inf`` unless the slot is active and ``ok``) and ``n_conv`` (0-d
    int32), the finite residuals below ``tol`` among the leading ``nev``
    (``None``: all).  ``k_eff`` and ``ok`` are numbers or one-element tensors
    on ``H_ext``'s device (read there); ``tol`` and ``nev`` are numbers.  On a
    CUDA tensor one fill (the count) and one launch, and nothing else when
    ``(wr, wi)`` are of ``H_ext``'s dtype."""
    if H_ext.device.type == "cpu":
        return ritz_check_reference(H_ext, wr, wi, ok, k_eff, tol, nev, p)
    out = launch_ritz(_build.load, H_ext, wr, wi, k_eff, ok, tol, nev, p)
    count_event("launches.ritz_check")
    return out


def inverse_iteration(H, wr, wi, k_eff=None):
    """The inverse iteration's vectors alone -> ``(Vr, Vi)`` in slot order,
    columns of unit norm, rows ``>= k_eff`` zero, for the square real ``H``
    (any structure) and the eigenvalues ``(wr, wi)``; the kernel of
    :func:`ritz_check` with no residual and no order.  One launch on a CUDA
    tensor."""
    if H.device.type == "cpu":
        return inverse_iteration_reference(H, wr, wi, k_eff)
    out = launch_ritz(_build.load, H, wr, wi, k_eff)
    count_event("launches.inverse_iteration")
    return out


def launch_ritz(load, H, wr, wi, k_eff=None, ok=True, tol=None, nev=None, p: int = 1):
    """The launch of the Ritz kernel on the CUDA tensor ``H`` from the library
    that ``load()`` returns: with ``tol`` that of :func:`ritz_check` (``H``
    the ``(kdim + p, kdim)`` buffer), without it that of
    :func:`inverse_iteration` (``H`` square); not counted."""
    ritz = tol is not None
    what = "ritz_check" if ritz else "inverse_iteration"
    if H.device.type != "cuda":
        raise ValueError(f"{what} kernel: expected a CUDA tensor, got {H.device}")
    tag = _build.dtype_tag(H.dtype, f"{what} kernel")
    n = H.shape[-1]
    rows = n + p if ritz else n
    if H.ndim != 2 or n == 0 or p < 1 or H.shape[0] != rows:
        raise ValueError(f"{what} kernel: expected a ({rows}, {n}) matrix with n >= 1 and "
                         f"p >= 1, got shape {tuple(H.shape)} and p = {p}")
    dev = H.device
    H = H.contiguous()
    wr = wr.to(H.dtype).contiguous()
    wi = wi.to(H.dtype).contiguous()
    for t, name in ((wr, "wr"), (wi, "wi")):
        if t.device != dev or t.shape != (n,):
            raise ValueError(f"{what} kernel: {name} must have shape ({n},) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    keff, kbytes, kval = _int_arg(k_eff, n, dev)
    okt, okbytes, okval = _int_arg(ok, 1, dev)
    geo = ritz_geometry(n, H.element_size())
    Vr = torch.empty((n, n), dtype=H.dtype, device=dev)
    Vi = torch.empty_like(Vr)
    wr_o = wi_o = res = n_conv = scratch = None
    if ritz:
        wr_o, wi_o, res = (torch.empty(n, dtype=H.dtype, device=dev) for _ in range(3))
        n_conv = torch.zeros((), dtype=torch.int32, device=dev)
    if not geo.w_smem:
        scratch = torch.empty(2 * n * n * ((n + 1) | 1), dtype=H.dtype, device=dev)
    _launch(load, f"lk_ritz_{tag}", what, dev,
            H.data_ptr(), wr.data_ptr(), wi.data_ptr(), _ptr(okt), okbytes, okval, _ptr(keff),
            kbytes, kval, float(tol) if ritz else 0.0, n if nev is None else int(nev), p,
            int(ritz), _ptr(wr_o), _ptr(wi_o), _ptr(res), Vr.data_ptr(), Vi.data_ptr(),
            _ptr(n_conv), _ptr(scratch), n, geo.slots, int(geo.h_smem), int(geo.w_smem),
            geo.cols, geo.smem_bytes)
    return (wr_o, wi_o, res, Vr, Vi, n_conv) if ritz else (Vr, Vi)


def ordschur(T, Z, sel):
    """Reorder the real Schur form ``(T, Z)`` so that the positions flagged
    in ``sel`` lead -> ``(T', Z', sel', ok, swaps)``: the mask made
    pair-consistent first, then the bubble sort of adjacent block swaps
    (:func:`..utils.hessenberg._ordschur_plain`) until the flagged blocks
    lead (``ok`` True), a swap is rejected (``ok`` False, the form partially
    reordered) or ``n^2 + 4`` passes are spent; ``swaps`` (0-d int32) the
    swaps applied.  ``T`` is ``n x n``, ``Z`` ``nz x n`` of ``T``'s dtype,
    ``sel`` ``n`` flags (bool, or any dtype, cast) on ``T``'s device.  On a
    CUDA tensor one launch, and nothing else when ``sel`` is bool and the
    tensors contiguous."""
    if T.device.type == "cpu":
        return ordschur_reference(T, Z, sel)
    out = launch_ordschur(_build.load, T, Z, sel)
    count_event("launches.ordschur")
    return out


def launch_ordschur(load, T, Z, sel):
    """The launch of :func:`ordschur` on the CUDA tensor ``T`` from the
    library that ``load()`` returns; not counted."""
    tag = _check(T, "ordschur")
    n = T.shape[0]
    dev = T.device
    if Z.device != dev or Z.dtype != T.dtype or Z.ndim != 2 or Z.shape[1] != n:
        raise ValueError(f"ordschur kernel: Z must be (nz, {n}) of {T.dtype} on {dev}, got "
                         f"{tuple(Z.shape)} of {Z.dtype} on {Z.device}")
    if sel.device != dev or sel.shape != (n,):
        raise ValueError(f"ordschur kernel: sel must have shape ({n},) on {dev}, got "
                         f"{tuple(sel.shape)} on {sel.device}")
    T, Z = T.contiguous(), Z.contiguous()
    sel = sel.to(torch.bool).contiguous()
    geo = ordschur_geometry(n, Z.shape[0], T.element_size())
    To, Zo = torch.empty_like(T), torch.empty_like(Z)
    sel_o = torch.empty_like(sel)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    swaps = torch.empty((), dtype=torch.int32, device=dev)
    _launch(load, f"lk_ordschur_{tag}", "ordschur", dev,
            T.data_ptr(), Z.data_ptr(), sel.data_ptr(), To.data_ptr(), Zo.data_ptr(),
            sel_o.data_ptr(), ok.data_ptr(), swaps.data_ptr(), n, Z.shape[0], geo.warps,
            int(geo.h_smem), int(geo.z_smem), geo.smem_bytes)
    return To, Zo, sel_o, ok, swaps
