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
  order, keep count and ``pure`` flag, all read from device memory.

:func:`geometry` decides each launch's layout in Python (warps, whether
``H`` and ``Z`` fit in shared memory, the bytes), so that the CPU tests can
hold it against the card's limit; the C entries check it and refuse what
does not fit.

For a CUDA tensor a wrapper launches its kernel or raises: a failed build
(:class:`._build.KernelCompileError`), a refused launch or an unsupported
tensor is an error, never a quiet switch to another path.  For a CPU tensor
it runs the plain version, :func:`hessenberg_schur_reference` or
:func:`francis_filter_sweeps_reference`, built from the pieces of
:mod:`..utils.hessenberg`.  Each wrapper counts its launches in its
``LAUNCHES`` attribute.  :func:`launch_schur` and :func:`launch_filter` are
the launches themselves, from a library that the caller names (the shipping
build, or the lagging-warp build of :func:`._build.load_lagging` that the
tests hold to it), and count nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import hessenberg as _plain
from . import _build

__all__ = ["Geometry", "francis_filter_sweeps", "francis_filter_sweeps_reference", "geometry",
           "hessenberg_schur", "hessenberg_schur_reference", "launch_filter", "launch_schur"]

_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def hessenberg_schur_reference(H, k_eff=None, with_z: bool = False, split: bool = False):
    """Plain PyTorch version of :func:`hessenberg_schur`, on ``H``'s
    device."""
    k = H.shape[0] if k_eff is None else k_eff
    return _plain._schur_plain(H, k, with_z, split)


def francis_filter_sweeps_reference(H, wr, wi, shift_order, n_keep, pure):
    """Plain PyTorch version of :func:`francis_filter_sweeps`."""
    return _plain._sweeps_plain(H, wr, wi, shift_order, n_keep, pure)


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


def _check(H, what):
    if H.device.type != "cuda":
        raise ValueError(f"{what} kernel: expected a CUDA tensor, got {H.device}")
    if H.dtype not in _NAMES:
        raise TypeError(f"{what} kernel: dtype {H.dtype} not supported (float32 or float64)")
    if H.ndim != 2 or H.shape[0] != H.shape[1] or H.shape[0] == 0:
        raise ValueError(f"{what} kernel: expected a non-empty square matrix, "
                         f"got shape {tuple(H.shape)}")


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


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.lk_error_string(err).decode()})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


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
    hessenberg_schur.LAUNCHES += 1
    return out


def launch_schur(load, H, k_eff=None, with_z: bool = False, split: bool = False):
    """The launch of :func:`hessenberg_schur` on the CUDA tensor ``H``, from
    the library that ``load()`` returns (:func:`._build.load` or
    :func:`._build.load_lagging`), called once the arguments are checked;
    not counted in ``LAUNCHES``."""
    _check(H, "hessenberg_schur")
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
    lib = load()
    err = getattr(lib, f"lk_hessenberg_schur_{_NAMES[H.dtype]}")(
        H.data_ptr(), T.data_ptr(), _ptr(Z), wr.data_ptr(), wi.data_ptr(),
        acc.data_ptr() if n > 1 else None, ok.data_ptr(), work.data_ptr(), _ptr(keff), kbytes,
        kval, n, int(with_z), int(split), geo.warps, int(geo.h_smem),
        int(geo.z_smem), geo.smem_bytes, _stream(dev))
    _raise_on(err, lib, "hessenberg_schur")
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
    francis_filter_sweeps.LAUNCHES += 1
    return out


def launch_filter(load, H, wr, wi, shift_order, n_keep, pure):
    """The launch of :func:`francis_filter_sweeps` on the CUDA tensor ``H``,
    from the library that ``load()`` returns, as :func:`launch_schur`; not
    counted in ``LAUNCHES``."""
    _check(H, "francis_filter_sweeps")
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
    lib = load()
    err = getattr(lib, f"lk_francis_sweeps_{_NAMES[H.dtype]}")(
        H.data_ptr(), Hf.data_ptr(), Z.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        order.data_ptr(), _ptr(nk), nkb, nkv, _ptr(pu), pub, puv, work.data_ptr(), n,
        geo.warps, int(geo.h_smem), int(geo.z_smem), geo.smem_bytes,
        _stream(dev))
    _raise_on(err, lib, "francis_filter_sweeps")
    return Hf, Z, work


hessenberg_schur.LAUNCHES = 0
francis_filter_sweeps.LAUNCHES = 0
