"""Block-ELL sparse matrix-vector product through the hand-written CUDA kernel.

Counterpart of :mod:`lightkrylov_tpu.ops.pallas.spmv`, the general
sparse-operator tier.  The matrix is cut into ``(bm, bn)`` dense blocks;
each block-row stores the same number ``K`` of blocks, padded with zero
blocks that point at block-column 0:

* ``data``: ``(nbr, K, bm, bn)`` block values;
* ``cols``: ``(nbr, K)`` int32 block-column indices.

The block shape is the caller's, or else :func:`bell_from_scipy` takes it
from where the matrix will live: on the CPU the JAX package's 8 x 128; on a
card the shape of :data:`FITTED_SHAPES` whose layout stores fewer bytes of
``data`` and ``cols`` (:func:`bell_block_shape`; ties to 8 x 128).  A matrix
of a few nonzeros a row gets 1 x 1 blocks, ELLPACK (a 5-point stencil: K = 5
values and indices a row, against 8 x 128 blocks 99% zeros); a matrix of
dense 8 x 128 blocks keeps them.  The 8 x 128 shape is the TPU kernel's
Mosaic tiling, which nothing on a card needs.

``bell_spmv`` on a CUDA tensor launches the kernel of ``csrc/spmv.cu`` or
raises: a failed build, a refused launch or an unsupported tensor is an
error, never a quiet switch to another path.  The kernel has two designs,
chosen by ``bn``: a warp a block-row for ``bn > 1``, and at ``bn == 1`` the
row design, a thread an output row over warp-staged coalesced loads, whose
bound is the bytes of ``data`` and ``cols`` (``csrc/spmv.cu`` says how each
is laid out).  On a CPU tensor it computes the plain version,
:func:`bell_spmv_reference`.  It counts its kernel launches in the counter
``launches.bell_spmv`` (:func:`..utils.timer.count_event`), and those of the
row design, from either wrapper, also in ``launches.bell_rows``.
:func:`bell_spmm` is the batched form,
``Y = A X`` for up to :data:`MAX_SPMM_COLUMNS` vectors in one launch that
reads the matrix once, counted in ``launches.bell_spmm``;
``BellOperator.matvec_basis`` goes through it, so a block Krylov step is one
launch (one a slice of :data:`MAX_SPMM_COLUMNS` vectors for a wider block).
``BellOperator.rmatvec`` is plain torch (an einsum and an ``index_add_``),
as the JAX one is plain XLA.

``bell_from_scipy`` builds the layout where the matrix will live: for a
card, from the CSR's three arrays moved there, with torch operations
(:func:`bell_assemble_torch`); for the CPU, on the host through the native
assembler or numpy.  All three give the same ``data`` and ``cols`` to the
bit.  Timing on (:func:`..utils.timer.set_timing`), the assembly is a host
span ``bell.assemble`` and each kernel launch of :class:`BellOperator` a
device span ``bell.spmv``; the counter ``bell.nnz_applied`` adds the
matrix's ``nnz`` for every vector an application multiplies, timing on or
off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_numpy_dtype, resolve_device
from ..linops import LinearOperator
from ..utils.timer import count_event, host_read, timed
from . import _build

__all__ = ["BellMatrix", "bell_assemble_torch", "bell_block_shape", "bell_from_scipy",
           "bell_spmm", "bell_spmm_reference", "bell_spmv", "bell_spmv_reference",
           "BellOperator", "FITTED_SHAPES", "MAX_SPMM_COLUMNS"]

#: The most vectors :func:`bell_spmm` takes in one launch (the kernel keeps
#: each vector's partial sums in registers).
MAX_SPMM_COLUMNS = 8

#: The block shapes :func:`bell_from_scipy` chooses between for a card, each
#: with a kernel design of its own: 1 x 1 (the row design) and 8 x 128, the
#: JAX package's default (the warp-per-block-row design), which takes ties.
FITTED_SHAPES = ((1, 1), (8, 128))

#: The C entries of ``csrc/spmv.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    **{f"lk_bell_spmv_{t}": "pppp liii p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_bell_spmm_{t}": "pppp illiii p" for t in _build.DTYPE_TAGS.values()},
})


class BellMatrix:
    """A Block-ELL matrix: ``data`` and ``cols`` tensors on one device, the
    logical ``shape`` (m, n) and the number of true scalar nonzeros
    ``nnz``.  ``bell_from_scipy`` also sets ``fill_ratio``, the share of
    stored values that are nonzeros."""

    def __init__(self, data, cols, shape, nnz: int):
        self.data = data      # (nbr, K, bm, bn)
        self.cols = cols      # (nbr, K) int32
        self.shape = tuple(shape)
        self.nnz = nnz

    @property
    def bm(self):
        return self.data.shape[2]

    @property
    def bn(self):
        return self.data.shape[3]

    @property
    def K(self):
        return self.data.shape[1]


def bell_from_scipy(A, bm: int | None = None, bn: int | None = None, dtype=np.float32,
                    device=None) -> BellMatrix:
    """Convert a scipy sparse (or dense) matrix to Block-ELL on ``device``
    (default: :func:`..constants.default_device`, the card), in ``(bm, bn)``
    blocks.

    Given neither ``bm`` nor ``bn``, a CUDA device takes the shape of
    :func:`bell_block_shape`, the one of :data:`FITTED_SHAPES` that stores
    fewer bytes; any other device, or a shape given in part, takes the JAX
    package's 8 x 128 for what is not given.  On a CUDA device the layout is
    built there from the CSR's arrays (:func:`bell_assemble_torch`), so no
    padded copy of it exists on the host.  Otherwise real float32/float64 go
    through the native assembler when it is available (:mod:`..native`),
    anything else through numpy.  Each gives the layout of the JAX package
    (its ``spmv.py:62-105``) for the same shape."""
    import scipy.sparse as sp

    dtype = as_numpy_dtype(dtype)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    device = resolve_device(device)
    if bm is None and bn is None and device.type == "cuda":
        bm, bn = bell_block_shape(A, dtype)
    bm, bn = 8 if bm is None else bm, 128 if bn is None else bn
    with timed("bell.assemble", "ops"):
        if device.type == "cuda":
            data, cols = bell_assemble_torch(A, bm, bn, dtype, device)
        else:
            data, cols = (torch.from_numpy(a).to(device)
                          for a in _bell_assemble_host(A, bm, bn, dtype))
    mat = BellMatrix(data, cols, A.shape, A.nnz)
    mat.fill_ratio = A.nnz / data.numel() if data.numel() else 1.0
    return mat


def bell_block_shape(A, dtype=np.float32) -> tuple:
    """The block shape of :data:`FITTED_SHAPES` whose Block-ELL layout of
    ``A`` (a scipy CSR matrix, duplicates summed) stores fewer bytes of
    ``data`` and ``cols`` in ``dtype``; 8 x 128 on a tie.

    At 1 x 1, ``K`` is the longest row, read from ``indptr``.  At 8 x 128 a
    block holds at most 1024 values, so the fullest block-row's nonzeros over
    1024 bound ``K`` from below; only when that bound's bytes do not already
    exceed the 1 x 1 layout's are the distinct blocks counted (on the host)."""
    m = A.shape[0]
    item = np.dtype(as_numpy_dtype(dtype)).itemsize
    row_nnz = np.diff(A.indptr)
    k_rows = max(int(row_nnz.max()), 1) if m else 1
    rows_bytes = m * k_rows * (item + 4)
    bm, bn = FITTED_SHAPES[1]
    nbr = -(-m // bm)
    block_row_nnz = np.diff(A.indptr[np.minimum(np.arange(nbr + 1) * bm, m)])
    k_least = max(-(-int(block_row_nnz.max()) // (bm * bn)), 1) if nbr else 1
    blocks_bytes = nbr * k_least * (bm * bn * item + 4)
    if blocks_bytes <= rows_bytes:
        blocks_bytes = nbr * _blocks_a_row(A, bm, bn) * (bm * bn * item + 4)
    return FITTED_SHAPES[0] if rows_bytes < blocks_bytes else FITTED_SHAPES[1]


def _blocks_a_row(A, bm: int, bn: int) -> int:
    """``K`` of the ``(bm, bn)`` Block-ELL layout of the CSR matrix ``A``:
    the most distinct blocks in a block-row, at least 1."""
    m, n = A.shape
    if A.nnz == 0:
        return 1
    nbc = -(-n // bn)
    br = np.repeat(np.arange(m, dtype=np.int64) // bm, np.diff(A.indptr))
    uniq = np.unique(br * nbc + A.indices.astype(np.int64) // bn)
    return int(np.bincount(uniq // nbc).max())


def _bell_assemble_host(A, bm: int, bn: int, dtype):
    """``(data, cols)`` numpy arrays of the Block-ELL layout of the CSR
    matrix ``A`` (duplicates summed), through the native assembler or
    numpy."""
    from .. import native

    if dtype in (np.float32, np.float64) and native.available():
        data, cols, _ = native.bell_assemble(A, bm, bn, dtype)
        return data, cols
    m, n = A.shape
    nbr = -(-m // bm)
    nbc = -(-n // bn)
    coo = A.tocoo()
    br = coo.row.astype(np.int64) // bm
    bc = coo.col.astype(np.int64) // bn
    uniq, inv = np.unique(br * nbc + bc, return_inverse=True)
    ubr = uniq // nbc
    # uniq is sorted by (block-row, block-col): the slot of each unique
    # block is its rank within its block-row
    slot_of_uniq = np.arange(len(uniq)) - np.searchsorted(ubr, np.arange(nbr))[ubr]
    K = max(int(slot_of_uniq.max()) + 1, 1) if len(uniq) else 1
    data = np.zeros((nbr, K, bm, bn), dtype)
    cols = np.zeros((nbr, K), np.int32)
    cols[ubr, slot_of_uniq] = (uniq % nbc).astype(np.int32)
    data[br, slot_of_uniq[inv], coo.row % bm, coo.col % bn] = coo.data.astype(dtype)
    return data, cols


def bell_assemble_torch(A, bm: int, bn: int, dtype, device):
    """``(data, cols)`` of the Block-ELL layout of the CSR matrix ``A``
    (duplicates summed) built on ``device`` with torch operations: the CSR's
    three arrays are all that crosses from the host.

    Each nonzero's block-row and block-column give its block; the distinct
    blocks, sorted by (block-row, block-column), give each block its slot,
    its rank among its block-row's; ``K`` is the largest count (one read to
    the host), padding slots point at block-column 0 with zero values, and
    one scatter writes each value, cast from ``A``'s dtype as numpy casts,
    into a zeroed ``(nbr, K, bm, bn)`` tensor.  Every entry is written once,
    so the layout is the host assemblers' to the bit.  At 1 x 1 blocks the
    block keys are not needed (:func:`_rows_assemble_torch`)."""
    if bm == bn == 1:
        return _rows_assemble_torch(A, dtype, device)
    m, n = A.shape
    nbr, nbc = -(-m // bm), -(-n // bn)
    vals = torch.from_numpy(np.ascontiguousarray(A.data.astype(dtype, copy=False))).to(device)
    col = torch.from_numpy(np.ascontiguousarray(A.indices)).to(device).long()
    counts = torch.from_numpy(np.diff(A.indptr)).to(device)
    row = torch.repeat_interleave(torch.arange(m, device=device), counts,
                                  output_size=len(vals))
    br = row // bm
    uniq, inv = torch.unique(br * nbc + col // bn, sorted=True, return_inverse=True)
    ubr = uniq // nbc
    first = torch.searchsorted(ubr, torch.arange(nbr, device=device))
    slot = torch.arange(len(uniq), device=device) - first[ubr]
    K = max(int(host_read(slot.max())) + 1, 1) if len(uniq) else 1
    cols = torch.zeros((nbr, K), dtype=torch.int32, device=device)
    cols[ubr, slot] = (uniq % nbc).to(torch.int32)
    flat = ((br * K + slot[inv]) * bm + row % bm) * bn + col % bn
    del row, col, counts, br, uniq, inv, ubr, first, slot
    data = torch.zeros((nbr, K, bm, bn), dtype=vals.dtype, device=device)
    data.view(-1)[flat] = vals
    return data, cols


def _rows_assemble_torch(A, dtype, device):
    """``(data, cols)`` of the 1 x 1 layout (ELLPACK) of the CSR matrix
    ``A`` (duplicates summed, so its columns are sorted in each row) on
    ``device``: ``K`` is the longest row, a nonzero's slot is its place in
    its row, and one scatter each writes the values into a zeroed ``(m, K,
    1, 1)`` tensor and the columns into an ``(m, K)`` one, whose padding
    slots stay at column 0.  The layout is the host assemblers' at 1 x 1 to
    the bit."""
    m = A.shape[0]
    row_nnz = np.diff(A.indptr)
    K = max(int(row_nnz.max()), 1) if m else 1
    vals = torch.from_numpy(np.ascontiguousarray(A.data.astype(dtype, copy=False))).to(device)
    col = torch.from_numpy(np.ascontiguousarray(A.indices)).to(device).to(torch.int32)
    first = torch.from_numpy(A.indptr[:-1].astype(np.int64)).to(device)
    row = torch.repeat_interleave(torch.arange(m, device=device),
                                  torch.from_numpy(row_nnz).to(device), output_size=len(vals))
    flat = row * K + torch.arange(len(vals), device=device) - first[row]
    del row, first
    data = torch.zeros((m, K, 1, 1), dtype=vals.dtype, device=device)
    data.view(-1)[flat] = vals
    cols = torch.zeros((m, K), dtype=torch.int32, device=device)
    cols.view(-1)[flat] = col
    return data, cols


def bell_spmv_reference(data, cols, x_padded):
    """Plain PyTorch version of the kernel: gather the ``x`` block of every
    stored block by ``cols``, one batched product per block, then the sum
    over the ``K`` blocks of each block-row."""
    nbr, K, bm, bn = data.shape
    xb = x_padded.reshape(-1, bn)[cols.long()]           # (nbr, K, bn)
    return torch.einsum("rkij,rkj->rki", data, xb).sum(1).reshape(-1)


def bell_spmm_reference(data, cols, X_padded):
    """Plain PyTorch version of the batched kernel: the einsum of
    :func:`bell_spmv_reference` with a leading batch axis, ``(p, n_p) ->
    (p, nbr * bm)``."""
    nbr, K, bm, bn = data.shape
    p = X_padded.shape[0]
    xb = X_padded.reshape(p, -1, bn)[:, cols.long()]     # (p, nbr, K, bn)
    return torch.einsum("rkij,prkj->pri", data, xb).reshape(p, -1)


def _launch(data, cols, x_padded, batched: bool = False):
    """Check the tensors, allocate the output and launch the CUDA kernel on
    the current stream: one vector ``(n_p,)``, or with ``batched`` a stack
    ``(p, n_p)``."""
    tensors = {"data": data, "cols": cols, "x": x_padded}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"bell_spmv kernel: expected a CUDA tensor, got {name} "
                             f"on {t.device}")
        if t.device != data.device:
            raise ValueError("bell_spmv kernel: data, cols and x must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"bell_spmv kernel: {name} must be contiguous")
    tag = _build.dtype_tag(data.dtype, "bell_spmv kernel")
    if x_padded.dtype != data.dtype:
        raise TypeError(f"bell_spmv kernel: x is {x_padded.dtype}, data {data.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"bell_spmv kernel: cols must be int32, got {cols.dtype}")
    if data.ndim != 4 or 0 in data.shape:
        raise ValueError(f"bell_spmv kernel: data must be a non-empty (nbr, K, bm, bn) "
                         f"tensor, got shape {tuple(data.shape)}")
    nbr, K, bm, bn = data.shape
    if tuple(cols.shape) != (nbr, K):
        raise ValueError(f"bell_spmv kernel: cols has shape {tuple(cols.shape)}, "
                         f"expected {(nbr, K)}")
    ndim = 2 if batched else 1
    n_p = x_padded.shape[-1] if x_padded.ndim == ndim else 0
    if n_p == 0 or n_p % bn:
        what = "a (p, n_p) stack" if batched else "1-D"
        raise ValueError(f"bell_spmv kernel: x must be {what}, padded to a non-zero "
                         f"multiple of bn={bn}, got shape {tuple(x_padded.shape)}")
    p = x_padded.shape[0] if batched else 1
    if not 1 <= p <= MAX_SPMM_COLUMNS:
        raise ValueError(f"bell_spmm kernel: {p} vectors, it takes 1 to "
                         f"{MAX_SPMM_COLUMNS} a launch")
    if K >= 2**31 or bm * bn >= 2**31:
        raise ValueError(f"bell_spmv kernel: K={K} or a {bm}x{bn} block is too large")
    lib = _build.load()
    y = torch.empty((p, nbr * bm) if batched else (nbr * bm,), dtype=data.dtype,
                    device=data.device)
    ptrs = (data.data_ptr(), cols.data_ptr(), x_padded.data_ptr(), y.data_ptr())
    if batched:
        _build.launch(lib, ENTRIES.on(lib)[f"lk_bell_spmm_{tag}"], "bell_spmv",
                      data.device.index, *ptrs, p, n_p, nbr, K, bm, bn)
    else:
        _build.launch(lib, ENTRIES.on(lib)[f"lk_bell_spmv_{tag}"], "bell_spmv",
                      data.device.index, *ptrs, nbr, K, bm, bn)
    return y


def bell_spmv(data, cols, x_padded, interpret: bool = False, rows_per_step: int = 32):
    """``y = A x`` for a Block-ELL matrix; ``x_padded`` is the ``(n_p,)``
    vector zero-padded to the block grid, ``y`` has ``nbr * bm`` entries.

    ``cols`` must hold block-columns in ``[0, n_p / bn)``; the kernel does
    not check them (:class:`BellOperator` does, once).  ``interpret`` and
    ``rows_per_step`` are accepted for parity with the JAX signature and do
    not change the result."""
    if data.device.type == "cpu":
        return bell_spmv_reference(data, cols, x_padded)
    y = _launch(data, cols, x_padded)
    count_event("launches.bell_spmv")
    _count_rows(data)
    return y


def _count_rows(data):
    """Count a launch of the row design, which ``bn == 1`` takes."""
    if data.shape[3] == 1:
        count_event("launches.bell_rows")


def bell_spmm(data, cols, X_padded):
    """``Y = A X`` for a Block-ELL matrix and a ``(p, n_p)`` stack of
    vectors zero-padded to the block grid, ``1 <= p <=``
    :data:`MAX_SPMM_COLUMNS`, in one launch: the counterpart of ``jax.vmap``
    over the Pallas kernel, which the JAX package's block Krylov methods
    make.  ``Y`` is ``(p, nbr * bm)``; ``cols`` is not checked, as in
    :func:`bell_spmv`."""
    if data.device.type == "cpu":
        return bell_spmm_reference(data, cols, X_padded)
    y = _launch(data, cols, X_padded, batched=True)
    count_event("launches.bell_spmm")
    _count_rows(data)
    return y


class BellOperator(LinearOperator):
    """Operator over a Block-ELL matrix, on rank-1 tensors of length
    ``shape[1]``; counterpart of the JAX ``BellOperator``.  ``matvec`` goes
    through :func:`bell_spmv`; ``rmatvec`` is ``matvec`` when
    ``is_hermitian``, else the transposed product as an einsum over the
    blocks and a scatter-add into the block-columns (``index_add_``, whose
    CUDA atomics make the float32 sum order vary from run to run).

    The constructor checks once that every block-column index lies in the
    block grid (one read of ``cols``'s range to the host).  Each launch of
    ``matvec`` and ``matvec_basis`` is a device span ``bell.spmv`` and adds
    ``nnz`` a vector to the counter ``bell.nnz_applied``."""

    def __init__(self, bell: BellMatrix, is_hermitian: bool = False,
                 interpret: bool = False, rows_per_step: int = 32):
        self.data = bell.data
        self.cols = bell.cols
        self.shape = tuple(bell.shape)
        self.nnz = bell.nnz
        self.is_hermitian = is_hermitian
        self.interpret = interpret
        self.rows_per_step = rows_per_step
        nbr, _, bm, bn = self.data.shape
        if nbr * bm < self.shape[0] or self.cols.shape != (nbr, bell.K):
            raise ValueError(f"BellOperator: blocks {tuple(self.data.shape)} and cols "
                             f"{tuple(self.cols.shape)} do not cover shape {self.shape}")
        lo, hi = host_read(torch.stack([self.cols.min(), self.cols.max()]))
        if lo < 0 or hi >= self._n_padded() // bn:
            raise ValueError(f"BellOperator: block-column indices in [{lo}, {hi}], "
                             f"outside [0, {self._n_padded() // bn})")

    def _n_padded(self):
        bn = self.data.shape[3]
        return -(-self.shape[1] // bn) * bn

    def template(self):
        return torch.zeros((self.shape[1],), dtype=self.data.dtype, device=self.data.device)

    def matvec(self, x):
        n_p = self._n_padded()
        x_p = torch.nn.functional.pad(x, (0, n_p - x.shape[0])) if n_p != x.shape[0] else x
        with timed("bell.spmv", "ops", device=True):
            y = bell_spmv(self.data, self.cols, x_p, interpret=self.interpret,
                          rows_per_step=self.rows_per_step)
        count_event("bell.nnz_applied", self.nnz)
        return y[: self.shape[0]]

    def matvec_basis(self, X):
        """The stacked block ``X`` (``(p, shape[1])``) through
        :func:`bell_spmm`, padded once: one launch a block for ``p`` up to
        :data:`MAX_SPMM_COLUMNS`, and for a larger ``p`` one launch for each
        slice of at most that many rows, each counted."""
        n_p = self._n_padded()
        X_p = torch.nn.functional.pad(X, (0, n_p - X.shape[1])) if n_p != X.shape[1] else X
        Y = []
        for i in range(0, X_p.shape[0], MAX_SPMM_COLUMNS):
            with timed("bell.spmv", "ops", device=True):
                Y.append(bell_spmm(self.data, self.cols, X_p[i:i + MAX_SPMM_COLUMNS]))
            count_event("bell.nnz_applied", self.nnz * Y[-1].shape[0])
        return (Y[0] if len(Y) == 1 else torch.cat(Y))[:, : self.shape[0]]

    def rmatvec_basis(self, Y):
        """:meth:`matvec_basis` when ``is_hermitian``, else one transposed
        product a column."""
        if self.is_hermitian:
            return self.matvec_basis(Y)
        return super().rmatvec_basis(Y)

    def rmatvec(self, y):
        if self.is_hermitian:
            return self.matvec(y)
        nbr, K, bm, bn = self.data.shape
        yb = torch.nn.functional.pad(y, (0, nbr * bm - y.shape[0])).reshape(nbr, bm)
        contrib = torch.einsum("rkms,rm->rks", self.data.conj(), yb)   # (nbr, K, bn)
        out = torch.zeros((self._n_padded() // bn, bn), dtype=contrib.dtype, device=y.device)
        out.index_add_(0, self.cols.reshape(-1).long(), contrib.reshape(-1, bn))
        return out.reshape(-1)[: self.shape[1]]
