"""Block-ELL sparse matrix-vector product through the hand-written CUDA kernel.

Counterpart of :mod:`lightkrylov_tpu.ops.pallas.spmv`, the general
sparse-operator tier.  The matrix is cut into ``(bm, bn)`` dense blocks
(8 x 128 by default); each block-row stores the same number ``K`` of blocks,
padded with zero blocks that point at block-column 0:

* ``data``: ``(nbr, K, bm, bn)`` block values;
* ``cols``: ``(nbr, K)`` int32 block-column indices.

``bell_spmv`` on a CUDA tensor launches the kernel of ``csrc/spmv.cu`` or
raises: a failed build, a refused launch or an unsupported tensor is an
error, never a quiet switch to another path.  On a CPU tensor it computes
the plain version, :func:`bell_spmv_reference`.  It counts its kernel
launches in ``bell_spmv.LAUNCHES``.  ``BellOperator.rmatvec`` is plain torch
(an einsum and an ``index_add_``), as the JAX one is plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_numpy_dtype, resolve_device
from ..linops import LinearOperator
from ..utils.timer import host_read
from . import _build

__all__ = ["BellMatrix", "bell_from_scipy", "bell_spmv", "bell_spmv_reference",
           "BellOperator"]


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


def bell_from_scipy(A, bm: int = 8, bn: int = 128, dtype=np.float32,
                    device=None) -> BellMatrix:
    """Convert a scipy sparse (or dense) matrix to Block-ELL on ``device``
    (default: :func:`..constants.default_device`, the card).

    Real float32/float64 go through the native assembler when it is
    available (:mod:`..native`), anything else through numpy; both give the
    layout of the JAX package (its ``spmv.py:62-105``)."""
    import scipy.sparse as sp

    from .. import native

    dtype = as_numpy_dtype(dtype)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    m, n = A.shape
    nbr = -(-m // bm)
    nbc = -(-n // bn)

    if dtype in (np.float32, np.float64) and native.available():
        data, cols, _ = native.bell_assemble(A, bm, bn, dtype)
    else:
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
    device = resolve_device(device)
    mat = BellMatrix(torch.from_numpy(data).to(device), torch.from_numpy(cols).to(device),
                     (m, n), A.nnz)
    mat.fill_ratio = A.nnz / data.size if data.size else 1.0
    return mat


def bell_spmv_reference(data, cols, x_padded):
    """Plain PyTorch version of the kernel: gather the ``x`` block of every
    stored block by ``cols``, one batched product per block, then the sum
    over the ``K`` blocks of each block-row."""
    nbr, K, bm, bn = data.shape
    xb = x_padded.reshape(-1, bn)[cols.long()]           # (nbr, K, bn)
    return torch.einsum("rkij,rkj->rki", data, xb).sum(1).reshape(-1)


def _launch(data, cols, x_padded):
    """Check the tensors, allocate the output and launch the CUDA kernel on
    the current stream."""
    tensors = {"data": data, "cols": cols, "x": x_padded}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"bell_spmv kernel: expected a CUDA tensor, got {name} "
                             f"on {t.device}")
        if t.device != data.device:
            raise ValueError("bell_spmv kernel: data, cols and x must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"bell_spmv kernel: {name} must be contiguous")
    entry = {torch.float32: "lk_bell_spmv_f32",
             torch.float64: "lk_bell_spmv_f64"}.get(data.dtype)
    if entry is None:
        raise TypeError(f"bell_spmv kernel: dtype {data.dtype} not supported "
                        "(float32 or float64)")
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
    if x_padded.ndim != 1 or x_padded.shape[0] == 0 or x_padded.shape[0] % bn:
        raise ValueError(f"bell_spmv kernel: x must be 1-D, padded to a non-zero "
                         f"multiple of bn={bn}, got shape {tuple(x_padded.shape)}")
    if K >= 2**31 or bm * bn >= 2**31:
        raise ValueError(f"bell_spmv kernel: K={K} or a {bm}x{bn} block is too large")
    lib = _build.load()
    y = torch.empty(nbr * bm, dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = getattr(lib, entry)(data.data_ptr(), cols.data_ptr(), x_padded.data_ptr(),
                                  y.data_ptr(), nbr, K, bm, bn, stream)
    if err:
        raise RuntimeError(f"bell_spmv kernel launch failed: CUDA error {err} "
                           f"({lib.lk_error_string(err).decode()})")
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
    bell_spmv.LAUNCHES += 1
    return y


bell_spmv.LAUNCHES = 0


class BellOperator(LinearOperator):
    """Operator over a Block-ELL matrix, on rank-1 tensors of length
    ``shape[1]``; counterpart of the JAX ``BellOperator``.  ``matvec`` goes
    through :func:`bell_spmv`; ``rmatvec`` is ``matvec`` when
    ``is_hermitian``, else the transposed product as an einsum over the
    blocks and a scatter-add into the block-columns (``index_add_``, whose
    CUDA atomics make the float32 sum order vary from run to run).

    The constructor checks once that every block-column index lies in the
    block grid (one read of ``cols``'s range to the host)."""

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
        y = bell_spmv(self.data, self.cols, x_p, interpret=self.interpret,
                      rows_per_step=self.rows_per_step)
        return y[: self.shape[0]]

    def rmatvec(self, y):
        if self.is_hermitian:
            return self.matvec(y)
        nbr, K, bm, bn = self.data.shape
        yb = torch.nn.functional.pad(y, (0, nbr * bm - y.shape[0])).reshape(nbr, bm)
        contrib = torch.einsum("rkms,rm->rks", self.data.conj(), yb)   # (nbr, K, bn)
        out = torch.zeros((self._n_padded() // bn, bn), dtype=contrib.dtype, device=y.device)
        out.index_add_(0, self.cols.reshape(-1).long(), contrib.reshape(-1, bn))
        return out.reshape(-1)[: self.shape[1]]
