"""Row-partitioned Block-ELL SpMV over a 1-D mesh.

Counterpart of :mod:`lightkrylov_tpu.parallel.bell`, the general-sparse
half of SURVEY.md §2 parallelism item 2: the block-rows of a square
Block-ELL matrix (:mod:`..ops.spmv`) are cut over the mesh, and a vector is
cut the same way.  A general sparse matrix reaches any column, so the
"halo" of a matvec is the whole vector: ``x`` is gathered over the group
(one ``all_gather``), padded to the block grid as the JAX body does, and
the Block-ELL kernel (:func:`..ops.spmv.bell_spmv`, ``csrc/spmv.cu``) runs
on this rank's block-rows, whose column indices stay global.  The output
rows come out partitioned like the input.  The adjoint scatters this rank's
transposed contributions into the whole column space and sums them over
the group with one ``all_reduce``, then keeps this rank's rows.

The JAX operator asks for a block-row count that divides over the mesh in
multiples of 8, the Pallas kernel's row tile; the port's kernel has no
such tile, so the count need only divide by the mesh size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..linops import LinearOperator
from ..ops.spmv import BellMatrix, bell_spmv
from ..utils.timer import count_collective, host_read, timed
from .mesh import Mesh, shard_rows
from .stencil import linear_apply

__all__ = ["ShardedBellOperator"]


class ShardedBellOperator(LinearOperator):
    """Square Block-ELL operator with block-rows partitioned over a 1-D mesh.

    Built from the global :class:`..ops.spmv.BellMatrix` (on any device, or
    numpy), whose logical shape must equal its block grid and whose
    block-row count and order must divide by the mesh size; each rank keeps
    its block-rows on the mesh's device.  A vector is this rank's
    ``n / P`` entries."""

    def __init__(self, bell: BellMatrix, *, mesh: Mesh, is_hermitian: bool = False,
                 interpret: bool = False):
        m, n = bell.shape
        data, cols = torch.as_tensor(bell.data), torch.as_tensor(bell.cols)
        nbr, K, bm, bn = data.shape
        if m != n:
            raise ValueError(f"ShardedBellOperator requires a square operator, got {bell.shape}")
        if nbr % mesh.size:
            raise ValueError(f"block-row count {nbr} must divide over {mesh.size} ranks; "
                             "pad at assembly")
        if m != nbr * bm or n % bn or n % mesh.size:
            raise ValueError(
                "ShardedBellOperator requires the logical shape to equal the block grid "
                "(pad the matrix to multiples of the block size at assembly time)")
        rows = shard_rows(mesh, nbr)
        self.mesh = mesh
        self.shape = (m, n)
        self.nnz = bell.nnz
        self.is_hermitian = is_hermitian
        self.interpret = interpret
        self.data = data[rows].to(mesh.device).contiguous()
        self.cols = cols[rows].to(mesh.device, torch.int32).contiguous()
        lo, hi = host_read(torch.stack([self.cols.min(), self.cols.max()]))
        if lo < 0 or hi >= n // bn:
            raise ValueError(f"ShardedBellOperator: block-column indices in [{lo}, {hi}], "
                             f"outside [0, {n // bn})")

    def template(self):
        return torch.zeros((self.shape[1] // self.mesh.size,), dtype=self.data.dtype,
                           device=self.mesh.device)

    def matvec(self, x):
        return linear_apply(self, False, x)

    def rmatvec(self, y):
        if self.is_hermitian:
            return self.matvec(y)
        return linear_apply(self, True, y)

    def _apply(self, v, adjoint):
        mesh = self.mesh
        if not adjoint or self.is_hermitian:
            x_full = v
            if mesh.group is not None:
                count_collective("operator_collectives")
                parts = [torch.empty_like(v) for _ in range(mesh.size)]
                with timed("halo", "parallel", device=True):
                    dist.all_gather(parts, v.contiguous(), group=mesh.group)
                x_full = torch.cat(parts)
            return bell_spmv(self.data, self.cols, x_full, interpret=self.interpret)
        nbr, K, bm, bn = self.data.shape
        contrib = torch.einsum("rkms,rm->rks", self.data.conj(), v.reshape(nbr, bm))
        out = torch.zeros((self.shape[1] // bn, bn), dtype=contrib.dtype, device=v.device)
        out.index_add_(0, self.cols.reshape(-1).long(), contrib.reshape(-1, bn))
        out = out.reshape(-1)
        if mesh.group is not None:
            count_collective("operator_collectives")
            with timed("halo", "parallel", device=True):
                dist.all_reduce(out, group=mesh.group)
        return out[shard_rows(mesh, self.shape[1])]
