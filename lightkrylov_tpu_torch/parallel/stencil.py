"""Row-partitioned stencil operators with a one-row halo exchange.

Counterpart of :mod:`lightkrylov_tpu.parallel.stencil` (SURVEY.md §2 item
2; BASELINE config 5, the 10M-DoF partitioned Poisson): the grid's rows are
cut over a 1-D mesh (:mod:`.mesh`), each rank applies the operator to its
own row block, and the rows beyond the block's ends come from the
neighbouring ranks.

The JAX package exchanges them with two non-cyclic ``ppermute`` calls.
Here the exchange is ONE ``all_gather`` of each rank's first and last rows
(:func:`halo_rows`): gloo carries no CUDA tensor through ``send``/``recv``,
every backend carries ``all_gather``, and it posts no point-to-point
operation that the end ranks could leave unmatched.  The ranks at the
global edges take zeros, the homogeneous Dirichlet condition, as the
non-cyclic ``ppermute`` delivers.

``ShardedPoisson2D`` with ``kernel="cuda"`` runs the stencil kernel
(:func:`..ops.stencil.stencil_matvec`, ``csrc/stencil.cu``) on the local
block with its zero edges, then adds the neighbours' rows as the rank-1
corrections ``-ihy2 * halo`` to its first and last rows (the JAX
``_stencil_shard_pallas``).  That wrapper launches the kernel on a CUDA
tensor and computes the plain version on a CPU tensor.
``kernel="plain"`` is the JAX ``_stencil_shard`` body: shifted neighbours
with the halo rows spliced in.  ``ShardedGinzburgLandau`` is plain torch, as
in the JAX package.

Under a ``torch.func`` transform or autograd, each operator's matvec is a
``torch.autograd.Function`` whose ``jvp`` is the matvec and whose
``backward`` the adjoint (exact: the operators are linear), with a ``vmap``
rule that applies it column by column: ``torch.func`` does not trace
through the in-place c10d collectives, and
:class:`..systems.JacobianOperator` differentiates through the matvec.  A
plain tensor that asks for no gradient skips the Function and its per-call
argument binding (:func:`linear_apply`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._C._functorch import is_functorch_wrapped_tensor

from ..constants import as_torch_dtype
from ..linops import LinearOperator
from ..models.ginzburg_landau import GAMMA, NU, _mu
from ..ops.stencil import stencil_matvec
from ..utils.timer import count_collective, timed
from .mesh import Mesh, shard_rows

__all__ = ["ShardedPoisson2D", "ShardedGinzburgLandau", "halo_rows", "linear_apply"]


def halo_rows(u, mesh: Mesh):
    """``(above, below)``: the last row of the previous rank's block and the
    first row of the next rank's, zeros beyond the global edges.  One
    ``all_gather`` of every rank's ``(first, last)`` rows, counted as an
    operator collective, and a span ``halo`` while timing is on; none
    without a group."""
    zero = torch.zeros_like(u[0])
    if mesh.group is None:
        return zero, zero
    count_collective("operator_collectives")
    edges = torch.stack([u[0], u[-1]])
    parts = [torch.empty_like(edges) for _ in range(mesh.size)]
    with timed("halo", "parallel", device=True):
        dist.all_gather(parts, edges, group=mesh.group)
    above = parts[mesh.rank - 1][1] if mesh.rank > 0 else zero
    below = parts[mesh.rank + 1][0] if mesh.rank < mesh.size - 1 else zero
    return above, below


class LinearApply(torch.autograd.Function):
    """``op._apply(x, adjoint)`` of a linear operator as a function that
    ``torch.func`` can differentiate and map: the tangent of ``A x`` is
    ``A dx``, its cotangent ``A^H g``, and a batch is applied column by
    column.  The tangent, cotangent and columns go through ``apply`` again,
    since they may still be wrapped by a transform (torch 2.11 passes the
    tangent of ``torch.func.jvp`` wrapped), and only ``forward`` sees
    plain tensors that the collectives can read."""

    @staticmethod
    def forward(op, adjoint, x):
        return op._apply(x, adjoint)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op, ctx.adjoint = inputs[0], inputs[1]

    @staticmethod
    def jvp(ctx, _op_t, _adjoint_t, x_t):
        return linear_apply(ctx.op, ctx.adjoint, x_t)

    @staticmethod
    def backward(ctx, g):
        return None, None, linear_apply(ctx.op, not ctx.adjoint, g)

    @staticmethod
    def vmap(info, in_dims, op, adjoint, x):
        if in_dims[2] is None:
            return linear_apply(op, adjoint, x), None
        cols = x.movedim(in_dims[2], 0)
        return torch.stack([linear_apply(op, adjoint, c.contiguous()) for c in cols]), 0


def linear_apply(op, adjoint: bool, x):
    """``op._apply(x, adjoint)``: through :class:`LinearApply` where a
    ``torch.func`` transform wraps ``x`` or autograd tracks it, directly
    otherwise, so that a solver's matvec pays no ``autograd.Function``
    binding on the host."""
    if x.requires_grad or is_functorch_wrapped_tensor(x):
        return LinearApply.apply(op, adjoint, x)
    return op._apply(x, adjoint)


def _stencil_shard(u, above, below, ihx2: float, ihy2: float):
    """The plain body: the 5-point ``-Delta`` of the local block, the
    x-neighbours from a zero-padded copy, the y-neighbours shifted within
    the block with the halo rows spliced in (the JAX ``_stencil_shard``)."""
    un = torch.nn.functional.pad(u, (1, 1))
    out = (2.0 * (ihx2 + ihy2)) * u - ihx2 * (un[:, :-2] + un[:, 2:])
    down = torch.cat([above[None], u[:-1]])  # u_{j-1}
    up = torch.cat([u[1:], below[None]])     # u_{j+1}
    return out - ihy2 * (down + up)


class ShardedPoisson2D(LinearOperator):
    """Negative 5-point Laplacian, row-partitioned over a 1-D mesh.

    The operator of :class:`..models.Poisson2D` (same grid, spacing, SPD);
    a vector is this rank's ``(ny / P, nx)`` row block, so ``ny`` must
    divide by the mesh size.  ``kernel`` is ``"cuda"`` (the stencil
    kernel's wrapper and the halo corrections; the JAX ``"pallas"``) or
    ``"plain"`` (the padded-shift body; the JAX ``"xla"``).  ``tile`` is
    kept for parity with the JAX signature and does not change the
    result."""

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, *, mesh: Mesh,
                 dtype=torch.float32, kernel: str = "cuda", tile: int = 256):
        if kernel not in ("cuda", "plain"):
            raise ValueError(f"kernel must be 'cuda' or 'plain', got {kernel!r}")
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = as_torch_dtype(dtype)
        self.mesh = mesh
        self.kernel = kernel
        self.tile = tile
        if self.ny % mesh.size != 0:
            raise ValueError(f"ny={self.ny} must be divisible by mesh size {mesh.size}")

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def template(self):
        """This rank's zero row block."""
        return torch.zeros((self.ny // self.mesh.size, self.nx), dtype=self.dtype_,
                           device=self.mesh.device)

    def matvec(self, u):
        return linear_apply(self, False, u)

    def rmatvec(self, u):
        return self.matvec(u)

    def _apply(self, u, adjoint):
        above, below = halo_rows(u, self.mesh)
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        if self.kernel == "plain":
            return _stencil_shard(u, above, below, ihx2, ihy2)
        out = stencil_matvec(u, ihx2=ihx2, ihy2=ihy2, tile=self.tile)
        out[0] -= ihy2 * above
        out[-1] -= ihy2 * below
        return out


class ShardedGinzburgLandau(LinearOperator):
    """Linearized complex Ginzburg-Landau operator, its ``nx`` points cut
    over a 1-D mesh with a one-point halo: the multi-process variant of
    :class:`..models.GinzburgLandau` (same physics and finite differences,
    Ginzburg_Landau.f90:24-33,127-181).  ``rmatvec`` is the adjoint form
    (conjugated coefficients, the advection term's sign flipped)."""

    def __init__(self, nx: int, L: float = 200.0, *, mesh: Mesh, dtype=torch.complex64):
        self.nx = nx
        self.L = float(L)
        self.dtype_ = as_torch_dtype(dtype)
        self.mesh = mesh
        if nx % mesh.size != 0:
            raise ValueError(f"nx={nx} must be divisible by mesh size {mesh.size}")
        mu = _mu(nx, self.L)[shard_rows(mesh, nx)]
        self.mu = torch.as_tensor(mu, dtype=self.dtype_, device=mesh.device)

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        return torch.zeros((self.nx // self.mesh.size,), dtype=self.dtype_,
                           device=self.mesh.device)

    def matvec(self, u):
        return linear_apply(self, False, u)

    def rmatvec(self, u):
        return linear_apply(self, True, u)

    def _apply(self, u, adjoint):
        left, right = halo_rows(u, self.mesh)
        um = torch.cat([left[None], u[:-1]])   # u_{i-1}
        up = torch.cat([u[1:], right[None]])   # u_{i+1}
        ux = (up - um) / (2.0 * self.dx)
        uxx = (up - 2.0 * u + um) / self.dx**2
        nu = NU.conjugate() if adjoint else -NU
        gamma = GAMMA.conjugate() if adjoint else GAMMA
        return nu * ux + gamma * uxx + self.mu * u
