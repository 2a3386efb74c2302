"""5-point Laplacian stencil matvec through the hand-written CUDA kernel.

Counterpart of :mod:`lightkrylov_tpu.ops.pallas.stencil`.  Both Pallas
kernels there, ``stencil_matvec`` and the x-tiled ``stencil_matvec_2d``,
compute the same function; here both wrappers launch the one CUDA kernel of
``csrc/stencil.cu``, which takes any ``(ny, nx)`` without padding.

For a CUDA tensor a wrapper launches the kernel or raises: a failed build,
a refused launch or an unsupported tensor is an error, never a quiet switch
to another path.  For a CPU tensor it computes the plain version,
:func:`stencil_matvec_reference`.  Each wrapper counts its kernel launches
in the counter ``launches.<wrapper>`` (:func:`..utils.timer.count_event`).
:func:`stencil_matvec_batched` applies the operator to a stack of fields in
one launch; ``CudaPoisson2D.matvec_basis`` goes through it, so a block
Krylov step is one launch.

The v5e VMEM tuning of the JAX module (``effective_tile``,
``DEFAULT_VMEM_BUDGET``, ``auto_poisson2d``) is not carried over.
"""

from __future__ import annotations

import torch

from ..constants import as_torch_dtype, resolve_device
from ..linops import LinearOperator
from ..utils.timer import count_event
from . import _build

__all__ = ["stencil_matvec", "stencil_matvec_2d", "stencil_matvec_batched",
           "stencil_matvec_reference", "CudaPoisson2D"]

#: The C entries of ``csrc/stencil.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    **{f"lk_stencil_{t}": "ppii ddd p" for t in _build.DTYPE_TAGS.values()},
    **{f"lk_stencil_batched_{t}": "ppiii ddd p" for t in _build.DTYPE_TAGS.values()},
})


def stencil_matvec_reference(u, *, ihx2: float, ihy2: float):
    """Plain PyTorch version of the kernel, and the matvec of
    :class:`lightkrylov_tpu_torch.models.Poisson2D`: shifted neighbours from
    zero-padded copies (the Dirichlet boundary), as in the JAX
    ``Poisson2D.matvec``.  The grid is the last two axes; leading axes are a
    batch of fields, each with its own boundary."""
    un = torch.nn.functional.pad(u, (1, 1))        # pad x
    left, right = un[..., :-2], un[..., 2:]
    um = torch.nn.functional.pad(u, (0, 0, 1, 1))  # pad y
    down, up = um[..., :-2, :], um[..., 2:, :]
    return (2.0 * (ihx2 + ihy2)) * u - ihx2 * (left + right) - ihy2 * (down + up)


def _launch(u, ihx2: float, ihy2: float, batched: bool = False):
    """Check ``u``, allocate the output and launch the CUDA kernel on the
    current stream: on one ``(ny, nx)`` grid, or with ``batched`` on each
    field of a ``(p, ny, nx)`` stack."""
    if u.device.type != "cuda":
        raise ValueError(f"stencil kernel: expected a CUDA tensor, got {u.device}")
    tag = _build.dtype_tag(u.dtype, "stencil kernel")
    ndim = 3 if batched else 2
    if u.ndim != ndim or 0 in u.shape:
        what = "(p, ny, nx) stack of grids" if batched else "2-D grid"
        raise ValueError(f"stencil kernel: expected a non-empty {what}, "
                         f"got shape {tuple(u.shape)}")
    if batched and u.shape[0] * -(-u.shape[1] // 16) > 65535:
        raise ValueError(f"stencil kernel: {u.shape[0]} fields of {u.shape[1]} rows exceed "
                         "65535 segments of 16 rows a launch")
    if not u.is_contiguous():
        raise ValueError("stencil kernel: the grid must be contiguous")
    lib = _build.load()
    entry = ENTRIES.on(lib)[f"lk_stencil_batched_{tag}" if batched else f"lk_stencil_{tag}"]
    out = torch.empty_like(u)
    _build.launch(lib, entry, "stencil", u.device.index, u.data_ptr(), out.data_ptr(), *u.shape,
                  2.0 * (ihx2 + ihy2), ihx2, ihy2)
    return out


def stencil_matvec(u, *, ihx2: float, ihy2: float, tile: int = 256):
    """5-point ``-Delta`` matvec of the ``(ny, nx)`` grid ``u``.

    ``tile`` is accepted for parity with the JAX signature; the kernel's
    tiling is fixed and the result does not depend on it."""
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    out = _launch(u, ihx2, ihy2)
    count_event("launches.stencil_matvec")
    return out


def stencil_matvec_2d(u, *, ihx2: float, ihy2: float, tile_y: int = 256,
                      tile_x: int = 1024):
    """Counterpart of the x-tiled Pallas variant.  It launches the same
    kernel as :func:`stencil_matvec`; ``tile_y``/``tile_x`` are accepted for
    parity with the JAX signature and do not change the result."""
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    out = _launch(u, ihx2, ihy2)
    count_event("launches.stencil_matvec_2d")
    return out


def stencil_matvec_batched(u, *, ihx2: float, ihy2: float):
    """5-point ``-Delta`` matvec of each field of the ``(p, ny, nx)`` stack
    ``u`` in one launch: the counterpart of ``jax.vmap`` over the Pallas
    kernel, which the JAX package's block Krylov methods make."""
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    out = _launch(u, ihx2, ihy2, batched=True)
    count_event("launches.stencil_matvec_batched")
    return out


class CudaPoisson2D(LinearOperator):
    """The Poisson operator of :class:`~lightkrylov_tpu_torch.models.Poisson2D`
    (same grid, spacing and SPD matrix) applied by the CUDA kernel;
    counterpart of ``PallasPoisson2D``.  With ``tile_x`` set it goes through
    :func:`stencil_matvec_2d`, as the JAX operator does.  ``device`` (default:
    :func:`..constants.default_device`, the card) is where :meth:`template`
    allocates."""

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, dtype=torch.float32,
                 tile: int = 256, tile_x: int | None = None, device=None):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = as_torch_dtype(dtype)
        self.tile = tile
        self.tile_x = tile_x
        self.device = resolve_device(device)

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def template(self):
        return torch.zeros((self.ny, self.nx), dtype=self.dtype_, device=self.device)

    def matvec(self, u):
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        if self.tile_x is not None:
            return stencil_matvec_2d(u, ihx2=ihx2, ihy2=ihy2,
                                     tile_y=self.tile, tile_x=self.tile_x)
        return stencil_matvec(u, ihx2=ihx2, ihy2=ihy2, tile=self.tile)

    def rmatvec(self, u):
        return self.matvec(u)

    def matvec_basis(self, X):
        """All fields of the stacked block ``X`` (``(p, ny, nx)``) in one
        batched launch, whatever ``tile``/``tile_x`` say."""
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2
        return stencil_matvec_batched(X, ihx2=ihx2, ihy2=ihy2)

    def rmatvec_basis(self, Y):
        return self.matvec_basis(Y)
