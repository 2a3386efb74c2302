"""5-point Laplacian stencil matvec through the hand-written CUDA kernel.

Counterpart of :mod:`lightkrylov_tpu.ops.pallas.stencil`.  Both Pallas
kernels there, ``stencil_matvec`` and the x-tiled ``stencil_matvec_2d``,
compute the same function; here both wrappers launch the one CUDA kernel of
``csrc/stencil.cu``, which takes any ``(ny, nx)`` without padding.

For a CUDA tensor a wrapper launches the kernel or raises: a failed build,
a refused launch or an unsupported tensor is an error, never a quiet switch
to another path.  For a CPU tensor it computes the plain version,
:func:`stencil_matvec_reference`.  Each wrapper counts its kernel launches
in its ``LAUNCHES`` attribute.

The v5e VMEM tuning of the JAX module (``effective_tile``,
``DEFAULT_VMEM_BUDGET``, ``auto_poisson2d``) is not carried over.
"""

from __future__ import annotations

import torch

from ..constants import as_torch_dtype
from ..linops import LinearOperator
from . import _build

__all__ = ["stencil_matvec", "stencil_matvec_2d", "stencil_matvec_reference",
           "CudaPoisson2D"]


def stencil_matvec_reference(u, *, ihx2: float, ihy2: float):
    """Plain PyTorch version of the kernel, and the matvec of
    :class:`lightkrylov_tpu_torch.models.Poisson2D`: shifted neighbours from
    zero-padded copies (the Dirichlet boundary), as in the JAX
    ``Poisson2D.matvec``."""
    un = torch.nn.functional.pad(u, (1, 1))        # pad x
    left, right = un[:, :-2], un[:, 2:]
    um = torch.nn.functional.pad(u, (0, 0, 1, 1))  # pad y
    down, up = um[:-2, :], um[2:, :]
    return (2.0 * (ihx2 + ihy2)) * u - ihx2 * (left + right) - ihy2 * (down + up)


def _launch(u, ihx2: float, ihy2: float):
    """Check ``u``, allocate the output and launch the CUDA kernel on the
    current stream."""
    if u.device.type != "cuda":
        raise ValueError(f"stencil kernel: expected a CUDA tensor, got {u.device}")
    entry = {torch.float32: "lk_stencil_f32", torch.float64: "lk_stencil_f64"}.get(u.dtype)
    if entry is None:
        raise TypeError(f"stencil kernel: dtype {u.dtype} not supported "
                        "(float32 or float64)")
    if u.ndim != 2 or 0 in u.shape:
        raise ValueError(f"stencil kernel: expected a non-empty 2-D grid, "
                         f"got shape {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("stencil kernel: the grid must be contiguous")
    ny, nx = u.shape
    lib = _build.load()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = getattr(lib, entry)(u.data_ptr(), out.data_ptr(), ny, nx,
                                  2.0 * (ihx2 + ihy2), ihx2, ihy2, stream)
    if err:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {err} "
                           f"({lib.lk_error_string(err).decode()})")
    return out


def stencil_matvec(u, *, ihx2: float, ihy2: float, tile: int = 256):
    """5-point ``-Delta`` matvec of the ``(ny, nx)`` grid ``u``.

    ``tile`` is accepted for parity with the JAX signature; the kernel's
    tiling is fixed and the result does not depend on it."""
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    out = _launch(u, ihx2, ihy2)
    stencil_matvec.LAUNCHES += 1
    return out


def stencil_matvec_2d(u, *, ihx2: float, ihy2: float, tile_y: int = 256,
                      tile_x: int = 1024):
    """Counterpart of the x-tiled Pallas variant.  It launches the same
    kernel as :func:`stencil_matvec`; ``tile_y``/``tile_x`` are accepted for
    parity with the JAX signature and do not change the result."""
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    out = _launch(u, ihx2, ihy2)
    stencil_matvec_2d.LAUNCHES += 1
    return out


stencil_matvec.LAUNCHES = 0
stencil_matvec_2d.LAUNCHES = 0


class CudaPoisson2D(LinearOperator):
    """The Poisson operator of :class:`~lightkrylov_tpu_torch.models.Poisson2D`
    (same grid, spacing and SPD matrix) applied by the CUDA kernel;
    counterpart of ``PallasPoisson2D``.  With ``tile_x`` set it goes through
    :func:`stencil_matvec_2d`, as the JAX operator does.  ``device`` is
    where :meth:`template` allocates."""

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, dtype=torch.float32,
                 tile: int = 256, tile_x: int | None = None, device=None):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = as_torch_dtype(dtype)
        self.tile = tile
        self.tile_x = tile_x
        self.device = device

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
