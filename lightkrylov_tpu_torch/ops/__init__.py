"""Operators backed by the package's hand-written CUDA kernels."""

from .spmv import (
    BellMatrix,
    BellOperator,
    bell_from_scipy,
    bell_spmv,
    bell_spmv_reference,
)
from .stencil import (
    CudaPoisson2D,
    stencil_matvec,
    stencil_matvec_2d,
    stencil_matvec_reference,
)

__all__ = ["BellMatrix", "BellOperator", "CudaPoisson2D", "bell_from_scipy",
           "bell_spmv", "bell_spmv_reference", "stencil_matvec",
           "stencil_matvec_2d", "stencil_matvec_reference"]
