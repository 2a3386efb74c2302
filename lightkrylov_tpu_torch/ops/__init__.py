"""Operators backed by the package's hand-written CUDA kernels."""

from .stencil import (
    CudaPoisson2D,
    stencil_matvec,
    stencil_matvec_2d,
    stencil_matvec_reference,
)

__all__ = ["CudaPoisson2D", "stencil_matvec", "stencil_matvec_2d",
           "stencil_matvec_reference"]
