"""Machine-precision tolerances and process-level context.

PyTorch counterpart of :mod:`lightkrylov_tpu.constants` (reference:
src/Constants.f90:16-56): per scalar kind

    atol = 10 ** (-precision(1.0))      # 1e-6 single / 1e-15 double
    rtol = sqrt(atol)

and the rank used to gate logging and IO.  The rank is the
``torch.distributed`` rank when a process group is initialised, else 0.

Every dtype argument may be a ``torch.dtype`` or anything ``numpy.dtype``
accepts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "atol",
    "rtol",
    "eps",
    "get_rank",
    "get_comm_size",
    "io_rank",
    "set_io_rank",
    "real_dtype_of",
    "is_complex_dtype",
    "as_torch_dtype",
]

_TORCH_TO_NUMPY = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.complex64: np.dtype(np.complex64),
    torch.complex128: np.dtype(np.complex128),
}
_NUMPY_TO_TORCH = {v: k for k, v in _TORCH_TO_NUMPY.items()}

# Decimal precision per real dtype, matching Fortran ``precision()``
# (reference: src/Constants.f90:18-37): 6 for binary32, 15 for binary64.
_PRECISION = {torch.float32: 6, torch.float64: 15, torch.bfloat16: 2}


def as_torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype`` (numpy dtypes and names accepted)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NUMPY_TO_TORCH[np.dtype(dtype)]


def real_dtype_of(dtype) -> torch.dtype:
    """The real dtype underlying ``dtype`` (c64 -> f32, c128 -> f64)."""
    dt = as_torch_dtype(dtype)
    return dt.to_real() if dt.is_complex else dt


def is_complex_dtype(dtype) -> bool:
    return as_torch_dtype(dtype).is_complex


def atol(dtype) -> float:
    """Absolute tolerance ``10**-precision`` for ``dtype``
    (reference: src/Constants.f90:18-37)."""
    return 10.0 ** (-_PRECISION[real_dtype_of(dtype)])


def rtol(dtype) -> float:
    """Relative tolerance ``sqrt(atol)`` (reference: src/Constants.f90:20-39)."""
    return math.sqrt(atol(dtype))


def eps(dtype) -> float:
    """Machine epsilon of the real dtype underlying ``dtype``."""
    return float(torch.finfo(real_dtype_of(dtype)).eps)


# -- Process context ---------------------------------------------------------

_io_rank = 0


def _dist():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_rank() -> int:
    """Rank of this process (reference: src/Constants.f90 ``get_rank``)."""
    return torch.distributed.get_rank() if _dist() else 0


def get_comm_size() -> int:
    """Number of processes (reference: src/Constants.f90 ``get_comm_size``)."""
    return torch.distributed.get_world_size() if _dist() else 1


def set_io_rank(rank: int) -> None:
    """Choose which process performs logging/IO (reference: ``set_io_rank``)."""
    global _io_rank
    if 0 <= rank < get_comm_size():
        _io_rank = rank


def io_rank() -> bool:
    """True on the process responsible for logging/IO (reference: ``io_rank``)."""
    return get_rank() == _io_rank
