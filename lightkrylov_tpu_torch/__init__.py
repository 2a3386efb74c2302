"""lightkrylov_tpu_torch: the Poisson GMRES/CG path of ``lightkrylov_tpu`` on
PyTorch and CUDA.

A port of the JAX package's vector and operator layers, CGS2 and DCGS2
orthogonalization, ``gmres``/``fgmres``/``cg`` and the 2-D Poisson operator,
whose matvec on a CUDA tensor is a hand-written CUDA stencil kernel
(``csrc/stencil.cu``, built for Hopper ``sm_90a`` on first use).  The module
layout follows the JAX package's, so each counterpart has the same path.

Float32 matrix products run in full float32: importing the package turns
TF32 off for matmuls and cuDNN.  TF32 keeps about three decimal digits,
which costs Krylov reductions their orthogonality, as the TPU's bf16-pass
default did for the JAX package (its ``vectors.py:287-293``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from . import constants  # noqa: E402
from .constants import atol, rtol, get_rank, get_comm_size, io_rank  # noqa: E402

from .vectors import (  # noqa: E402
    dot,
    norm,
    scal,
    axpby,
    add,
    zero_like,
    dtype_of,
    innerprod,
    gram,
    linear_combination,
    innerprod_vpu,
    linear_combination_vpu,
    zeros_basis,
    get_column,
    set_column,
    basis_size,
)

from .linops import (  # noqa: E402
    LinearOperator,
    Preconditioner,
    MatvecOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    ScaledOperator,
    AdjointOperator,
    AxpbyOperator,
    ComposedOperator,
    adjoint,
    aslinop,
)

from .krylov import double_gram_schmidt_step, orthogonalize_against_basis  # noqa: E402
from .models import BlockJacobiPoisson, Poisson2D, poisson2d_eigvals  # noqa: E402
from .ops import CudaPoisson2D, stencil_matvec, stencil_matvec_2d  # noqa: E402
from .solvers import cg, fgmres, gmres  # noqa: E402

from .utils import linalg, logger, options, timer  # noqa: E402
from .utils.logger import logger_setup, check_info, LightKrylovError  # noqa: E402
from .utils.options import CGOptions, GMRESOptions, SolverMetadata  # noqa: E402
from .utils.timer import global_watch, set_timing, time_lightkrylov, timed  # noqa: E402


def greetings() -> str:
    """Version banner (reference: ``greetings()``, LightKrylov.fypp:140-169)."""
    banner = (f"lightkrylov_tpu_torch v{__version__} — Krylov subspace methods "
              "on PyTorch and CUDA")
    logger.log_message(banner)
    return banner
