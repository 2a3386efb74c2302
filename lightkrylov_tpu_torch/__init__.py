"""lightkrylov_tpu_torch: the Krylov solvers of ``lightkrylov_tpu`` on PyTorch
and CUDA.

A port of the JAX package's vector and operator layers, CGS2 and DCGS2
orthogonalization, QR, ``gmres``/``fgmres``/``cg``, Lanczos and ``eighs``
(host projected path, thick restart), Arnoldi and ``eigs`` (host projected
path, Krylov-Schur restart), Golub-Kahan and ``svds`` (host projected path,
thick restart), checkpoints of the three eigensolvers, ``kexpm``, nonlinear systems and
Newton-Krylov, the Poisson, convection-diffusion, Toeplitz, Ginzburg-Landau
and Roessler models with OTD modes, and two operators whose matvec on a
CUDA tensor is a hand-written CUDA kernel, built for Hopper ``sm_90a`` on
first use: the 2-D Poisson stencil (``csrc/stencil.cu``) and the Block-ELL
sparse matrix (``csrc/spmv.cu``).  The module layout follows the JAX
package's, so each counterpart has the same path.

Models, operators and converted arrays land on the card unless the caller
asks for the CPU: ``constants.set_default_device("cpu")`` or
``device="cpu"`` (:func:`.constants.default_device`).

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
from .constants import (atol, rtol, get_rank, get_comm_size, io_rank,  # noqa: E402
                        default_device, set_default_device)

from .vectors import (  # noqa: E402
    dot,
    norm,
    scal,
    axpby,
    add,
    sub,
    chsgn,
    zero_like,
    dtype_of,
    get_size,
    rand_like,
    rand_basis,
    innerprod,
    gram,
    linear_combination,
    innerprod_vpu,
    linear_combination_vpu,
    axpby_basis,
    zeros_basis,
    stack,
    unstack,
    get_column,
    set_column,
    basis_size,
    verify_vector_axioms,
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
from .systems import System, JacobianOperator  # noqa: E402

from .krylov import (  # noqa: E402
    arnoldi,
    arnoldi_block,
    arnoldi_step,
    bidiagonalization,
    cholesky_qr2,
    double_gram_schmidt_step,
    initialize_arnoldi,
    initialize_bidiag,
    initialize_krylov_subspace,
    initialize_lanczos,
    initialize_random_orthonormal_basis,
    invperm,
    is_orthonormal,
    krylov_schur,
    lanczos,
    lanczos_step,
    median_selector,
    orthogonalize_against_basis,
    orthonormalize_basis,
    permcols,
    qr,
    qr_pivoted,
)
from .models import (  # noqa: E402
    BlockJacobiPoisson,
    ConvectionDiffusion2D,
    GinzburgLandau,
    GinzburgLandauReal,
    GLPropagator,
    Poisson2D,
    TridiagToeplitz,
    UPOJacobian,
    fixed_point_system,
    floquet_exponents,
    flow,
    gl_analytic_eigvals,
    lyapunov_exponents,
    monodromy,
    otd_evolve,
    otd_rhs,
    poisson2d_eigvals,
    roessler_fixed_points,
    roessler_rhs,
    toeplitz_eigvals,
    upo_system,
)
from .ops import (  # noqa: E402
    BellMatrix,
    BellOperator,
    CudaPoisson2D,
    bell_from_scipy,
    bell_spmv,
    stencil_matvec,
    stencil_matvec_2d,
)
from .solvers import (  # noqa: E402
    ExponentialPropagator,
    cg,
    constant_tol,
    dynamic_tol,
    eighs,
    eigs,
    fgmres,
    gmres,
    kexpm,
    kexpm_mat,
    krylov_exptA,
    newton,
    save_eigenspectrum,
    svds,
)

from .utils import checkpoint, linalg, logger, options, timer  # noqa: E402
from .utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from .utils.logger import logger_setup, check_info, LightKrylovError  # noqa: E402
from .utils.options import (  # noqa: E402
    CGOptions,
    EigsOptions,
    GMRESOptions,
    KexpmOptions,
    NewtonMetadata,
    NewtonOptions,
    SVDSOptions,
    SolverMetadata,
)
from .utils.timer import global_watch, set_timing, time_lightkrylov, timed  # noqa: E402


def greetings() -> str:
    """Version banner (reference: ``greetings()``, LightKrylov.fypp:140-169)."""
    banner = (f"lightkrylov_tpu_torch v{__version__} — Krylov subspace methods "
              "on PyTorch and CUDA")
    logger.log_message(banner)
    return banner
