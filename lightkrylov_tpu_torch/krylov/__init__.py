"""Krylov processes: CGS2, QR, the Arnoldi, Lanczos and Golub-Kahan
factorizations and the Krylov-Schur restart."""

from .arnoldi import (arnoldi, arnoldi_block, arnoldi_block_step, arnoldi_step,
                      initialize_arnoldi, initialize_arnoldi_block)
from .bidiag import bidiag_step, bidiagonalization, initialize_bidiag
from .gram_schmidt import double_gram_schmidt_step, orthogonalize_against_basis
from .krylov_schur import (iram_restart, krylov_schur, krylov_schur_block, krylov_schur_device,
                           median_selector)
from .lanczos import initialize_lanczos, lanczos, lanczos_step
from .qr import cholesky_qr2, qr, qr_pivoted
from .utilities import (initialize_krylov_subspace, initialize_random_orthonormal_basis,
                        invperm, is_orthonormal, orthonormalize_basis, permcols)

__all__ = ["arnoldi", "arnoldi_block", "arnoldi_block_step", "arnoldi_step",
           "bidiag_step", "bidiagonalization", "cholesky_qr2", "double_gram_schmidt_step", "initialize_arnoldi",
           "initialize_arnoldi_block", "initialize_bidiag", "initialize_krylov_subspace",
           "initialize_lanczos", "initialize_random_orthonormal_basis", "invperm", "iram_restart",
           "is_orthonormal", "krylov_schur", "krylov_schur_block", "krylov_schur_device", "lanczos", "lanczos_step",
           "median_selector", "orthogonalize_against_basis", "orthonormalize_basis",
           "permcols", "qr", "qr_pivoted"]
