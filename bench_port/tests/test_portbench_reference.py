"""The plain reference on tiny grids against NumPy and SciPy."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from bench_port.reference import cg as ref_cg
from bench_port.reference import gmres as ref_gmres
from bench_port.reference import poisson as ref_poisson
from bench_port.reference import precision


def scipy_laplacian(nx, ny):
    def d2(n):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)) * float(n + 1) ** 2
    return (sp.kron(sp.eye(ny), d2(nx)) + sp.kron(d2(ny), sp.eye(nx))).tocsr()


@pytest.mark.parametrize("nx,ny", [(7, 5), (16, 16), (1, 3)])
def test_laplacian_is_the_5_point_matrix(nx, ny):
    u = torch.randn((ny, nx), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    want = scipy_laplacian(nx, ny) @ u.numpy().ravel()
    got = ref_poisson.laplacian(u.clone(), nx, ny).numpy().ravel()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-9)


def test_gmres_cycle_minimises_the_residual_over_the_krylov_space():
    nx = ny = 12
    A = scipy_laplacian(nx, ny).toarray()
    b = torch.randn((ny, nx), dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    k = 8
    x, res = ref_gmres.gmres_cycle(lambda u: ref_poisson.laplacian(u, nx, ny), b, k)
    bv = b.numpy().ravel()
    K = np.column_stack([np.linalg.matrix_power(A, i) @ bv for i in range(k)])
    Q, _ = np.linalg.qr(K)
    y, *_ = np.linalg.lstsq(A @ Q, bv, rcond=None)
    want = Q @ y
    np.testing.assert_allclose(x.numpy().ravel(), want, rtol=1e-7, atol=1e-9 * np.abs(want).max())
    assert res == pytest.approx(np.linalg.norm(bv - A @ want), rel=1e-8)


def test_gmres_cycle_solves_once_the_space_is_complete():
    A = torch.diag(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    b = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64)
    x, res = ref_gmres.gmres_cycle(lambda u: A @ u, b, 5)
    np.testing.assert_allclose(x.numpy(), [1.0, 0.5, 1.0 / 3.0], rtol=1e-12)
    assert res < 1e-12


def test_cg_meets_its_tolerance_and_matches_scipy():
    nx = ny = 20
    A = scipy_laplacian(nx, ny)
    b = torch.randn((ny, nx), dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    x, k = ref_cg.cg(lambda u: ref_poisson.laplacian(u, nx, ny), b, 1e-8, 1000)
    assert ref_poisson.relative_residual(x, b, nx, ny) < 1e-8
    want = spla.spsolve(A.tocsc(), b.numpy().ravel())
    np.testing.assert_allclose(x.numpy().ravel(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert 0 < k < 1000


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 3 * 2**-12), 3.0e-20],
                     dtype=torch.float32)
    got = precision.round_tf32(x)
    assert got[0] == 1.0 and got[2] == 1.0 + 2**-10
    assert got[1] == 1.0 + 2**-10  # a tie rounds away from zero
    assert got[3] == -(1.0 + 2**-10)
    r = torch.randn(10000, generator=torch.Generator().manual_seed(7))
    rel = ((precision.round_tf32(r) - r).abs() / r.abs()).max()
    assert 2**-13 < rel <= 2**-11
    assert precision.rounding("float32") is None and precision.rounding("float64") is None
