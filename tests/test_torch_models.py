"""The port's convection-diffusion and Toeplitz models against the JAX
package's, on the same inputs.

Both are elementwise shifts and sums, evaluated in the same order, so in
float64 and complex128 the results agree to a few roundings (``1e-12``
relative); dense matrices and closed-form spectra are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import ConvectionDiffusion2D as JConvDiff
from lightkrylov_tpu.models import TridiagToeplitz as JToeplitz
from lightkrylov_tpu.models import toeplitz_eigvals as j_toeplitz_eigvals
from lightkrylov_tpu_torch.convert import port_operator

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


CONVDIFF = {
    "square": dict(nx=12),
    "rect-strong-convection": dict(nx=9, ny=14, eps=1e-3, cx=2.0, cy=-1.0),
}


@pytest.mark.parametrize("case", list(CONVDIFF))
def test_convdiff_matches_jax(case):
    op_j = JConvDiff(**CONVDIFF[case])
    op_t = port_operator(op_j)
    assert isinstance(op_t, lt.ConvectionDiffusion2D) and not op_t.is_hermitian
    assert (op_t.nx, op_t.ny, op_t.eps, op_t.cx, op_t.cy) == \
        (op_j.nx, op_j.ny, op_j.eps, op_j.cx, op_j.cy)
    u = np.random.default_rng(0).standard_normal((op_j.ny, op_j.nx))
    _close(op_t.matvec(torch.from_numpy(u)).numpy(), op_j.matvec(jnp.asarray(u)))
    _close(op_t.rmatvec(torch.from_numpy(u)).numpy(), op_j.rmatvec(jnp.asarray(u)))
    dense = op_t.dense()
    assert dense.dtype == torch.float64 and np.array_equal(dense.numpy(), op_j.dense())
    assert op_t.template().shape == (op_j.ny, op_j.nx)


def test_convdiff_rmatvec_is_the_transpose():
    op = lt.ConvectionDiffusion2D(7, 5, dtype=torch.float64)
    A = op.dense().numpy()
    u = np.random.default_rng(1).standard_normal((5, 7))
    assert np.allclose(op.matvec(torch.from_numpy(u)).numpy().ravel(), A @ u.ravel())
    assert np.allclose(op.rmatvec(torch.from_numpy(u)).numpy().ravel(), A.T @ u.ravel())


def test_convdiff_float32():
    op_j = JConvDiff(16, dtype=jnp.float32)
    op_t = port_operator(op_j)
    assert op_t.dtype_ == torch.float32 and op_t.template().dtype == torch.float32
    u = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)
    got = op_t.matvec(torch.from_numpy(u)).numpy()
    ref = np.asarray(op_j.matvec(jnp.asarray(u)))
    assert got.dtype == np.float32
    assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref)


TOEPLITZ = {
    "spd-f64": dict(n=50, a=2.0, b=-1.0, c=None, dtype=np.float64),
    "nonsym-f64": dict(n=40, a=1.0, b=0.5, c=-2.0, dtype=np.float64),
    "hermitian-c128": dict(n=30, a=3.0, b=1.0 + 1.0j, c=1.0 - 1.0j, dtype=np.complex128),
    "complex-c128": dict(n=30, a=1.0 + 0.5j, b=2.0j, c=0.5, dtype=np.complex128),
}


@pytest.mark.parametrize("case", list(TOEPLITZ))
def test_toeplitz_matches_jax(case):
    c = TOEPLITZ[case]
    op_j = JToeplitz(c["n"], c["a"], c["b"], c["c"], dtype=c["dtype"])
    op_t = port_operator(op_j)
    assert isinstance(op_t, lt.TridiagToeplitz)
    assert op_t.is_hermitian == op_j.is_hermitian
    rng = np.random.default_rng(3)
    x = rng.standard_normal(c["n"]).astype(c["dtype"])
    if np.dtype(c["dtype"]).kind == "c":
        x = x + 1j * rng.standard_normal(c["n"])
    _close(op_t.matvec(torch.from_numpy(x)).numpy(), op_j.matvec(jnp.asarray(x)))
    _close(op_t.rmatvec(torch.from_numpy(x)).numpy(), op_j.rmatvec(jnp.asarray(x)))
    dense = op_t.dense().numpy()
    assert np.array_equal(dense, op_j.dense())
    assert np.allclose(op_t.rmatvec(torch.from_numpy(x)).numpy(), dense.conj().T @ x)
    # the same operator built directly in the port
    direct = lt.TridiagToeplitz(c["n"], c["a"], c["b"], c["c"], dtype=c["dtype"])
    assert direct.is_hermitian == op_j.is_hermitian
    assert np.array_equal(direct.dense().numpy(), dense)


@pytest.mark.parametrize("abc", [(2.0, -1.0, None), (1.0, 0.5, -2.0), (0.0, 1.0, 3.0)])
def test_toeplitz_eigvals_match_jax_and_the_dense_spectrum(abc):
    a, b, c = abc
    n = 25
    got = lt.toeplitz_eigvals(n, a, b, c)
    assert np.array_equal(got, j_toeplitz_eigvals(n, a, b, c))
    dense = lt.TridiagToeplitz(n, a, b, c).dense().numpy()
    ev = np.linalg.eigvals(dense)
    # each closed-form value next to a computed one (a nonnormal Toeplitz
    # matrix's eigenvalues are computed to ~1e-8 only)
    assert np.all(np.abs(got[:, None] - ev[None, :]).min(axis=1) < 1e-8)
