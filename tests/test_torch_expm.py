"""The port's ``kexpm``, ``kexpm_mat``, ``krylov_exptA`` and
``ExponentialPropagator`` against the JAX package's and scipy's dense
``expm`` (reference model: test/TestExpmlib.fypp:42-230), on the same
seeded numpy inputs.  ``info`` (the Krylov dimension used) equals the JAX
one; the results agree with JAX within the ``rtol`` of ``constants.py``
and with scipy as the JAX tests require."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.convert import port_operator, port_options

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

N = 128


def _rand(dtype, rng, shape):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _rel(got, ref):
    return float(np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref))


def test_kexpm_matches_jax_and_scipy(dtype):
    """c = exp(tau A) b (reference: TestExpmlib.fypp:42-230)."""
    rng = np.random.default_rng(23)
    A = (_rand(dtype, rng, (N, N)) / np.sqrt(N)).astype(dtype)
    b = _rand(dtype, rng, (N,))
    tau = 0.7
    double = np.dtype(dtype) in (np.float64, np.complex128)
    tol = lk.rtol(dtype) * 1e-2 if double else lk.rtol(dtype)
    cj, infoj = lk.kexpm(jnp.asarray(A), jnp.asarray(b), tau, tol=tol, kdim=80)
    lt.timer.reset_counters()
    c, info = lt.kexpm(torch.from_numpy(A), torch.from_numpy(b), tau, tol=tol, kdim=80)
    assert info == infoj and info > 0
    assert lt.timer.get_counter("DenseOperator.matvec") == info
    assert c.dtype == torch.from_numpy(b).dtype
    assert _rel(c.numpy(), np.asarray(cj)) < (1e-12 if double else 10 * lk.rtol(dtype))
    assert _rel(c.numpy(), sla.expm(tau * A.astype(np.complex128)) @ b) < 100 * lk.rtol(dtype)


def test_kexpm_invariant_subspace():
    """Breakdown: the result is exact and info = -2 (reference:
    ExpmLib.fypp:200-204)."""
    rng = np.random.default_rng(24)
    A = np.zeros((N, N))
    A[:3, :3] = rng.standard_normal((3, 3))
    b = np.zeros(N)
    b[:3] = rng.standard_normal(3)
    cj, infoj = lk.kexpm(jnp.asarray(A), jnp.asarray(b), 1.0, tol=1e-12, kdim=30)
    c, info = lt.kexpm(torch.from_numpy(A), torch.from_numpy(b), 1.0, tol=1e-12, kdim=30)
    assert info == infoj == -2
    assert _rel(c.numpy(), sla.expm(A) @ b) < 1e-10 and _rel(c.numpy(), np.asarray(cj)) < 1e-12


def test_kexpm_not_converged():
    """kdim too small for the tolerance: info = -1, as in JAX."""
    rng = np.random.default_rng(25)
    A = rng.standard_normal((N, N))
    b = rng.standard_normal(N)
    _, infoj = lk.kexpm(jnp.asarray(A), jnp.asarray(b), 1.0, tol=1e-12, kdim=4)
    _, info = lt.kexpm(torch.from_numpy(A), torch.from_numpy(b), 1.0, tol=1e-12, kdim=4)
    assert info == infoj == -1


def test_krylov_exptA_matches_jax(dtype_dp):
    """(reference: krylov_exptA wrapper, ExpmLib.fypp:365-392)."""
    rng = np.random.default_rng(26)
    A = (_rand(dtype_dp, rng, (N, N)) / np.sqrt(N)).astype(dtype_dp)
    b = _rand(dtype_dp, rng, (N,))
    c = lt.krylov_exptA(torch.from_numpy(A), torch.from_numpy(b), 0.3, kdim=60)
    cj = lk.krylov_exptA(jnp.asarray(A), jnp.asarray(b), 0.3, kdim=60)
    assert _rel(c.numpy(), sla.expm(0.3 * A) @ b) < 1e-9
    assert _rel(c.numpy(), np.asarray(cj)) < 1e-12


def test_exponential_propagator_matches_jax():
    """exp(tau A) and its adjoint exp(tau A^H) as an operator; the JAX
    operator ports with its nested DenseOperator."""
    rng = np.random.default_rng(27)
    A = rng.standard_normal((N, N)) / np.sqrt(N)
    x = rng.standard_normal(N)
    Pj = lk.ExponentialPropagator(jnp.asarray(A), 0.5, kdim=60)
    P = port_operator(Pj)
    assert isinstance(P, lt.ExponentialPropagator) and isinstance(P.A, lt.DenseOperator)
    assert (P.tau, P.kdim, P.tol) == (0.5, 60, None)
    for mv, E in (("matvec", sla.expm(0.5 * A)), ("rmatvec", sla.expm(0.5 * A.T))):
        y = getattr(P, mv)(torch.from_numpy(x)).numpy()
        assert np.allclose(y, E @ x, rtol=1e-8, atol=1e-9)
        assert _rel(y, np.asarray(getattr(Pj, mv)(jnp.asarray(x)))) < 1e-12


def test_kexpm_mat_matches_jax(dtype_dp):
    """Block Krylov exponential of a 3-column block (reference: kexpm_mat,
    ExpmLib.fypp:234-363)."""
    rng = np.random.default_rng(28)
    A = (_rand(dtype_dp, rng, (N, N)) / np.sqrt(N)).astype(dtype_dp)
    B = _rand(dtype_dp, rng, (3, N))
    # kdim 36: the JAX package unrolls one block step per 3 columns
    Cj, infoj = lk.kexpm_mat(jnp.asarray(A), jnp.asarray(B), 0.4, tol=1e-10, kdim=36)
    C, info = lt.kexpm_mat(torch.from_numpy(A), torch.from_numpy(B), 0.4, tol=1e-10, kdim=36)
    assert info == infoj > 0
    E = sla.expm(0.4 * A)
    for j in range(3):
        assert _rel(C[j].numpy(), E @ B[j]) < 1e-8
    assert _rel(C.numpy(), np.asarray(Cj)) < 1e-12


def test_kexpm_options():
    opts = lk.KexpmOptions(kdim=12)
    assert port_options(opts) == lt.KexpmOptions(kdim=12)
    rng = np.random.default_rng(29)
    A, b = rng.standard_normal((N, N)) / np.sqrt(N), rng.standard_normal(N)
    _, info = lt.kexpm(torch.from_numpy(A), torch.from_numpy(b), 0.5, options=lt.KexpmOptions(kdim=12))
    _, infoj = lk.kexpm(jnp.asarray(A), jnp.asarray(b), 0.5, options=opts)
    assert info == infoj


@pytest.mark.parametrize("transpose", [False, True])
def test_kexpm_through_the_stencil_operator(transpose):
    """kexpm on the Poisson operator with |tau| lambda_max about 1, through
    ``CudaPoisson2D`` (its plain version on the CPU) and the JAX
    ``Poisson2D``: the chip_smoke configuration at a small size."""
    from lightkrylov_tpu.models import Poisson2D as JPoisson2D

    n = 32
    tau = -1.0 / (8 * (n + 1) ** 2)
    b = np.random.default_rng(30).standard_normal((n, n))
    b /= np.linalg.norm(b)
    c, info = lt.kexpm(lt.CudaPoisson2D(n), torch.from_numpy(b), tau, transpose=transpose)
    cj, infoj = lk.kexpm(JPoisson2D(n), jnp.asarray(b), tau, transpose=transpose)
    assert info == infoj > 0
    assert _rel(c.numpy(), np.asarray(cj)) < 1e-12
    E = sla.expm(tau * lt.Poisson2D(n).dense().numpy())
    assert _rel(c.numpy().ravel(), E @ b.ravel()) < 1e-8
