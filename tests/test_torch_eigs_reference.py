"""The port's ``eigs`` against the benchmark's plain reference
(``bench_port/reference/eigs.py``: Arnoldi with CGS2 and exact-shift
restarts, dense ``eig`` of the projected matrix), and the reference against
a dense eigensolver, on the CPU in float64; and the float32 device path's
pairs against what it reports of them.

The port and the reference keep the same subspace at a restart by other
arithmetic: the port's device path by the implicit Francis filter (the
kernels' plain versions here), its host path by a host Krylov-Schur
restart, the reference by a sorted real Schur form.  In exact arithmetic
all three give the same Ritz pairs after the same cycles from the same
start, so the runs below agree to rounding."""

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from bench_port.reference import eigs as ref_eigs
from bench_port.reference import poisson as ref_poisson

torch.set_num_threads(2)

NX, NY = 48, 40
NEV, KDIM, MAXITER = 4, 16, 5


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _start(seed, shape=(NY, NX)):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("projected", ["host", "device"])
def test_eigs_matches_the_reference(projected, seed):
    """Ritz values, residuals and vectors after 5 cycles at ``tolerance =
    0`` (no pair converges, so every cycle runs: 16 + 4 x 8 steps).  Both
    runs are float64 and differ only in how a restart computes its kept
    subspace; they read 1e-14 of ``|lambda_1|`` apart on these starts.  The
    bound, 1e-11, leaves a thousandfold for other BLAS orders and sits far
    below what a restart that keeps another subspace moves (the Ritz values
    change by 1e-4 of ``|lambda_1|`` and more between cycles here)."""
    x0 = _start(seed)
    w_ref, V_ref, r_ref = ref_eigs.eigs(lambda u: ref_poisson.laplacian(u, NX, NY), x0, NEV,
                                        KDIM, MAXITER)
    w, V, r, info, meta = lt.eigs(lt.Poisson2D(NX, NY, dtype=torch.float64, device="cpu"), NEV,
                                  x0=x0.clone(), kdim=KDIM, tolerance=0.0, check_every=8,
                                  options=lt.EigsOptions(maxiter=MAXITER, projected=projected))
    assert info == 0 and not meta.converged
    assert meta.n_iter == KDIM + (MAXITER - 1) * KDIM // 2
    scale = abs(w_ref[0])
    assert np.max(np.abs(w - w_ref)) < 1e-11 * scale
    assert np.max(np.abs(r - r_ref)) < 1e-11 * scale
    # the Ritz vectors, each up to a unit factor
    Vm = V.reshape(NEV, -1).to(torch.complex128)
    Vr = V_ref.reshape(NEV, -1).to(torch.complex128)
    overlap = torch.abs(torch.sum(Vm.conj() * Vr, dim=1))
    assert torch.max(torch.abs(overlap - 1)) < 1e-9


def test_reference_finds_the_poisson_spectrum():
    """On a 12 x 10 grid the reference converges to the dense matrix's four
    largest eigenvalues (double ones of a square grid aside: 12 x 10 has
    none), with residuals that describe its vectors."""
    nx, ny = 12, 10
    A = lt.Poisson2D(nx, ny, dtype=torch.float64, device="cpu").dense()
    exact = np.sort(np.linalg.eigvalsh(A))[::-1][:4]
    lap = lambda u: ref_poisson.laplacian(u, nx, ny)  # noqa: E731
    w, V, r = ref_eigs.eigs(lap, _start(3, (ny, nx)), 4, 24, 12)
    assert np.max(np.abs(w - exact)) < 1e-10 * exact[0]
    assert np.max(np.abs(w.imag)) == 0.0
    for lam, v, res in zip(w, V, r):
        v = v.real
        true = float(torch.linalg.vector_norm(lap(v) - lam.real * v) / torch.linalg.vector_norm(v))
        assert res < 1e-8 * exact[0] and abs(true - res) < 1e-10 * exact[0]


def test_reference_keeps_complex_pairs_whole():
    """A real non-normal matrix whose leading eigenvalues are a complex pair
    and a real one (10 +- 2i, 7; then 6 +- i and the rest in [0, 1]): the
    restarts take the pairs as double shifts and the three leading values
    converge to ``numpy.linalg.eigvals``' own."""
    rng = np.random.default_rng(5)
    n = 40
    B = np.diag(rng.uniform(0.0, 1.0, n))
    B[:2, :2] = [[10.0, 2.0], [-2.0, 10.0]]
    B[2, 2] = 7.0
    B[3:5, 3:5] = [[6.0, 1.0], [-1.0, 6.0]]
    S = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    A = torch.from_numpy(S @ B @ np.linalg.inv(S))
    exact = np.linalg.eigvals(A.numpy())
    exact = exact[np.argsort(-np.abs(exact), kind="stable")][:3]
    w, V, r = ref_eigs.eigs(lambda u: A @ u, _start(6, (n,)), 3, 12, 30)
    assert np.max(np.min(np.abs(w[:, None] - exact[None, :]), axis=1)) < 1e-9
    assert np.sum(w.imag > 0) == 1 and np.sum(w.imag < 0) == 1
    for lam, v, res in zip(w, V, r):
        true = torch.linalg.vector_norm(A.to(torch.complex128) @ v - complex(lam) * v)
        assert abs(float(true / torch.linalg.vector_norm(v)) - res) < 1e-9


def test_float32_device_path_returns_the_pairs_it_reports():
    """A float32 ``eigs`` on the device path, on a symmetric operator whose 24
    leading eigenvalues lie 3e-6 apart: its Ritz vectors are orthonormal and
    each reported residual is its vector's own.  The checks and the filter
    solve the projected problem in float64; solved in float32, whose
    eigenvalues of the kdim-32 ``H`` err by about the gap, the inverse
    iteration returned vectors 0.10 from orthogonal and residuals 4.6e-6
    from their own.  Float64 reads 6.7e-4 and 6.2e-8 here."""
    rng = np.random.default_rng(0)
    n = 300
    d = np.concatenate([1.0 - 3e-6 * np.arange(24), rng.uniform(0.0, 0.99, n - 24)])
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * d) @ Q.T
    op = lt.DenseOperator(torch.from_numpy(A.astype(np.float32)))
    x0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    w, V, r, _, _ = lt.eigs(op, 6, x0=x0, kdim=32, tolerance=0.0, check_every=4,
                            options=lt.EigsOptions(maxiter=8, projected="device"))
    Vm = V.to(torch.complex128)
    G = Vm.conj() @ Vm.T
    assert float((G - torch.eye(len(w), dtype=G.dtype)).abs().max()) < 1e-2
    Ad = torch.from_numpy(A).to(torch.complex128)
    true = np.array([float(torch.linalg.vector_norm(Ad @ v - complex(lam) * v))
                     for lam, v in zip(w, Vm)])
    assert np.max(np.abs(true - r)) < 5e-7
