"""The benchmark's convection-diffusion cell (``bench_port/loops/
bell_gmres_cycles.py``) on the CPU at 40 x 24 in float64, a grid whose
sides are multiples of neither the Block-ELL block's 8 rows nor its 128
columns: the loop's CSR matrix through the program's ``bell_from_scipy``
and ``BellOperator`` against the plain matrix-free reference
(``bench_port/reference/convdiff.py``), a GMRES(10) cycle of the program
against the reference cycle, and the sign of the convection term."""

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from bench_port import harness
from bench_port.reference import convdiff as ref_convdiff
from bench_port.reference import gmres as ref_gmres

torch.set_num_threads(2)

NX, NY = 40, 24
EPS, CX, CY = 1e-2, 1.0, 0.5
loop = harness.load_module("loops", "bell_gmres_cycles")


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _operator(nx=NX, ny=NY):
    A = loop.convdiff_csr(nx, ny, EPS, CX, CY)
    return lt.BellOperator(lt.bell_from_scipy(A, dtype=torch.float64, device="cpu"))


def _reference(u, nx=NX, ny=NY):
    return ref_convdiff.apply(u, nx, ny, EPS, CX, CY)


def _fields(count, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((NY, NX), generator=g, dtype=torch.float64) for _ in range(count)]


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_the_assembled_operator_is_the_reference():
    """Within 1e-14 relative: both sum the same five float64 products of
    magnitude ~50 in other orders, a few units of 1.1e-16 apart."""
    op = _operator()
    for u in _fields(4, 11):
        assert _rel(op.matvec(u.reshape(-1)).reshape(NY, NX), _reference(u)) <= 1e-14


def test_a_gmres_cycle_is_the_reference_cycle():
    """One GMRES(10) cycle within 1e-10 relative: the program's DCGS2 and
    the reference's CGS2 span the same Krylov space, each to about 1e-15 in
    float64 on this well-conditioned basis (readings ~3e-15); the rest of
    the room is the small least-squares problem's condition."""
    op = _operator()
    opts = lt.GMRESOptions(kdim=10, maxiter=1)
    for b in _fields(2, 12):
        x, _, meta = lt.gmres(op, b.reshape(-1), rtol=0.0, atol=0.0, options=opts)
        x_ref, res_ref = ref_gmres.gmres_cycle(_reference, b, 10)
        assert _rel(x.reshape(NY, NX), x_ref) <= 1e-10
        true_res = float(torch.linalg.vector_norm(b - _reference(x_ref)))
        assert abs(float(meta.residuals[-1]) - true_res) <= 1e-10 * true_res


def test_the_convection_term_has_its_sign():
    """``A - A^T`` is the convection term twice: non-zero, and the same in
    the loop's matrix, the reference and the library's model."""
    nx, ny = 6, 5
    A = loop.convdiff_csr(nx, ny, EPS, CX, CY).toarray()
    eye = torch.eye(nx * ny, dtype=torch.float64)
    R = torch.stack([_reference(e.reshape(ny, nx), nx, ny).reshape(-1) for e in eye], 1).numpy()
    model = lt.ConvectionDiffusion2D(nx, ny, eps=EPS, cx=CX, cy=CY).dense().numpy()
    skew = A - A.T
    assert np.linalg.norm(skew) > 0.5 * np.linalg.norm(A - np.diag(np.diag(A)))
    assert np.allclose(skew, R - R.T, rtol=0, atol=1e-12 * np.abs(A).max())
    assert np.allclose(A, R, rtol=0, atol=1e-12 * np.abs(A).max())
    assert np.allclose(A, model, rtol=0, atol=1e-12 * np.abs(A).max())
    # the east neighbour carries +cx / (2 hx): the first row's entry to its right
    hx = 1.0 / (nx + 1)
    assert A[0, 1] - A[1, 0] == pytest.approx(CX / hx)
