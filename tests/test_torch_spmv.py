"""The port's Block-ELL tier against the JAX package's and, on a GPU, the
CUDA kernel against its plain version.

On the CPU, ``bell_spmv`` computes the plain version; it is held against the
Pallas kernel run in interpret mode, as tests/test_pallas.py runs it, and
against scipy.  The layouts of ``bell_from_scipy`` (native assembler and
numpy path) must equal the JAX package's exactly.  Solves through the
operator use the float64 ``rtol`` of ``constants.py`` (about 3.2e-8).  The
tests marked ``cuda`` skip where there is no GPU; JAX is imported only by
the tests that use it, so that on a machine with a GPU and no JAX they run
with ``python -m pytest --noconftest -m cuda tests/test_torch_spmv.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.ops import spmv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

RTOL = lt.constants.rtol(torch.float64)  # sqrt(1e-15), as in the JAX constants.py


@pytest.fixture
def jpallas():
    """``(jax.numpy, lightkrylov_tpu, lightkrylov_tpu.ops.pallas)``."""
    import jax.numpy as jnp

    import lightkrylov_tpu as lk
    from lightkrylov_tpu.ops import pallas

    return jnp, lk, pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_csr(m, n, density, seed, eye=False):
    A = sp.random(m, n, density=density, random_state=seed, format="csr")
    return (A + sp.eye(m, n)).tocsr() if eye else A


def _assert_same_layout(got, ref):
    assert got.K == ref.K and got.shape == tuple(ref.shape) and got.nnz == ref.nnz
    assert got.fill_ratio == ref.fill_ratio
    assert got.cols.dtype == torch.int32
    assert np.array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert np.array_equal(got.data.numpy(), np.asarray(ref.data))


LAYOUTS = {
    "8x16-ragged-f64": dict(m=100, n=90, bm=8, bn=16, dtype=np.float64),
    "8x128-f64": dict(m=256, n=256, bm=8, bn=128, dtype=np.float64),
    "8x128-ragged-f32": dict(m=300, n=200, bm=8, bn=128, dtype=np.float32),
    "4x32-c128": dict(m=70, n=70, bm=4, bn=32, dtype=np.complex128),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_bell_layout_matches_jax(jpallas, case):
    _, _, pallas = jpallas
    c = LAYOUTS[case]
    A = _random_csr(c["m"], c["n"], 0.05, seed=1)
    if np.dtype(c["dtype"]).kind == "c":
        A = (A + 1j * _random_csr(c["m"], c["n"], 0.05, seed=2)).tocsr()
    ref = pallas.bell_from_scipy(A, bm=c["bm"], bn=c["bn"], dtype=c["dtype"])
    got = lt.bell_from_scipy(A, bm=c["bm"], bn=c["bn"], dtype=c["dtype"])
    assert got.data.dtype == lt.constants.as_torch_dtype(c["dtype"])
    _assert_same_layout(got, ref)


def test_numpy_path_matches_jax_native(jpallas, monkeypatch):
    """With the native assembler off, the numpy path gives the layout the
    JAX package's native assembler gives."""
    _, _, pallas = jpallas
    A = _random_csr(300, 300, 0.02, seed=7, eye=True)
    ref = pallas.bell_from_scipy(A, bm=8, bn=128, dtype=np.float64)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_same_layout(lt.bell_from_scipy(A, bm=8, bn=128, dtype=np.float64), ref)


def test_native_loader_matches_jax_native():
    from lightkrylov_tpu import native as jnative

    if not (native.available() and jnative.available()):
        pytest.skip("native assembler unavailable (no g++)")
    A = _random_csr(300, 280, 0.02, seed=8, eye=True)
    for dtype in (np.float32, np.float64):
        got = native.bell_assemble(A, 8, 128, dtype)
        ref = jnative.bell_assemble(A, 8, 128, dtype)
        assert got[2] == ref[2]
        assert got[0].dtype == dtype
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_native_loader_without_compiler_falls_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    assert "g++ not found" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.bell_assemble(sp.eye(8, format="csr"), 8, 8)
    A = _random_csr(40, 40, 0.1, seed=9, eye=True)
    bell = lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64)
    x = np.random.default_rng(0).standard_normal(40)
    y = lt.BellOperator(bell).matvec(torch.from_numpy(x)).numpy()
    assert np.allclose(y, A @ x, rtol=1e-12, atol=1e-12)


MATVEC_SHAPES = {
    "256-8x128": dict(m=256, n=256, bm=8, bn=128, eye=True, seed=2),
    "100x90-8x16": dict(m=100, n=90, bm=8, bn=16, eye=False, seed=3),
    "300x200-8x128": dict(m=300, n=200, bm=8, bn=128, eye=False, seed=4),
}


@pytest.mark.parametrize("case", list(MATVEC_SHAPES))
def test_bell_matvec_and_rmatvec_match_jax(jpallas, case):
    jnp, _, pallas = jpallas
    c = MATVEC_SHAPES[case]
    A = _random_csr(c["m"], c["n"], 0.03, seed=c["seed"], eye=c["eye"])
    op_j = pallas.BellOperator(pallas.bell_from_scipy(A, bm=c["bm"], bn=c["bn"],
                                                      dtype=np.float64), interpret=True)
    op_t = port_operator(op_j)
    assert isinstance(op_t, lt.BellOperator) and op_t.shape == (c["m"], c["n"])
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(c["n"]), rng.standard_normal(c["m"])
    got = op_t.matvec(torch.from_numpy(x)).numpy()
    assert np.allclose(got, np.asarray(op_j.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    assert np.allclose(got, A @ x, rtol=1e-12, atol=1e-12)
    gotr = op_t.rmatvec(torch.from_numpy(y)).numpy()
    assert np.allclose(gotr, np.asarray(op_j.rmatvec(jnp.asarray(y))), rtol=1e-12, atol=1e-12)
    assert np.allclose(gotr, A.T @ y, rtol=1e-12, atol=1e-12)
    assert op_t.template().shape == (c["n"],)


def test_complex_rmatvec_is_the_adjoint():
    A = (_random_csr(60, 50, 0.1, seed=10) + 1j * _random_csr(60, 50, 0.1, seed=11)).tocsr()
    op = lt.BellOperator(lt.bell_from_scipy(A, bm=4, bn=16, dtype=np.complex128))
    rng = np.random.default_rng(12)
    x = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    y = rng.standard_normal(60) + 1j * rng.standard_normal(60)
    assert np.allclose(op.matvec(torch.from_numpy(x)).numpy(), A @ x, rtol=1e-12, atol=1e-12)
    assert np.allclose(op.rmatvec(torch.from_numpy(y)).numpy(), A.conj().T @ y,
                       rtol=1e-12, atol=1e-12)


def _dense_from_blocks(data, cols, n_p):
    nbr, K, bm, bn = data.shape
    dense = np.zeros((nbr * bm, n_p))
    for r in range(nbr):
        for k in range(K):
            j = cols[r, k]
            dense[r * bm:(r + 1) * bm, j * bn:(j + 1) * bn] += data[r, k]
    return dense


def _blocks_with_repeats(rng, nbr, K, bm, bn, nbc):
    """Random blocks whose block-rows repeat block-columns, with zero
    padding slots at block-column 0."""
    data = rng.standard_normal((nbr, K, bm, bn))
    cols = rng.integers(0, nbc, size=(nbr, K)).astype(np.int32)
    cols[:, 1] = cols[:, 0]           # a repeated block-column in every row
    cols[::3, -1] = 0                 # padding slots
    data[::3, -1] = 0.0
    return data, cols


def test_reference_sums_repeated_columns_and_padding():
    rng = np.random.default_rng(13)
    data, cols = _blocks_with_repeats(rng, 9, 4, 8, 16, nbc=5)
    x = rng.standard_normal(5 * 16)
    got = spmv.bell_spmv_reference(torch.from_numpy(data), torch.from_numpy(cols),
                                   torch.from_numpy(x)).numpy()
    assert np.allclose(got, _dense_from_blocks(data, cols, 80) @ x, rtol=1e-12, atol=1e-12)


def test_operator_rejects_out_of_grid_columns():
    data = torch.zeros(2, 2, 8, 16)
    cols = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        lt.BellOperator(lt.BellMatrix(data, cols, (16, 32), nnz=0))


def test_cpu_tensor_launches_nothing():
    before = lt.bell_spmv.LAUNCHES
    bell = lt.bell_from_scipy(sp.eye(32, format="csr"), bm=8, bn=16, dtype=np.float32)
    lt.BellOperator(bell).matvec(torch.ones(32))
    assert lt.bell_spmv.LAUNCHES == before


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor gets the plain version: any other device goes to
    the kernel's checks and raises there."""
    data = torch.empty(2, 1, 8, 16, device="meta")
    cols = torch.empty(2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.bell_spmv(data, cols, torch.empty(16, device="meta"))


def test_cg_through_bell_matches_jax(jpallas):
    """CG on a Hermitian Block-ELL Poisson 16^2 operator, both packages
    (the JAX test_bell_poisson_cg case)."""
    jnp, lk, pallas = jpallas
    dense = lt.Poisson2D(16).dense().numpy()
    op_j = pallas.BellOperator(pallas.bell_from_scipy(sp.csr_matrix(dense), dtype=np.float64),
                               is_hermitian=True, interpret=True)
    b = np.random.default_rng(6).standard_normal(256)
    xj, infoj, metaj = lk.cg(op_j, jnp.asarray(b), options=lk.CGOptions(maxiter=400))
    xt, infot, metat = lt.cg(port_operator(op_j), torch.from_numpy(b),
                             options=lt.CGOptions(maxiter=400))
    assert infot == infoj and metat.converged and metaj.converged
    hj = np.asarray(metaj.residuals)
    assert np.linalg.norm(metat.residuals - hj) <= RTOL * np.linalg.norm(hj)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= RTOL * np.linalg.norm(np.asarray(xj))
    assert np.linalg.norm(dense @ xt.numpy() - b) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("orth", ["dcgs2", "cgs2"])
def test_gmres_through_bell_matches_jax(jpallas, orth):
    """GMRES on the nonsymmetric convection-diffusion matrix in Block-ELL,
    with restarts, both packages."""
    jnp, lk, pallas = jpallas
    dense = lt.ConvectionDiffusion2D(12).dense().numpy()
    op_j = pallas.BellOperator(pallas.bell_from_scipy(sp.csr_matrix(dense), bm=8, bn=16,
                                                      dtype=np.float64), interpret=True)
    b = np.random.default_rng(7).standard_normal(144)
    opts = lk.GMRESOptions(kdim=10, maxiter=20, orthogonalization=orth)
    xj, infoj, metaj = lk.gmres(op_j, jnp.asarray(b), rtol=1e-10, options=opts)
    xt, infot, metat = lt.gmres(port_operator(op_j), torch.from_numpy(b), rtol=1e-10,
                                options=lt.GMRESOptions(kdim=10, maxiter=20,
                                                        orthogonalization=orth))
    assert (infot, metat.n_iter, metat.n_inner) == (infoj, metaj.n_iter, metaj.n_inner)
    assert metat.converged and metat.n_iter > 1
    hj = np.asarray(metaj.residuals)
    assert np.linalg.norm(metat.residuals - hj) <= RTOL * np.linalg.norm(hj)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= RTOL * np.linalg.norm(np.asarray(xj))


# -- on the GPU ---------------------------------------------------------------

CUDA_SHAPES = {  # (m, n, bm, bn): the main path's 8x128, 8x16, and general sizes
    "8x128": (1000, 777, 8, 128),
    "8x16": (1003, 1500, 8, 16),
    "3x100": (301, 250, 3, 100),      # bn % 4 != 0: the scalar-load kernel
    "20x64": (500, 640, 20, 64),      # bm > 8: several passes per block-row
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-5), (np.float64, 1e-13)])
@pytest.mark.parametrize("case", list(CUDA_SHAPES))
def test_cuda_kernel_matches_plain(cuda, case, dtype, rel):
    m, n, bm, bn = CUDA_SHAPES[case]
    bell = lt.bell_from_scipy(_random_csr(m, n, 0.02, seed=14, eye=True), bm=bm, bn=bn,
                              dtype=dtype, device=cuda)
    op = lt.BellOperator(bell)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(n)).to(cuda, bell.data.dtype)
    before = lt.bell_spmv.LAUNCHES
    got = op.matvec(x)
    torch.cuda.synchronize()
    assert lt.bell_spmv.LAUNCHES == before + 1
    x_p = torch.nn.functional.pad(x, (0, op._n_padded() - n))
    want = spmv.bell_spmv_reference(bell.data, bell.cols, x_p)[:m]
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
def test_cuda_kernel_sums_repeated_columns(cuda, dtype, rel):
    rng = np.random.default_rng(16)
    data, cols = _blocks_with_repeats(rng, 257, 6, 8, 128, nbc=7)
    data = torch.from_numpy(data).to(cuda, dtype)
    cols = torch.from_numpy(cols).to(cuda)
    x = torch.from_numpy(rng.standard_normal(7 * 128)).to(cuda, dtype)
    got = lt.bell_spmv(data, cols, x)
    want = spmv.bell_spmv_reference(data, cols, x)
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_tensors(cuda):
    data = torch.ones(4, 2, 8, 16, device=cuda)
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    x = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        lt.bell_spmv(data.half(), cols, x.half())
    with pytest.raises(TypeError):
        lt.bell_spmv(data, cols.long(), x)
    with pytest.raises(TypeError):
        lt.bell_spmv(data, cols, x.double())
    with pytest.raises(ValueError):
        lt.bell_spmv(data.transpose(2, 3).contiguous().transpose(2, 3), cols, x)
    with pytest.raises(ValueError):
        lt.bell_spmv(data, cols, torch.ones(33, device=cuda))
    with pytest.raises(ValueError):
        lt.bell_spmv(data, cols.cpu(), x)
